"""Fault injection: named points in the serving stack that a test or an
operator arms to stall, fail or kill the process at a known boundary.

A disarmed point is one dict miss on an empty dict. The points hooked in
this package:

  - ``store_read``        — every store's `get_relation_tuples` (memory,
    columnar, sqlite): `stall` a slow store, `error` a failing one.
  - ``store_commit_pre``  — inside the SQL store's write transaction,
    after the rows and the changelog are staged, before COMMIT: a crash
    here loses the write (it was never acked).
  - ``store_commit_post`` — after COMMIT, before the write listeners run:
    the write is durable but unacked.
  - ``changelog_append``  — inside the transaction, between the tuple
    writes and the changelog insert: a crash loses both together.
  - ``device_launch``     — the top of the engine's `check_batch_submit`,
    before any state build: `stall` a wedged card, `error` a dying one.
  - ``batch_corrupt``     — a marker: resolve sends every slot of a batch
    to the exact host replay; the answers stay the same.
  - ``cache_invalidation``— after a commit, before the registry's push
    invalidation reaches the engine and the check cache.
  - ``watch_broadcast``   — in the Watch hub's tailer, after it read the
    changelog and before it fans the events out: resumed cursors still
    get them exactly once from the store.

`configure` also accepts ``store_outage`` (the store health guard),
``checkpoint_pre_rename``, ``checkpoint_post_rename`` and
``mirror_corrupt`` (the mirror checkpoint and the scrubber), the same
names as the JAX package's; nothing in this package fires them yet.

A ``crash:<exit code>`` spec makes the point call ``os._exit(code)`` when
it fires: no atexit hooks, no flushes, the in-process ``kill -9`` at a
named boundary.

Armed per process, through `set_fault` / `clear`, or through the
``KETO_FAULTS`` environment variable, parsed at import::

    KETO_FAULTS="device_launch=stall:0.25,store_read=error:disk gone"
    KETO_FAULTS="batch_corrupt=on"
    KETO_FAULTS="store_commit_pre=crash:137@0.25"   # crash ~25% of commits
    KETO_FAULTS="changelog_append=crash:137!1"      # at most one crash

``@<probability>``, ``!<max_hits>`` and ``~<duration_s>`` suffixes compose
with the ``stall``, ``crash`` and ``on`` modes; ``error`` messages are
taken verbatim (arm a flaky error through `set_fault`).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional


class FaultInjected(RuntimeError):
    """The error an ``error:``-mode injection point raises."""


class FaultSpec:
    __slots__ = (
        "stall_s", "error", "crash", "hits", "probability", "max_hits",
        "expires_at", "_rng", "_mu",
    )

    def __init__(
        self,
        stall_s: float = 0.0,
        error: Optional[str] = None,
        crash: Optional[int] = None,
        probability: float = 1.0,
        max_hits: Optional[int] = None,
        seed: Optional[int] = None,
        duration_s: Optional[float] = None,
    ):
        self.stall_s = float(stall_s or 0.0)
        self.error = error
        # crash-mode exit code (os._exit — the in-process kill -9); None
        # for stall/error/marker faults
        self.crash = crash if crash is None else int(crash)
        # partial faults: `probability` injects on a fraction of hits (a
        # FLAKY device path — the tail-latency shape request hedging
        # exists for: p50 healthy, p99 eats the stall); `max_hits` bounds
        # served injections (deterministic tests: exactly the first N
        # launches stall). Both default to the old always-on behavior.
        self.probability = min(max(float(probability), 0.0), 1.0)
        self.max_hits = max_hits if max_hits is None else int(max_hits)
        # self-clearing faults (the store_outage window shape): past
        # `duration_s` after arming the spec stops firing — an env-armed
        # outage recovers on its own, like a real store coming back
        self.expires_at = (
            None if duration_s is None
            else time.monotonic() + float(duration_s)
        )
        import random

        self._rng = random.Random(seed)
        self.hits = 0  # injections served (test/smoke observable)
        self._mu = threading.Lock()

    def should_fire(self) -> bool:
        """Atomically decide AND claim one injection (bumping `hits`):
        concurrent launch threads can never push past `max_hits`, so the
        'exactly the first N' deterministic-bound contract holds."""
        with self._mu:
            if self.expires_at is not None and time.monotonic() >= self.expires_at:
                return False  # the outage window ended: store is back
            if self.max_hits is not None and self.hits >= self.max_hits:
                return False
            if (self.probability < 1.0
                    and self._rng.random() >= self.probability):
                return False
            self.hits += 1
            return True


POINTS = (
    "device_launch", "store_read", "batch_corrupt", "mirror_corrupt",
    # whole-store outage (the store health guard's every op; not hooked here)
    "store_outage",
    # crash-recovery plane boundaries (module docstring; every one is a
    # dict miss when disarmed, like the rest)
    "store_commit_pre", "store_commit_post", "changelog_append",
    "checkpoint_pre_rename", "checkpoint_post_rename",
    "cache_invalidation", "watch_broadcast",
)

_SPECS: dict[str, FaultSpec] = {}
_mu = threading.Lock()


def set_fault(
    point: str,
    stall_s: float = 0.0,
    error: Optional[str] = None,
    crash: Optional[int] = None,
    probability: float = 1.0,
    max_hits: Optional[int] = None,
    seed: Optional[int] = None,
    duration_s: Optional[float] = None,
) -> FaultSpec:
    """Arm one injection point; returns its spec (hits counter included).
    A spec with no stall/error/crash is a pure marker (batch_corrupt);
    `crash` makes the point os._exit with that code (kill-anywhere
    harness); `probability` < 1 makes the fault flaky (served on a
    fraction of hits), `max_hits` bounds served injections
    (deterministic tests), `duration_s` makes the spec self-clearing
    (the store_outage window shape)."""
    if point not in POINTS:
        raise ValueError(
            f"unknown fault point {point!r}; known: {', '.join(POINTS)}"
        )
    spec = FaultSpec(
        stall_s=stall_s, error=error, crash=crash, probability=probability,
        max_hits=max_hits, seed=seed, duration_s=duration_s,
    )
    with _mu:
        _SPECS[point] = spec
    return spec


def clear(point: Optional[str] = None) -> None:
    with _mu:
        if point is None:
            _SPECS.clear()
        else:
            _SPECS.pop(point, None)


def get(point: str) -> Optional[FaultSpec]:
    return _SPECS.get(point)


def armed_names() -> list[str]:
    """Names of the currently armed injection points."""
    with _mu:
        return list(_SPECS)


def inject(point: str) -> None:
    """Serve one injection: sleep the stall, then crash or raise (all
    optional). A disarmed point is one dict miss; a partial fault
    (probability < 1 / max_hits reached) passes through untouched."""
    spec = _SPECS.get(point)
    if spec is None:
        return
    if not spec.should_fire():  # atomically claims the hit when it fires
        return
    if spec.stall_s:
        time.sleep(spec.stall_s)
    if spec.crash is not None:
        # the in-process kill -9: no atexit, no finally blocks, no
        # buffered-IO flush — exactly the torn state a SIGKILL at this
        # instruction boundary would leave behind
        os._exit(spec.crash)
    if spec.error is not None:
        raise FaultInjected(spec.error)


def _split_suffixes(
    value: str,
) -> tuple[str, float, Optional[int], Optional[float]]:
    """Strip the shared ``@<probability>`` / ``!<max_hits>`` /
    ``~<duration_s>`` suffixes off an env-var mode value (any order),
    returning (bare value, probability, max_hits, duration_s)."""
    probability, max_hits, duration_s = 1.0, None, None
    # scan from the right so a literal '@'/'!'/'~' inside an error
    # message body (left of the first suffix) is never consumed
    while True:
        at, bang = value.rfind("@"), value.rfind("!")
        tilde = value.rfind("~")
        cut = max(at, bang, tilde)
        if cut < 0:
            break
        head, tail = value[:cut], value[cut + 1:]
        try:
            if cut == at:
                probability = float(tail)
            elif cut == bang:
                max_hits = int(tail)
            else:
                duration_s = float(tail)
        except ValueError:
            break  # not a suffix: part of the value proper
        value = head
    return value, probability, max_hits, duration_s


def configure(text: str) -> None:
    """Parse the KETO_FAULTS format: comma-separated
    ``point=stall:<seconds>`` / ``point=error:<message>`` /
    ``point=crash:<exit code>`` / ``point=on`` entries; on the stall /
    crash / on modes, ``@<probability>`` makes the entry flaky
    (``device_launch=stall:0.25@0.2`` stalls ~20% of launches;
    ``store_commit_pre=crash:137@0.25`` crashes ~25% of commits) and
    ``!<max_hits>`` bounds served injections; error messages are taken
    verbatim (module docstring). Replaces the whole armed set."""
    clear()
    for entry in (text or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, spec = entry.partition("=")
        mode, sep, value = spec.partition(":")
        name, mode = name.strip(), mode.strip()
        probability, max_hits, duration_s = 1.0, None, None
        if not sep:
            # value-less modes (``on``) carry the suffixes on the mode
            # token itself: ``mirror_corrupt=on!1``
            mode, probability, max_hits, duration_s = _split_suffixes(mode)
        elif mode != "error":
            # error MESSAGES are taken verbatim — '@'/'!'/'~' are
            # legitimate message content ("error:HTTP 429!") and must
            # never be reinterpreted as suffixes; arm flaky/bounded
            # error faults programmatically (set_fault) instead
            value, probability, max_hits, duration_s = _split_suffixes(value)
        if mode == "stall":
            set_fault(
                name, stall_s=float(value),
                probability=probability, max_hits=max_hits,
                duration_s=duration_s,
            )
        elif mode == "error":
            set_fault(name, error=value or "injected fault")
        elif mode == "crash":
            set_fault(
                name, crash=int(value or 137),
                probability=probability, max_hits=max_hits,
                duration_s=duration_s,
            )
        elif mode == "on":
            set_fault(
                name, probability=probability, max_hits=max_hits,
                duration_s=duration_s,
            )
        else:
            raise ValueError(
                f"unknown fault mode {mode!r} in {entry!r} "
                "(use stall:<s>, error:<msg>, crash:<code>, or on)"
            )


if os.environ.get("KETO_FAULTS"):
    configure(os.environ["KETO_FAULTS"])

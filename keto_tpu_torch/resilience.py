"""The serving plane's overload and failure primitives: deadlines,
admission, the device-path circuit breaker, and the counters of what
they refuse.

  - `Deadline`: one end-to-end budget a request, taken at the transport
    (the REST `x-request-timeout-ms` header, else
    `serve.check.default_deadline_ms`, capped by
    `serve.check.max_deadline_ms`) and checked at every stage boundary
    (admission, queue, the wait on the batch), so an expired request
    fails fast with a typed `DeadlineExceededError` instead of holding a
    batch slot.
  - `admit_check` / `admit_filter`: the admission gate the transport runs
    before any work: a typed `OverloadedError` while the daemon drains or
    when the batcher's admitted-but-unresolved count is at
    `serve.check.max_queue`, the typed 504 for a request already expired,
    and for a filter the `filter.max_objects` bound.
  - `CircuitBreaker`: consecutive device-batch failures or launch
    timeouts open it; while open the batcher fails every check at once
    with a typed 503 and leaves the device alone; after `cooldown_s` one
    probe batch half-opens it and its outcome closes or re-opens it.
  - `ServeCounters`: the events these count, under the JAX package's
    metric label names, until the port exports metrics.
  - `RetryPolicy`: the gRPC read client's retry of a shed (UNAVAILABLE,
    RESOURCE_EXHAUSTED) inside the caller's deadline, its backoff floored
    by the server's `retry-after` hint.

The JAX package's explain token bucket comes with Explain.
"""

from __future__ import annotations

import collections
import contextvars
import copy
import math
import random
import threading
import time
from typing import Optional

from .errors import DeadlineExceededError, FilterTooLargeError, MalformedInputError, OverloadedError

# -- deadlines ----------------------------------------------------------------


class Deadline:
    """One request's end-to-end budget, pinned to the monotonic clock
    when it is taken."""

    __slots__ = ("expires_at", "budget_s")

    def __init__(self, budget_s: float):
        self.budget_s = float(budget_s)
        self.expires_at = time.monotonic() + self.budget_s

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(float(ms) / 1e3)

    def remaining_s(self) -> float:
        return max(0.0, self.expires_at - time.monotonic())

    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at


class RequestTrace:
    """What one request carries through admission, the cache and the
    batcher: its deadline (None: no deadline). The JAX package's
    RequestTrace also carries stage timings and a span context; those come
    with the port's tracing."""

    __slots__ = ("deadline",)

    def __init__(self, deadline: Optional[Deadline] = None):
        self.deadline = deadline


# the executing handler's RequestTrace: a transport sets it so that the
# layers below (the aio plane's admission and batcher, its delegated
# bodies on executor threads) reach the request's deadline without an
# argument through every signature
CURRENT_TRACE: contextvars.ContextVar[Optional[RequestTrace]] = (
    contextvars.ContextVar("keto_tpu_torch_request_trace", default=None))


def set_request_trace(rt: Optional[RequestTrace]):
    return CURRENT_TRACE.set(rt)


def reset_request_trace(token) -> None:
    CURRENT_TRACE.reset(token)


def current_request_trace() -> Optional[RequestTrace]:
    return CURRENT_TRACE.get()


def parse_timeout_ms(value: Optional[str]) -> Optional[float]:
    """The `x-request-timeout-ms` header as milliseconds; a malformed or
    non-positive value is the client's error (400), never no deadline."""
    if not value:
        return None
    try:
        ms = float(value)
    except ValueError:
        raise MalformedInputError(debug=f"invalid x-request-timeout-ms {value!r}")
    if ms <= 0:
        raise MalformedInputError(debug=f"x-request-timeout-ms must be positive, got {value!r}")
    return ms


def ingest_deadline(config, request_ms: Optional[float] = None,
                    native_s: Optional[float] = None) -> Optional[Deadline]:
    """A request's Deadline from, in order, its own budget (the header's
    ms, or a transport's native seconds) and `serve.check.default_deadline_ms`,
    capped by `serve.check.max_deadline_ms` and by one day. None: no
    deadline."""
    budget_ms = request_ms
    if budget_ms is None and native_s is not None:
        if native_s <= 0:
            # expired in transit: an expired deadline, not none
            return Deadline(0.0)
        # past a day is a transport's "no deadline" sentinel, not a budget
        if native_s < 86400.0:
            budget_ms = native_s * 1e3
    if budget_ms is None:
        default_ms = config.get("serve.check.default_deadline_ms")
        if default_ms:
            budget_ms = float(default_ms)
    if budget_ms is None:
        return None
    max_ms = config.get("serve.check.max_deadline_ms")
    if max_ms:
        budget_ms = min(budget_ms, float(max_ms))
    return Deadline.after_ms(min(budget_ms, 86400.0 * 1e3))


# -- counters -----------------------------------------------------------------

# metric -> its labels (None: an unlabelled count), the JAX package's
# metric and label names
COUNTERS = {
    "coalesced": None,
    # breaker_open: the port's own label; the JAX package answers those
    # checks from its host oracle, the port fails them with a typed 503
    "shed": ("queue_full", "draining", "breaker_open"),
    "deadline_exceeded": ("admission", "wait", "queue"),
    "check_batch_failed": ("device", "device_timeout", "engine", "keto"),
    "batches": None,
    "batched_checks": None,
}


class ServeCounters:
    """Thread-safe counts of the serving plane's events: shed and expired
    requests, failed batches, coalesced riders, device
    batches and the checks they carried. `snapshot()` is a plain dict:
    a labelled metric is a dict by label."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counts = {name: ({label: 0 for label in labels} if labels else 0)
                        for name, labels in COUNTERS.items()}

    def inc(self, name: str, label: Optional[str] = None, n: int = 1) -> None:
        with self._mu:
            if label is None:
                self._counts[name] += n
            else:
                self._counts[name][label] += n

    def snapshot(self) -> dict:
        with self._mu:
            return copy.deepcopy(self._counts)


# -- admission ----------------------------------------------------------------


def admit_check(registry, batcher, rt=None) -> None:
    """The admission gate a transport runs before any check work, the
    cache lookup included: a typed 429 while the daemon drains, a typed
    504 for a request that arrived expired, then the batcher's own bound."""
    counters = registry.counters()
    if registry.draining.is_set():
        counters.inc("shed", "draining")
        raise OverloadedError("server is draining", retry_after_s=1.0)
    dl = getattr(rt, "deadline", None) if rt is not None else None
    if dl is not None and dl.expired():
        counters.inc("deadline_exceeded", "admission")
        raise DeadlineExceededError("request deadline expired before admission")
    if batcher is not None:
        batcher.admit(dl)


DEFAULT_FILTER_MAX_OBJECTS = 65536


def admit_filter(registry, n_objects: int, rt=None) -> None:
    """The filter's admission gate: admit_check's draining and expiry
    checks, then the `filter.max_objects` bound (a typed 400)."""
    admit_check(registry, None, rt)
    max_objects = int(registry.config.get("filter.max_objects", DEFAULT_FILTER_MAX_OBJECTS))
    if n_objects > max_objects:
        raise FilterTooLargeError(
            f"filter candidate list has {n_objects} objects; filter.max_objects allows "
            f"{max_objects} — split the list and chain the response snaptoken"
        )


def retry_after_header_value(retry_after_s: Optional[float]) -> str:
    """Retry-After in whole seconds, rounded up, so that the hint never
    invites a retry that is shed again at once."""
    if not retry_after_s or retry_after_s <= 0:
        return "1"
    return str(max(1, int(math.ceil(retry_after_s))))


# -- client retry -------------------------------------------------------------


class RetryPolicy:
    """Client-side retry of idempotent reads (the gRPC ReadClient takes
    one; the WriteClient never does: a retried transact could apply
    twice).

    Retries the codes this server sheds with, UNAVAILABLE and
    RESOURCE_EXHAUSTED, after a decorrelated-jitter delay (U[base, 3 x
    the previous delay], capped), so clients shed at one instant do not
    come back together. The server's `retry-after` hint (gRPC trailing
    metadata, or a typed error's `retry_after_s`) floors the delay. A
    retry whose delay would outlive the caller's budget gives up and
    re-raises. `stats` counts attempts, retries and give-ups."""

    RETRYABLE_CODES = ("UNAVAILABLE", "RESOURCE_EXHAUSTED")

    def __init__(self, max_attempts: int = 3, base_s: float = 0.05, cap_s: float = 2.0,
                 codes=None, sleep=time.sleep, rng: Optional[random.Random] = None):
        self.max_attempts = max(int(max_attempts), 1)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.codes = tuple(codes) if codes is not None else self.RETRYABLE_CODES
        self._sleep = sleep
        self._rng = rng or random.Random()
        self.stats = {"attempts": 0, "retries": 0, "giveups": 0}

    def _next_delay(self, prev: float) -> float:
        return min(self.cap_s, self._rng.uniform(self.base_s, prev * 3.0))

    def _retryable(self, err) -> bool:
        code = getattr(err, "code", None)
        if not callable(code):
            return False
        try:
            name = code().name
        except Exception:  # noqa: BLE001 - a malformed RpcError is not retried
            return False
        return name in self.codes

    @staticmethod
    def retry_after_hint_s(err) -> Optional[float]:
        """The server's retry hint in seconds, None when the error carries
        none."""
        direct = getattr(err, "retry_after_s", None)
        if isinstance(direct, (int, float)) and direct > 0:
            return float(direct)
        trailing = getattr(err, "trailing_metadata", None)
        if not callable(trailing):
            return None
        try:
            for key, value in trailing() or ():
                if key == "retry-after":
                    parsed = float(value)
                    return parsed if parsed > 0 else None
        except Exception:  # noqa: BLE001 - malformed metadata is no hint
            return None
        return None

    def call(self, fn, budget_s: Optional[float] = None):
        """`fn(remaining_s)` with retries; `budget_s` is the caller's whole
        deadline across attempts (None: no deadline)."""
        start = time.monotonic()
        attempt = 0
        prev_delay = self.base_s
        while True:
            self.stats["attempts"] += 1
            remaining = None if budget_s is None else budget_s - (time.monotonic() - start)
            try:
                return fn(remaining)
            except Exception as e:  # noqa: BLE001 - classified just below
                if not self._retryable(e) or attempt + 1 >= self.max_attempts:
                    raise
                prev_delay = delay = self._next_delay(prev_delay)
                hint = self.retry_after_hint_s(e)
                if hint is not None:
                    delay = max(delay, hint)
                if remaining is not None and delay >= max(remaining, 0.0):
                    self.stats["giveups"] += 1
                    raise
                self.stats["retries"] += 1
                self._sleep(delay)
                attempt += 1


# -- circuit breaker ----------------------------------------------------------


class CircuitBreaker:
    """The device path's breaker: closed -> open -> half-open.

    `record_failure()` counts consecutive device-batch failures (submit or
    resolve raised, the launch watchdog fired); at `threshold` the breaker
    opens and `allow()` answers False, so the batcher fails every check
    group with a typed 503 (shed "breaker_open"). After `cooldown_s` the next `allow()`
    admits one probe group (half-open): its `record_success()` closes the
    breaker, its `record_failure()` opens it for another cooldown. A probe
    that never reports (its riders expired, the engine failed before the
    device) is reclaimed after one cooldown. Thread-safe; `transitions`
    keeps the last 64 states it moved to."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 5, cooldown_s: float = 5.0, clock=time.monotonic):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._open_until = 0.0
        # trip()'s floor: until then, successes of batches launched before
        # the trip do not close the breaker
        self._floor_until = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        self.transitions: collections.deque = collections.deque(maxlen=64)

    def _transition(self, to: str) -> None:
        self._state = to
        self.transitions.append(to)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May this check group take the device path? Takes the half-open
        probe slot when it grants one: call once a group."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = self._clock()
            if self._state == self.OPEN:
                if now < self._open_until:
                    return False
                self._transition(self.HALF_OPEN)
                self._probe_inflight = True
                self._probe_started = now
                return True
            if self._probe_inflight and now - self._probe_started < self.cooldown_s:
                return False
            self._probe_inflight = True
            self._probe_started = now
            return True

    def open_remaining_s(self) -> float:
        """Seconds until an open breaker admits its probe (0.0 when it is
        not open)."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self._open_until - self._clock())

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state == self.CLOSED or self._clock() < self._floor_until:
                return
            self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == self.HALF_OPEN:
                self._open_until = self._clock() + self.cooldown_s
                self._transition(self.OPEN)
                return
            self._failures += 1
            if self._state == self.CLOSED and self._failures >= self.threshold:
                self._open_until = self._clock() + self.cooldown_s
                self._transition(self.OPEN)

    def trip(self, cooldown_s: Optional[float] = None) -> None:
        """Open the breaker now, whatever its count: for a detector that
        found the device path unhealthy out of band. The usual half-open
        probe then decides recovery."""
        with self._lock:
            self._probe_inflight = False
            self._open_until = self._clock() + (
                self.cooldown_s if cooldown_s is None else float(cooldown_s))
            self._floor_until = self._open_until
            if self._state != self.OPEN:
                self._transition(self.OPEN)

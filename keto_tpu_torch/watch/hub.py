"""WatchHub: the change-log tailer and its fan-out to subscribers.

The Zanzibar Watch contract on the port's stores:

  - One hub a process, one tail state a network id. The tailer reads the
    store's versioned change log (`manager.changelog_since`) and
    broadcasts each committed store version as one WatchEvent carrying
    all that version's tuple changes and the version's snaptoken. A
    client that keeps the last event's snaptoken and reconnects with it
    sees every change strictly after it, exactly once, in version order.
  - In-process writers wake the tailer: the hub is the store's write
    listener (`notify(nid)` after each commit) and hands every commit on
    to its commit listeners (the registry's engine and check-cache
    pokes, the closure maintainer's wake). A poll every `poll_interval`
    seconds covers a writer the hub does not hear.
  - Backpressure: a subscription owns a bounded ring of pending events.
    A full ring never drops an event silently: the subscription is
    deactivated and cleared, and its next read delivers a RESET event
    with a fresh snaptoken, live from that version on. A cursor the
    change log no longer reaches gets a RESET at once.
  - `min_active_version(nid)` is the lowest version an open cursor may
    resume from: the trim guard of a store that trims its log (the hub
    registers it where the store has `set_trim_guard`: the SQL store,
    storage/sqlite.py, keeps the rows an open cursor still needs past
    its soft cap).
  - A store that raises StoreUnavailableError while the tailer reads it
    gets one DEGRADED event a subscriber per episode; heartbeats
    (`heartbeat_s`) go on through it.

The hub keeps its counts in `counts`, under the names of the JAX
package's metrics: watch_events_delivered_total, watch_resets_total,
watch_heartbeats_total, store_degraded_serves_total and the gauge
watch_streams_active; `watch_lag_seconds` is the last commit-to-drain
lag.

Locking: a per-nid state lock guards {subs, tail_version}; the tailer
broadcasts and `subscribe` replays under it, which makes the hand-off
from the store replay to the live tail exactly once. A subscription's
buffer has its own condition; the lock order is always state lock, then
subscription lock (`Subscription.get` re-enters the hub only after it
releases its own condition).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from .. import faults as _faults
from ..engine.snaptoken import encode_snaptoken
from ..errors import SnaptokenUnsatisfiableError, StoreUnavailableError
from ..ketoapi import RelationTuple

logger = logging.getLogger("keto_tpu_torch")

DEFAULT_BUFFER_EVENTS = 256
DEFAULT_POLL_INTERVAL = 0.25

KIND_CHANGE = "change"
KIND_RESET = "reset"
# a store outage (the store raises StoreUnavailableError): the tailer cannot
# read the changelog, so subscribers get ONE in-band marker per outage
# episode instead of a silently stalled stream; delivery resumes from
# the same cursors when the store recovers (a trimmed-changelog gap
# during the outage flows through the normal RESET machinery)
KIND_DEGRADED = "degraded"
# stream liveness: with
# `watch.heartbeat_s` set, an idle tail emits an in-band HEARTBEAT
# carrying the CURRENT tail snaptoken, so an out-of-process tail can
# (a) bound dead-upstream detection — silence past the liveness window
# means the connection is gone, not the store idle — and (b) learn the
# store version on a stream that has never delivered a change
KIND_HEARTBEAT = "heartbeat"


class WatchEvent:
    """One committed store version: all its tuple changes, or a RESET.

    `changes` is a sequence of ("insert" | "delete", RelationTuple);
    empty for RESET events. `snaptoken` encodes (nid, version) — the
    resumable cursor a client persists after consuming the event."""

    __slots__ = ("kind", "version", "snaptoken", "changes")

    def __init__(
        self,
        kind: str,
        version: int,
        snaptoken: str,
        changes: Sequence[tuple[str, RelationTuple]] = (),
    ):
        self.kind = kind
        self.version = version
        self.snaptoken = snaptoken
        self.changes = tuple(changes)

    @property
    def is_reset(self) -> bool:
        return self.kind == KIND_RESET

    def filtered(self, namespace: str) -> Optional["WatchEvent"]:
        """The event restricted to one namespace, or None when nothing
        survives the filter (RESET and DEGRADED events always survive —
        they signal a gap / an outage, which a namespace filter must
        never hide)."""
        if self.kind != KIND_CHANGE or not namespace:
            return self
        kept = [
            (op, t) for op, t in self.changes if t.namespace == namespace
        ]
        if not kept:
            return None
        if len(kept) == len(self.changes):
            return self
        return WatchEvent(self.kind, self.version, self.snaptoken, kept)

    def to_dict(self) -> dict:
        return {
            "event_type": self.kind,
            "snaptoken": self.snaptoken,
            "changes": [
                {"action": op, "relation_tuple": t.to_dict()}
                for op, t in self.changes
            ],
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"WatchEvent({self.kind!r}, v{self.version}, "
            f"{len(self.changes)} change(s))"
        )


class Subscription:
    """One watcher's resumable cursor + bounded pending-event ring."""

    def __init__(self, hub: "WatchHub", nid: str, cap: int):
        self._hub = hub
        self.nid = nid
        self.cap = max(int(cap), 1)
        self._cond = threading.Condition()
        self._events: deque[WatchEvent] = deque()
        # subscribe-time replay, consumed before the live ring: already
        # materialized from the store (bounded by the changelog cap), so
        # it is NOT subject to the live ring's backpressure cap — a
        # cursor the changelog still covers must never collapse to a
        # RESET just because the gap exceeds the ring size
        self._backlog: deque[WatchEvent] = deque()
        self._overflowed = False
        self._active = True
        self._closed = False
        # last version this cursor has fully consumed (or resumed at);
        # feeds min_active_version -> the durable changelog trim guard
        self.cursor = 0
        self._notify_fns: list[Callable[[], None]] = []

    # -- producer side (hub, under the nid state lock) ------------------------

    def _push(self, event: WatchEvent) -> int:
        """Enqueue one event; returns the number of tuple changes
        actually enqueued (0 when inactive or overflowing)."""
        fns = ()
        delivered = 0
        with self._cond:
            if self._closed or not self._active:
                return 0
            if len(self._events) >= self.cap:
                # full ring: never drop silently — clear, deactivate,
                # and let the consumer's next read turn this into a
                # RESET event with a fresh snaptoken (which supersedes
                # any unconsumed replay backlog too)
                self._events.clear()
                self._backlog.clear()
                self._overflowed = True
                self._active = False
            else:
                self._events.append(event)
                delivered = len(event.changes)
            fns = tuple(self._notify_fns)
            self._cond.notify_all()
        for fn in fns:
            fn()
        return delivered

    def _push_heartbeat(self, event: WatchEvent) -> None:
        """Enqueue a liveness heartbeat ONLY when the ring has room: a
        backed-up consumer must never be tipped into an overflow RESET
        by a frame that carries no changes (its own backlog already
        proves the stream live)."""
        fns = ()
        with self._cond:
            if self._closed or not self._active:
                return
            if len(self._events) >= self.cap:
                return
            self._events.append(event)
            fns = tuple(self._notify_fns)
            self._cond.notify_all()
        for fn in fns:
            fn()

    def _force_reset(self, event: WatchEvent) -> None:
        """Changelog truncated beneath the tail (bulk load, trim): the
        gap is unrecoverable, so pending events are superseded by an
        in-band RESET; the stream stays live from the event's version."""
        fns = ()
        with self._cond:
            if self._closed:
                return
            self._events.clear()
            self._backlog.clear()
            self._overflowed = False
            self._active = True
            self._events.append(event)
            self.cursor = event.version
            fns = tuple(self._notify_fns)
            self._cond.notify_all()
        for fn in fns:
            fn()

    # -- consumer side ---------------------------------------------------------

    def add_notify(self, fn: Callable[[], None]) -> None:
        """Register a producer-side wakeup hook (called after events are
        enqueued, outside all locks). The asyncio plane uses this to set
        a loop event via call_soon_threadsafe — no thread parks per
        stream."""
        with self._cond:
            self._notify_fns.append(fn)

    def pop_nowait(self) -> tuple[Optional[WatchEvent], bool]:
        """(event, needs_resume) without blocking or re-entering the
        hub. needs_resume=True means the ring overflowed: the caller
        must invoke hub.resume(sub) — which takes the nid state lock
        and may query the store — to obtain the RESET event. The
        asyncio plane runs that resume on an executor so the store
        query never blocks the event loop."""
        with self._cond:
            if self._overflowed:
                self._overflowed = False
                return None, True
            if self._backlog:
                event = self._backlog.popleft()
                self.cursor = event.version
                return event, False
            if self._events:
                event = self._events.popleft()
                self.cursor = event.version
                return event, False
            return None, False

    def get_nowait(self) -> Optional[WatchEvent]:
        """Next pending event without blocking; None when the buffer is
        empty. Converts a pending overflow into its RESET event (which
        re-enters the hub — see pop_nowait for the non-blocking split)."""
        event, needs_resume = self.pop_nowait()
        if needs_resume:
            return self._hub._resume(self)
        return event

    def get(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        """Next event in version order; blocks up to `timeout` seconds
        (None = forever). Returns None on timeout or once closed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            resume = False
            with self._cond:
                if self._closed:
                    return None
                if self._overflowed:
                    self._overflowed = False
                    resume = True
                elif self._backlog:
                    event = self._backlog.popleft()
                    self.cursor = event.version
                    return event
                elif self._events:
                    event = self._events.popleft()
                    self.cursor = event.version
                    return event
                else:
                    if deadline is None:
                        self._cond.wait()
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return None
                        self._cond.wait(remaining)
                    continue
            if resume:
                # outside self._cond: _resume takes the nid state lock
                # (lock order: state -> subscription, never the reverse)
                return self._hub._resume(self)

    def close(self) -> None:
        self._hub._unsubscribe(self)
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed


class _NidState:
    """Tail bookkeeping for one network id."""

    __slots__ = (
        "lock", "cond", "subs", "tail_version", "dirty", "pending_since",
        "thread", "degraded", "last_emit",
    )

    def __init__(self, tail_version: int):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.subs: list[Subscription] = []
        self.tail_version = tail_version
        self.dirty = False
        self.pending_since: Optional[float] = None
        self.thread: Optional[threading.Thread] = None
        # True while the tailer is riding out a store outage (one
        # DEGRADED marker per episode, flipped back on the first
        # successful drain)
        self.degraded = False
        # monotonic time of the last broadcast (change or heartbeat):
        # the idle clock the heartbeat schedule runs against
        self.last_emit = time.monotonic()


class WatchHub:
    """Per-process changelog fan-out (see module docstring)."""

    def __init__(
        self,
        manager,
        poll_interval: float = DEFAULT_POLL_INTERVAL,
        buffer: int = DEFAULT_BUFFER_EVENTS,
        heartbeat_s: Optional[float] = None,
    ):
        self.manager = manager
        self.poll_interval = max(float(poll_interval), 0.01)
        self.buffer = max(int(buffer), 1)
        self._counts_mu = threading.Lock()
        self.counts = {
            "watch_events_delivered_total": 0,
            "watch_resets_total": 0,
            "watch_heartbeats_total": 0,
            "store_degraded_serves_total": 0,
            "watch_streams_active": 0,
        }
        self.watch_lag_seconds = 0.0
        # None = no in-band heartbeats (the pre-HA behavior); a period
        # makes every idle tail emit KIND_HEARTBEAT on that schedule
        self.heartbeat_s = (
            max(float(heartbeat_s), 0.05) if heartbeat_s else None
        )
        self._states: dict[str, _NidState] = {}
        self._states_lock = threading.Lock()
        self._commit_listeners: list[Callable[[str], None]] = []
        self._stopped = False
        # wire the write hook when the store supports it (all in-repo
        # managers do; a foreign Manager degrades to polling-only)
        add = getattr(manager, "add_write_listener", None)
        if add is not None:
            add(self.notify)
        guard = getattr(manager, "set_trim_guard", None)
        if guard is not None:
            guard(self.min_active_version)

    # -- write-side hooks ------------------------------------------------------

    def notify(self, nid: str) -> None:
        """Post-commit write hook: wake the nid's tailer (if any) and the
        commit listeners (engine push-invalidation). Called on the writer
        thread — everything here is a flag flip + condition notify."""
        state = self._states.get(nid)
        if state is not None:
            with state.lock:
                state.dirty = True
                if state.pending_since is None:
                    state.pending_since = time.monotonic()
                state.cond.notify_all()
        for fn in tuple(self._commit_listeners):
            fn(nid)

    def add_commit_listener(self, fn: Callable[[str], None]) -> None:
        """`fn(nid)` runs on every committed write (on the writer thread;
        must be cheap — the engine hook just sets an event)."""
        self._commit_listeners.append(fn)

    # -- subscription lifecycle ------------------------------------------------

    def subscribe(
        self,
        nid: str,
        min_version: Optional[int] = None,
        buffer: Optional[int] = None,
    ) -> Subscription:
        """Open a resumable cursor.

        `min_version` is the parsed snaptoken (engine/snaptoken.py):
        every change strictly after it replays from the store changelog,
        then the stream goes live — exactly once, in version order,
        because both the replay and the live registration happen under
        the nid state lock the tailer broadcasts under. None starts a
        live tail at the current version. A version ahead of the store
        raises SnaptokenUnsatisfiableError (409, like every other
        token-enforcing surface); a version the bounded changelog can no
        longer reach yields an immediate RESET instead of a silent gap.
        """
        if self._stopped:
            raise RuntimeError("watch hub is stopped")
        current = self.manager.version(nid=nid)
        if min_version is not None and min_version > current:
            raise SnaptokenUnsatisfiableError(
                debug=f"store at v{current}, watch cursor demands v{min_version}"
            )
        state = self._state(nid)
        sub = Subscription(self, nid, buffer or self.buffer)
        with state.lock:
            # bring the tail to the present BEFORE replaying, so the
            # replay below covers everything the broadcasts won't
            self._drain_locked(state, nid)
            sub.cursor = state.tail_version
            if min_version is not None and min_version < state.tail_version:
                ops = self._changelog(min_version, nid)
                if ops is None:
                    sub._force_reset(self._reset_event(nid, state.tail_version))
                    self._count_reset()
                else:
                    # replay ONLY up to the tail: a write committing
                    # between the drain above and this store read would
                    # otherwise be replayed here AND broadcast by the
                    # tailer later — a duplicate delivery. The replay
                    # goes to the sub's backlog, not the live ring: a
                    # gap the changelog covers is always deliverable,
                    # however far behind the cursor is.
                    ops = [t for t in ops if t[0] <= state.tail_version]
                    events = self._group(nid, ops)
                    sub._backlog.extend(events)
                    self._count_delivered(
                        sum(len(e.changes) for e in events)
                    )
            state.subs.append(sub)
            if state.thread is None:
                state.thread = threading.Thread(
                    target=self._tail_loop,
                    args=(state, nid),
                    name=f"keto-watch-{nid}",
                    daemon=True,
                )
                state.thread.start()
        self._count("watch_streams_active", 1)
        return sub

    def _unsubscribe(self, sub: Subscription) -> None:
        state = self._states.get(sub.nid)
        if state is None:
            return
        removed = False
        with state.lock:
            if sub in state.subs:
                state.subs.remove(sub)
                removed = True
            state.cond.notify_all()  # let an idle tailer exit
        if removed:
            self._count("watch_streams_active", -1)

    def min_active_version(self, nid: str) -> Optional[int]:
        """The lowest store version an active cursor may still resume
        from — the durable changelog's trim guard: rows with version >
        this value stay reachable (up to the store's hard cap), so a
        watcher that disconnects and presents its last snaptoken finds
        its history intact. None = no active cursors, trim freely.

        LOCK-FREE by design: the store calls this from INSIDE its write
        lock (where it logs its changes), while the tailer calls
        into the store while holding the state lock — taking the state
        lock here would be an ABBA deadlock. A retention policy tolerates
        a slightly stale snapshot (the hard cap bounds the error)."""
        state = self._states.get(nid)
        if state is None:
            return None
        subs = [s for s in list(state.subs) if not s.closed]
        if not subs:
            return None
        return min([state.tail_version] + [s.cursor for s in subs])

    def stop(self) -> None:
        """Daemon shutdown: close every subscription, stop tailers, and
        JOIN them — "stopped" means quiesced, so a caller may close the
        underlying store the moment this returns (the crash-recovery
        restart tests do exactly that) without a parting tailer drain
        racing the closed connection."""
        self._stopped = True
        with self._states_lock:
            states = list(self._states.items())
        threads = []
        for _nid, state in states:
            with state.lock:
                subs = list(state.subs)
                if state.thread is not None:
                    threads.append(state.thread)
                state.cond.notify_all()
            for sub in subs:
                sub.close()
        for thread in threads:
            thread.join(timeout=5)
            if thread.is_alive():
                # the quiesced-on-return contract could not be met (a
                # tailer wedged >5s inside a store read): SAY so — the
                # caller about to close the store can decide, instead of
                # rediscovering this as a use-after-close race
                logger.warning(
                    "watch hub stop: tailer %s still running after join "
                    "timeout; store teardown may race it", thread.name,
                )

    # -- internals -------------------------------------------------------------

    def _state(self, nid: str) -> _NidState:
        with self._states_lock:
            state = self._states.get(nid)
            if state is not None:
                return state
        # store query OUTSIDE the states lock: manager.version takes the
        # store lock, and holding ours across it would order
        # _states_lock -> store lock on a path a store-side hook could
        # one day invert. A write landing between the read and the
        # insert only leaves tail_version slightly behind; the first
        # _drain_locked catches the tail up before any subscriber
        # registers.
        version = self.manager.version(nid=nid)
        with self._states_lock:
            return self._states.setdefault(nid, _NidState(version))

    def _changelog(self, version: int, nid: str):
        fn = getattr(self.manager, "changelog_since", None)
        if fn is None:
            return None  # no versioned log: every gap is a RESET
        return fn(version, nid=nid)

    def _reset_event(self, nid: str, version: int) -> WatchEvent:
        return WatchEvent(
            KIND_RESET, version, encode_snaptoken(version, nid)
        )

    def _group(self, nid: str, ops) -> list[WatchEvent]:
        """Versioned (version, op, tuple) triples -> one WatchEvent per
        committed version, in version order. Ops are accumulated in
        lists and each event built once — a delete-all can commit tens
        of thousands of ops under ONE version, and this runs under the
        nid state lock."""
        events: list[WatchEvent] = []
        current_version: Optional[int] = None
        current_changes: list = []
        for version, op, t in ops:
            if version != current_version:
                if current_changes:
                    events.append(
                        WatchEvent(
                            KIND_CHANGE, current_version,
                            encode_snaptoken(current_version, nid),
                            current_changes,
                        )
                    )
                current_version = version
                current_changes = []
            current_changes.append((op, t))
        if current_changes:
            events.append(
                WatchEvent(
                    KIND_CHANGE, current_version,
                    encode_snaptoken(current_version, nid), current_changes,
                )
            )
        return events

    def _drain_locked(self, state: _NidState, nid: str) -> None:
        """Advance the tail to the store's current version, broadcasting
        every committed version since. Caller holds state.lock."""
        # the store read and the broadcast are one step under the nid
        # state lock: that makes subscribe()'s replay -> live-tail
        # hand-off exactly once; the store never takes the state lock
        # (min_active_version is lock-free)
        current = self.manager.version(nid=nid)
        state.dirty = False
        pending_since, state.pending_since = state.pending_since, None
        if current == state.tail_version:
            return
        ops = self._changelog(state.tail_version, nid)
        if ops is None:
            # the bounded changelog no longer reaches the tail (trim
            # beyond the guard's hard cap, or a bulk load that reset the
            # log): the gap is explicit, never silent
            state.tail_version = current
            event = self._reset_event(nid, current)
            for sub in state.subs:
                sub._force_reset(event)
                self._count_reset()
        else:
            # fault point (faults.py): the changelog is read, nothing is
            # fanned out yet; the tail position is derived, never kept,
            # so a resumed cursor gets these events from the store
            _faults.inject("watch_broadcast")
            delivered = 0
            broadcast = False
            for event in self._group(nid, ops):
                for sub in state.subs:
                    delivered += sub._push(event)
                broadcast = True
                if event.version > state.tail_version:
                    state.tail_version = event.version
            if broadcast:
                state.last_emit = time.monotonic()
            self._count_delivered(delivered)
            if state.tail_version < current:
                state.tail_version = current
        if pending_since is not None:
            self.watch_lag_seconds = time.monotonic() - pending_since

    def _resume(self, sub: Subscription) -> WatchEvent:
        """Reactivate an overflowed subscription at the current tail and
        hand back the RESET event that signals the gap."""
        state = self._state(sub.nid)
        with state.lock:
            self._drain_locked(state, sub.nid)
            event = self._reset_event(sub.nid, state.tail_version)
            with sub._cond:
                sub._active = True
                sub._overflowed = False
                sub.cursor = state.tail_version
        self._count_reset()
        return event

    def _tail_loop(self, state: _NidState, nid: str) -> None:
        park = self.poll_interval
        if self.heartbeat_s is not None:
            # the park must wake often enough to keep the heartbeat
            # schedule honest even when nothing ever commits
            park = min(park, self.heartbeat_s / 2)
        while not self._stopped:
            with state.lock:
                if not state.subs:
                    state.thread = None
                    return
                if not state.dirty:
                    state.cond.wait(park)
                # re-check AFTER the park: stop() may have flipped the
                # flag while this thread waited — one more drain here
                # would race whatever the stopper tears down next (e.g.
                # the store connection on a restart-test shutdown)
                if self._stopped:
                    state.thread = None
                    return
                try:
                    self._drain_locked(state, nid)
                    state.degraded = False  # resumed delivery IS the recovery signal
                    if (
                        self.heartbeat_s is not None
                        and time.monotonic() - state.last_emit
                        >= self.heartbeat_s
                    ):
                        # idle past the period: an in-band liveness
                        # frame at the CURRENT tail — never pushed into
                        # a full ring (see _push_heartbeat), never
                        # advances cursors (consumers treat it as a
                        # version announcement, not a change)
                        event = WatchEvent(
                            KIND_HEARTBEAT, state.tail_version,
                            encode_snaptoken(state.tail_version, nid),
                        )
                        for sub in state.subs:
                            sub._push_heartbeat(event)
                        state.last_emit = time.monotonic()
                        self._count_heartbeat()
                except StoreUnavailableError:
                    # store outage: never let the tailer thread die (a
                    # dead tailer is a silently stalled stream) — push
                    # ONE in-band DEGRADED marker per episode and keep
                    # polling; the poll loop's next version read doubles
                    # as the breaker's half-open probe, so recovery
                    # closes the breaker within one poll interval
                    if not state.degraded:
                        state.degraded = True
                        event = WatchEvent(
                            KIND_DEGRADED, state.tail_version,
                            encode_snaptoken(state.tail_version, nid),
                        )
                        for sub in state.subs:
                            sub._push(event)
                        self._count_degraded()
                    elif (
                        self.heartbeat_s is not None
                        and time.monotonic() - state.last_emit
                        >= self.heartbeat_s
                    ):
                        # keep heartbeating THROUGH the outage (no store
                        # read needed): an out-of-process tail must be
                        # able to tell a degraded-but-alive upstream
                        # from a dead connection
                        event = WatchEvent(
                            KIND_HEARTBEAT, state.tail_version,
                            encode_snaptoken(state.tail_version, nid),
                        )
                        for sub in state.subs:
                            sub._push_heartbeat(event)
                        state.last_emit = time.monotonic()
                        self._count_heartbeat()

    # -- counts ----------------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        with self._counts_mu:
            self.counts[name] += n

    def _count_delivered(self, n: int) -> None:
        if n:
            self._count("watch_events_delivered_total", n)

    def _count_reset(self) -> None:
        self._count("watch_resets_total")

    def _count_heartbeat(self) -> None:
        self._count("watch_heartbeats_total")

    def _count_degraded(self) -> None:
        self._count("store_degraded_serves_total")

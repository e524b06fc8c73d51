"""The micro-batching front of Check.

The engine evaluates a batch of checks in one device launch sequence, so
concurrent request threads are coalesced into device batches: each caller
enqueues (tuple, depth) and blocks on a future; one collector thread
drains the queue, waiting at most `window_s` after the first arrival for
more, groups the batch by (depth, network) (a launch takes one depth),
and hands each group to the launch thread. The launch thread submits it
(`engine.check_batch_submit`) and a pool of `pipeline_depth` threads
resolves it (`check_batch_resolve_v`), so the next group's submit does
not wait for the last one's resolve; a semaphore bounds the batches
launched but not resolved (`resolve_max_inflight`).

Identical concurrent checks collapse onto one batch slot (singleflight)
and the slot's answer fans out to every rider, so a hot key costs one
slot a batch however many clients send it.

Overload and failure, as the JAX package's batcher, except that a
failing device is never answered from the host:
  - admission is bounded at `max_queue` admitted-but-unresolved checks,
    atomically at enqueue (a typed 429 with a Retry-After hint);
  - a rider whose deadline expires fails with the typed 504 at every
    boundary (the caller's wait, the launch, the in-flight semaphore) and
    never takes a batch slot;
  - with `device_timeout_ms`, a launch watchdog fails a stalled batch's
    riders with the typed 500 and releases its in-flight slot, and a
    routing watchdog does the same for a group stuck behind a wedged
    launch thread (`_LaunchGuard` lets one of watchdog and resolver
    finish a launch);
  - a failed submit or resolve fails its riders with the typed 500 and
    counts a failure on the breaker; while the breaker is open every
    group fails at once with a typed 503 and a Retry-After of the
    breaker's remaining cooldown, and the device is left alone;
  - an untyped engine error reaches the riders as CheckBatchFailedError.

The JAX package answers those riders from its exact host oracle instead.
Here the tables live on the card, and a host answer would turn a broken
kernel into a server that still answers 200: every such batch fails,
typed, and is counted in `stats` (resilience.COUNTERS).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass, field

from ..errors import (
    BatcherClosedError,
    CheckBatchFailedError,
    DeadlineExceededError,
    KetoError,
    OverloadedError,
    StoreUnavailableError,
)
from ..resilience import ServeCounters


def resolve_max_inflight(max_inflight, pipeline_depth: int) -> int:
    """serve.check.max_inflight, or twice the pipeline depth (at least 4)."""
    return int(max_inflight) if max_inflight else max(2 * pipeline_depth, 4)


def coalesce_pending(group, key_fn, counters):
    """Singleflight: identical pending checks of one (depth, network)
    group collapse onto one slot. Returns the slots (lists of pendings,
    leader first) in arrival order and counts the riders that joined one."""
    slots: dict = {}
    for p in group:
        slots.setdefault(key_fn(p), []).append(p)
    out = list(slots.values())
    coalesced = len(group) - len(out)
    if coalesced and counters is not None:
        counters.inc("coalesced", n=coalesced)
    return out


def classify_engine_error(e: Exception, counters, cause: str) -> KetoError:
    """A failed engine batch reaches its riders as a KetoError: a typed
    error passes through (counted under "keto"), anything else becomes a
    CheckBatchFailedError (counted under `cause`)."""
    if isinstance(e, KetoError):
        cause = "keto"
        err = e
    else:
        err = CheckBatchFailedError(f"check batch failed: {type(e).__name__}: {e}")
    if counters is not None:
        counters.inc("check_batch_failed", cause)
    return err


def device_failure(breaker, counters, e: Exception | None, cause: str,
                   device_timeout_s: float | None) -> KetoError:
    """A failed or stalled device batch: a failure on the breaker, the count
    under `cause` ("device" or "device_timeout"), and the typed error its
    riders fail with (a typed engine error passes through, counted "keto").
    `e` None: the launch watchdog abandoned the batch."""
    if breaker is not None:
        breaker.record_failure()
    if isinstance(e, KetoError):
        counters.inc("check_batch_failed", "keto")
        return e
    counters.inc("check_batch_failed", cause)
    return CheckBatchFailedError(
        f"check batch failed on the device: {type(e).__name__}: {e}" if e is not None
        else f"check batch unresolved after {device_timeout_s * 1e3:g} ms on the device")


def breaker_open_error(breaker) -> StoreUnavailableError:
    """What a check fails with while the breaker is open: a typed 503 whose
    Retry-After is the breaker's remaining cooldown."""
    return StoreUnavailableError(
        "check device circuit breaker is open",
        retry_after_s=max(breaker.open_remaining_s(), 0.05), breaker_open=True)


class _LaunchGuard:
    """Exactly one of the resolver and the launch watchdog finishes a
    launch: the winner releases the in-flight slot and answers the
    riders, the loser does nothing."""

    __slots__ = ("_lock", "_done")

    def __init__(self):
        self._lock = threading.Lock()
        self._done = False

    def claim(self) -> bool:
        with self._lock:
            if self._done:
                return False
            self._done = True
            return True

    def peek(self) -> bool:
        with self._lock:
            return self._done


@dataclass
class _Pending:
    tuple: object
    max_depth: int
    nid: object = None  # None: the registry's default network
    rt: object = None  # resilience.RequestTrace | None
    future: Future = field(default_factory=Future)
    # the caller already counted this rider's expiry ("wait"): the
    # collector's later drop must not count it again
    dl_counted: bool = False


class CheckBatcher:
    def __init__(
        self,
        engine,
        max_batch: int = 1024,
        window_s: float = 0.002,
        pipeline_depth: int = 2,
        engine_resolver=None,
        max_inflight: int | None = None,
        max_queue: int | None = None,
        device_timeout_ms: float | None = None,
        breaker=None,
        counters: ServeCounters | None = None,
    ):
        # batches group by network id and go to that network's engine;
        # the default resolver pins everything to `engine`
        self.engine = engine
        self._resolve = engine_resolver or (lambda nid: engine)
        self.max_batch = max_batch
        self.window_s = window_s
        self.counters = counters if counters is not None else ServeCounters()
        self._queue: queue.Queue[_Pending | None] = queue.Queue()
        self._thread = threading.Thread(target=self._run, name="keto-torch-check-batcher",
                                        daemon=True)
        # resolve pool: while one batch resolves, the collector and the
        # launch thread go on with the next
        self._pool = ThreadPoolExecutor(max_workers=max(pipeline_depth, 1),
                                        thread_name_prefix="keto-torch-check-resolve")
        # launch thread: submits run here, not on the collector, so that a
        # mirror refresh inside a submit does not stop the queue draining
        self._launcher = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="keto-torch-check-launch")
        self.max_inflight = resolve_max_inflight(max_inflight, pipeline_depth)
        self._inflight = threading.BoundedSemaphore(self.max_inflight)
        # admitted-but-unresolved checks (queued, grouped, in flight);
        # 0: unbounded
        self.max_queue = int(max_queue) if max_queue else 0
        self._pending = 0
        self._pending_mu = threading.Lock()
        self.device_timeout_s = float(device_timeout_ms) / 1e3 if device_timeout_ms else None
        self.breaker = breaker
        # True while a launch runs (an unlocked flag): the collector arms
        # the routing watchdog only then, so the healthy path starts no
        # timer thread
        self._launcher_busy = False
        self._closed = False
        self._thread.start()

    @property
    def stats(self) -> dict:
        """The counts of resilience.COUNTERS this batcher (and, in a daemon,
        the admission gate) added to."""
        return self.counters.snapshot()

    # -- caller side ----------------------------------------------------------

    def _queue_delay_estimate_s(self, pending: int) -> float:
        """A shed request's Retry-After hint: how long the admitted work
        plausibly takes to drain (batches of max_batch, a window each)."""
        batches = pending // max(self.max_batch, 1) + 1
        return max(batches * max(self.window_s, 0.001), 0.05)

    def admit(self, deadline=None) -> None:
        """The advisory admission check a transport runs before any check
        work: a typed 429 at max_queue, a typed 504 for an expired budget.
        No slot is reserved; submit enforces the bound again, atomically."""
        if self._closed:
            raise OverloadedError("check batcher is closed", retry_after_s=1.0)
        if self.max_queue:
            with self._pending_mu:
                pending = self._pending
            if pending >= self.max_queue:
                self.counters.inc("shed", "queue_full")
                raise OverloadedError("check queue is full",
                                      retry_after_s=self._queue_delay_estimate_s(pending))
        if deadline is not None and deadline.expired():
            self.counters.inc("deadline_exceeded", "admission")
            raise DeadlineExceededError("request deadline expired before admission")

    def _dec_pending(self, _f=None) -> None:
        with self._pending_mu:
            self._pending -= 1

    def idle(self) -> bool:
        """Nothing admitted is unresolved (the daemon's drain polls this)."""
        with self._pending_mu:
            return self._pending == 0

    def check(self, tuple, max_depth: int = 0, nid=None, rt=None):
        """One check, blocking; the CheckResult. `rt.deadline` (if any)
        bounds the wait."""
        return self.check_versioned(tuple, max_depth, nid=nid, rt=rt)[0]

    def check_versioned(self, tuple, max_depth: int = 0, nid=None, rt=None):
        """(CheckResult, version | None): the store version the answer is
        authoritative at (check_batch_resolve_v's), None where the
        evaluation cannot pin one (an item the engine replayed on its
        host reference, or an engine without versions)."""
        return self.wait_pending(self.submit(tuple, max_depth, nid, rt), rt)

    def submit(self, tuple, max_depth: int = 0, nid=None, rt=None) -> _Pending:
        """Enqueue one check without waiting; its `future` resolves to
        (CheckResult, version)."""
        if self._closed:
            raise BatcherClosedError(retry_after_s=1.0)
        # check and increment under one lock: concurrent callers never
        # push the count past max_queue
        shed_pending = None
        with self._pending_mu:
            if self.max_queue and self._pending >= self.max_queue:
                shed_pending = self._pending
            else:
                self._pending += 1
        if shed_pending is not None:
            self.counters.inc("shed", "queue_full")
            raise OverloadedError("check queue is full",
                                  retry_after_s=self._queue_delay_estimate_s(shed_pending))
        p = _Pending(tuple, max_depth, nid, rt)
        p.future.add_done_callback(self._dec_pending)
        self._queue.put(p)
        return p

    def wait_pending(self, p: _Pending, rt=None):
        """Wait for one submitted pending, bounded by `rt.deadline`."""
        deadline = rt.deadline if rt is not None else None
        if deadline is None:
            return p.future.result()
        try:
            return p.future.result(timeout=max(deadline.remaining_s(), 1e-4))
        except FutureTimeoutError:
            # the pending stays queued; the collector drops it at its
            # launch boundary, without a batch slot
            p.dl_counted = True
            self.counters.inc("deadline_exceeded", "wait")
            raise DeadlineExceededError("request deadline expired waiting for the check batch")

    def close(self) -> None:
        """Stop the collector and its pools; a check that raced the close
        fails with BatcherClosedError instead of waiting forever."""
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=5)
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p is not None and not p.future.done():
                p.future.set_exception(BatcherClosedError(retry_after_s=1.0))

    # -- collector ------------------------------------------------------------

    def _drain(self, first: _Pending) -> list[_Pending]:
        batch = [first]
        end = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            timeout = end - time.monotonic()
            try:
                if timeout <= 0:
                    # the window is over: take what is queued, no waiting
                    item = self._queue.get_nowait()
                else:
                    item = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # the main loop sees the shutdown too
                break
            batch.append(item)
        return batch

    @staticmethod
    def _fail_slots(slots: list[list[_Pending]], err: Exception) -> None:
        for slot in slots:
            for p in slot:
                if not p.future.done():
                    p.future.set_exception(err)

    def _expire(self, group: list[_Pending]) -> list[_Pending]:
        """The riders still live: an expired one fails with the typed 504
        without taking a batch slot, and one already answered (or
        cancelled) drops out."""
        live: list[_Pending] = []
        for p in group:
            if p.future.done():
                continue
            dl = p.rt.deadline if p.rt is not None else None
            if dl is not None and dl.expired():
                if not p.dl_counted:
                    self.counters.inc("deadline_exceeded", "queue")
                if not p.future.done():
                    p.future.set_exception(
                        DeadlineExceededError("request deadline expired in the check queue"))
            else:
                live.append(p)
        return live

    def _count_batch(self, slots) -> None:
        self.counters.inc("batches")
        self.counters.inc("batched_checks", n=len(slots))

    def _evaluate(self, slots: list[list[_Pending]], depth: int, nid=None) -> None:
        """An engine without the split submit/resolve: one check_batch."""
        try:
            engine = self._resolve(nid)
            self._count_batch(slots)
            results = engine.check_batch([s[0].tuple for s in slots], depth)
        except Exception as e:  # noqa: BLE001 - every rider gets a typed error
            self._fail_slots(slots, classify_engine_error(e, self.counters, "engine"))
            return
        for slot, res in zip(slots, results):
            for p in slot:
                if not p.future.done():
                    p.future.set_result((res, None))

    def _device_failed(self, slots: list[list[_Pending]], e: Exception | None,
                       cause: str) -> None:
        """A failed or stalled device batch: a failure on the breaker, the
        count under `cause` ("device" or "device_timeout"), and every rider
        failed with a typed error (a typed engine error passes through)."""
        self._fail_slots(slots, device_failure(self.breaker, self.counters, e, cause,
                                               self.device_timeout_s))

    def _breaker_open(self, group: list[_Pending]) -> None:
        """The breaker-open route, on the collector: the group's live
        riders fail with a typed 503 whose Retry-After is the breaker's
        remaining cooldown; no launch, no host answer."""
        group = self._expire(group)
        if not group:
            return
        self.counters.inc("shed", "breaker_open", n=len(group))
        self._fail_slots([group], breaker_open_error(self.breaker))

    def _device_timed_out(self, guard, slots) -> None:
        """The launch watchdog: a batch unresolved after device_timeout_ms
        is abandoned, its in-flight slot released, a failure recorded, and
        its riders failed; the guard turns the stalled resolve, should it
        return, into a no-op."""
        if not guard.claim():
            return
        self._inflight.release()
        self._device_failed(slots, None, "device_timeout")

    def _resolve_inflight(self, engine, handle, slots: list[list[_Pending]], guard=None,
                          watchdog=None) -> None:
        if guard is not None and guard.peek():
            return  # the watchdog already failed these riders
        try:
            resolve_v = getattr(engine, "check_batch_resolve_v", None)
            if resolve_v is not None:
                results, versions = resolve_v(handle)
            else:
                results = engine.check_batch_resolve(handle)
                versions = [None] * len(results)
        except Exception as e:  # noqa: BLE001 - every rider gets a typed error
            if guard is None or guard.claim():
                if watchdog is not None:
                    watchdog.cancel()
                self._inflight.release()
                self._device_failed(slots, e, "device")
            return
        if guard is not None and not guard.claim():
            return  # the watchdog won the race mid-resolve
        if watchdog is not None:
            watchdog.cancel()
        self._inflight.release()
        if self.breaker is not None:
            self.breaker.record_success()
        for slot, res, ver in zip(slots, results, versions):
            # singleflight fan-out: every rider of a slot gets its answer
            for p in slot:
                if not p.future.done():
                    p.future.set_result((res, ver))

    def _stuck_in_launcher(self, route_guard, group: list[_Pending], depth: int, nid) -> None:
        """The routing watchdog: a group still waiting for the launch
        thread after device_timeout_ms (an earlier submit wedged it) fails
        from the timer thread with the typed 500. No breaker failure: a
        long wait is backpressure, not a verdict on the device."""
        if not route_guard.claim():
            return
        group = self._expire(group)
        if not group:
            return
        self.counters.inc("check_batch_failed", "device_timeout")
        self._fail_slots([group], CheckBatchFailedError(
            f"check waited {self.device_timeout_s * 1e3:g} ms for a wedged device launch"))

    def _launch(self, group: list[_Pending], depth: int, nid=None, route_guard=None,
                route_wd=None) -> None:
        """On the launch thread: submit one group and hand its resolve to
        the pool. The in-flight semaphore bounds the launched but
        unresolved batches."""
        if route_guard is not None:
            if not route_guard.claim():
                return  # the routing watchdog already failed this group
            if route_wd is not None:
                route_wd.cancel()
        self._launcher_busy = True
        try:
            self._launch_inner(group, depth, nid)
        finally:
            self._launcher_busy = False

    def _launch_inner(self, group: list[_Pending], depth: int, nid) -> None:
        group = self._expire(group)
        if not group:
            return
        slots = coalesce_pending(group, lambda p: p.tuple, self.counters)
        try:
            engine = self._resolve(nid)
        except Exception as e:  # noqa: BLE001 - every rider gets a typed error
            self._fail_slots(slots, classify_engine_error(e, self.counters, "engine"))
            return
        submit = getattr(engine, "check_batch_submit", None)
        if submit is None:
            self._pool.submit(self._evaluate, slots, depth, nid)
            return
        self._inflight.acquire()
        # the semaphore wait can outlast every rider's budget: a fully
        # expired group gives its slot back without launching
        live = self._expire([p for slot in slots for p in slot])
        if not live:
            self._inflight.release()
            return
        if len(live) != sum(len(s) for s in slots):
            slots = coalesce_pending(live, lambda p: p.tuple, None)
        # armed before the submit, so that a stalled submit is bounded too
        guard = _LaunchGuard()
        watchdog = None
        if self.device_timeout_s:
            watchdog = threading.Timer(self.device_timeout_s, self._device_timed_out,
                                       args=(guard, slots))
            watchdog.daemon = True
            watchdog.start()
        try:
            self._count_batch(slots)
            handle = submit([s[0].tuple for s in slots], depth)
        except Exception as e:  # noqa: BLE001 - every rider gets a typed error
            if guard.claim():
                if watchdog is not None:
                    watchdog.cancel()
                self._inflight.release()
                self._device_failed(slots, e, "device")
            return
        self._pool.submit(self._resolve_inflight, engine, handle, slots, guard, watchdog)

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._launcher.shutdown(wait=True)
                self._pool.shutdown(wait=True)
                return
            batch = self._drain(item)
            by_key: dict[tuple, list[_Pending]] = {}
            for p in batch:
                by_key.setdefault((p.max_depth, p.nid), []).append(p)
            for (depth, nid), group in by_key.items():
                # breaker routing on the collector: while it is open, groups
                # fail here, never queued behind a launch thread that a
                # stalled device may hold
                if self.breaker is not None and not self.breaker.allow():
                    self._breaker_open(group)
                    continue
                # the routing watchdog bounds the wait for the launch
                # thread, armed only while a launch runs
                route_guard = route_wd = None
                if self.device_timeout_s and self._launcher_busy:
                    route_guard = _LaunchGuard()
                    route_wd = threading.Timer(self.device_timeout_s, self._stuck_in_launcher,
                                               args=(route_guard, group, depth, nid))
                    route_wd.daemon = True
                    route_wd.start()
                self._launcher.submit(self._launch, group, depth, nid, route_guard, route_wd)

"""The asyncio read plane: the direct read gRPC listener with every RPC a
coroutine on one event-loop thread (`serve.read.grpc.aio`).

The threaded plane hands each single check across threads: a gRPC worker
enqueues it, the collector batches it, the launch thread submits it, a
pool thread resolves it and a future wakes the worker again, each step a
wake-up and a GIL handoff. Here grpc.aio parses every request, assembles
the batches and fans the answers out on one loop thread; only the device
work (check_batch_submit and check_batch_resolve_v, which block on
launches and readbacks) runs on a small executor, bounded by the
threaded batcher's in-flight rule. The daemon's muxed port stays on the
threaded plane.

  - AioCheckBatcher: api/batcher.py's CheckBatcher contract on the loop:
    admission against the exact pending count (a typed 429 whose
    Retry-After is the queue-delay estimate), the typed 504 at admission,
    in the wait, in the queue and after the in-flight semaphore,
    singleflight, bounded launches, the launch watchdog
    (serve.check.device_timeout_ms) and the breaker the registry shares
    with the threaded batcher. Its events count into the registry's
    ServeCounters under the threaded batcher's names. A failed or
    abandoned device batch fails its riders with the typed 500, and while
    the breaker is open every group fails with the typed 503: never a
    host answer (api/batcher.py says why).
  - _AioReadServices: Check rides the batcher behind the check cache;
    BatchCheck, Expand, both lists, Filter and ListRelationTuples run
    grpc_server._Services' bodies on a blocking executor; Version and
    Health answer in-loop; a Health Watch parks on a pool of
    serve.read.grpc.max_watchers threads. The tuple Watch is loop-native:
    its subscription's producer wakes the stream through
    call_soon_threadsafe, no thread parks a stream, and only the
    subscribe and an overflow's resume (which read the store) run on the
    blocking executor; the cursor, RESET and heartbeat contract and the
    watcher slots are the threaded plane's. The request's RequestTrace
    (its deadline) travels in resilience's contextvar.
  - AioReadServer: the listener on its own loop thread; with credentials
    (the daemon passes serve.read.tls's) it serves TLS only.

As on the threaded plane, explain answers UNIMPLEMENTED. Replica workers
are not served.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import threading
from concurrent.futures import ThreadPoolExecutor

import grpc
import grpc.aio

from ..engine.snaptoken import encode_snaptoken
from ..errors import (
    BatcherClosedError,
    DeadlineExceededError,
    KetoError,
    NotImplementedYetError,
    OverloadedError,
)
from ..resilience import (
    ServeCounters,
    admit_check,
    reset_request_trace,
    set_request_trace,
)
from .batcher import (
    _LaunchGuard,
    breaker_open_error,
    classify_engine_error,
    coalesce_pending,
    device_failure,
    resolve_max_inflight,
)
from .check_cache import cached_check_async
from .descriptors import (
    BATCH_CHECK_SERVICE,
    CHECK_SERVICE,
    EXPAND_SERVICE,
    FILTER_SERVICE,
    HEALTH_SERVICE,
    READ_SERVICE,
    REVERSE_READ_SERVICE,
    VERSION_SERVICE,
    WATCH_SERVICE,
    pb,
)
from .grpc_server import _attach_retry_after, _grpc_code, _Services
from .rest_server import EXPLAIN_UNIMPLEMENTED

logger = logging.getLogger("keto_tpu_torch")

class _AioPending:
    __slots__ = ("tuple", "max_depth", "nid", "rt", "future")

    def __init__(self, tuple, max_depth, nid, rt, future):
        self.tuple = tuple
        self.max_depth = max_depth
        self.nid = nid
        self.rt = rt
        self.future = future


def _key(p: _AioPending):
    return p.tuple


class AioCheckBatcher:
    """Coalesces concurrent checks into device batches on the running
    event loop. Build it and call start() on that loop; every method but
    idle() runs there."""

    def __init__(
        self,
        engine_resolver,
        max_batch: int = 1024,
        window_s: float = 0.002,
        pipeline_depth: int = 2,
        max_inflight: int | None = None,
        max_queue: int | None = None,
        device_timeout_ms: float | None = None,
        breaker=None,
        counters: ServeCounters | None = None,
    ):
        self._resolve_engine = engine_resolver
        self.max_batch = max_batch
        self.window_s = window_s
        self.counters = counters if counters is not None else ServeCounters()
        self._queue: asyncio.Queue = asyncio.Queue()
        # submit and resolve block on the device: they run here, never on
        # the loop
        self._executor = ThreadPoolExecutor(max_workers=max(pipeline_depth, 2),
                                            thread_name_prefix="keto-torch-aio-dispatch")
        self.max_inflight = resolve_max_inflight(max_inflight, pipeline_depth)
        self._inflight = asyncio.Semaphore(self.max_inflight)
        self._collector: asyncio.Task | None = None
        self._tasks: set = set()
        self._closed = False
        # admitted-but-unresolved checks; admission and completion both run
        # on the loop, so the count needs no lock. 0: unbounded
        self.max_queue = int(max_queue) if max_queue else 0
        self._pending = 0
        self.device_timeout_s = float(device_timeout_ms) / 1e3 if device_timeout_ms else None
        self.breaker = breaker

    @property
    def stats(self) -> dict:
        return self.counters.snapshot()

    def start(self) -> None:
        self._collector = asyncio.get_running_loop().create_task(self._run())

    async def close(self, timeout_s: float = 5.0) -> None:
        """Stop the collector: what is queued is still launched, a check
        arriving later fails with BatcherClosedError; the launches in flight
        get `timeout_s` to answer, and the executor is let go without
        waiting on a device call that stalls."""
        self._closed = True
        if self._collector is not None:
            self._queue.put_nowait(None)
            try:
                await asyncio.wait_for(self._collector, timeout_s)
            except asyncio.TimeoutError:
                pass
        while not self._queue.empty():
            p = self._queue.get_nowait()
            if p is not None and not p.future.done():
                p.future.set_exception(BatcherClosedError(retry_after_s=1.0))
        if self._tasks:
            await asyncio.wait(set(self._tasks), timeout=timeout_s)
        self._executor.shutdown(wait=False, cancel_futures=True)

    # -- caller side ----------------------------------------------------------

    def _queue_delay_estimate_s(self, pending: int) -> float:
        batches = pending // max(self.max_batch, 1) + 1
        return max(batches * max(self.window_s, 0.001), 0.05)

    def _shed_full(self) -> OverloadedError:
        self.counters.inc("shed", "queue_full")
        return OverloadedError("check queue is full",
                               retry_after_s=self._queue_delay_estimate_s(self._pending))

    def admit(self, deadline=None) -> None:
        """The admission gate's batcher check: a typed 429 at max_queue (the
        count is exact here: nothing else runs on the loop meanwhile), a
        typed 504 for an expired budget."""
        if self._closed:
            raise OverloadedError("check batcher is closed", retry_after_s=1.0)
        if self.max_queue and self._pending >= self.max_queue:
            raise self._shed_full()
        if deadline is not None and deadline.expired():
            self.counters.inc("deadline_exceeded", "admission")
            raise DeadlineExceededError("request deadline expired before admission")

    def idle(self) -> bool:
        """Nothing admitted is unresolved (read from any thread)."""
        return self._pending == 0

    def _dec_pending(self, _f=None) -> None:
        self._pending -= 1

    async def check(self, tuple, max_depth: int = 0, nid=None, rt=None):
        return (await self.check_versioned(tuple, max_depth, nid=nid, rt=rt))[0]

    async def check_versioned(self, tuple, max_depth: int = 0, nid=None, rt=None):
        """(CheckResult, version | None), as CheckBatcher.check_versioned;
        `rt.deadline` bounds the wait."""
        if self._closed:
            raise BatcherClosedError(retry_after_s=1.0)
        if self.max_queue and self._pending >= self.max_queue:
            raise self._shed_full()
        self._pending += 1
        fut = asyncio.get_running_loop().create_future()
        fut.add_done_callback(self._dec_pending)
        self._queue.put_nowait(_AioPending(tuple, max_depth, nid, rt, fut))
        deadline = rt.deadline if rt is not None else None
        if deadline is None:
            return await fut
        try:
            # a timeout cancels the future: the collector then drops the
            # rider without a batch slot and without counting it again
            return await asyncio.wait_for(fut, timeout=max(deadline.remaining_s(), 1e-4))
        except asyncio.TimeoutError:
            self.counters.inc("deadline_exceeded", "wait")
            raise DeadlineExceededError("request deadline expired waiting for the check batch")

    # -- collector ------------------------------------------------------------

    async def _drain(self, first) -> list:
        batch = [first]
        loop = asyncio.get_running_loop()
        end = loop.time() + self.window_s
        while len(batch) < self.max_batch:
            timeout = end - loop.time()
            try:
                if timeout <= 0:
                    item = self._queue.get_nowait()
                else:
                    item = await asyncio.wait_for(self._queue.get(), timeout)
            except (asyncio.QueueEmpty, asyncio.TimeoutError):
                break
            if item is None:
                self._queue.put_nowait(None)  # the main loop sees the shutdown too
                break
            batch.append(item)
        return batch

    def _expire(self, group: list) -> list:
        """The riders still live: an expired one fails with the typed 504
        without taking a batch slot; one already answered or cancelled
        (its caller's wait timed out, counted there) drops out."""
        live = []
        for p in group:
            if p.future.done():
                continue
            dl = p.rt.deadline if p.rt is not None else None
            if dl is not None and dl.expired():
                self.counters.inc("deadline_exceeded", "queue")
                p.future.set_exception(
                    DeadlineExceededError("request deadline expired in the check queue"))
            else:
                live.append(p)
        return live

    @staticmethod
    def _fail_slots(slots, err) -> None:
        for slot in slots:
            for p in slot:
                if not p.future.done():
                    p.future.set_exception(err)

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._task_done)

    def _task_done(self, task) -> None:
        self._tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            logger.error("check batch task failed", exc_info=task.exception())

    async def _run(self) -> None:
        while True:
            item = await self._queue.get()
            if item is None:
                return
            batch = await self._drain(item)
            by_key: dict = {}
            for p in batch:
                by_key.setdefault((p.max_depth, p.nid), []).append(p)
            for (depth, nid), group in by_key.items():
                group = self._expire(group)
                if not group:
                    continue
                # while the breaker is open a group fails here, on the
                # collector, never queued behind a stalled launch
                if self.breaker is not None and not self.breaker.allow():
                    self.counters.inc("shed", "breaker_open", n=len(group))
                    self._fail_slots([group], breaker_open_error(self.breaker))
                    continue
                # each group is a task of its own: the collector goes on
                # draining while it waits for a launch slot
                self._spawn(self._device_serve(
                    coalesce_pending(group, _key, self.counters), depth, nid))

    # -- launches -------------------------------------------------------------

    def _count_batch(self, slots) -> None:
        self.counters.inc("batches")
        self.counters.inc("batched_checks", n=len(slots))

    def _device_failed(self, slots, e, cause: str) -> None:
        self._fail_slots(slots, device_failure(self.breaker, self.counters, e, cause,
                                               self.device_timeout_s))

    def _watchdog_fire(self, guard, slots) -> None:
        """On the loop, device_timeout_ms after the launch began: a batch
        still unresolved is abandoned, its in-flight slot released and its
        riders failed; the guard turns a late resolve into a no-op."""
        if not guard.claim():
            return
        self._inflight.release()
        self._device_failed(slots, None, "device_timeout")

    async def _device_serve(self, slots, depth, nid) -> None:
        loop = asyncio.get_running_loop()
        try:
            engine = self._resolve_engine(nid)
        except Exception as e:  # noqa: BLE001 - every rider gets a typed error
            self._fail_slots(slots, classify_engine_error(e, self.counters, "engine"))
            return
        await self._inflight.acquire()
        # the semaphore wait can outlast every rider's budget: a fully
        # expired group gives its slot back without launching
        live = self._expire([p for slot in slots for p in slot])
        if not live:
            self._inflight.release()
            return
        if len(live) != sum(len(s) for s in slots):
            slots = coalesce_pending(live, _key, None)
        submit = getattr(engine, "check_batch_submit", None)
        if submit is None:
            await self._evaluate(engine, slots, depth)
            return
        # armed before the submit, so that a stalled submit is bounded too
        guard = _LaunchGuard()
        watchdog = loop.call_later(self.device_timeout_s, self._watchdog_fire, guard, slots) \
            if self.device_timeout_s else None
        self._count_batch(slots)
        try:
            handle = await loop.run_in_executor(self._executor, submit,
                                                [s[0].tuple for s in slots], depth)
        except Exception as e:  # noqa: BLE001 - every rider gets a typed error
            if guard.claim():
                if watchdog is not None:
                    watchdog.cancel()
                self._inflight.release()
                self._device_failed(slots, e, "device")
            return
        await self._finish(engine, handle, slots, guard, watchdog)

    async def _evaluate(self, engine, slots, depth) -> None:
        """An engine without the split submit/resolve: one check_batch."""
        loop = asyncio.get_running_loop()
        self._count_batch(slots)
        try:
            results = await loop.run_in_executor(self._executor, engine.check_batch,
                                                 [s[0].tuple for s in slots], depth)
        except Exception as e:  # noqa: BLE001 - every rider gets a typed error
            self._fail_slots(slots, classify_engine_error(e, self.counters, "engine"))
            return
        finally:
            self._inflight.release()
        for slot, res in zip(slots, results):
            for p in slot:
                if not p.future.done():
                    p.future.set_result((res, None))

    async def _finish(self, engine, handle, slots, guard, watchdog) -> None:
        loop = asyncio.get_running_loop()
        if guard.peek():
            return  # the watchdog already failed these riders
        try:
            resolve_v = getattr(engine, "check_batch_resolve_v", None)
            if resolve_v is not None:
                results, versions = await loop.run_in_executor(self._executor, resolve_v, handle)
            else:
                results = await loop.run_in_executor(self._executor,
                                                     engine.check_batch_resolve, handle)
                versions = [None] * len(results)
        except Exception as e:  # noqa: BLE001 - every rider gets a typed error
            if guard.claim():
                if watchdog is not None:
                    watchdog.cancel()
                self._inflight.release()
                self._device_failed(slots, e, "device")
            return
        if not guard.claim():
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


class _AioReadServices:
    """The read services over grpc.aio, on _Services' bodies."""

    def __init__(self, services: _Services, batcher: AioCheckBatcher):
        self._svc = services
        self._batcher = batcher
        self._blocking = ThreadPoolExecutor(max_workers=4,
                                            thread_name_prefix="keto-torch-aio-blocking")
        # a Health Watch parks a thread in wait_change for up to 5 s a wake
        self._watch_pool = ThreadPoolExecutor(max_workers=services.max_watchers,
                                              thread_name_prefix="keto-torch-aio-watch")

    async def _observed(self, body, req, context):
        """Run one unary body with the request's RequestTrace set: a
        KetoError answers its mapped code and message (with its retry hint
        as `retry-after`), anything else INTERNAL, as the threaded plane."""
        rt = self._svc._request_trace(context)
        token = set_request_trace(rt)
        try:
            return await body(req, context, rt)
        except KetoError as e:
            _attach_retry_after(context, e)
            await context.abort(_grpc_code(e), e.message)
        except grpc.aio.AbortError:
            raise
        except Exception as e:  # noqa: BLE001 - the RPC boundary answers INTERNAL
            await context.abort(grpc.StatusCode.INTERNAL, str(e))
        finally:
            reset_request_trace(token)

    async def check(self, req, context):
        return await self._observed(self._check, req, context)

    async def _check(self, req, context, rt):
        svc = self._svc
        reg = svc.registry
        if req.explain:
            raise NotImplementedYetError(EXPLAIN_UNIMPLEMENTED)
        # admission before any work; the batcher's pending count is the
        # loop's own, so its bound is exact
        admit_check(reg, self._batcher, rt)
        t = svc.check_tuple(req)
        # the store version read and the cache lookup are a few dict
        # operations on the memory store: fine in-loop
        version = svc._enforce(req.snaptoken)
        res = await cached_check_async(reg, self._batcher, reg.nid, t, int(req.max_depth),
                                       version, rt)
        if res.error is not None:
            raise res.error
        return pb.CheckResponse(allowed=res.allowed, snaptoken=svc._token(version))

    def delegated(self, sync_fn):
        """A handler running `sync_fn(req, context, rt)`, one of _Services'
        bodies, on the blocking executor with the request's contextvars."""
        async def body(req, context, rt):
            cvctx = contextvars.copy_context()
            return await asyncio.get_running_loop().run_in_executor(
                self._blocking, lambda: cvctx.run(sync_fn, req, context, rt))

        async def handler(req, context):
            return await self._observed(body, req, context)

        return handler

    async def get_version(self, req, context):
        return self._svc.get_version(req, context, None)

    async def health_check(self, req, context):
        return self._svc.health_check(req, context, None)

    async def watch_tuples(self, req, context):
        """_Services.watch_tuples as an async generator on the loop: the
        hub wakes it through call_soon_threadsafe and it drains the
        subscription in-loop."""
        svc = self._svc
        if not svc._watch_slots.acquire(blocking=False):
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                "too many concurrent watchers")
        try:
            loop = asyncio.get_running_loop()
            try:
                # the subscribe replays history from the store: off the loop
                sub = await loop.run_in_executor(self._blocking, svc.watch_subscribe, req,
                                                 context)
            except KetoError as e:
                await context.abort(_grpc_code(e), e.message)
            wake = asyncio.Event()

            def _wake():
                try:
                    loop.call_soon_threadsafe(wake.set)
                except RuntimeError:
                    pass  # the loop is closing; so is the stream

            sub.add_notify(_wake)
            hub = svc.registry.watch_hub()
            heartbeat_s = float(svc.registry.config.get("watch.heartbeat_s", 5.0))
            last_write = loop.time()
            try:
                while not context.cancelled():
                    if loop.time() - last_write >= heartbeat_s:
                        last_write = loop.time()
                        yield pb.WatchResponse(event_type="heartbeat",
                                               snaptoken=encode_snaptoken(sub.cursor, sub.nid))
                    event, needs_resume = sub.pop_nowait()
                    if needs_resume:
                        try:
                            # the resume reads the store's log: off the loop
                            event = await loop.run_in_executor(self._blocking, hub._resume, sub)
                        except KetoError as e:
                            await context.abort(_grpc_code(e), e.message)
                    if event is None:
                        if sub.closed:  # the daemon's drain ends the stream
                            break
                        try:
                            await asyncio.wait_for(wake.wait(), timeout=0.5)
                        except asyncio.TimeoutError:
                            pass
                        wake.clear()
                        continue
                    event = event.filtered(req.namespace)
                    if event is None:
                        continue
                    yield svc.watch_event_to_proto(event)
                    last_write = loop.time()
            finally:
                sub.close()
        finally:
            svc._watch_slots.release()

    async def health_watch(self, req, context):
        """_Services.health_watch on the loop: the same cap and stream, the
        wait for a readiness change parked on the watch pool."""
        slots = self._svc._watch_slots
        if not slots.acquire(blocking=False):
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                "too many concurrent health watchers")
        loop = asyncio.get_running_loop()
        ready = self._svc.registry.ready
        try:
            flag, gen = ready.state()
            last = None
            while not context.cancelled():
                current = 1 if flag else 2
                if current != last:
                    last = current
                    yield pb.HealthCheckResponse(status=current)
                flag, gen = await loop.run_in_executor(self._watch_pool, ready.wait_change,
                                                       gen, 5.0)
        finally:
            slots.release()

    def close(self) -> None:
        self._blocking.shutdown(wait=False, cancel_futures=True)
        self._watch_pool.shutdown(wait=False, cancel_futures=True)


def _aio_handlers(service: _AioReadServices) -> list:
    def unary(fn, req_cls):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=req_cls.FromString,
            response_serializer=lambda m: m.SerializeToString())

    svc = service._svc
    d = service.delegated
    handlers = {
        CHECK_SERVICE: {"Check": unary(service.check, pb.CheckRequest)},
        # a batch, a column of candidates or a walk per RPC is blocking
        # device work that the client has batched already: delegated
        BATCH_CHECK_SERVICE: {"BatchCheck": unary(d(svc.batch_check), pb.BatchCheckRequest)},
        EXPAND_SERVICE: {"Expand": unary(d(svc.expand), pb.ExpandRequest)},
        READ_SERVICE: {"ListRelationTuples": unary(d(svc.list_relation_tuples),
                                                   pb.ListRelationTuplesRequest)},
        REVERSE_READ_SERVICE: {
            "ListObjects": unary(d(svc.list_objects), pb.ListObjectsRequest),
            "ListSubjects": unary(d(svc.list_subjects), pb.ListSubjectsRequest),
        },
        FILTER_SERVICE: {"Filter": unary(d(svc.filter), pb.FilterRequest)},
        WATCH_SERVICE: {"Watch": grpc.unary_stream_rpc_method_handler(
            service.watch_tuples,
            request_deserializer=pb.WatchRequest.FromString,
            response_serializer=lambda m: m.SerializeToString())},
        VERSION_SERVICE: {"GetVersion": unary(service.get_version, pb.GetVersionRequest)},
        HEALTH_SERVICE: {
            "Check": unary(service.health_check, pb.HealthCheckRequest),
            "Watch": grpc.unary_stream_rpc_method_handler(
                service.health_watch,
                request_deserializer=pb.HealthCheckRequest.FromString,
                response_serializer=lambda m: m.SerializeToString()),
        },
    }
    return [grpc.method_handlers_generic_handler(name, methods)
            for name, methods in handlers.items()]


class AioReadServer:
    """The asyncio read listener on a loop thread of its own: start()
    binds and returns the port, stop(grace) drains and ends the loop."""

    def __init__(self, registry, host: str, port: int, pipeline_depth: int = 2,
                 window_s: float = 0.002, credentials=None):
        self.registry = registry
        self.host = host
        self.port = port
        self.bound_port: int | None = None
        self.batcher: AioCheckBatcher | None = None
        self._pipeline_depth = pipeline_depth
        self._window_s = window_s
        self._credentials = credentials
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._error: BaseException | None = None
        self._server = None
        self._services: _AioReadServices | None = None

    def start(self) -> int:
        self._thread = threading.Thread(target=self._run, name="keto-torch-aio-read",
                                        daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("the aio read server did not start within 30 s")
        if self._error is not None:
            raise self._error
        return self.bound_port

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._start_server())
        except BaseException as e:  # noqa: BLE001 - start() re-raises it
            self._error = e
            self._started.set()
            loop.close()
            return
        self._loop = loop
        self._started.set()
        # the loop outlives the server: stop()'s shutdown coroutine closes
        # the batcher and the pools on it
        loop.run_forever()
        loop.run_until_complete(loop.shutdown_asyncgens())
        loop.close()

    async def _start_server(self) -> None:
        reg = self.registry
        cfg = reg.config
        self.batcher = AioCheckBatcher(
            reg.check_engine,
            pipeline_depth=self._pipeline_depth,
            window_s=self._window_s,
            max_inflight=cfg.get("serve.check.max_inflight"),
            max_queue=cfg.get("serve.check.max_queue"),
            device_timeout_ms=cfg.get("serve.check.device_timeout_ms"),
            # one breaker a process, shared with the threaded batcher: the
            # device's health is judged from all traffic
            breaker=reg.circuit_breaker(),
            counters=reg.counters(),
        )
        self.batcher.start()
        self._services = _AioReadServices(_Services(reg), self.batcher)
        server = grpc.aio.server()
        server.add_generic_rpc_handlers(tuple(_aio_handlers(self._services)))
        addr = f"{self.host}:{self.port}"
        self.bound_port = server.add_secure_port(addr, self._credentials) \
            if self._credentials is not None else server.add_insecure_port(addr)
        await server.start()
        self._server = server

    def stop(self, grace: float = 2.0) -> None:
        """Stop the server (its calls get `grace`), the batcher and the
        pools, then the loop; bounded even when a call or a device launch
        stalls."""
        if self._loop is None or self._server is None:
            return

        async def shutdown():
            await self._server.stop(grace)
            await self.batcher.close(timeout_s=grace)
            self._services.close()

        try:
            asyncio.run_coroutine_threadsafe(shutdown(), self._loop).result(timeout=grace + 10)
        except TimeoutError:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)

"""The port's asyncio read plane (keto_tpu_torch/api/aio_server.py) held
against keto_tpu's on the CPU.

  (a) a port Daemon and a keto_tpu Daemon with `serve.read.grpc.aio` over
      equal stores: every read method's raw response bytes, status code,
      details and trailing metadata (`retry-after`) on the aio listeners
      are equal, with every kind of snaptoken and page by page; a Health
      Watch stream across a drain and the watcher cap; read-your-writes at
      a write's snaptoken; 32 concurrent checks (equal answers, fewer
      batches than checks); writes past the overlay's compaction threshold
      while checks stream through the aio listener (tests/test_aio.py's
      config and tuples);
  (b) AioCheckBatcher on gated, raising and stalling stub engines: the 429
      at the queue bound (message and Retry-After as the threaded
      batcher's and keto_tpu's aio batcher's), the 504 in admission and in
      the wait, the launch watchdog, the breaker's transitions shared with
      a threaded CheckBatcher, close and the server's stop within their
      grace;
  (c) each known difference beside keto_tpu's behaviour: no host answer
      for a failing device, explain UNIMPLEMENTED, the aio listener
      serving TLS, no replica workers;
  (d) the loop-native tuple Watch: a heartbeat, a replay and every kind
      of snaptoken, equal response bytes, codes and details.

Every wait is bounded. Tolerance: exact equality.
"""

import asyncio
import inspect
import threading
import time

import grpc
import pytest

from keto_tpu.api.aio_server import AioCheckBatcher as JAioBatcher
from keto_tpu.api.aio_server import AioReadServer as JAioReadServer
from keto_tpu.api.daemon import Daemon as JDaemon
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.definitions import RESULT_IS_MEMBER as J_MEMBER
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.registry import Registry as JRegistry

from keto_tpu_torch.api.aio_server import AioCheckBatcher, AioReadServer
from keto_tpu_torch.api.batcher import CheckBatcher
from keto_tpu_torch.api.daemon import Daemon as TDaemon
from keto_tpu_torch.api.descriptors import pb
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine.definitions import RESULT_IS_MEMBER as T_MEMBER
from keto_tpu_torch.engine.snaptoken import encode_snaptoken
from keto_tpu_torch.errors import (
    CheckBatchFailedError,
    DeadlineExceededError,
    OverloadedError,
    StoreUnavailableError,
)
from keto_tpu_torch.ketoapi import RelationTuple
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.resilience import CircuitBreaker, Deadline, RequestTrace, ServeCounters

from test_aio import NAMESPACES as AIO_NAMESPACES
from test_torch_grpc import (
    CHECK_PATH,
    HEALTH_WATCH_PATH,
    LISTEN,
    LIST_OBJECTS_PATH,
    READS,
    TOKEN_METHODS,
    TRANSACT_PATH,
    WAIT_S,
    _check,
    _list_objects,
    _tuple_pb,
    raw,
    small_pools,
    watch_raw,
)
from test_torch_daemon import wait_until
from test_torch_resilience import _FailingDeviceEngine
from test_torch_serve_options import cert  # noqa: F401  (a fixture)
from test_torch_snaptoken import NAMESPACES, TOKENS, TUPLES

AIO_READ = {**LISTEN["read"], "grpc": {"host": "127.0.0.1", "port": 0, "aio": True}}


def aio_pair(serve=None, engines=None, check=None, namespaces=NAMESPACES, tuples=TUPLES,
             extra=None):
    """A port and a keto_tpu daemon over equal stores, both with
    `serve.read.grpc.aio`, as test_torch_grpc.make_pair's; `namespaces`,
    `tuples` and the top-level config keys `extra` as given."""
    serve = dict(serve or {})
    serve["read"] = {**AIO_READ, **serve.get("read", {})}
    cfg = {"dsn": "memory", "check": {"engine": "tpu", **(check or {})},
           "namespaces": namespaces, "serve": {**LISTEN, **serve}, **(extra or {})}
    treg = TRegistry(TConfig(cfg), device="cpu", engine=engines[0] if engines else None)
    jreg = JRegistry(JConfig(cfg))
    treg.relation_tuple_manager().write_relation_tuples(
        [RelationTuple.from_string(s) for s in tuples])
    jreg.relation_tuple_manager().write_relation_tuples(
        [JTuple.from_string(s) for s in tuples])
    if engines is not None:
        jreg._engine = engines[1]  # keto_tpu's Registry takes no engine
    tdaemon, jdaemon = TDaemon(treg), JDaemon(jreg)
    with small_pools():
        tdaemon.start()
        jdaemon.start()
    return tdaemon, jdaemon


def both_aio(tdaemon, jdaemon, path, msg, timeout=WAIT_S):
    data = msg.SerializeToString()
    return (raw(tdaemon.read_grpc_port, path, data, timeout),
            raw(jdaemon.read_grpc_port, path, data, timeout))


@pytest.fixture(scope="module")
def aio_daemons():
    tdaemon, jdaemon = aio_pair()
    yield tdaemon, jdaemon
    tdaemon.stop()
    jdaemon.stop()


# -- (a) the aio listener against keto_tpu's -------------------------------------------


def test_aio_listener_is_the_asyncio_plane(aio_daemons):
    tdaemon, jdaemon = aio_daemons
    assert isinstance(tdaemon._aio_read, AioReadServer)
    assert isinstance(jdaemon._aio_read, JAioReadServer)
    assert tdaemon.read_grpc_port not in (None, tdaemon.read_port)
    # its own loop thread and batcher, beside the threaded plane's
    assert tdaemon._aio_read._thread.is_alive()
    assert tdaemon._aio_read.batcher is not tdaemon.batcher


@pytest.mark.parametrize("case", sorted(READS))
def test_aio_read_methods_equal_keto_tpu(aio_daemons, case):
    path, msg = READS[case]
    got, want = both_aio(*aio_daemons, path, msg)
    assert got == want, case
    # and the port's aio answer is its own muxed (threaded) port's
    assert got == raw(aio_daemons[0].read_port, path, msg.SerializeToString()), case
    if case == "check_unknown_namespace":
        assert got[0] == "NOT_FOUND"


@pytest.mark.parametrize("token", sorted(TOKENS))
@pytest.mark.parametrize("method", sorted(TOKEN_METHODS))
def test_aio_snaptokens_equal_keto_tpu(aio_daemons, method, token):
    path, msg = TOKEN_METHODS[method](TOKENS[token])
    got, want = both_aio(*aio_daemons, path, msg)
    assert got == want, (method, token)


def test_aio_pages_equal_keto_tpu(aio_daemons):
    token, sizes = "", []
    while True:
        got, want = both_aio(*aio_daemons, LIST_OBJECTS_PATH,
                             _list_objects(page_size=2, page_token=token))
        assert got == want and got[0] == "OK", token
        resp = pb.ListObjectsResponse.FromString(got[1])
        sizes.append(len(resp.objects))
        token = resp.next_page_token
        if not token:
            break
    assert len(sizes) > 1


def test_aio_health_watch_across_a_drain():
    """On each aio listener a Health Watch sees SERVING, then NOT_SERVING
    when the drain starts."""
    seen = []
    for daemon in aio_pair():
        ch = grpc.insecure_channel(f"127.0.0.1:{daemon.read_grpc_port}")
        stream = ch.unary_stream(HEALTH_WATCH_PATH)(
            pb.HealthCheckRequest().SerializeToString(), timeout=WAIT_S)
        stopper = threading.Thread(target=daemon.stop, kwargs={"grace": 1.0}, daemon=True)
        try:
            statuses = [pb.HealthCheckResponse.FromString(next(stream)).status]
            stopper.start()
            statuses.append(pb.HealthCheckResponse.FromString(next(stream)).status)
        finally:
            stream.cancel()
            ch.close()
            if stopper.ident is None:
                daemon.stop(grace=1.0)
            stopper.join(timeout=WAIT_S)
        assert not stopper.is_alive()
        seen.append(statuses)
    assert seen[0] == seen[1] == [1, 2]


def test_aio_health_watch_cap():
    tdaemon, jdaemon = aio_pair(serve={"read": {"grpc": {**AIO_READ["grpc"],
                                                         "max_watchers": 1}}})
    try:
        out = []
        for daemon in (tdaemon, jdaemon):
            ch = grpc.insecure_channel(f"127.0.0.1:{daemon.read_grpc_port}")
            watch = ch.unary_stream(HEALTH_WATCH_PATH)
            first = watch(pb.HealthCheckRequest().SerializeToString(), timeout=WAIT_S)
            next(first)
            second = watch(pb.HealthCheckRequest().SerializeToString(), timeout=WAIT_S)
            with pytest.raises(grpc.RpcError) as e:
                next(second)
            out.append((e.value.code().name, e.value.details()))
            first.cancel()
            ch.close()
        assert out[0] == out[1] == ("RESOURCE_EXHAUSTED", "too many concurrent health watchers")
    finally:
        tdaemon.stop(grace=1.0)
        jdaemon.stop(grace=1.0)


def test_aio_read_your_writes_through_a_snaptoken():
    """A Transact on each write port, then Checks on the aio listener at
    the token it returned: equal bytes, the write seen."""
    tdaemon, jdaemon = aio_pair()
    try:
        for i in range(3):
            req = pb.TransactRelationTuplesRequest()
            d = req.relation_tuple_deltas.add()
            d.action = 1
            d.relation_tuple.CopyFrom(_tuple_pb(f"videos:/w{i}#owner@w{i}"))
            data = req.SerializeToString()
            got = raw(tdaemon.write_port, TRANSACT_PATH, data)
            assert got == raw(jdaemon.write_port, TRANSACT_PATH, data) and got[0] == "OK"
            token = pb.TransactRelationTuplesResponse.FromString(got[1]).snaptokens[0]
            for s in (f"videos:/w{i}#owner@w{i}", f"videos:/w{i}#view@w{i}",
                      f"videos:/w{i}#owner@nobody"):
                got, want = both_aio(tdaemon, jdaemon, CHECK_PATH, _check(s, token=token))
                assert got == want and got[0] == "OK", s
                assert pb.CheckResponse.FromString(got[1]).allowed == ("nobody" not in s)
    finally:
        tdaemon.stop()
        jdaemon.stop()


def test_aio_32_concurrent_checks_batch():
    """32 clients at once on each aio listener: equal answers, and the
    port's aio batcher took fewer batches than checks."""
    tdaemon, jdaemon = aio_pair(check={"batch_window_ms": 50.0})
    try:
        queries = [f"videos:/d{i % 3}/v{i % 4}#view@{('alice', 'bob', 'carol')[i % 3]}"
                   for i in range(32)]
        before = tdaemon.registry.counters().snapshot()
        answers = {}
        for daemon in (tdaemon, jdaemon):
            out = [None] * len(queries)
            start = threading.Barrier(len(queries))

            def client(i, port=daemon.read_grpc_port, out=out):
                start.wait(timeout=WAIT_S)
                with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                    out[i] = ch.unary_unary(CHECK_PATH)(
                        _check(queries[i]).SerializeToString(), timeout=WAIT_S)

            threads = [threading.Thread(target=client, args=(i,), daemon=True)
                       for i in range(len(queries))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=WAIT_S)
            answers[daemon] = out
        assert answers[tdaemon] == answers[jdaemon]
        assert all(a is not None for a in answers[tdaemon])
        after = tdaemon.registry.counters().snapshot()
        batches = after["batches"] - before["batches"]
        checks = after["batched_checks"] - before["batched_checks"] + \
            after["coalesced"] - before["coalesced"]
        cache = tdaemon.registry.check_cache().counts
        assert 1 <= batches < len(queries)
        assert checks + cache["hit"] == len(queries)
    finally:
        tdaemon.stop()
        jdaemon.stop()


def test_aio_incremental_merge_under_live_traffic():
    """tests/test_aio.py's churn on both aio planes: a burst past the
    overlay's compaction threshold while a client streams checks through
    the aio listener; the merge happens inside serving, read-your-writes
    holds across it, and neither engine rebuilt."""
    from keto_tpu.engine.delta import DELTA_COMPACT_THRESHOLD as J_THRESHOLD
    from keto_tpu_torch.engine.delta import DELTA_COMPACT_THRESHOLD

    assert DELTA_COMPACT_THRESHOLD == J_THRESHOLD
    tdaemon, jdaemon = aio_pair(namespaces=AIO_NAMESPACES, tuples=["videos:/m0#owner@m0"])
    try:
        n = DELTA_COMPACT_THRESHOLD + 16
        for daemon in (tdaemon, jdaemon):
            stop = threading.Event()
            seen = []

            def stream(port=daemon.read_grpc_port):
                with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                    rpc = ch.unary_unary(CHECK_PATH)
                    while not stop.is_set():
                        resp = rpc(_check("videos:/m0#owner@m0").SerializeToString(),
                                   timeout=WAIT_S)
                        seen.append(pb.CheckResponse.FromString(resp).allowed)

            th = threading.Thread(target=stream, daemon=True)
            th.start()
            token = ""
            for i in range(0, n, 512):
                req = pb.TransactRelationTuplesRequest()
                for k in range(i, min(i + 512, n)):
                    d = req.relation_tuple_deltas.add()
                    d.action = 1
                    d.relation_tuple.CopyFrom(_tuple_pb(f"videos:/mb{k}#owner@mu{k}"))
                got = raw(daemon.write_port, TRANSACT_PATH, req.SerializeToString())
                assert got[0] == "OK"
                token = pb.TransactRelationTuplesResponse.FromString(got[1]).snaptokens[0]
            stop.set()
            th.join(timeout=WAIT_S)
            assert seen and all(seen)
            for s, want in ((f"videos:/mb{n - 1}#owner@mu{n - 1}", True),
                            ("videos:/m0#owner@m0", True), ("videos:/mb3#owner@mu4", False),
                            (f"videos:/mb{n - 1}#view@mu{n - 1}", True)):
                got = raw(daemon.read_grpc_port, CHECK_PATH, _check(s, token=token)
                          .SerializeToString())
                assert got[0] == "OK" and pb.CheckResponse.FromString(got[1]).allowed == want
        # neither engine rebuilt, and the port merged the overlay into a
        # new base; keto_tpu's engine had, under xdist load, at times not
        # counted its merge yet when the reads above returned
        assert [d.registry.check_engine().stats["snapshot_builds"]
                for d in (tdaemon, jdaemon)] == [1, 1]
        assert tdaemon.registry.check_engine().stats["incremental_merges"] >= 1
    finally:
        tdaemon.stop()
        jdaemon.stop()


# -- (b) AioCheckBatcher on stub engines -------------------------------------------------


class LoopThread:
    """An event loop on a thread of its own; run() waits for a coroutine."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=WAIT_S):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    def spawn(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=WAIT_S)
        self.loop.close()


@pytest.fixture
def loop():
    lt = LoopThread()
    yield lt
    lt.close()


class GatedSplitEngine:
    """A split-phase engine whose submit blocks until the gate opens."""

    def __init__(self, member):
        self.member = member
        self.gate = threading.Event()
        self.submits = 0

    def check_batch_submit(self, tuples, depth=0):
        self.submits += 1
        assert self.gate.wait(timeout=WAIT_S)
        return list(tuples)

    def check_batch_resolve(self, handle):
        return [self.member for _ in handle]


def make_aio(loop, engine, **kw):
    async def build():
        b = AioCheckBatcher(lambda nid: engine, **kw)
        b.start()
        return b

    return loop.run(build())


def make_jaio(loop, engine, **kw):
    async def build():
        b = JAioBatcher(lambda nid: engine, **kw)
        b.start()
        return b

    return loop.run(build())


T = "videos:/d1#owner@alice"


def test_aio_batcher_answers_and_counts(loop):
    engine = GatedSplitEngine(T_MEMBER)
    engine.gate.set()
    b = make_aio(loop, engine)
    res, version = loop.run(b.check_versioned(RelationTuple.from_string(T)))
    assert res is T_MEMBER and version is None
    assert b.stats["batches"] == 1 and b.stats["batched_checks"] == 1 and b.idle()
    loop.run(b.close())


def test_aio_batcher_429_at_the_queue_bound(loop):
    """max_queue 1: a second check while one is admitted is shed with the
    threaded batcher's and keto_tpu's aio batcher's message and hint."""
    out = []
    for kind in ("aio", "threaded", "keto_tpu_aio"):
        member = J_MEMBER if kind == "keto_tpu_aio" else T_MEMBER
        parse = JTuple.from_string if kind == "keto_tpu_aio" else RelationTuple.from_string
        engine = GatedSplitEngine(member)
        if kind == "threaded":
            b = CheckBatcher(engine, max_queue=1)
            first = b.submit(parse(T))
            with pytest.raises(OverloadedError) as e:
                b.submit(parse("videos:/d2#owner@bob"))
            engine.gate.set()
            assert first.future.result(timeout=WAIT_S)[0] is member
            b.close()
        else:
            b = (make_jaio if kind == "keto_tpu_aio" else make_aio)(loop, engine, max_queue=1)
            first = loop.spawn(b.check_versioned(parse(T)))
            wait_until(lambda: not b.idle())
            with pytest.raises(Exception) as e:
                loop.run(b.check_versioned(parse("videos:/d2#owner@bob")))
            engine.gate.set()
            assert first.result(timeout=WAIT_S)[0] is member
            loop.run(b.close())
        out.append((type(e.value).__name__, e.value.message, e.value.retry_after_s))
        if kind == "aio":
            assert b.stats["shed"]["queue_full"] == 1
    assert out[0] == out[1] == out[2] == ("OverloadedError", "check queue is full", 0.05)


def test_aio_batcher_504_in_admission_and_in_the_wait(loop):
    engine = GatedSplitEngine(T_MEMBER)
    b = make_aio(loop, engine)
    with pytest.raises(DeadlineExceededError, match="before admission"):
        b.admit(Deadline(0.0))
    assert b.stats["deadline_exceeded"]["admission"] == 1
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceededError, match="waiting for the check batch"):
        loop.run(b.check_versioned(RelationTuple.from_string(T),
                                   rt=RequestTrace(Deadline(0.2))))
    assert 0.15 <= time.monotonic() - t0 < 5.0
    assert b.stats["deadline_exceeded"]["wait"] == 1
    engine.gate.set()
    # the expired rider let go of its pending count, and nobody counted it twice
    wait_until(b.idle)
    loop.run(b.close())
    assert b.stats["deadline_exceeded"] == {"admission": 1, "wait": 1, "queue": 0}


def test_aio_batcher_watchdog_fails_a_stalled_launch(loop):
    engine = _FailingDeviceEngine(T_MEMBER, stall_s=1.5)
    breaker = CircuitBreaker(threshold=5, cooldown_s=60)
    b = make_aio(loop, engine, device_timeout_ms=100, breaker=breaker, max_inflight=1)
    t0 = time.monotonic()
    with pytest.raises(CheckBatchFailedError, match="unresolved after 100 ms"):
        loop.run(b.check_versioned(RelationTuple.from_string(T)))
    assert time.monotonic() - t0 < 1.2
    assert b.stats["check_batch_failed"]["device_timeout"] == 1
    assert breaker._failures == 1
    # the in-flight slot came back at once: the next launch does not wait
    # for the stalled one
    assert b._inflight._value == 1
    loop.run(b.close(timeout_s=0.1))


def test_aio_batcher_breaker_shared_with_the_threaded_batcher(loop):
    """One breaker, two planes: a failure through each opens it, both
    then fail fast with the typed 503, and after the cooldown a probe
    through the aio plane closes it."""
    now = [0.0]
    breaker = CircuitBreaker(threshold=2, cooldown_s=60, clock=lambda: now[0])
    counters = ServeCounters()
    engine = _FailingDeviceEngine(T_MEMBER)
    threaded = CheckBatcher(engine, breaker=breaker, counters=counters)
    aio = make_aio(loop, engine, breaker=breaker, counters=counters)
    t = RelationTuple.from_string(T)
    try:
        with pytest.raises(CheckBatchFailedError):
            threaded.check(t)
        assert breaker.state == "closed"
        with pytest.raises(CheckBatchFailedError):
            loop.run(aio.check(t))
        assert breaker.state == "open"
        errors = []
        for fn in (lambda: threaded.check(t), lambda: loop.run(aio.check(t))):
            with pytest.raises(StoreUnavailableError) as e:
                fn()
            errors.append((e.value.message, e.value.retry_after_s))
        assert errors[0] == errors[1] == ("check device circuit breaker is open", 60.0)
        now[0] += 60.0
        engine.healthy = True
        assert loop.run(aio.check(t)) is T_MEMBER
        assert threaded.check(t) is T_MEMBER
        assert list(breaker.transitions) == ["open", "half_open", "closed"]
        stats = counters.snapshot()
        assert stats["check_batch_failed"]["device"] == 2
        assert stats["shed"]["breaker_open"] == 2
        assert engine.host_batches == 0
    finally:
        threaded.close()
        loop.run(aio.close())


def test_aio_batcher_close_within_its_grace(loop):
    """A launch stalled on the device does not hold close() past its
    timeout; a check after the close fails typed."""
    from keto_tpu_torch.errors import BatcherClosedError

    engine = _FailingDeviceEngine(T_MEMBER, stall_s=3.0)
    b = make_aio(loop, engine)
    rider = loop.spawn(b.check_versioned(RelationTuple.from_string(T)))
    wait_until(lambda: engine.submits == 1)
    t0 = time.monotonic()
    loop.run(b.close(timeout_s=0.3))
    assert time.monotonic() - t0 < 1.5
    with pytest.raises(BatcherClosedError):
        loop.run(b.check(RelationTuple.from_string(T)))
    rider.cancel()


def test_aio_server_stop_within_its_grace():
    """Daemon.stop with a check stalled on the device: the aio listener,
    its batcher and pools stop within the grace, the daemon soon after."""
    engine = _FailingDeviceEngine(T_MEMBER, stall_s=10.0)
    tdaemon, jdaemon = aio_pair(engines=(engine, _FailingDeviceEngine(J_MEMBER)),
                                check={"cache": {"enabled": False}})
    jdaemon.stop()
    out = {}
    th = threading.Thread(target=lambda: out.update(r=raw(
        tdaemon.read_grpc_port, CHECK_PATH, _check("videos:/d1#owner@alice")
        .SerializeToString())), daemon=True)
    th.start()
    wait_until(lambda: engine.submits == 1)
    t0 = time.monotonic()
    tdaemon.stop(grace=0.5)
    assert time.monotonic() - t0 < 6.0
    th.join(timeout=WAIT_S)
    assert out["r"][0] != "OK"


# -- (c) known differences ------------------------------------------------------------------


def test_aio_failing_device_no_host_answer():
    """Known difference: keto_tpu's aio batcher answers a failed device
    batch, and every check while its breaker is open, from the host
    oracle; the port's answers INTERNAL, then UNAVAILABLE with a
    `retry-after` of the remaining cooldown, and never asks the host."""
    engines = (_FailingDeviceEngine(T_MEMBER), _FailingDeviceEngine(J_MEMBER))
    tdaemon, jdaemon = aio_pair(serve={"check": {"breaker": {"threshold": 2,
                                                             "cooldown_s": 60}}},
                                engines=engines, check={"cache": {"enabled": False}})
    try:
        got = {}
        for daemon in (tdaemon, jdaemon):
            got[daemon] = [raw(daemon.read_grpc_port, CHECK_PATH, _check(s).SerializeToString())
                           for s in ("videos:/d1/v0#view@alice", "videos:/d1/v1#view@alice",
                                     "videos:/d2#view@bob")]
        port, keto = got[tdaemon], got[jdaemon]
        assert [g[0] for g in keto] == ["OK"] * 3
        assert all(pb.CheckResponse.FromString(g[1]).allowed for g in keto)
        assert engines[1].host_batches >= 2
        assert [g[0] for g in port] == ["INTERNAL", "INTERNAL", "UNAVAILABLE"]
        assert port[2][2] == "check device circuit breaker is open"
        assert int(dict(port[2][3])["retry-after"]) > 1
        assert engines[0].host_batches == 0 and engines[0].submits == 2
        stats = tdaemon.registry.counters().snapshot()
        assert stats["check_batch_failed"]["device"] == 2 and stats["shed"]["breaker_open"] == 1
    finally:
        tdaemon.stop()
        jdaemon.stop()


def test_aio_explain_is_unimplemented(aio_daemons):
    """Known difference: keto_tpu's aio Check answers a DecisionTrace
    with `explain`; the port's, which has no engine/explain.py, answers
    UNIMPLEMENTED, as its threaded plane does."""
    req = _check("videos:/d1/v2#view@alice", explain=True)
    got, want = both_aio(*aio_daemons, CHECK_PATH, req)
    assert want[0] == "OK" and pb.CheckResponse.FromString(want[1]).decision_trace
    assert got[0] == "UNIMPLEMENTED" and "explain" in got[2]
    assert got == raw(aio_daemons[0].read_port, CHECK_PATH, req.SerializeToString())


# -- (d) the tuple Watch ---------------------------------------------------------------------


@pytest.mark.parametrize("namespace", ["", "groups"])
def test_aio_watch_stream_equals_keto_tpu(namespace):
    """The loop-native tuple Watch against keto_tpu's aio listener: with
    watch.heartbeat_s 0.2 an idle live tail's first frame is a heartbeat
    at the store's version, then a replay from v0 is one event of the
    store's commit; both byte for byte, and the port's replay is its own
    threaded port's."""
    tdaemon, jdaemon = aio_pair(extra={"watch": {"heartbeat_s": 0.2}})
    try:
        idle = pb.WatchRequest(namespace=namespace)
        got, want = (watch_raw(d.read_grpc_port, idle, heartbeats=True)
                     for d in (tdaemon, jdaemon))
        assert got == want and got[0] == "OK"
        assert pb.WatchResponse.FromString(got[1][0]) == pb.WatchResponse(
            event_type="heartbeat", snaptoken=encode_snaptoken(1, "default"))
        replay = pb.WatchRequest(snaptoken=encode_snaptoken(0, "default"), namespace=namespace)
        got, want = (watch_raw(d.read_grpc_port, replay) for d in (tdaemon, jdaemon))
        assert got == want and got[0] == "OK"
        assert got == watch_raw(tdaemon.read_port, replay)
        assert len(pb.WatchResponse.FromString(got[1][0]).changes) == \
            len([t for t in TUPLES if not namespace or t.startswith(namespace + ":")])
    finally:
        tdaemon.stop(grace=1.0)
        jdaemon.stop(grace=1.0)


@pytest.mark.parametrize("token", sorted(TOKENS))
def test_aio_watch_snaptokens_equal_keto_tpu(aio_daemons, token):
    req = pb.WatchRequest(snaptoken=TOKENS[token])
    got, want = (watch_raw(d.read_grpc_port, req, timeout=0.5) for d in aio_daemons)
    assert got == want, token
    assert got == watch_raw(aio_daemons[0].read_port, req, timeout=0.5), token


def _check_call(channel):
    return channel.unary_unary(CHECK_PATH)(_check("videos:/d1/v2#view@alice")
                                           .SerializeToString(), timeout=10)


def test_aio_listener_serves_tls(cert):
    """Known difference: with serve.read.tls, keto_tpu's aio listener
    still binds plaintext (its aio branch never binds the certificate);
    the port's serves TLS only, as every other listener of the deployment."""
    tls = {"cert_path": cert[0], "key_path": cert[1]}
    tdaemon, jdaemon = aio_pair(serve={"read": {"tls": tls}})
    with open(cert[0], "rb") as f:
        creds = grpc.ssl_channel_credentials(f.read())
    try:
        with grpc.secure_channel(f"127.0.0.1:{tdaemon.read_grpc_port}", creds) as ch:
            got = _check_call(ch)
        assert pb.CheckResponse.FromString(got).allowed
        with grpc.insecure_channel(f"127.0.0.1:{tdaemon.read_grpc_port}") as ch:
            with pytest.raises(grpc.RpcError):
                _check_call(ch)
        # keto_tpu's: plaintext answers, TLS does not
        with grpc.insecure_channel(f"127.0.0.1:{jdaemon.read_grpc_port}") as ch:
            want = _check_call(ch)
        assert want == got
        with grpc.secure_channel(f"127.0.0.1:{jdaemon.read_grpc_port}", creds) as ch:
            with pytest.raises(grpc.RpcError):
                _check_call(ch)
    finally:
        tdaemon.stop()
        jdaemon.stop()


def test_aio_no_replica_workers():
    """Known difference: with serve.check.workers 2, keto_tpu's daemon
    builds a replica group whose worker 0 owns its aio listener; the
    port's AioReadServer takes no worker and serves one batcher. The
    answers are the same."""
    assert "worker" in inspect.signature(JAioReadServer).parameters
    assert "worker" not in inspect.signature(AioReadServer).parameters
    tdaemon, jdaemon = aio_pair(serve={"check": {"workers": 2}})
    try:
        assert jdaemon._group is not None and len(jdaemon._group.workers) == 2
        assert jdaemon._aio_read.worker is jdaemon._group.workers[0]
        assert not hasattr(tdaemon, "_group") and tdaemon._aio_read.batcher is not None
        for case in ("check_allowed", "check_denied", "check_group"):
            path, msg = READS[case]
            got, want = both_aio(tdaemon, jdaemon, path, msg)
            assert got == want, case
    finally:
        tdaemon.stop()
        jdaemon.stop()

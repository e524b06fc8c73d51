"""The port's CheckBatcher over the port's engine on the CPU, held against
keto_tpu's CheckBatcher over TPUCheckEngine on equal stores: rounds of 16
threads checking at once, with writes between the rounds, under both
table layouts and with the closure index on and off.

Per query the verdict and the store version its answer carries
(`check_batch_resolve_v`, through the batcher's futures) are equal, as
are the singleflight counts of each round (all of a round's checks land
in one collector window, so the coalesced riders are exactly the
repeats). Through an engine whose submit raises, the breaker opens as
keto_tpu's does with the same failure counts, but where keto_tpu answers
from its host oracle the port fails every rider typed (500, then 503
with Retry-After while the breaker is open) and asks nothing of the
engine's host reference.
The engine's own resolve_v is held item by item on batches that mix
device answers, closure hits, closure leftovers (dirty after a write) and
host replays, and across a write landing between submit and resolve.

Every wait is bounded. Tolerance: exact equality.
"""

import copy
import random
import threading

import pytest

from keto_tpu.api.batcher import CheckBatcher as JBatcher
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.observability import Metrics
from keto_tpu.resilience import CircuitBreaker as JBreaker
from keto_tpu.storage import MemoryManager as JMemory

from keto_tpu_torch.api.batcher import CheckBatcher as TBatcher
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.errors import KetoError as TKetoError
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.resilience import CircuitBreaker as TBreaker

from test_torch_closure_maint import DEPTH, deep_namespaces, deep_tuples
from test_torch_kernel import layout, port_namespaces  # noqa: F401  (layout is a fixture)

WAIT_S = 60
THREADS = 16
ROUNDS = 3
# a window long enough that a round's 16 threads all land in one drain
WINDOW_S = 0.4


class Both:
    """Equal stores behind keto_tpu's engine and the port's Registry-held
    engine, each with its batcher."""

    def __init__(self, layout, closure, n_chains=6):
        tuples, self.owners = deep_tuples(n_chains=n_chains)
        cfg = {"dsn": "memory", "limit": {"max_read_depth": DEPTH + 4},
               "closure": {"enabled": closure}}
        jcfg = JConfig(cfg)
        jcfg.set_namespaces(deep_namespaces())
        self.jm = JMemory()
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.jax = TPUCheckEngine(self.jm, jcfg)
        tcfg = TConfig(cfg)
        tcfg.set_namespaces(port_namespaces(deep_namespaces()))
        self.registry = TRegistry(tcfg, device="cpu", layout=layout)
        self.tm = self.registry.relation_tuple_manager()
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])
        self.port = self.registry.check_engine()
        if closure:
            assert self.jax.closure_ensure_built() and self.port.closure_ensure_built()

    def write(self, inserts=(), deletes=()):
        self.jm.transact_relation_tuples([JTuple.from_string(s) for s in inserts],
                                         [JTuple.from_string(s) for s in deletes])
        self.tm.transact_relation_tuples([TTuple.from_string(s) for s in inserts],
                                         [TTuple.from_string(s) for s in deletes])
        assert self.jm.version() == self.tm.version()

    def close(self):
        self.port.stop_push_refresh()


def round_queries(owners, r, n_users=8):
    """Each thread's (query, max_depth) list: 4 draws from a pool of 24,
    so the round repeats some, at two depths (two collector groups)."""
    rng = random.Random(100 + r)
    pool = []
    for _ in range(24):
        c = rng.randrange(len(owners))
        sub = owners[c] if rng.random() < 0.5 else f"u{rng.randrange(n_users)}"
        pool.append(f"deep:c{c}f{rng.randrange(DEPTH)}#viewer@{sub}")
    pool.append(f"deep:c0f0#viewer@w{r}")  # a written owner, when there is one
    return [[(rng.choice(pool), 0 if t % 2 else DEPTH + 2) for _ in range(4)]
            for t in range(THREADS)]


def run_round(batcher, parse, per_thread):
    """Every thread submits its checks at once and waits for them:
    (allowed, version) by (thread, item)."""
    out = [[None] * len(qs) for qs in per_thread]
    errors = []
    start = threading.Barrier(len(per_thread))

    def worker(i):
        try:
            start.wait(timeout=WAIT_S)
            pendings = [batcher.submit(parse(q), depth) for q, depth in per_thread[i]]
            for j, p in enumerate(pendings):
                res, version = p.future.result(timeout=WAIT_S)
                out[i][j] = (res.allowed, version)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(per_thread))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=WAIT_S)
    assert not errors, errors
    return out


def jax_coalesced(m: Metrics) -> int:
    return int(m.check_coalesced_total._value.get())


@pytest.mark.parametrize("closure", [False, True], ids=["bfs", "closure"])
def test_concurrent_rounds_equal_keto_tpu(layout, closure):
    both = Both(layout, closure)
    metrics = Metrics()
    jb = JBatcher(both.jax, window_s=WINDOW_S, pipeline_depth=2, metrics=metrics)
    tb = TBatcher(both.port, window_s=WINDOW_S, pipeline_depth=2)
    try:
        for r in range(ROUNDS):
            if r:
                # one chain's owner moves: its nodes go dirty in the index
                both.write(inserts=[f"deep:c0f{DEPTH}#owner@w{r}"],
                           deletes=[f"deep:c0f{DEPTH}#owner@w{r - 1}"] if r > 1 else ())
            per_thread = round_queries(both.owners, r)
            coalesced_before = (tb.stats["coalesced"], jax_coalesced(metrics))
            got = run_round(tb, TTuple.from_string, per_thread)
            want = run_round(jb, JTuple.from_string, per_thread)
            assert got == want, r
            version = both.tm.version()
            assert {v for row in got for _a, v in row} <= {version, None}
            # one window, two depth groups: the repeats of each coalesce
            items = [qd for qs in per_thread for qd in qs]
            repeats = len(items) - len(set(items))
            assert tb.stats["coalesced"] - coalesced_before[0] == repeats
            assert jax_coalesced(metrics) - coalesced_before[1] == repeats
        stats = tb.stats
        assert sum(stats["check_batch_failed"].values()) == 0
        assert stats["batches"] == 2 * ROUNDS
        if closure:
            assert both.port.stats["closure_hits"] > 0
    finally:
        jb.close()
        tb.close()
        both.close()


class RaisingDevice:
    """A real engine whose device submit raises. keto_tpu's batcher
    answers from its host oracle (check_batch_host); the port's never
    asks for one."""

    def __init__(self, engine):
        self.engine = engine

    def check_batch_submit(self, tuples, depth=0):
        raise RuntimeError("device wedge")

    def check_batch_host(self, tuples, depth=0):
        return self.engine.check_batch_host(tuples, depth)


def _typed(fn):
    try:
        return ("ok", fn())
    except TKetoError as e:
        return (type(e).__name__, e.status, getattr(e, "retry_after_s", None) is not None)


def test_device_failure_fails_riders_typed(layout):
    both = Both(layout, closure=False, n_chains=3)
    metrics = Metrics()
    jbr, tbr = JBreaker(threshold=2, cooldown_s=60.0), TBreaker(threshold=2, cooldown_s=60.0)
    jb = JBatcher(RaisingDevice(both.jax), window_s=0.0, breaker=jbr, metrics=metrics)
    tb = TBatcher(RaisingDevice(both.port), window_s=0.0, breaker=tbr)
    try:
        queries = [f"deep:c{c}f{f}#viewer@{both.owners[c]}" for c in range(3) for f in (0, 4)]
        queries += ["deep:c0f0#viewer@nobody", "ghost:o#r@u"]
        got = [_typed(lambda q=q: tb.check_versioned(TTuple.from_string(q))) for q in queries]
        want = [(r.allowed, v) for r, v in
                (jb.check_versioned(JTuple.from_string(q)) for q in queries)]
        # keto_tpu answers every check from its host oracle
        assert [a for a, _v in want] == [True] * 6 + [False] * 2
        # the port: two device failures (500), then the open breaker (503)
        assert got == [("CheckBatchFailedError", 500, False)] * 2 + \
            [("StoreUnavailableError", 503, True)] * (len(queries) - 2)
        stats = tb.stats
        assert stats["check_batch_failed"]["device"] == \
            int(metrics.check_batch_failed_total.labels("device")._value.get()) == 2
        assert stats["shed"]["breaker_open"] == len(queries) - 2
        assert list(tbr.transitions) == list(jbr.transitions) == ["open"]
        assert both.port.stats["host_checks"] == both.port.stats["device_checks"] == 0
    finally:
        jb.close()
        tb.close()
        both.close()


def _resolve_v(engine, parse, queries, between=None):
    handle = engine.check_batch_submit([parse(q) for q in queries], 0)
    if between is not None:
        between()
    results, versions = engine.check_batch_resolve_v(handle)
    return [(r.allowed, v) for r, v in zip(results, versions)]


@pytest.mark.parametrize("closure", [False, True], ids=["bfs", "closure"])
def test_resolve_v_versions_equal_keto_tpu(layout, closure):
    """Device answers and closure hits at the state's covered version,
    closure leftovers (dirty after a write) at their sub-batch's, host
    replays (an unknown namespace, a dirty row) None; and a write landing
    between submit and resolve leaves the submitted state's version on
    what the submit evaluated."""
    both = Both(layout, closure, n_chains=4)
    try:
        queries = [f"deep:c{c}f{f}#viewer@{both.owners[c]}" for c in range(4) for f in (0, 5)]
        queries += ["deep:c1f2#viewer@nobody", "ghost:o#r@u", "deep:c0f0#viewer@w1"]
        assert _resolve_v(both.port, TTuple.from_string, queries) == \
            _resolve_v(both.jax, JTuple.from_string, queries)
        both.write(inserts=[f"deep:c0f{DEPTH}#owner@w1", "deep:c2f3#owner@w1"])
        got = _resolve_v(both.port, TTuple.from_string, queries)
        assert got == _resolve_v(both.jax, JTuple.from_string, queries)
        assert got[-1] == (True, both.tm.version()) or got[-1] == (True, None)
        assert any(v is None for _a, v in got)  # host-replayed items
        v_submit = both.tm.version()

        def write_tpu():
            both.jm.write_relation_tuples([JTuple.from_string("deep:c3f1#owner@late")])

        def write_port():
            both.tm.write_relation_tuples([TTuple.from_string("deep:c3f1#owner@late")])

        late = queries + ["deep:c3f1#viewer@late"]
        got = _resolve_v(both.port, TTuple.from_string, late, write_port)
        assert got == _resolve_v(both.jax, JTuple.from_string, late, write_tpu)
        if closure:
            # a closure batch's leftovers ride the BFS at resolve, after
            # the write: their sub-batch's version
            assert {v for _a, v in got} <= {v_submit, v_submit + 1, None}
        else:
            assert {v for _a, v in got} <= {v_submit, None}
            assert got[-1][0] is False  # evaluated at the submitted state
        if closure:
            assert both.port.stats["closure_hits"] > 0
            assert sum(both.port.stats["closure_fallback"].values()) > 0
    finally:
        both.close()


def test_counters_hold_under_thread_stress():
    """Many more threads than cores count into the engine's stats (checks,
    expands, lists) and the serving counters at once, with the interpreter
    switching threads as often as it can: no count is lost."""
    import sys

    from keto_tpu_torch.ketoapi import SubjectSet as TSubjectSet
    from keto_tpu_torch.resilience import ServeCounters

    both = Both("bucketized", closure=False, n_chains=3)
    engine, counters = both.port, ServeCounters()
    queries = [TTuple.from_string(f"deep:c{c}f{f}#viewer@{both.owners[c]}")
               for c in range(3) for f in range(3)] + [TTuple.from_string("ghost:o#r@u")]
    engine.check_batch(queries)  # the mirror, built once
    engine.expand(TSubjectSet("deep", "c0f0", "parent"))
    engine.list_objects("deep", "viewer", both.owners[0])
    before = copy.deepcopy(engine.stats)
    n_threads, rounds = 16, 1
    errors = []

    def worker():
        try:
            for _ in range(rounds):
                engine.check_batch(queries)
                engine.expand(TSubjectSet("deep", "c0f0", "parent"))
                engine.list_objects("deep", "viewer", both.owners[0])
                counters.inc("batches")
                counters.inc("shed", "queue_full", n=2)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=worker, daemon=True) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT_S)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        both.close()
    assert not errors, errors
    calls = n_threads * rounds
    after = engine.stats

    def grew(*keys):
        return sum(after[k] - before[k] for k in keys)

    assert grew("device_checks", "host_checks") == calls * len(queries)
    assert after["host_cause"]["unindexed"] - before["host_cause"]["unindexed"] == calls
    assert grew("device_expands", "host_expands") == calls
    assert grew("device_list_objects", "host_list_objects") == calls
    snap = counters.snapshot()
    assert snap["batches"] == calls and snap["shed"]["queue_full"] == 2 * calls

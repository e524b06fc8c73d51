"""The port's closure index maintenance (keto_tpu_torch.engine.closure's
catch_up, apply_changes and refresh_dirty, the engine's inline catch-up,
and keto_tpu_torch.closure's maintainer) held against keto_tpu's on the
same store sequence, on the CPU, under both table layouts and with
closure.powering "host" and "device" (P1-P3's plain versions).

Every scenario of tests/test_closure.py's TestChurn, TestMaintainer and
TestVersionGating::test_dirty_overflow_goes_stale_not_wrong runs on a
TorchCheckEngine(device="cpu") and a TPUCheckEngine over equal stores;
after each step the two hold equal:
  - the dirty key set, the cd_pack array and the view's has_dirty and
    synced version (same_index);
  - C1's packed result vector on the installed views, has_dirty set
    whenever nodes are dirty, bit for bit (same_closure_vector);
  - the build's seven arrays, merged after each refresh;
  - the index counters (applied_ops, dirty_nodes, refreshes,
    scoped_refreshes, refresh_rows_read, full_refresh_reads,
    rebuild_pending, builds, device_builds, ...);
  - the engines' closure_hits and closure_fallback by cause;
  - every verdict, which also equals the port's host oracle's.
The maintainer scenarios drive keto_tpu's Registry-held maintainer and
the port's Registry-held one; their pass and rebuild counts agree (the
Watch events each drains depend on when its hub's tailer thread
broadcast, so they are not compared here: tests/test_torch_watch.py
holds the drain).

Also: a writer committing between a refresh's two version reads (the
re-marked nodes stay dirty), the `_marks_gen` abort, a truncated change
log (stale, then stuck over the same base), the full-store read past the
region walk's budget, the maintainer's commit listener on the Watch hub
registered once over start/stop/start, and `serve`'s Daemon running the
maintainer.

Tolerance: exact equality; every output is an integer or a verdict.
"""

import random
import time

import numpy as np
import pytest

import keto_tpu.engine.closure as jcl
import keto_tpu.storage.memory as jmemory
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.namespace import Namespace as JNamespace
from keto_tpu.namespace.ast import (
    ComputedSubjectSet,
    Relation,
    SubjectSetRewrite,
    TupleToSubjectSet,
)
from keto_tpu.registry import Registry
from keto_tpu.storage import MemoryManager as JMemory

import keto_tpu_torch.storage.memory as tmemory
from keto_tpu_torch.api.daemon import Daemon as TDaemon
from keto_tpu_torch.closure import ClosureMaintainer
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine import closure as tcl
from keto_tpu_torch.engine.closure_kernel import CL_CAUSE_DIRTY
from keto_tpu_torch.engine.definitions import Membership
from keto_tpu_torch.engine.reference import ReferenceEngine as TReference
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.storage import MemoryManager as TMemory

from test_torch_closure import same_closure_vector, same_index
from test_torch_kernel import layout, port_namespaces  # noqa: F401  (layout is a fixture)

DEPTH = 9
POWERINGS = ["host", "device"]


def deep_namespaces():
    return [JNamespace(name="deep", relations=[
        Relation(name="owner"), Relation(name="parent"),
        Relation(name="viewer", subject_set_rewrite=SubjectSetRewrite(children=[
            ComputedSubjectSet(relation="owner"),
            TupleToSubjectSet(relation="parent", computed_subject_set_relation="viewer"),
        ])),
    ])]


def deep_tuples(n_chains=6, n_users=8, seed=3):
    """tests/test_closure.py's chains: DEPTH parent hops, a tail owner."""
    rng = random.Random(seed)
    tuples, owners = [], {}
    for c in range(n_chains):
        tuples += [f"deep:c{c}f{i}#parent@(deep:c{c}f{i + 1}#...)" for i in range(DEPTH)]
        owners[c] = f"u{rng.randrange(n_users)}"
        tuples.append(f"deep:c{c}f{DEPTH}#owner@{owners[c]}")
    return tuples, owners


def deep_queries(owners, n=64, n_users=8, seed=11):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        c = rng.randrange(len(owners))
        f = rng.randrange(DEPTH)
        sub = owners[c] if i % 2 == 0 else f"u{rng.randrange(n_users)}"
        out.append(f"deep:c{c}f{f}#viewer@{sub}")
    return out


def config_dict(max_depth=DEPTH + 4, **closure):
    return {"limit": {"max_read_depth": max_depth}, "closure": {"enabled": True, **closure}}


class Pair:
    """One store sequence behind both engines, the closure on."""

    def __init__(self, layout, powering, tuples, jm=None, tm=None, **closure):
        cfg = config_dict(powering=powering, **closure)
        self.jcfg, self.tcfg = JConfig(cfg), TConfig(cfg)
        self.jcfg.set_namespaces(deep_namespaces())
        self.tcfg.set_namespaces(port_namespaces(deep_namespaces()))
        self.jm = jm if jm is not None else JMemory()
        self.tm = tm if tm is not None else TMemory()
        self.write(tuples)
        self.jax = TPUCheckEngine(self.jm, self.jcfg, frontier_cap=4096)
        self.port = TorchCheckEngine(self.tm, self.tcfg, device="cpu", frontier_cap=4096,
                                     layout=layout)
        self.oracle = TReference(self.tm, self.tcfg)

    @property
    def tidx(self):
        return self.port.closure_index()

    @property
    def jidx(self):
        return self.jax.closure_index()

    def write(self, ss):
        if ss:
            self.jm.write_relation_tuples([JTuple.from_string(s) for s in ss])
            self.tm.write_relation_tuples([TTuple.from_string(s) for s in ss])

    def delete(self, ss):
        self.jm.delete_relation_tuples([JTuple.from_string(s) for s in ss])
        self.tm.delete_relation_tuples([TTuple.from_string(s) for s in ss])

    def ensure(self):
        """closure_ensure_built on both (catch-up and dirty refresh)."""
        ready = self.port.closure_ensure_built()
        assert ready == self.jax.closure_ensure_built()
        self.same()
        return ready

    def catch_up(self):
        got = self.tidx.catch_up(self.tm, self.tm.version())
        assert got == self.jidx.catch_up(self.jm, self.jm.version())
        self.same()
        return got

    def check(self, queries, depth=0):
        """Verdicts of both engines and the oracle, then the indexes, the
        C1 vectors over the same queries and the engines' closure counts."""
        got = self.port.check_batch([TTuple.from_string(s) for s in queries], depth)
        want = self.jax.check_batch([JTuple.from_string(s) for s in queries], depth)
        for s, g, w in zip(queries, got, want):
            assert g.membership.value == w.membership.value, s
            assert g.membership == self.oracle.check_relation_tuple(
                TTuple.from_string(s), depth).membership, s
        self.same(queries)
        return got

    def same(self, queries=()):
        same_index(self.tidx, self.jidx)
        same_closure_vector(self.port, self.jax, list(queries) or ["deep:c0f0#viewer@u0"])
        assert self.port.stats["closure_hits"] == self.jax.stats.get("closure_hits", 0)
        assert self.port.stats["closure_fallback"] == self.jax.stats.get("closure_fallback", {})

    def fallback(self, cause):
        return self.port.stats["closure_fallback"].get(cause, 0)


def key(engine, obj, rel):
    node = engine.ensure_state().view.encode_node("deep", obj, rel)
    return node[0] * engine.closure_index()._graph.R + node[1]


# -- tests/test_closure.py TestChurn ------------------------------------------------------


@pytest.mark.parametrize("powering", POWERINGS)
def test_write_then_check_is_never_stale(layout, powering):
    tuples, owners = deep_tuples()
    p = Pair(layout, powering, tuples)
    assert p.ensure()
    rng = random.Random(5)
    for r in range(20):
        c = rng.randrange(len(owners))
        p.write([f"deep:c{c}f{rng.randrange(DEPTH + 1)}#owner@w{r}"])
        got = p.check(deep_queries(owners, n=8, seed=r) + [f"deep:c{c}f0#viewer@w{r}"])
        assert got[-1].membership == Membership.IS_MEMBER
    # the churn produced hits and dirty fallbacks; C1 ran with has_dirty
    assert p.port.stats["closure_hits"] > 0 and p.fallback("dirty") > 0
    assert p.tidx._view.has_dirty


@pytest.mark.parametrize("powering", POWERINGS)
def test_refresh_reads_proportional_to_dirty_set(layout, powering):
    tuples, _owners = deep_tuples(n_chains=24)
    p = Pair(layout, powering, tuples)
    assert p.ensure()
    p.write([f"deep:c3f{DEPTH}#owner@fresh"])
    assert p.ensure()
    assert p.tidx.stats["scoped_refreshes"] == 1 and p.tidx.stats["full_refresh_reads"] == 0
    assert 0 < p.tidx.stats["refresh_rows_read"] <= 3 * (DEPTH + 2)
    assert p.tidx.last_refresh["scoped"] and p.tidx.last_refresh["sources"] > 0
    assert p.check(["deep:c3f0#viewer@fresh"])[0].membership == Membership.IS_MEMBER


@pytest.mark.parametrize("powering", POWERINGS)
def test_scoped_refresh_marks_future_writes(layout, powering):
    tuples, _owners = deep_tuples(n_chains=4)
    p = Pair(layout, powering, tuples)
    assert p.ensure()
    p.write([f"deep:c1f{DEPTH}#parent@(deep:newtail#...)", "deep:newtail#owner@tailowner"])
    assert p.ensure()
    q = ["deep:c1f0#viewer@tailowner"]
    assert p.check(q)[0].membership == Membership.IS_MEMBER
    p.delete(["deep:newtail#owner@tailowner"])
    assert p.ensure()
    assert p.check(q)[0].membership == Membership.NOT_MEMBER


@pytest.mark.parametrize("powering", POWERINGS)
def test_held_tail_lag_gating(layout, powering):
    """Lag budget 0: no inline catch-up, the batch falls back with lag."""
    tuples, owners = deep_tuples()
    p = Pair(layout, powering, tuples, lag_budget_versions=0)
    assert p.ensure()
    q_hit = f"deep:c0f0#viewer@{owners[0]}"
    p.check([q_hit])
    assert p.port.stats["closure_hits"] == 1
    p.write(["deep:c0f9#owner@late"])
    assert p.check(["deep:c0f0#viewer@late"])[0].membership == Membership.IS_MEMBER
    assert p.fallback("lag") == 1
    assert p.tidx.lag_versions(p.tm.version()) == 1
    assert p.ensure()
    assert p.tidx.stats["refreshes"] >= 1 and p.tidx.describe()["dirty_nodes"] == 0
    hits = p.port.stats["closure_hits"]
    got = p.check([f"deep:c1f0#viewer@{owners[1]}", q_hit, "deep:c0f0#viewer@late"])
    assert p.port.stats["closure_hits"] == hits + 3
    assert got[2].membership == Membership.IS_MEMBER


@pytest.mark.parametrize("powering", POWERINGS)
def test_overlay_relation_edges_stay_dirty_not_wrong(layout, powering):
    tuples, owners = deep_tuples()
    p = Pair(layout, powering, tuples)
    assert p.ensure()
    p.write(["deep:c0f5#parent@(other:x#g)", "other:x#g@newbie"])
    assert p.ensure()
    assert p.tidx._dirty  # the unkeyable region stays dirty
    assert p.check(["deep:c0f5#parent@newbie"])[0].membership == Membership.IS_MEMBER
    assert p.fallback("dirty") >= 1
    hits = p.port.stats["closure_hits"]
    p.check([f"deep:c1f0#viewer@{owners[1]}"])
    assert p.port.stats["closure_hits"] == hits + 1


@pytest.mark.parametrize("powering", POWERINGS)
def test_write_at_refreshed_overlay_object_still_marks(layout, powering):
    tuples, _owners = deep_tuples()
    p = Pair(layout, powering, tuples)
    assert p.ensure()
    p.write([f"deep:c0f{DEPTH}#parent@(deep:c0tail#...)"])
    assert p.ensure()
    assert p.tidx.describe()["dirty_nodes"] == 0
    p.write(["deep:c0tail#owner@phantom"])
    assert p.ensure()
    assert p.check(["deep:c0f0#viewer@phantom"])[0].membership == Membership.IS_MEMBER


@pytest.mark.parametrize("powering", POWERINGS)
def test_empty_store_cold_start_gains_coverage(layout, powering):
    p = Pair(layout, powering, [])
    assert p.ensure()
    tuples, owners = deep_tuples(n_chains=2)
    p.write(tuples)
    assert p.ensure()
    assert p.check([f"deep:c0f0#viewer@{owners[0]}"])[0].membership == Membership.IS_MEMBER
    assert p.port.stats["closure_hits"] == 1


@pytest.mark.parametrize("powering", POWERINGS)
def test_dirty_marks_transitive_ancestors_only(layout, powering):
    tuples, owners = deep_tuples()
    p = Pair(layout, powering, tuples)
    assert p.ensure()
    p.write(["deep:c2f5#owner@noob"])
    assert p.catch_up()
    dirty = p.tidx._dirty
    for f in (0, 3, 5):
        assert key(p.port, f"c2f{f}", "viewer") in dirty
    assert key(p.port, "c3f0", "viewer") not in dirty
    assert key(p.port, "c2f6", "viewer") not in dirty
    # C1 with the cd table: the chain's heads are dirty, the others hit
    vec = same_closure_vector(p.port, p.jax, [f"deep:c2f0#viewer@{owners[2]}",
                                              f"deep:c3f0#viewer@{owners[3]}"])
    assert vec[2:4].tolist() == [CL_CAUSE_DIRTY, 0]


# -- tests/test_closure.py TestMaintainer -------------------------------------------------


class Maintained:
    """keto_tpu's Registry-held engine and maintainer, and the port's
    Registry-held engine and maintainer, on equal stores."""

    def __init__(self, layout, powering, **closure):
        tuples, self.owners = deep_tuples()
        cfg = {"dsn": "memory", **config_dict(powering=powering, **closure)}
        jcfg = JConfig(cfg)
        jcfg.set_namespaces(deep_namespaces())
        self.reg = Registry(jcfg)
        self.jm = self.reg.relation_tuple_manager()
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.jax = self.reg.check_engine()
        self.jmaint = self.reg.closure_maintainer()
        self.reg.watch_hub()  # the write hooks live
        tcfg = TConfig({**cfg, "check": {"frontier_cap": 4096}})
        tcfg.set_namespaces(port_namespaces(deep_namespaces()))
        self.treg = TRegistry(tcfg, device="cpu", layout=layout)
        self.tm = self.treg.relation_tuple_manager()
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])
        self.port = self.treg.check_engine()
        self.tmaint = self.treg.closure_maintainer()
        self.oracle = TReference(self.tm, tcfg)

    def write(self, s):
        self.jm.write_relation_tuples([JTuple.from_string(s)])
        self.tm.write_relation_tuples([TTuple.from_string(s)])

    def step(self):
        self.tmaint.step()
        self.jmaint.step()
        self.same()

    def same(self):
        same_index(self.port.closure_index(), self.jax.closure_index())
        for k in ("passes", "rebuilds"):
            assert self.tmaint.stats[k] == self.jmaint.stats[k], k
        assert self.port.stats["closure_hits"] == self.jax.stats.get("closure_hits", 0)
        assert self.port.stats["closure_fallback"] == self.jax.stats.get("closure_fallback", {})

    def check(self, s):
        got = self.port.check_batch([TTuple.from_string(s)])[0]
        want = self.jax.check_batch([JTuple.from_string(s)])[0]
        assert got.membership.value == want.membership.value
        assert got.membership == self.oracle.check_relation_tuple(TTuple.from_string(s)).membership
        return got

    def wait_synced(self, idx, manager, deadline_s=10.0):
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            if not idx.needs_rebuild() and idx.lag_versions(manager.version()) == 0 \
                    and idx.describe()["dirty_nodes"] == 0:
                return
            time.sleep(0.02)
        raise AssertionError(f"not synced: {idx.describe()}")

    def stop(self):
        self.tmaint.stop()
        self.jmaint.stop()


@pytest.mark.parametrize("powering", POWERINGS)
def test_maintainer_step_applies_writes(layout, powering):
    m = Maintained(layout, powering)
    m.step()  # the first powering
    assert not m.port.closure_index().needs_rebuild()
    assert m.tmaint.stats["rebuilds"] == 1
    m.write("deep:c0f9#owner@tailed")
    m.step()
    idx = m.port.closure_index()
    assert idx.lag_versions(m.tm.version()) == 0
    assert idx.stats["refreshes"] >= 1 and idx.describe()["dirty_nodes"] == 0
    assert m.check("deep:c0f0#viewer@tailed").membership == Membership.IS_MEMBER
    assert m.port.stats["closure_hits"] >= 1
    m.same()


@pytest.mark.parametrize("powering", POWERINGS)
def test_refused_universe_is_extracted_once_per_base(layout, powering, monkeypatch):
    """A base whose universe passes MAX_CLOSURE_NODES: the maintainer's
    passes over it extract the graph once, not on every pass; the index
    stays off, the stats and verdicts equal keto_tpu's."""
    monkeypatch.setattr(tcl, "MAX_CLOSURE_NODES", 4)
    monkeypatch.setattr(jcl, "MAX_CLOSURE_NODES", 4)
    calls = []
    extract = tcl.extract_graph
    monkeypatch.setattr(tcl, "extract_graph", lambda *a, **k: calls.append(1) or extract(*a, **k))
    m = Maintained(layout, powering)
    m.step()
    m.step()
    m.write("deep:c0f9#owner@refused")
    m.step()
    idx = m.port.closure_index()
    assert len(calls) == 1
    assert idx.needs_rebuild() and idx.stats["builds"] == 0
    assert m.tmaint.stats["rebuilds"] == 0
    assert m.check("deep:c0f0#viewer@refused").membership == Membership.IS_MEMBER
    assert m.port.stats["closure_hits"] == 0
    m.same()


@pytest.mark.parametrize("powering", POWERINGS)
def test_background_thread_keeps_index_fresh(layout, powering):
    m = Maintained(layout, powering)
    for maint in (m.tmaint, m.jmaint):
        maint.poll_interval = 0.05
        maint.start()
    try:
        m.write("deep:c1f9#owner@bg")
        m.wait_synced(m.port.closure_index(), m.tm)
        m.wait_synced(m.jax.closure_index(), m.jm)
        assert m.check("deep:c1f0#viewer@bg").membership == Membership.IS_MEMBER
    finally:
        m.stop()
    # the passes differ by timing; the index state does not
    same_index(m.port.closure_index(), m.jax.closure_index())
    assert m.port.stats["closure_hits"] == m.jax.stats.get("closure_hits", 0) == 1


@pytest.mark.parametrize("powering", POWERINGS)
def test_held_maintainer_never_answers_stale(layout, powering):
    m = Maintained(layout, powering, lag_budget_versions=0)
    m.step()
    for maint in (m.tmaint, m.jmaint):
        maint.hold()
        maint.start()
    try:
        m.write("deep:c0f9#owner@held")
        assert m.check("deep:c0f0#viewer@held").membership == Membership.IS_MEMBER
        assert m.port.stats["closure_fallback"] == {tcl.CAUSE_LAG: 1}
        m.same()
        for maint in (m.tmaint, m.jmaint):
            maint.release()
        m.wait_synced(m.port.closure_index(), m.tm)
        m.wait_synced(m.jax.closure_index(), m.jm)
    finally:
        m.stop()
    same_index(m.port.closure_index(), m.jax.closure_index())
    assert m.check("deep:c0f0#viewer@held").membership == Membership.IS_MEMBER
    assert m.port.stats["closure_hits"] == m.jax.stats.get("closure_hits", 0) == 1


# -- tests/test_closure.py TestVersionGating ----------------------------------------------


@pytest.mark.parametrize("powering", POWERINGS)
def test_dirty_overflow_goes_stale_not_wrong(layout, powering, monkeypatch):
    tuples, _owners = deep_tuples()
    p = Pair(layout, powering, tuples)
    assert p.ensure()
    monkeypatch.setattr(tcl, "DIRTY_COMPACT_THRESHOLD", 1)
    monkeypatch.setattr(jcl, "DIRTY_COMPACT_THRESHOLD", 1)
    p.write(["deep:c0f9#owner@burst", "deep:c1f9#owner@burst"])
    assert not p.catch_up()
    assert p.tidx.needs_rebuild() and p.tidx.stats["rebuild_pending"] == 1
    p.check(["deep:c0f0#viewer@burst"])
    assert p.fallback("stale_snapshot") >= 1
    # stuck over the same base: no powering until a new base
    assert not p.ensure()
    assert p.tidx.stats["builds"] == 1


# -- the race protocol, the change log, the walk budget ----------------------------------


class _WritesOnce:
    """A store whose next get_relation_tuples commits `pending` first:
    a writer landing between a refresh's v1 and v2 version reads."""

    pending: list = []
    cls = None

    def get_relation_tuples(self, *args, **kw):
        if self.pending:
            batch, self.pending = self.pending, []
            self.write_relation_tuples([self.cls.from_string(s) for s in batch])
        return super().get_relation_tuples(*args, **kw)


class JWritesOnce(_WritesOnce, JMemory):
    cls = JTuple


class TWritesOnce(_WritesOnce, TMemory):
    cls = TTuple


@pytest.mark.parametrize("powering", POWERINGS)
def test_write_between_refresh_reads_stays_dirty(layout, powering):
    """Chains 0 and 2 are dirty when the refresh starts; a write at
    chains 0 and 1 commits during its region read. Only chain 2 is
    refreshed: chain 0 was re-marked, chain 1 newly marked."""
    tuples, owners = deep_tuples()
    p = Pair(layout, powering, tuples, jm=JWritesOnce(), tm=TWritesOnce())
    assert p.ensure()
    p.write(["deep:c0f9#owner@first", "deep:c2f9#owner@first"])
    p.check(["deep:c0f0#viewer@first"])
    p.jm.pending = p.tm.pending = ["deep:c0f8#owner@late", "deep:c1f9#owner@late"]
    v1 = p.tm.version()
    assert p.ensure()
    assert p.tm.version() == v1 + 1 and p.tidx._synced_version == v1 + 1
    assert p.tidx.stats["refreshes"] == 1 and p.tidx.last_refresh["sources"] > 0
    dirty = p.tidx._dirty
    assert key(p.port, "c2f0", "viewer") not in dirty
    assert key(p.port, "c0f0", "viewer") in dirty and key(p.port, "c1f0", "viewer") in dirty
    got = p.check(["deep:c0f0#viewer@first", "deep:c0f0#viewer@late", "deep:c1f0#viewer@late",
                   "deep:c2f0#viewer@first", f"deep:c3f0#viewer@{owners[3]}"])
    assert all(r.membership == Membership.IS_MEMBER for r in got)
    assert p.fallback("dirty") >= 3
    assert p.ensure()  # the next pass refreshes chains 0 and 1
    assert p.tidx.describe()["dirty_nodes"] == 0


@pytest.mark.parametrize("powering", POWERINGS)
def test_marks_after_the_remark_read_abort_the_install(layout, powering, monkeypatch):
    """A catch-up that marks while the refresh packs: the install aborts
    (the marks would be cleared past the synced version), nothing of the
    refresh lands, and the next pass refreshes both."""
    tuples, owners = deep_tuples()
    p = Pair(layout, powering, tuples)
    assert p.ensure()
    p.write(["deep:c0f9#owner@first"])
    p.check(["deep:c0f0#viewer@first"])
    builds = (p.tidx._build, p.jidx._build)
    for mod, idx, store, cls in ((tcl, p.tidx, p.tm, TTuple), (jcl, p.jidx, p.jm, JTuple)):
        pack = mod.pack_closure_tables

        def racing(*args, _pack=pack, _idx=idx, _store=store, _cls=cls):
            _store.write_relation_tuples([_cls.from_string("deep:c1f9#owner@racer")])
            assert _idx.catch_up(_store, _store.version())
            return _pack(*args)

        monkeypatch.setattr(mod, "pack_closure_tables", racing)
    p.port.closure_ensure_built()
    p.jax.closure_ensure_built()
    monkeypatch.undo()
    assert (p.tidx._build, p.jidx._build) == builds
    assert p.tidx.stats["refreshes"] == 0
    assert key(p.port, "c0f0", "viewer") in p.tidx._dirty
    assert key(p.port, "c1f0", "viewer") in p.tidx._dirty
    p.same()
    assert p.ensure()
    assert p.tidx.stats["refreshes"] == 1 and p.tidx.describe()["dirty_nodes"] == 0
    p.check(["deep:c0f0#viewer@first", "deep:c1f0#viewer@racer"])


@pytest.mark.parametrize("powering", POWERINGS)
def test_truncated_change_log_goes_stale_then_stuck(layout, powering, monkeypatch):
    monkeypatch.setattr(tmemory, "CHANGE_LOG_CAP", 4)
    monkeypatch.setattr(jmemory, "CHANGE_LOG_CAP", 4)
    tuples, owners = deep_tuples()
    p = Pair(layout, powering, [])
    p.write(tuples)  # one call: one version
    assert p.ensure()
    state, jstate = p.port.ensure_state(), p.jax._ensure_state()
    for i in range(6):
        p.write([f"deep:c{i % 6}f{DEPTH}#owner@gone{i}"])
    assert not p.catch_up()  # the log no longer reaches the synced version
    assert p.tidx.needs_rebuild()
    builds = p.tidx.stats["builds"]
    # over the same base the index is stuck: nothing is powered
    assert not p.tidx.ensure_for(state, p.tm, DEPTH + 4)
    assert not p.jidx.ensure_for(jstate, p.jm, DEPTH + 4)
    assert p.tidx.stats["builds"] == builds
    p.same()
    # the engine rebuilds its mirror from the store: a new base, powered
    p.check([f"deep:c0f0#viewer@{owners[0]}", "deep:c1f0#viewer@gone1"])
    assert p.fallback("stale_snapshot") >= 2
    assert p.ensure()
    assert p.tidx.stats["builds"] == builds + 1
    hits = p.port.stats["closure_hits"]
    got = p.check([f"deep:c0f0#viewer@{owners[0]}", "deep:c1f0#viewer@gone1"])
    assert p.port.stats["closure_hits"] == hits + 2
    assert all(r.membership == Membership.IS_MEMBER for r in got)


@pytest.mark.parametrize("powering", POWERINGS)
def test_region_past_the_walk_budget_reads_the_store(layout, powering):
    """A dirty node whose region holds more than 4,096 objects: the walk
    gives up and the refresh reads the whole store."""
    tuples, owners = deep_tuples(n_chains=2)
    tuples += [f"deep:hub#parent@(deep:k{i}#...)" for i in range(4100)]
    tuples += ["deep:k7#owner@u7"]
    p = Pair(layout, powering, tuples, max_set_rows=8)
    assert p.ensure()
    p.write(["deep:hub#owner@hubber"])
    assert p.ensure()
    assert p.tidx.stats["full_refresh_reads"] == 1 and p.tidx.stats["scoped_refreshes"] == 0
    assert p.tidx.stats["refresh_rows_read"] == len(tuples) + 1
    assert not p.tidx.last_refresh["scoped"]
    p.check(["deep:hub#viewer@hubber", "deep:hub#viewer@u7", f"deep:c0f0#viewer@{owners[0]}"])


# -- the maintainer's listener and serve ---------------------------------------------------


def test_maintainer_listener_registered_once_over_restarts():
    tuples, owners = deep_tuples(n_chains=2)
    cfg = TConfig(config_dict())
    cfg.set_namespaces(port_namespaces(deep_namespaces()))
    registry = TRegistry(cfg, device="cpu")
    tm = registry.relation_tuple_manager()
    tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])
    engine = registry.check_engine()
    maint = ClosureMaintainer(registry, poll_interval=30)
    # the store's one listener is the Watch hub; the hub's own commit
    # listener is the registry's (engine and cache pokes)
    hub = registry.watch_hub()
    assert tm._write_listeners == [hub.notify]
    assert len(hub._commit_listeners) == 1
    for _ in range(2):
        maint.start()
        maint.start()  # a second start is a no-op
        maint.stop()
    assert len(hub._commit_listeners) == 2
    maint.start()
    try:
        assert len(hub._commit_listeners) == 2 and len(tm._write_listeners) == 1
        engine.closure_ensure_built()
        passes = maint.stats["passes"]
        # a 30 s poll: only the write listener can wake the loop in time
        tm.write_relation_tuples([TTuple.from_string("deep:c0f9#owner@woken")])
        deadline = time.monotonic() + 10
        idx = engine.closure_index()
        while time.monotonic() < deadline and (
                maint.stats["passes"] == passes or idx.lag_versions(tm.version())
                or idx.describe()["dirty_nodes"]):
            time.sleep(0.02)
        assert maint.stats["passes"] > passes
        assert idx.lag_versions(tm.version()) == 0 and idx.stats["refreshes"] == 1
    finally:
        maint.stop()
    assert maint._thread is None
    res = engine.check_batch([TTuple.from_string("deep:c0f0#viewer@woken")])
    assert res[0].membership == Membership.IS_MEMBER and engine.stats["closure_hits"] == 1


def test_serve_runs_the_maintainer_with_the_closure_on():
    tuples, owners = deep_tuples(n_chains=2)
    cfg = TConfig({**config_dict(), "serve": {"read": {"host": "127.0.0.1", "port": 0},
                                              "write": {"host": "127.0.0.1", "port": 0}}})
    cfg.set_namespaces(port_namespaces(deep_namespaces()))
    registry = TRegistry(cfg, device="cpu")
    tm = registry.relation_tuple_manager()
    tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])
    # as `serve` does: the mirror and the index before the daemon
    registry.check_engine().closure_ensure_built()
    daemon = TDaemon(registry)
    daemon.start()
    try:
        maint = registry._closure_maintainer
        assert maint is not None and maint._thread.is_alive()
        idx = registry.check_engine().closure_index()
        assert not idx.needs_rebuild()
        tm.write_relation_tuples([TTuple.from_string("deep:c1f9#owner@served")])
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                idx.lag_versions(tm.version()) or idx.describe()["dirty_nodes"]):
            time.sleep(0.02)
        assert idx.lag_versions(tm.version()) == 0 and idx.stats["refreshes"] == 1
    finally:
        daemon.stop()
    assert maint._thread is None
    off = TConfig({"serve": {"read": {"host": "127.0.0.1", "port": 0},
                             "write": {"host": "127.0.0.1", "port": 0}}})
    off.set_namespaces(port_namespaces(deep_namespaces()))
    off_registry = TRegistry(off, device="cpu")
    daemon = TDaemon(off_registry)
    daemon.start()
    daemon.stop()
    assert off_registry._closure_maintainer is None

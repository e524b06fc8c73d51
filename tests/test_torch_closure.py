"""The port's Leopard closure (keto_tpu_torch.engine.closure, closure_kernel
and the engine's closure-routed Check) held against the JAX package's on
identical inputs, on the CPU.

- build: ClosureBuild's seven arrays, the packed cc/ch tables and both
  probe counts equal keto_tpu's power_closure's, over the tests/test_closure.py
  TestBuilderVsOracle shapes (deep chains, cycles, island poison,
  relation not found) in one store, at the default row cap and at a cap
  small enough to uncover the chains and the 32-subject hub
- vectors: closure_kernel_packed (the plain version of C1) returns the
  vector keto_tpu's returns, under both layouts, with and without a dirty
  table, over covered, uncovered, dirty, invalid and depth-gated queries,
  and on batches all invalid, all uncovered or all dirty and of 0 and 1
  queries
- engines: TorchCheckEngine(device="cpu") with the closure on answers
  like the oracle and TPUCheckEngine at every depth, with the same hit and
  fallback counts; a mixed batch merges in order, unknown vocabulary
  falls back, and a write marks the written chain dirty (dirty
  fallbacks, the rest hits), a refresh powers it again and a compaction
  gives the index a new base to power, each step equal to keto_tpu's
  index (same_index, the helpers tests/test_torch_closure_maint.py uses)

Tolerance: exact equality; every output is an integer or a verdict.
"""

import random

import numpy as np
import pytest
import torch

import keto_tpu.engine.closure as jcl
import keto_tpu.engine.closure_kernel as jck
import keto_tpu.engine.snapshot as jsnap
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.reference import ReferenceEngine as JReference
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.namespace import Namespace as JNamespace
from keto_tpu.namespace.ast import (
    ComputedSubjectSet,
    InvertResult,
    Operator,
    Relation,
    SubjectSetRewrite,
    TupleToSubjectSet,
)
from keto_tpu.storage import MemoryManager as JMemory

from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine import closure as tcl
from keto_tpu_torch.engine import closure_kernel as tck
from keto_tpu_torch.engine import snapshot as tsnap
from keto_tpu_torch.engine.definitions import Membership
from keto_tpu_torch.engine.reference import ReferenceEngine as TReference
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.storage import MemoryManager as TMemory

from test_torch_kernel import layout, port_namespaces  # noqa: F401  (layout is a fixture)

DEPTH = 9
B = 64
BUILD_FIELDS = ("covered_keys", "ent_obj", "ent_rel", "ent_skind", "ent_sa", "ent_sb",
                "ent_req")


# -- one store: every TestBuilderVsOracle shape under its own namespace -----------


def namespaces():
    deep = JNamespace(name="deep", relations=[
        Relation(name="owner"), Relation(name="parent"),
        Relation(name="viewer", subject_set_rewrite=SubjectSetRewrite(children=[
            ComputedSubjectSet(relation="owner"),
            TupleToSubjectSet(relation="parent", computed_subject_set_relation="viewer"),
        ])),
    ])
    acl = JNamespace(name="acl", relations=[
        Relation(name="allow"), Relation(name="deny"),
        Relation(name="access", subject_set_rewrite=SubjectSetRewrite(
            operation=Operator.AND,
            children=[ComputedSubjectSet(relation="allow"),
                      InvertResult(child=ComputedSubjectSet(relation="deny"))])),
        Relation(name="group"),
    ])
    return [deep, acl, JNamespace(name="g", relations=[Relation(name="member")]),
            JNamespace(name="cfg", relations=[Relation(name="member")]),
            JNamespace(name="big", relations=[Relation(name="member")])]


def tuples_and_owners(n_chains=6, n_users=8, seed=3):
    rng = random.Random(seed)
    tuples, owners = [], {}
    for c in range(n_chains):
        tuples += [f"deep:c{c}f{i}#parent@(deep:c{c}f{i + 1}#...)" for i in range(DEPTH)]
        owners[c] = f"u{rng.randrange(n_users)}"
        tuples.append(f"deep:c{c}f{DEPTH}#owner@{owners[c]}")
    # a few direct viewer grants mid-chain
    tuples += ["deep:c0f4#viewer@u7", "deep:c3f1#viewer@u2"]
    # cycles; an island and a node that reaches it; relation not found;
    # a hub wider than a small row cap
    tuples += ["g:x#member@(g:y#member)", "g:y#member@(g:x#member)", "g:x#member@alice"]
    tuples += ["acl:d#allow@u1", "acl:g#group@(acl:d#access)", "acl:h#group@u2"]
    tuples += ["cfg:a#member@(cfg:b#ghost)", "cfg:b#ghost@u1"]
    tuples += [f"big:hub#member@u{i}" for i in range(32)]
    return tuples, owners


def deep_queries(owners, n=48, n_users=8, seed=11):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        c = rng.randrange(len(owners))
        sub = owners[c] if i % 2 == 0 else f"u{rng.randrange(n_users)}"
        out.append(f"deep:c{c}f{rng.randrange(DEPTH)}#viewer@{sub}")
    return out


OTHER_QUERIES = [
    "g:x#member@alice", "g:y#member@alice", "g:y#member@bob",
    "acl:d#access@u1", "acl:g#group@u1", "acl:h#group@u2",
    "cfg:a#member@u1", "big:hub#member@u3", "big:hub#member@nobody",
    "deep:c0f4#viewer@u7", "deep:c3f0#viewer@u2",
    "deep:c0f0#viewer@martian", "nowhere:x#y@alice", "deep:c99f0#viewer@u1",
]


@pytest.fixture(scope="module")
def store():
    tuples, owners = tuples_and_owners()
    return namespaces(), tuples, owners


def _both_builds(store, layout, max_set_rows):
    ns, tuples, _owners = store
    jsn = jsnap.build_snapshot([JTuple.from_string(s) for s in tuples], ns)
    tsn = tsnap.build_snapshot([TTuple.from_string(s) for s in tuples], port_namespaces(ns),
                               layout=layout)
    jg, tg = jcl.extract_graph(jsn), tcl.extract_graph(tsn)
    depth = DEPTH + 4
    return (jsn, jg, jcl.power_closure(jg, jsn, depth, max_set_rows, 0),
            tsn, tg, tcl.power_closure(tg, tsn, depth, max_set_rows, 0))


# -- (a) the build ---------------------------------------------------------------------


@pytest.mark.parametrize("max_set_rows", [4096, 8])
def test_closure_build_and_tables_identical(store, layout, max_set_rows):
    jsn, jg, jb, tsn, tg, tb = _both_builds(store, layout, max_set_rows)
    assert tg.R == jg.R
    np.testing.assert_array_equal(tg.universe, jg.universe)
    for k in BUILD_FIELDS:
        got, want = getattr(tb, k), getattr(jb, k)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert (tb.n_entries, tb.n_nodes, tb.vocab_fp) == (jb.n_entries, jb.n_nodes, jb.vocab_fp)
    jt, jc, jh = jcl.pack_closure_tables(jb, jg.R)
    tt, tc, th = tcl.pack_closure_tables(tb, tg.R, layout)
    assert (tc, th) == (jc, jh)
    assert set(tt) == set(jt) == {"cc_pack", "ch_pack"}
    for k in tt:
        np.testing.assert_array_equal(tt[k], np.asarray(jt[k]), err_msg=k)

    def covered(ns, obj, rel):
        node = tsn.obj_slots[(tsn.ns_ids[ns], obj)] * tg.R + tsn.rel_ids[rel]
        return node in set(tb.covered_keys.tolist())

    # the shapes reached their coverage rules
    assert not covered("acl", "d", "access") and not covered("acl", "g", "group")
    assert covered("acl", "h", "group") and covered("g", "x", "member")
    assert not covered("cfg", "a", "member")
    assert covered("big", "hub", "member") == (max_set_rows >= 32)
    assert covered("deep", "c0f0", "viewer") == (max_set_rows >= 4096)


def test_empty_build_packs_like_jax(layout):
    """A build with no coverage and no entries packs the fixed empty
    tables."""
    tb = tcl.ClosureBuild(snapshot_version=0, base_version=0,
                          covered_keys=np.zeros(0, np.int64),
                          **{k: np.zeros(0, np.int32) for k in BUILD_FIELDS[1:]})
    jb = jcl.ClosureBuild(snapshot_version=0, base_version=0,
                          covered_keys=np.zeros(0, np.int64),
                          **{k: np.zeros(0, np.int32) for k in BUILD_FIELDS[1:]})
    tt, tc, th = tcl.pack_closure_tables(tb, 5, layout)
    jt, jc, jh = jcl.pack_closure_tables(jb, 5)
    assert (tc, th) == (jc, jh) == (1, 1)
    for k in tt:
        np.testing.assert_array_equal(tt[k], np.asarray(jt[k]))


# -- (b) the closure vector --------------------------------------------------------------


def _qpack(jsn, queries, depths):
    view = jsn
    q = np.zeros((7, B), np.int32)
    for i, (s, d) in enumerate(zip(queries, depths)):
        t = JTuple.from_string(s)
        q[2, i] = d
        node = view.encode_node(t.namespace, t.object, t.relation)
        if node is None:
            continue
        q[0, i], q[1, i] = node
        sub = view.encode_subject(t)
        q[3:6, i] = sub if sub is not None else (0, -2, 0)
        q[6, i] = 1
    return q


def _same_vector(jt, jcd, tt, q, jc, jh, has_dirty, layout):
    """keto_tpu's closure vector and the port's on the query pack q (the
    port's tables tt carrying its cd_pack); asserts them equal and
    returns the port's."""
    import jax.numpy as jnp

    want = np.asarray(jck.closure_kernel_packed(
        {**{k: jnp.asarray(v) for k, v in jt.items()}, "cd_pack": jnp.asarray(jcd)},
        jnp.asarray(q), cc_probes=jc, ch_probes=jh, has_dirty=has_dirty))
    got = tck.closure_kernel_packed(tck.closure_tables_from_numpy(tt, "cpu"),
                                    torch.from_numpy(q), cc_probes=jc, ch_probes=jh,
                                    has_dirty=has_dirty, layout=layout).numpy()
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("has_dirty", [False, True])
def test_closure_vector_identical(store, layout, has_dirty):
    jsn, jg, jb, tsn, tg, tb = _both_builds(store, layout, 4096)
    jt, jc, jh = jcl.pack_closure_tables(jb, jg.R)
    tt, _tc, _th = tcl.pack_closure_tables(tb, tg.R, layout)
    # the dirty table marks chain c1 and the island's neighbour
    keys = [jsn.obj_slots[(jsn.ns_ids["deep"], f"c1f{i}")] * jg.R + jsn.rel_ids["viewer"]
            for i in range(DEPTH)]
    keys.append(jsn.obj_slots[(jsn.ns_ids["acl"], "h")] * jg.R + jsn.rel_ids["group"])
    keys = np.array(keys, dtype=np.int64)
    jcd = jcl.build_dirty_table(keys, jg.R) if has_dirty else jcl.empty_dirty_table()
    tcd = tcl.build_dirty_table(keys, tg.R, layout) if has_dirty else tcl.empty_dirty_table()
    np.testing.assert_array_equal(tcd, jcd)
    tt["cd_pack"] = tcd

    _ns, _tuples, owners = store
    queries = (deep_queries(owners, n=40) + OTHER_QUERIES)[:B]
    rng = random.Random(5)
    depths = [rng.choice([1, 2, 3, 5, DEPTH + 2]) for _ in queries]
    q = _qpack(jsn, queries, depths)
    got = _same_vector(jt, jcd, tt, q, jc, jh, has_dirty, layout)
    member, cause, stats = tck.unpack_closure_results(got, B)
    # every cause occurred: resolved, uncovered, invalid, and dirty when on
    want_causes = {0, 1, 3} | ({2} if has_dirty else set())
    assert want_causes <= set(cause.tolist())
    assert member.sum() > 4 and stats[0] == 1 and stats[1] == B


@pytest.mark.parametrize("case", ["all_invalid", "all_uncovered", "all_dirty", "B0", "B1"])
def test_closure_vector_edge_batches_identical(store, layout, case):
    """The batches the kernel's stats tail and its loads must hold: every
    query invalid, every query valid but uncovered (objects no node has),
    every query covered but dirty, and batches of 0 and 1 queries; each
    vector equal to keto_tpu's."""
    jsn, jg, jb, _tsn, tg, tb = _both_builds(store, layout, 4096)
    jt, jc, jh = jcl.pack_closure_tables(jb, jg.R)
    tt, _tc, _th = tcl.pack_closure_tables(tb, tg.R, layout)
    _ns, _tuples, owners = store
    queries = (deep_queries(owners, n=40) + OTHER_QUERIES)[:B]
    q = _qpack(jsn, queries, [DEPTH + 2] * len(queries))
    jcd = jcl.empty_dirty_table()
    tt["cd_pack"] = tcl.empty_dirty_table()
    base = _same_vector(jt, jcd, tt, q, jc, jh, False, layout)
    cause = base[B : 2 * B]
    has_dirty = case == "all_dirty"
    if case == "all_invalid":
        q[6] = 0
    elif case == "all_uncovered":
        q[0] += 1 << 20
        q[6] = 1
    elif case == "all_dirty":
        q = np.ascontiguousarray(q[:, np.resize(np.flatnonzero(cause == 0), B)])
        keys = np.unique(q[0].astype(np.int64) * jg.R + q[1])
        jcd = jcl.build_dirty_table(keys, jg.R)
        tt["cd_pack"] = tcl.build_dirty_table(keys, tg.R, layout)
    else:
        q = np.ascontiguousarray(q[:, (cause == 0) & (base[:B] == 1)][:, : int(case[1])])
    n = q.shape[1]
    got = _same_vector(jt, jcd, tt, q, jc, jh, has_dirty, layout)
    member, got_cause, stats = tck.unpack_closure_results(got, n)
    want_cause = {"all_invalid": 3, "all_uncovered": 1, "all_dirty": 2}.get(case, 0)
    assert n == int(case[1:]) if case[0] == "B" else n == B
    assert (got_cause == want_cause).all() and member.sum() == (n if case == "B1" else 0)
    assert stats.tolist() == [1, n, n, 0 if case == "all_invalid" else n, member.sum(), 0, 0, 0]


# -- (c) the engines -----------------------------------------------------------------


INDEX_STATS = ("builds", "applied_ops", "dirty_nodes", "rebuild_pending", "refreshes",
               "scoped_refreshes", "refresh_rows_read", "full_refresh_reads", "device_builds",
               "device_fallbacks", "power_waves", "power_steps")


def same_index(tidx, jidx):
    """The port's closure index equal to keto_tpu's: the counters, the
    stale flag and synced version, the dirty key set, the (merged) build's
    arrays, and the installed view's flags and tables, cd_pack included."""
    for k in INDEX_STATS:
        assert tidx.stats[k] == jidx.stats.get(k, 0), k
    assert (tidx._stale, tidx._synced_version) == (jidx._stale, jidx._synced_version)
    assert tidx._dirty == jidx._dirty
    tb, jb = tidx._build, jidx._build
    assert (tb is None) == (jb is None)
    if tb is not None:
        for k in BUILD_FIELDS:
            assert getattr(tb, k).dtype == getattr(jb, k).dtype, k
            np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k), err_msg=k)
        assert tb.n_entries == jb.n_entries
    tv, jv = tidx._view, jidx._view
    assert (tv is None) == (jv is None)
    if tv is not None:
        assert (tv.has_dirty, tv.synced_version, tv.cc_probes, tv.ch_probes, tv.R) == (
            jv.has_dirty, jv.synced_version, jv.cc_probes, jv.ch_probes, jv.R)
        assert set(tv.tables) == set(jv.tables) == {"cc_pack", "ch_pack", "cd_pack"}
        for k in tv.tables:
            np.testing.assert_array_equal(tv.tables[k].numpy(), np.asarray(jv.tables[k]),
                                          err_msg=k)


def same_closure_vector(port, jax_engine, queries, depth=0):
    """C1's packed result vector on both engines' current views, for one
    query pack encoded under the port's mirror: bit for bit, whatever
    has_dirty the views carry. Returns the port's vector (None when
    neither view serves)."""
    import jax.numpy as jnp

    from keto_tpu_torch.engine.kernel import pack_queries
    from keto_tpu_torch.engine.snapshot import encode_query_batch

    state = port.ensure_state()
    tview, cause = port.closure_index().view_for(state)
    jview, jcause = jax_engine.closure_index().view_for(jax_engine._ensure_state())
    assert cause == jcause
    if tview is None:
        return None
    tuples = [TTuple.from_string(s) for s in queries]
    n = max(len(tuples), 1)
    Bq = 1 << (n - 1).bit_length()
    q_obj, q_rel, q_skind, q_sa, q_sb, q_valid = encode_query_batch(state.view, tuples, Bq)
    depth = depth or port.config.max_read_depth()
    q = pack_queries(q_obj, q_rel, np.full(Bq, depth, np.int32), q_skind, q_sa, q_sb, q_valid)
    got = tck.closure_kernel_packed(tview.tables, torch.from_numpy(q), cc_probes=tview.cc_probes,
                                    ch_probes=tview.ch_probes, has_dirty=tview.has_dirty,
                                    layout=tview.layout).numpy()
    want = np.asarray(jck.closure_kernel_packed(
        jview.tables, jnp.asarray(q), cc_probes=jview.cc_probes, ch_probes=jview.ch_probes,
        has_dirty=jview.has_dirty))
    np.testing.assert_array_equal(got, want)
    return got


class Pair:
    """One store and config behind both engines (closure on) and both
    oracles."""

    def __init__(self, ns, tuples, max_depth=DEPTH + 4, layout="bucketized", **closure):
        cfg = {"limit": {"max_read_depth": max_depth}, "closure": {"enabled": True, **closure}}
        self.jcfg, self.tcfg = JConfig(cfg), TConfig(cfg)
        self.jcfg.set_namespaces(ns)
        self.tcfg.set_namespaces(port_namespaces(ns))
        self.jm, self.tm = JMemory(), TMemory()
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])
        self.jax = TPUCheckEngine(self.jm, self.jcfg, frontier_cap=4096)
        self.port = TorchCheckEngine(self.tm, self.tcfg, device="cpu", frontier_cap=4096,
                                     layout=layout)
        self.toracle = TReference(self.tm, self.tcfg)
        self.joracle = JReference(self.jm, self.jcfg)

    def write(self, ss):
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in ss])
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in ss])

    def delete(self, ss):
        self.jm.delete_relation_tuples([JTuple.from_string(s) for s in ss])
        self.tm.delete_relation_tuples([TTuple.from_string(s) for s in ss])

    def check(self, queries, depth=0):
        got = self.port.check_batch([TTuple.from_string(s) for s in queries], depth)
        want = self.jax.check_batch([JTuple.from_string(s) for s in queries], depth)
        for s, g, w in zip(queries, got, want):
            assert g.membership.value == w.membership.value, (s, depth)
            o = self.toracle.check_relation_tuple(TTuple.from_string(s), depth)
            assert g.membership == o.membership, (s, depth)
        return got

    def same_closure_stats(self):
        assert self.port.stats["closure_hits"] == self.jax.stats.get("closure_hits", 0)
        assert self.port.stats["closure_fallback"] == self.jax.stats.get("closure_fallback", {})


@pytest.fixture(scope="module")
def pair(store):
    ns, tuples, owners = store
    p = Pair(ns, tuples)
    assert p.port.closure_ensure_built() and p.jax.closure_ensure_built()
    return p, owners


@pytest.mark.parametrize("depth", [0, 1, 3, DEPTH + 2])
def test_engine_closure_checks_equal_jax_and_oracle(pair, depth):
    p, owners = pair
    p.check(deep_queries(owners), depth)
    p.same_closure_stats()
    assert p.port.stats["closure_hits"] > 0


def test_engine_mixed_batch_merges_in_order(pair):
    """Covered queries, island and uncovered ones, unknown vocabulary and
    an unknown namespace in one batch: resolved verdicts and the BFS
    leftovers interleave back in request order."""
    p, owners = pair
    before = dict(p.port.stats["closure_fallback"])
    batch = [f"deep:c0f0#viewer@{owners[0]}", "acl:d#access@u1", "deep:c1f0#viewer@nobody",
             "acl:g#group@u1", "deep:c0f0#viewer@martian", "nowhere:x#y@alice",
             f"deep:c2f3#viewer@{owners[2]}", "cfg:a#member@u1"]
    got = p.check(batch)
    # the last: the direct edge of cfg:b#ghost answers before its
    # relation-not-found lookup, on the BFS path as in the oracle
    assert [r.membership for r in got] == [
        Membership.IS_MEMBER, Membership.IS_MEMBER, Membership.NOT_MEMBER,
        Membership.IS_MEMBER, Membership.NOT_MEMBER, Membership.NOT_MEMBER,
        Membership.IS_MEMBER, Membership.IS_MEMBER,
    ]
    after = p.port.stats["closure_fallback"]
    assert after.get("uncovered", 0) - before.get("uncovered", 0) >= 3
    assert after.get("unindexed", 0) - before.get("unindexed", 0) >= 1
    p.same_closure_stats()


def test_engine_tables_nbytes_reports_closure(pair):
    """cc and ch, and the empty dirty table every build uploads, as
    keto_tpu's engine holds them (its closure and closure_delta
    families)."""
    p, _owners = pair
    nbytes = p.port.tables_nbytes("closure")
    idx = p.port.closure_index()
    packed, _cc, _ch = tcl.pack_closure_tables(idx._build, idx._graph.R, p.port.layout)
    packed["cd_pack"] = tcl.empty_dirty_table()
    assert nbytes == {k: v.nbytes for k, v in packed.items()}
    assert nbytes == {k: v.nbytes for k, v in p.jax.closure_device_tables().items()}
    assert set(nbytes) == {"cc_pack", "ch_pack", "cd_pack"}


def compacting_writes(n=2100):
    """More ops than the delta overlay holds (DELTA_COMPACT_THRESHOLD):
    the next refresh merges them into a new base."""
    return [f"big:filler{i}#member@f{i}" for i in range(n)]


def test_write_marks_dirty_refreshes_then_rebuilds(store, layout):
    """A write rides the overlay over the index's base snapshot: the
    check's inline catch-up marks the written chain's ancestors, whose
    queries fall back as dirty while the rest hit, all as keto_tpu;
    closure_ensure_built() powers the dirty nodes again over the same base
    (a refresh, not a build) and every query hits, the written grant
    included. A delete never reads as allowed. A write of more ops than
    the overlay holds compacts the mirror into a new base, which the index
    powers in full."""
    ns, tuples, owners = store
    p = Pair(ns, tuples, layout=layout)
    queries = deep_queries(owners, n=16) + ["deep:c2f0#viewer@newbie"]
    on_c2 = sum(q.startswith("deep:c2f") for q in queries)
    assert p.port.closure_index().view_for(p.port.ensure_state())[1] == tcl.CAUSE_UNBUILT
    assert p.port.closure_ensure_built() and p.jax.closure_ensure_built()
    p.check(queries)
    hits = p.port.stats["closure_hits"]
    assert hits == len(queries)

    p.write([f"deep:c2f{DEPTH}#owner@newbie"])
    got = p.check(queries)
    assert p.port.stats["closure_fallback"] == {"dirty": on_c2}
    assert p.port.stats["closure_hits"] == hits + len(queries) - on_c2
    assert got[-1].membership == Membership.IS_MEMBER
    idx = p.port.closure_index()
    assert idx.describe()["dirty_nodes"] == DEPTH + 2  # the chain's viewers and its owner
    same_index(idx, p.jax.closure_index())
    same_closure_vector(p.port, p.jax, queries)
    builds = idx.stats["builds"]
    assert p.port.closure_ensure_built() and p.jax.closure_ensure_built()
    assert idx.stats["builds"] == builds and idx.stats["refreshes"] == 1
    same_index(idx, p.jax.closure_index())
    hits = p.port.stats["closure_hits"]
    assert all(r.membership == g.membership for r, g in zip(p.check(queries), got))
    assert p.port.stats["closure_hits"] == hits + len(queries)

    p.delete([f"deep:c2f{DEPTH}#owner@newbie"])
    assert p.check(queries[-1:])[0].membership == Membership.NOT_MEMBER
    p.write(compacting_writes())
    assert p.port.closure_ensure_built() and p.jax.closure_ensure_built()
    assert p.port.stats["incremental_merges"] == 1 and p.port.stats["snapshot_builds"] == 1
    assert idx.stats["builds"] == builds + 1
    same_index(idx, p.jax.closure_index())
    hits = p.port.stats["closure_hits"]
    again = p.check(queries)
    assert p.port.stats["closure_hits"] == hits + len(queries)
    assert again[-1].membership == Membership.NOT_MEMBER
    p.same_closure_stats()


def test_row_cap_and_universe_cap_fall_back(store, monkeypatch):
    ns, tuples, _owners = store
    p = Pair(ns, tuples, max_set_rows=8)
    assert p.port.closure_ensure_built() and p.jax.closure_ensure_built()
    p.check(["big:hub#member@u3", "big:hub#member@nobody", "g:x#member@alice"])
    assert p.port.stats["closure_fallback"].get("uncovered") == 2
    p.same_closure_stats()
    # a universe past the cap: no index, every check on the BFS kernel
    monkeypatch.setattr(tcl, "MAX_CLOSURE_NODES", 4)
    engine = TorchCheckEngine(p.tm, p.tcfg, device="cpu")
    assert not engine.closure_ensure_built()
    res = engine.check_batch([TTuple.from_string("big:hub#member@u3")])
    assert res[0].membership == Membership.IS_MEMBER
    assert engine.stats["closure_fallback"] == {tcl.CAUSE_UNBUILT: 1}


def test_closure_disabled_by_default():
    engine = TorchCheckEngine(TMemory(), TConfig({}), device="cpu")
    assert engine.closure_enabled is False
    engine.check_batch([TTuple.from_string("n:o#r@u")])
    assert engine.stats["closure_fallback"] == {} and engine.stats["closure_hits"] == 0

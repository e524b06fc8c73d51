"""The port's BatchFilter (keto_tpu_torch.engine.filter_kernel, the
engine's filter_batch / filter_objects and the oracle's filter_objects)
held against the JAX package's on identical inputs, on the CPU.

- vectors: filter_kernel_packed (the plain version of F1 around K2, L2
  and K4) returns the vector keto_tpu's returns, hits, cause and launch
  stats, over the tests/test_filter.py shapes (direct edges, cat-videos
  rewrites, a subject-set subject, cycles, depth limits, the AND island)
  in one store, under both layouts; with a small frontier (overflow), a
  small step budget (exhaustion), a candidate column hit before the walk
  drains (the early exit) and a reverse-dirty overlay
- the plain F1 against the JAX step's searchsorted marking on random
  columns
- engines: filter_batch equals the oracle and TPUCheckEngine.filter_batch
  with the same per-tier counts, closure off and on, with a NOT config,
  unknown names, duplicates and chunking

Tolerance: exact equality; every output is an integer or a verdict.
"""

import numpy as np
import pytest
import torch

import keto_tpu.engine.filter_kernel as jfk
import keto_tpu.engine.snapshot as jsnap
from keto_tpu.config import Config as JConfig
from keto_tpu.engine.reference import ReferenceEngine as JReference
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.ketoapi import SubjectSet as JSubjectSet
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

import keto_tpu_torch.engine.filter_kernel as tfk
import keto_tpu_torch.engine.reverse_kernel as trk
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine.reference import ReferenceEngine as TReference
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.ketoapi import SubjectSet as TSubjectSet
from keto_tpu_torch.storage import MemoryManager as TMemory

from test_torch_kernel import layout, port_namespaces  # noqa: F401  (layout is a fixture)
from test_torch_list import Fixture, _delta_ops

C = 64
MAX_DEPTH = 12


def _view_rewrite():
    return SubjectSetRewrite(children=[
        ComputedSubjectSet(relation="owner"),
        TupleToSubjectSet(relation="parent", computed_subject_set_relation="view"),
    ])


def namespaces():
    return [
        JNamespace(name="files"),
        JNamespace(name="videos", relations=[
            Relation(name="owner"), Relation(name="parent"),
            Relation(name="view", subject_set_rewrite=_view_rewrite()),
        ]),
        JNamespace(name="groups", relations=[Relation(name="member")]),
        JNamespace(name="cyc"),
        JNamespace(name="chain"),
        JNamespace(name="acl", relations=[
            Relation(name="allow"), Relation(name="paid"),
            Relation(name="access", subject_set_rewrite=SubjectSetRewrite(
                operation=Operator.AND,
                children=[ComputedSubjectSet(relation="allow"),
                          ComputedSubjectSet(relation="paid")])),
        ]),
    ]


CAT_OBJECTS = ["/d1", "/d1/v1", "/d1/v2", "/d2", "/d2/v1", "/nope"]
# every shape's subjects carry its own prefix, so no walk crosses shapes
TUPLES = [
    "files:a#owner@f_alice", "files:b#owner@f_alice", "files:c#owner@f_bob",
    "videos:/d1#owner@v_alice", "videos:/d1/v1#parent@(videos:/d1#...)",
    "videos:/d1/v2#parent@(videos:/d1#...)", "videos:/d2#owner@v_bob",
    "videos:/d2/v1#parent@(videos:/d2#...)", "videos:/d2/v1#owner@v_alice",
    "videos:/d1#view@(groups:eng#member)", "groups:eng#member@v_carol",
    "groups:eng#member@(groups:leads#member)", "groups:leads#member@v_dana",
    "cyc:a#member@(cyc:b#member)", "cyc:b#member@(cyc:c#member)",
    "cyc:c#member@(cyc:a#member)", "cyc:c#member@c_alice",
    *[f"chain:g{i}#member@(chain:g{i + 1}#member)" for i in range(6)],
    "chain:g6#member@d_alice",
    "acl:d1#allow@a_u1", "acl:d1#paid@a_u1", "acl:d2#allow@a_u1", "acl:d3#paid@a_u2",
]
CHAIN = [f"g{i}" for i in range(7)]
# (namespace, relation, subject, depth, candidates)
QUERIES = [
    ("files", "owner", "f_alice", MAX_DEPTH, ["a", "b", "c", "zzz"]),
    *[("videos", "view", s, MAX_DEPTH, CAT_OBJECTS)
      for s in ("v_alice", "v_bob", "v_carol", "v_dana", "f_alice")],
    ("videos", "view", "groups:eng#member", MAX_DEPTH, CAT_OBJECTS),
    ("cyc", "member", "c_alice", 10, ["a", "b", "c", "d"]),
    *[("chain", "member", "d_alice", d, CHAIN) for d in (1, 2, 3, 5, 8)],
    # hit before the walk drains: the all-hit early exit
    ("chain", "member", "d_alice", 8, ["g5", "g6"]),
    ("acl", "access", "a_u1", MAX_DEPTH, ["d1", "d2", "d3"]),
]


def _jsub(s):
    return JSubjectSet.from_string(s) if "#" in s else s


def _tsub(s):
    return TSubjectSet.from_string(s) if "#" in s else s


def _qcpack(jsn, ns, rel, subject, depth, objects):
    """The [5 + C] pack of one query, encoded as the JAX engine encodes
    it (None when a name is unknown)."""
    view = jsn
    proxy = JTuple(namespace=ns, object="", relation=rel)
    sub = _jsub(subject)
    if isinstance(sub, JSubjectSet):
        proxy.subject_set = sub
    else:
        proxy.subject_id = sub
    enc = view.encode_subject(proxy)
    ns_id, rel_id = view.ns_ids.get(ns), view.rel_ids.get(rel)
    slots = sorted({view.obj_slots[(ns_id, o)] for o in objects if (ns_id, o) in view.obj_slots})
    skind, sa, sb = enc
    return jfk.pack_filter_query(sa, int(jsnap.reverse_subject_tag(skind, sb)), rel_id, depth,
                                 np.array(slots, np.int32), C)


VARIANTS = {
    "base": ({}, False),
    "small_frontier": ({"frontier_cap": 2}, False),
    "small_step_budget": ({"max_steps": 2}, False),
    "reverse_dirty": ({}, True),
}


@pytest.fixture(scope="module")
def fixtures(layout):
    ns = namespaces()
    return {
        False: Fixture(ns, TUPLES, [], []),
        True: Fixture(ns, TUPLES, [], [], delta_ops=_delta_ops(TUPLES, 2)),
    }


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_filter_vector_identical(fixtures, variant):
    import jax.numpy as jnp

    over, has_delta = VARIANTS[variant]
    fx = fixtures[has_delta]
    snap = fx.jsn
    kw = {**dict(rvh_probes=fx.rnp["rvh_probes"], rsh_probes=fx.rnp["rsh_probes"],
                 max_steps=MAX_DEPTH + snap.n_config_rels + 4, wildcard_rel=snap.wildcard_rel,
                 n_config_rels=max(snap.n_config_rels, 1), frontier_cap=1024,
                 has_delta=has_delta), **over}
    jtables = {k: jnp.asarray(v) for k, v in fx.rev.items()}
    ttables = trk.reverse_tables_from_numpy(fx.rev, "cpu")
    causes, steps = [], []
    for query in QUERIES:
        qc = _qcpack(snap, *query)
        want = np.asarray(jfk.filter_kernel_packed(jtables, jnp.asarray(qc), RK=fx.rnp["RK"],
                                                   **kw))
        got = tfk.filter_kernel_packed(ttables, torch.from_numpy(qc), layout=fx.layout,
                                       **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(query))
        _hit, cause, stats = tfk.unpack_filter_results(got, C)
        causes.append(cause)
        steps.append(int(stats[0]))
    # each variant reached what it was built for
    expect = {"base": {0, 8}, "small_frontier": {2}, "small_step_budget": {1},
              "reverse_dirty": {4}}[variant]
    assert expect <= set(causes), causes
    if variant == "base":
        # the early exit stops after the step that hit g5 and g6
        assert steps[-2] == 2 and steps[-3] > 2


def _jax_mark(obj, rel, depth, live, cand, q_rel, hit):
    """The JAX step's marking (keto_tpu/engine/filter_kernel.py _filter_impl
    step 2): searchsorted, clip, drop-mode scatter; (hit, marks)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def reference(obj, rel, depth, live, cand, q_rel, hit):
        match = live & (rel == q_rel) & (depth >= 0)
        pos = jnp.clip(jnp.searchsorted(cand, obj).astype(jnp.int32), 0, cand.shape[0] - 1)
        found = match & (cand[pos] == obj)
        return hit.at[jnp.where(found, pos, cand.shape[0])].set(True, mode="drop"), found.sum()

    want_hit, want_marks = reference(*(jnp.asarray(x) for x in (obj, rel, depth, live, cand)),
                                     jnp.int32(q_rel), jnp.asarray(hit))
    return np.asarray(want_hit), int(want_marks)


def _port_mark(obj, rel, depth, live, cand, n, hit, status):
    """The plain F1 on the same numpy columns; hit and status update in
    place; returns the marks."""
    head = torch.tensor([0, 0, 1, 0, n], dtype=torch.int32)
    return int(tfk.filter_mark_plain(*(torch.from_numpy(x) for x in (obj, rel, depth, live, cand)),
                                     head, hit, status))


@pytest.mark.parametrize("seed", range(4))
def test_filter_mark_plain_equals_jax_step(seed):
    """The plain F1 against the JAX step's marking (searchsorted, clip,
    drop-mode scatter) on random columns with duplicate tasks."""
    rng = np.random.default_rng(seed)
    F, n = 512, int(rng.integers(1, C))
    cand = np.full(C, tfk.CAND_PAD, np.int32)
    cand[:n] = np.sort(rng.choice(200, n, replace=False)).astype(np.int32)
    obj = rng.integers(0, 210, F).astype(np.int32)
    rel = rng.integers(0, 3, F).astype(np.int32)
    depth = rng.integers(-1, 3, F).astype(np.int32)
    live = rng.random(F) < 0.8
    hit0 = rng.random(C) < 0.2
    hit0[n:] = False
    want_hit, want_marks = _jax_mark(obj, rel, depth, live, cand, 1, hit0)
    hit = torch.from_numpy(hit0.astype(np.int32))
    status = torch.tensor([F, 0, int(hit0.sum()), n], dtype=torch.int32)
    marks = _port_mark(obj, rel, depth, live, cand, n, hit, status)
    np.testing.assert_array_equal(hit.numpy().astype(bool), want_hit)
    assert marks == want_marks > 0
    assert int(status[2]) == int(want_hit.sum())


# (F tasks, C slots, candidates, object draw): the F1 kernel's edge shapes
MARK_EDGES = {
    "c1": (64, 1, 1, "near"),
    "all_padding": (64, 16, 0, "near"),
    "no_padding": (256, 32, 32, "near"),
    "one_object": (128, 16, 9, "one"),
    "outside": (128, 16, 9, "outside"),
    "f_gt_c": (4096, 64, 40, "near"),
    "second_call_sets_nothing": (256, 32, 20, "near"),
}


@pytest.mark.parametrize("case", sorted(MARK_EDGES))
def test_filter_mark_plain_edges_equal_jax_step(case):
    """The plain F1 against the JAX step on its edge shapes: one slot; a
    column of padding only, or none; every task on one object; objects
    below the first candidate and above the last; more tasks than slots;
    and a second call on the same hit mask, which sets nothing new and
    still counts its matching tasks."""
    F, Cc, n, draw = MARK_EDGES[case]
    rng = np.random.default_rng(len(case))
    cand = np.full(Cc, tfk.CAND_PAD, np.int32)
    cand[:n] = np.sort(rng.choice(np.arange(10, 10 + 4 * max(n, 1)), n, replace=False))
    if draw == "one":
        obj = np.full(F, cand[n // 2], np.int32)
    elif draw == "outside":
        obj = np.where(rng.random(F) < 0.5, rng.integers(-5, cand[0], F),
                       rng.integers(cand[n - 1] + 1, cand[n - 1] + 50, F)).astype(np.int32)
    else:
        obj = rng.integers(0, 20 + 4 * max(n, 1), F).astype(np.int32)
    rel = rng.integers(0, 3, F).astype(np.int32)
    depth = rng.integers(-1, 3, F).astype(np.int32)
    live = rng.random(F) < 0.9
    hit0 = np.zeros(Cc, bool)
    hit = torch.zeros(Cc, dtype=torch.int32)
    status = torch.tensor([F, 0, 0, n], dtype=torch.int32)
    calls = 2 if case == "second_call_sets_nothing" else 1
    for _ in range(calls):
        want_hit, want_marks = _jax_mark(obj, rel, depth, live, cand, 1, hit0)
        before = int(status[2])
        marks = _port_mark(obj, rel, depth, live, cand, n, hit, status)
        np.testing.assert_array_equal(hit.numpy().astype(bool), want_hit)
        assert marks == want_marks
        assert int(status[2]) == int(want_hit.sum())
        hit0 = want_hit
    if case == "second_call_sets_nothing":
        assert int(status[2]) == before > 0 and marks > 0
    elif case in ("all_padding", "outside"):
        assert marks == 0 and not hit.any()
    else:
        assert marks > 0
    if case == "one_object":
        assert int(status[2]) == 1


# -- the engines ---------------------------------------------------------------------


class Pair:
    """One store and config behind both engines and both oracles."""

    def __init__(self, ns, tuples, closure=False, max_depth=MAX_DEPTH):
        cfg = {"limit": {"max_read_depth": max_depth}, "closure": {"enabled": closure}}
        self.jcfg, self.tcfg = JConfig(cfg), TConfig(cfg)
        self.jcfg.set_namespaces(ns)
        self.tcfg.set_namespaces(port_namespaces(ns))
        self.jm, self.tm = JMemory(), TMemory()
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])
        self.jax = TPUCheckEngine(self.jm, self.jcfg)
        self.port = TorchCheckEngine(self.tm, self.tcfg, device="cpu")
        self.toracle = TReference(self.tm, self.tcfg)
        self.joracle = JReference(self.jm, self.jcfg)
        if closure:
            assert self.port.closure_ensure_built() and self.jax.closure_ensure_built()

    def filter(self, ns, rel, subject, objects, max_depth=0, **kw):
        got = self.port.filter_batch(ns, rel, _tsub(subject), objects, max_depth, **kw)
        assert got == self.jax.filter_batch(ns, rel, _jsub(subject), objects, max_depth, **kw)
        assert got == self.toracle.filter_objects(ns, rel, _tsub(subject), objects, max_depth)
        assert got == self.joracle.filter_objects(ns, rel, _jsub(subject), objects, max_depth)
        self.same_tiers()
        return got

    def same_tiers(self):
        for k in ("filter_requests", "filter_vocab", "filter_closure", "filter_frontier",
                  "filter_host", "closure_hits"):
            assert self.port.stats[k] == self.jax.stats.get(k, 0), k
        assert self.port.stats["host_cause"] == self.jax.stats["host_cause"]
        assert self.port.stats["closure_fallback"] == self.jax.stats.get("closure_fallback", {})


@pytest.fixture(scope="module")
def pair():
    return Pair(namespaces(), TUPLES)


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_engine_filter_equals_jax_and_oracle(pair, i):
    ns, rel, subject, depth, objects = QUERIES[i]
    pair.filter(ns, rel, subject, objects + ["missing"], depth)


def test_engine_filter_tiers(pair):
    """Unknown names under this config (an AND island, not monotone) go to
    the host; duplicates and request order survive; chunking is exact."""
    before = dict(pair.port.stats)
    got = pair.filter("videos", "view", "v_alice", ["/d1/v1", "/d2", "/d1/v1", "/nope", "/d2"])
    assert got == [True, False, True, False, False]
    assert pair.port.stats["filter_frontier"] - before["filter_frontier"] == 4
    pair.filter("videos", "view", "ghost", CAT_OBJECTS)
    pair.filter("videos", "nope", "v_alice", ["/d1"])
    objs = (CAT_OBJECTS * 5)[:27]
    assert pair.filter("videos", "view", "v_alice", objs, chunk_size=4) == \
        pair.toracle.filter_objects("videos", "view", "v_alice", objs)
    assert pair.port.stats["filter_host"] > before["filter_host"]


def test_engine_filter_objects_subset(pair):
    objs = ["/d1/v2", "/d2/v1", "/d1/v2", "/nope"]
    got = pair.port.filter_objects("videos", "view", "v_alice", objs)
    assert got == [o for o in objs if o != "/nope"]
    assert got == pair.jax.filter_objects("videos", "view", "v_alice", objs)


def test_engine_monotone_vocab_tier():
    """A monotone config answers unknown candidates and an unknown subject
    with no device or host work."""
    ns = [JNamespace(name="files"), JNamespace(name="videos", relations=[
        Relation(name="owner"), Relation(name="parent"),
        Relation(name="view", subject_set_rewrite=_view_rewrite())])]
    p = Pair(ns, [t for t in TUPLES if t.startswith(("files:", "videos:"))
                  and "groups:" not in t])
    assert p.filter("files", "owner", "f_alice", ["a", "zzz", "c"]) == [True, False, False]
    assert p.port.stats["filter_vocab"] == 1 and p.port.stats["filter_frontier"] == 2
    p.filter("videos", "view", "martian", CAT_OBJECTS)
    assert p.port.stats["filter_vocab"] == 1 + len(CAT_OBJECTS)
    assert p.port.stats["filter_host"] == 0


def test_engine_not_config_routes_to_host():
    ns = [JNamespace(name="n", relations=[
        Relation(name="allow"), Relation(name="deny"),
        Relation(name="access", subject_set_rewrite=SubjectSetRewrite(
            operation=Operator.AND,
            children=[ComputedSubjectSet(relation="allow"),
                      InvertResult(child=ComputedSubjectSet(relation="deny"))])),
    ])]
    p = Pair(ns, ["n:d1#allow@u1", "n:d2#allow@u1", "n:d2#deny@u1"])
    assert p.filter("n", "access", "u1", ["d1", "d2"]) == [True, False]
    assert p.port.stats["filter_frontier"] == 0
    assert p.port.stats["host_cause"] == {"island_host": 2}


def test_engine_closure_tier():
    """Covered candidates resolve on one closure launch; the frontier and
    the host see none of them."""
    ns = [JNamespace(name="deep", relations=[
        Relation(name="owner"), Relation(name="parent"),
        Relation(name="viewer", subject_set_rewrite=SubjectSetRewrite(children=[
            ComputedSubjectSet(relation="owner"),
            TupleToSubjectSet(relation="parent", computed_subject_set_relation="viewer"),
        ])),
    ])]
    tuples = [f"deep:c{c}f{i}#parent@(deep:c{c}f{i + 1}#...)" for c in range(4) for i in range(6)]
    tuples += [f"deep:c{c}f6#owner@u{c}" for c in range(4)]
    p = Pair(ns, tuples, closure=True, max_depth=10)
    objs = [f"c{c}f{i}" for c in range(4) for i in range(7)]
    for sub in ("u0", "u2"):
        p.filter("deep", "viewer", sub, objs)
    p.filter("deep", "viewer", "u1", objs, max_depth=3)
    assert p.port.stats["filter_closure"] == 3 * len(objs)
    assert p.port.stats["filter_frontier"] == p.port.stats["filter_host"] == 0
    p.filter("deep", "viewer", "u9", objs)
    assert p.port.stats["filter_vocab"] == len(objs)

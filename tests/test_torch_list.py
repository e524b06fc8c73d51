"""The port's ListObjects and ListSubjects (keto_tpu_torch.engine.
reverse_kernel, the engine's list_*_batch, the oracle's list_* and the
REST list routes) held against the JAX package's on identical inputs, on
the CPU.

- tables: the reverse state, the inverted programs, the reverse-dirty
  columns and both legs' packed tables equal the JAX builders' output
  under both table layouts
- packed vectors: list_objects_kernel_packed and
  list_subjects_kernel_packed (the plain versions of L1-L4 around K2 and
  K4) return vectors bit-identical to keto_tpu's, launch stats included,
  over the tests/test_reverse.py shapes and random graphs (all in one
  store, each shape under its own namespaces), with tiny frontier,
  result and pool caps, step exhaustion, a non-empty reverse-dirty table
  and a non-empty dirty table; the plain list_emit equals keto_tpu's
  _bump_emit arithmetic on queries in random order, in long runs and all
  on one query
- engines: TorchCheckEngine(device="cpu").list_*_batch equals
  TPUCheckEngine's and both host oracles', with a NOT config, unknown
  names and chained page tokens; the REST list routes answer the expected
  bodies and errors

Tolerance: exact equality; every output is an integer or a list of names.
"""

import json
import random
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import keto_tpu.engine.expand_kernel as jek
import keto_tpu.engine.reverse_kernel as jrk
import keto_tpu.engine.snapshot as jsnap
from keto_tpu.config import Config as JConfig
from keto_tpu.engine import delta as jdelta
from keto_tpu.engine.definitions import paginate_names as jpaginate
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

import keto_tpu_torch.engine.expand_kernel as tek
import keto_tpu_torch.engine.reverse_kernel as trk
from keto_tpu_torch.api.daemon import make_batcher
from keto_tpu_torch.api.rest_server import make_server
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine import delta as tdelta
from keto_tpu_torch.engine import snapshot as tsnap
from keto_tpu_torch.engine.definitions import paginate_names as tpaginate
from keto_tpu_torch.engine.reference import ReferenceEngine as TReference
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.errors import MalformedInputError
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.ketoapi import SubjectSet as TSubjectSet
from keto_tpu_torch.registry import Registry as TRegistry
from keto_tpu_torch.storage import MemoryManager as TMemory

from test_torch_kernel import SCENARIOS as CHECK_SCENARIOS
from test_torch_kernel import layout, port_namespaces  # noqa: F401  (layout is a fixture)

B = 128


# -- scenarios: the tests/test_reverse.py shapes, each under its own namespaces --
#
# A scenario is (namespaces, tuples, ListObjects queries (ns, rel, subject,
# depth), ListSubjects queries (ns, obj, rel, depth)); `p` prefixes every
# namespace so that all of them share one store.


def _plain(p, *names):
    return [JNamespace(name=p + n) for n in names]


def direct(p):
    f = p + "files"
    tuples = [f"{f}:a#owner@alice", f"{f}:b#owner@alice", f"{f}:c#owner@bob"]
    lo = [(f, "owner", s, 8) for s in ("alice", "bob", "nobody")]
    return _plain(p, "files"), tuples, lo, [(f, "a", "owner", 8), (f, "c", "owner", 8)]


def indirection(p):
    f, g = p + "files", p + "groups"
    tuples = [
        f"{f}:doc#view@({g}:eng#member)", f"{f}:doc2#view@({g}:leads#member)",
        f"{g}:eng#member@alice", f"{g}:eng#member@({g}:leads#member)", f"{g}:leads#member@carol",
    ]
    lo = [(f, "view", "alice", 8), (f, "view", "carol", 8), (g, "member", "carol", 8)]
    ls = [(f, "doc", "view", 8), (f, "doc2", "view", 8), (g, "eng", "member", 8)]
    return _plain(p, "files", "groups"), tuples, lo, ls


def cat_videos(p):
    v, g = p + "videos", p + "groups"
    ns = [
        JNamespace(name=v, relations=[
            Relation(name="owner"), Relation(name="parent"),
            Relation(name="view", subject_set_rewrite=SubjectSetRewrite(children=[
                ComputedSubjectSet(relation="owner"),
                TupleToSubjectSet(relation="parent", computed_subject_set_relation="view"),
            ])),
        ]),
        JNamespace(name=g, relations=[Relation(name="member")]),
    ]
    tuples = [
        f"{v}:/d1#owner@alice", f"{v}:/d1/v1#parent@({v}:/d1#...)",
        f"{v}:/d1/v2#parent@({v}:/d1#...)", f"{v}:/d2#owner@bob",
        f"{v}:/d2/v1#parent@({v}:/d2#...)", f"{v}:/d2/v1#owner@alice",
        f"{v}:/d1#view@({g}:eng#member)", f"{g}:eng#member@carol",
        f"{g}:eng#member@({g}:leads#member)", f"{g}:leads#member@dana",
    ]
    # a subject-set query subject, and depths that cut the walk short
    lo = [(v, "view", s, 8) for s in ("alice", "bob", "carol", "dana")]
    lo += [(v, "view", f"{g}:eng#member", 8), (v, "view", "alice", 2)]
    ls = [(v, "/d1/v1", "view", 8), (v, "/d2/v1", "view", 8), (v, "/d1", "owner", 8),
          (g, "eng", "member", 8), (v, "/d1/v1", "view", 1), (v, "/d1", "view", 2)]
    return ns, tuples, lo, ls


def deep_chain(p):
    v = p + "v"
    ns = [JNamespace(name=v, relations=[
        Relation(name="owner"), Relation(name="parent"),
        Relation(name="viewer", subject_set_rewrite=SubjectSetRewrite(children=[
            ComputedSubjectSet(relation="owner"),
            TupleToSubjectSet(relation="parent", computed_subject_set_relation="viewer"),
        ])),
    ])]
    tuples = [f"{v}:c{i}#parent@({v}:c{i + 1}#...)" for i in range(10)]
    tuples += [f"{v}:c10#owner@u1", f"{v}:c3#parent@({v}:c0#...)"]
    return ns, tuples, [(v, "viewer", "u1", 16)], [(v, "c0", "viewer", 16), (v, "c7", "viewer", 4)]


def cycles(p):
    g = p + "groups"
    tuples = [f"{g}:a#member@({g}:b#member)", f"{g}:b#member@({g}:a#member)",
              f"{g}:b#member@bob"]
    return _plain(p, "groups"), tuples, [(g, "member", "bob", 10)], [(g, "a", "member", 10)]


def and_island(p):
    a = p + "acl"
    ns = [JNamespace(name=a, relations=[
        Relation(name="allow"), Relation(name="paid"),
        Relation(name="access", subject_set_rewrite=SubjectSetRewrite(
            operation=Operator.AND,
            children=[ComputedSubjectSet(relation="allow"), ComputedSubjectSet(relation="paid")])),
    ])]
    tuples = [f"{a}:d1#allow@u1", f"{a}:d1#paid@u1", f"{a}:d2#allow@u1", f"{a}:d3#paid@u2"]
    lo = [(a, "access", s, 8) for s in ("u1", "u2", "u3")]
    return ns, tuples, lo, [(a, "d1", "access", 8), (a, "d1", "allow", 8)]


def random_graph(seed):
    def make(p):
        rng = random.Random(seed)
        v = p + "v"
        objects = [f"o{i}" for i in range(12)]
        relations = ["r1", "r2"]
        tuples = set()
        for _ in range(60):
            obj, rel = rng.choice(objects), rng.choice(relations)
            if rng.random() < 0.45:
                tuples.add(f"{v}:{obj}#{rel}@({v}:{rng.choice(objects)}#{rng.choice(relations)})")
            else:
                tuples.add(f"{v}:{obj}#{rel}@u{rng.randrange(8)}")
        depths = (2, 4, 10)
        lo = [(v, rel, f"u{s}", depths[(s + k) % 3])
              for s in range(8) for k, rel in enumerate(relations)]
        ls = [(v, o, rel, (1, 3, 10)[(i + k) % 3])
              for i, o in enumerate(objects[:6]) for k, rel in enumerate(relations)]
        return _plain(p, "v"), sorted(tuples), lo, ls
    return make


SCENARIOS = {
    "direct": direct, "indirection": indirection, "cat_videos": cat_videos,
    "deep_chain": deep_chain, "cycles": cycles, "and_island": and_island,
    **{f"random_{s}": random_graph(s) for s in range(6)},
}


def all_scenarios():
    """Every scenario in one store: (namespaces, tuples, {name: (lo, ls)}).
    Subject ids carry the scenario's prefix too, so that no walk crosses
    into another scenario through a shared subject."""
    namespaces, tuples, queries = [], [], {}
    for name, make in SCENARIOS.items():
        p = f"{name}_"
        ns, tp, lo, ls = make(p)
        namespaces += ns
        for s in tp:
            t = JTuple.from_string(s)
            if t.subject_id is not None:
                t.subject_id = p + t.subject_id
            tuples.append(str(t))
        queries[name] = ([(n, r, sub if "#" in sub else p + sub, d) for n, r, sub, d in lo], ls)
    return namespaces, tuples, queries


def _jsub(s):
    return JSubjectSet.from_string(s) if "#" in s else s


def _tsub(s):
    return TSubjectSet.from_string(s) if "#" in s else s


# -- the two packages' tables and launches ----------------------------------------


class Fixture:
    """One store's JAX snapshot, both legs' JAX-built packed tables (as
    numpy) and query packs, encoded as the JAX engine encodes them."""

    def __init__(self, namespaces, tuples, lo, ls, delta_ops=None):
        self.jt = [JTuple.from_string(s) for s in tuples]
        self.jsn = jsnap.build_snapshot(self.jt, namespaces)
        self.layout = jsnap.table_layout()
        delta = jdelta.empty_delta_tables()
        if delta_ops:
            view = jdelta.SnapshotView(self.jsn, jdelta.build_vocab_overlay(self.jsn, delta_ops))
            delta = jdelta.build_delta_tables(view, delta_ops)
        self.rnp = jrk.build_reverse_state(self.jt, self.jsn, namespaces)
        self.rev = {k: np.asarray(v) for k, v in TPUCheckEngine._merge_reverse_dirty(
            jrk.pack_reverse_tables(self.rnp, self.jsn), delta).items()}
        self.csr = jek.build_full_csr(self.jt, self.jsn)
        self.sub = {k: np.asarray(v) for k, v in TPUCheckEngine._merge_subjects_dirty(
            jrk.pack_subjects_tables(self.csr, self.jsn), delta).items()}
        view = jdelta.SnapshotView(self.jsn)
        self.lo_q = np.zeros((6, B), np.int32)
        for i, (ns, rel, s, depth) in enumerate(lo):
            proxy = JTuple(namespace=ns, object="", relation=rel)
            sub = _jsub(s)
            if isinstance(sub, JSubjectSet):
                proxy.subject_set = sub
            else:
                proxy.subject_id = sub
            enc = view.encode_subject(proxy)
            self.lo_q[4, i] = depth
            if enc is not None and view.ns_id(ns) is not None and view.rel_id(rel) is not None:
                self.lo_q[:4, i] = (enc[1], jsnap.reverse_subject_tag(enc[0], enc[2]),
                                    view.ns_id(ns), view.rel_id(rel))
                self.lo_q[5, i] = 1
        self.ls_q = np.zeros((4, B), np.int32)
        for i, (ns, obj, rel, depth) in enumerate(ls):
            node = view.encode_node(ns, obj, rel)
            self.ls_q[2, i] = depth
            if node is not None:
                self.ls_q[0, i], self.ls_q[1, i] = node
                self.ls_q[3, i] = 1

    def statics(self, leg, **over):
        snap = self.jsn
        common = dict(max_steps=16 + snap.n_config_rels + 4, wildcard_rel=snap.wildcard_rel,
                      n_config_rels=max(snap.n_config_rels, 1), frontier_cap=4096,
                      result_cap=512, pool_cap=16384, has_delta=False)
        if leg == "objects":
            common.update(rvh_probes=self.rnp["rvh_probes"], rsh_probes=self.rnp["rsh_probes"],
                          RK=self.rnp["RK"])
        else:
            common.update(K=snap.K, fsh_probes=self.csr["fh_probes"])
        return {**common, **over}

    def run(self, leg, **over):
        """(port vector, JAX vector) of one launch."""
        import jax.numpy as jnp

        kw = self.statics(leg, **over)
        if leg == "objects":
            jfn, tfn, tables, q = jrk.list_objects_kernel_packed, trk.list_objects_kernel_packed, \
                self.rev, self.lo_q
            ttables = trk.reverse_tables_from_numpy(tables, "cpu")
        else:
            jfn, tfn, tables, q = jrk.list_subjects_kernel_packed, \
                trk.list_subjects_kernel_packed, self.sub, self.ls_q
            ttables = trk.subjects_tables_from_numpy(tables, "cpu")
        want = np.asarray(jfn({k: jnp.asarray(v) for k, v in tables.items()}, jnp.asarray(q),
                              **kw))
        # the port reads RK and K off its tables' widths
        port_kw = {k: v for k, v in kw.items() if k not in ("RK", "K")}
        got = tfn(ttables, torch.from_numpy(q), layout=self.layout, **port_kw).numpy()
        return got, want


@pytest.fixture(scope="module")
def combined(layout):
    namespaces, tuples, queries = all_scenarios()
    lo = [q for name in SCENARIOS for q in queries[name][0]]
    ls = [q for name in SCENARIOS for q in queries[name][1]]
    fx = Fixture(namespaces, tuples, lo, ls)
    return fx, queries, {leg: fx.run(leg) for leg in ("objects", "subjects")}


# -- (a) tables ------------------------------------------------------------------------


def _port_snapshot(namespaces, tuples, layout):
    tt = [TTuple.from_string(s) for s in tuples]
    tns = port_namespaces(namespaces)
    return tt, tns, tsnap.build_snapshot(tt, tns, layout=layout)


@pytest.mark.parametrize("scenario", ["cat_videos", "and_island", "random_2", "all"])
def test_reverse_state_and_tables_identical(layout, scenario):
    if scenario == "all":
        namespaces, tuples, _q = all_scenarios()
    else:
        namespaces, tuples, _lo, _ls = SCENARIOS[scenario]("")
    jt = [JTuple.from_string(s) for s in tuples]
    jsn = jsnap.build_snapshot(jt, namespaces)
    tt, tns, tsn = _port_snapshot(namespaces, tuples, layout)
    want = jrk.build_reverse_state(jt, jsn, namespaces)
    got = trk.build_reverse_state(tt, tsn, tns)
    assert set(got) | {"garbage"} == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want_t = TPUCheckEngine._merge_reverse_dirty(jrk.pack_reverse_tables(want, jsn),
                                                 jdelta.empty_delta_tables())
    got_t = trk.pack_reverse_tables(got, tsn)
    assert set(got_t) == set(want_t) == set(trk.REVERSE_TABLE_KEYS)
    for k in got_t:
        np.testing.assert_array_equal(got_t[k], np.asarray(want_t[k]), err_msg=k)

    want_c = jek.build_full_csr(jt, jsn)
    want_s = TPUCheckEngine._merge_subjects_dirty(jrk.pack_subjects_tables(want_c, jsn),
                                                  jdelta.empty_delta_tables())
    got_s = trk.pack_subjects_tables(tek.build_full_csr(tt, tsn), tsn)
    assert set(got_s) == set(want_s) == set(trk.SUBJECTS_TABLE_KEYS)
    for k in got_s:
        np.testing.assert_array_equal(got_s[k], np.asarray(want_s[k]), err_msg=k)


@pytest.mark.parametrize("scenario", sorted(CHECK_SCENARIOS))
def test_reverse_programs_identical(scenario):
    """The inverted programs of the check tests' configs: unions,
    AND/NOT islands (POISON entries, host_all) and oversized rewrites."""
    namespaces, tuples, _q, _d = CHECK_SCENARIOS[scenario]()
    jsn = jsnap.build_snapshot([JTuple.from_string(s) for s in tuples], namespaces)
    _tt, tns, tsn = _port_snapshot(namespaces, tuples, "compact")
    want = jsnap.build_reverse_programs(namespaces, jsn.ns_ids, jsn.rel_ids, jsn.n_config_rels)
    got = tsnap.build_reverse_programs(tns, tsn.ns_ids, tsn.rel_ids, tsn.n_config_rels)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4:] == want[4:]


def _delta_ops(tuples, seed):
    rng = random.Random(seed)
    parsed = [JTuple.from_string(s) for s in tuples]
    ops = [("delete", t) for t in rng.sample(parsed, 6)]
    for _ in range(6):
        a, b = rng.sample(parsed, 2)
        ops.append(("insert", JTuple(namespace=a.namespace, object=a.object, relation=b.relation,
                                     subject_id=b.subject_id, subject_set=b.subject_set)))
    return ops


def test_reverse_dirty_columns_identical(layout):
    namespaces, tuples, _q = all_scenarios()
    ops = _delta_ops(tuples, 3)
    jsn = jsnap.build_snapshot([JTuple.from_string(s) for s in tuples], namespaces)
    want = jdelta.build_delta_tables(
        jdelta.SnapshotView(jsn, jdelta.build_vocab_overlay(jsn, ops)), ops)
    _tt, _tns, tsn = _port_snapshot(namespaces, tuples, layout)
    tops = [(op, TTuple.from_string(str(t))) for op, t in ops]
    got = tdelta.build_delta_tables(
        tdelta.SnapshotView(tsn, tdelta.build_vocab_overlay(tsn, tops)), tops)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["rd_obj"] >= 0).sum() >= 6


# -- (b) the packed vectors ------------------------------------------------------------


def _unpack(vec):
    offs, needs, pool, stats = trk.unpack_list_results(vec, B)
    return offs, needs, pool, stats


@pytest.mark.parametrize("leg", ["objects", "subjects"])
def test_packed_vector_identical(combined, leg):
    _fx, _queries, runs = combined
    got, want = runs[leg]
    np.testing.assert_array_equal(got, want)
    _offs, needs, _pool, stats = _unpack(got)
    assert stats[0] > 2 and (needs == 0).sum() > 50


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_each_shape_answers_on_device(combined, scenario):
    """Each shape's slice of the two vectors: its queries' causes and
    decoded results agree (the whole vectors are equal above), and the
    monotone shapes stay on the device."""
    fx, queries, runs = combined
    i0 = {"objects": 0, "subjects": 0}
    for name in SCENARIOS:
        if name == scenario:
            break
        i0["objects"] += len(queries[name][0])
        i0["subjects"] += len(queries[name][1])
    for leg, qs in zip(("objects", "subjects"), queries[scenario]):
        got, want = runs[leg]
        g_offs, g_needs, g_pool, _s = _unpack(got)
        w_offs, w_needs, w_pool, _s = _unpack(want)
        for i in range(i0[leg], i0[leg] + len(qs)):
            assert g_needs[i] == w_needs[i]
            assert trk.decode_pool_slice(g_pool, g_offs[i], g_offs[i + 1]) == \
                jrk.decode_pool_slice(w_pool, int(w_offs[i]), int(w_offs[i + 1]))
        if scenario != "and_island":
            assert not g_needs[i0[leg] : i0[leg] + len(qs)].any(), (leg, scenario)


CAP_CASES = {
    # seeds and children past the frontier: dedupe and truncation overflow
    "tiny_frontier_cap": (dict(frontier_cap=B), 2),
    "tiny_result_cap": (dict(result_cap=2), 2),
    "tiny_pool_cap": (dict(pool_cap=24), 2),
    "step_exhaustion": (dict(max_steps=2), 1),
}


@pytest.fixture(scope="module")
def plain_fixture():
    namespaces, tuples, queries = all_scenarios()
    lo = [q for name in SCENARIOS for q in queries[name][0]]
    ls = [q for name in SCENARIOS for q in queries[name][1]]
    return Fixture(namespaces, tuples, lo, ls)


@pytest.mark.parametrize("leg", ["objects", "subjects"])
@pytest.mark.parametrize("case", sorted(CAP_CASES))
def test_packed_vector_caps(plain_fixture, case, leg):
    over, cause = CAP_CASES[case]
    got, want = plain_fixture.run(leg, **over)
    np.testing.assert_array_equal(got, want)
    assert cause in _unpack(got)[1]  # the case reached the flag it was built for


@pytest.mark.parametrize("leg", ["objects", "subjects"])
def test_packed_vector_dirty_tables(leg):
    """A non-empty reverse-dirty table (ListObjects) or dirty-row table
    (ListSubjects) with has_delta=True."""
    namespaces, tuples, queries = all_scenarios()
    lo = [q for name in SCENARIOS for q in queries[name][0]]
    ls = [q for name in SCENARIOS for q in queries[name][1]]
    fx = Fixture(namespaces, tuples, lo, ls, delta_ops=_delta_ops(tuples, 11))
    got, want = fx.run(leg, has_delta=True)
    np.testing.assert_array_equal(got, want)
    needs = _unpack(got)[1]
    assert 4 in needs and (needs == 0).sum() > 20  # CAUSE_DIRTY, and not everywhere


@pytest.mark.parametrize("leg", ["objects", "subjects"])
def test_packed_vector_duplicate_keys(layout, leg):
    """Eight queries, each repeated twelve times in the batch: every step's
    frontier holds runs of tasks on the same (obj, rel) keys (K4 keeps one
    task per query), which K2 probes and L3 expands once per task, and a
    frontier cap far past the walk leaves a zero-filled tail at every
    step."""
    namespaces, tuples, queries = all_scenarios()
    lo = [q for name in SCENARIOS for q in queries[name][0]]
    ls = [q for name in SCENARIOS for q in queries[name][1]]
    fx = Fixture(namespaces, tuples, lo[::5][:8] * 12, ls[::5][:8] * 12)
    got, want = fx.run(leg)
    np.testing.assert_array_equal(got, want)
    offs, needs, _pool, stats = _unpack(got)
    counts = np.diff(offs)[:96].reshape(12, 8)
    assert (counts == counts[0]).all() and counts[0].sum() > 0 and stats[0] > 2


def _list_emit_against_bump_emit(q, emit, value, rc, needs, R) -> int:
    """The plain L1 against keto_tpu's _bump_emit and the result write
    around it, on the same numpy inputs; returns the landed count."""
    import jax
    import jax.numpy as jnp

    N, nq = q.shape[0], rc.shape[0]

    @jax.jit
    def reference(q, emit, value, rc, needs, res):
        alloc = jrk._bump_emit(q, emit, rc, N, nq)
        over = emit & (alloc >= R)
        needs = needs.at[q].max(jnp.where(over, 2, 0).astype(jnp.int32))
        land = emit & ~over
        dest = jnp.where(land, q * R + alloc, nq * R)
        res = res.at[dest].set(value, mode="drop")
        return res, rc.at[q].add(land.astype(jnp.int32)), needs, land.sum()

    res = np.full(nq * R, -1, np.int32)
    *want, want_landed = reference(*(jnp.asarray(x) for x in (q, emit, value, rc, needs, res)))
    bufs = [torch.from_numpy(x.copy()) for x in (res, rc, needs)]
    landed = trk.list_emit_plain(torch.from_numpy(q), torch.from_numpy(emit),
                                 torch.from_numpy(value), *bufs, result_cap=R)
    for got, w in zip(bufs, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert int(landed) == int(want_landed)
    return int(landed)


@pytest.mark.parametrize("N,nq,R", [(64, 4, 4), (500, 16, 8), (3000, 128, 3)])
def test_list_emit_plain_equals_bump_emit(N, nq, R):
    """The plain L1 against keto_tpu's _bump_emit and the result write
    around it, on queries in random order."""
    rng = np.random.default_rng(N)
    q = rng.integers(0, nq, N).astype(np.int32)
    emit = rng.random(N) < 0.6
    value = rng.integers(0, 1 << 20, N).astype(np.int32)
    rc = rng.integers(0, R + 1, nq).astype(np.int32)
    needs = rng.integers(0, 3, nq).astype(np.int32)
    assert _list_emit_against_bump_emit(q, emit, value, rc, needs, R) > 0


# keys in long runs (sorted by query, as L2's candidates and K4's frontier
# come), then a tail of padding that does not emit; all on one key
@pytest.mark.parametrize("order,N,nq,R", [("runs", 5000, 8, 300), ("runs", 4000, 64, 40),
                                          ("one_key", 3000, 16, 1000)])
def test_list_emit_plain_equals_bump_emit_in_runs(order, N, nq, R):
    rng = np.random.default_rng(N + nq)
    if order == "runs":
        q = np.sort(rng.integers(0, nq, N))
    else:
        q = np.full(N, rng.integers(0, nq))
    q = q.astype(np.int32)
    emit = (rng.random(N) < 0.7) & (np.arange(N) < int(0.6 * N))
    value = rng.integers(0, 1 << 20, N).astype(np.int32)
    rc = rng.integers(0, R // 2, nq).astype(np.int32)
    needs = rng.integers(0, 3, nq).astype(np.int32)
    landed = _list_emit_against_bump_emit(q, emit, value, rc, needs, R)
    assert 0 < landed < int(emit.sum())  # some land, some overflow their query's cap


# -- (c) the engines -------------------------------------------------------------------


class ListPair:
    """The same store and config behind both engines and both oracles."""

    def __init__(self, namespaces, tuples, max_depth=16):
        self.jcfg = JConfig({"limit": {"max_read_depth": max_depth}})
        self.jcfg.set_namespaces(namespaces)
        self.tcfg = TConfig({"limit": {"max_read_depth": max_depth}})
        self.tcfg.set_namespaces(port_namespaces(namespaces))
        self.jm, self.tm = JMemory(), TMemory()
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])
        self.jax = TPUCheckEngine(self.jm, self.jcfg)
        self.port = TorchCheckEngine(self.tm, self.tcfg, device="cpu")
        self.joracle, self.toracle = JReference(self.jm, self.jcfg), TReference(self.tm, self.tcfg)

    def objects(self, queries, max_depth=0, **caps):
        got = self.port.list_objects_batch([(n, r, _tsub(s)) for n, r, s in queries], max_depth,
                                           **caps)
        want = self.jax.list_objects_batch([(n, r, _jsub(s)) for n, r, s in queries], max_depth,
                                           **caps)
        assert got == want
        for (n, r, s), g in zip(queries, got):
            assert g == self.toracle.list_objects(n, r, _tsub(s), max_depth), (n, r, s)
            assert g == self.joracle.list_objects(n, r, _jsub(s), max_depth), (n, r, s)
        return got

    def subjects(self, queries, max_depth=0, **caps):
        got = self.port.list_subjects_batch(queries, max_depth, **caps)
        assert got == self.jax.list_subjects_batch(queries, max_depth, **caps)
        for (n, o, r), g in zip(queries, got):
            assert g == self.toracle.list_subjects(n, o, r, max_depth), (n, o, r)
            assert g == self.joracle.list_subjects(n, o, r, max_depth), (n, o, r)
        return got

    def same_stats(self):
        for leg in ("list_objects", "list_subjects"):
            for kind in ("device", "host"):
                key = f"{kind}_{leg}"
                assert self.port.stats[key] == self.jax.stats.get(key, 0), key


@pytest.fixture(scope="module")
def pair():
    namespaces, tuples, _q = all_scenarios()
    return ListPair(namespaces, tuples)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_lists_equal_jax_engine_and_oracles(pair, scenario):
    lo, ls = all_scenarios()[2][scenario]
    by_depth: dict = {}
    for n, r, s, d in lo:
        by_depth.setdefault(d, []).append((n, r, s))
    for d, queries in sorted(by_depth.items()):
        pair.objects(queries, d)
    by_depth = {}
    for n, o, r, d in ls:
        by_depth.setdefault(d, []).append((n, o, r))
    for d, queries in sorted(by_depth.items()):
        pair.subjects(queries, d)
    pair.same_stats()
    assert pair.port.stats["device_list_objects"] > 0


def test_engine_unknown_names_are_empty(pair):
    before = dict(pair.port.stats)
    got = pair.objects([("nope", "owner", "direct_alice"), ("direct_files", "nope", "direct_alice"),
                        ("direct_files", "owner", "ghost"),
                        ("direct_files", "owner", "direct_alice")])
    assert got == [[], [], [], ["a", "b"]]
    assert pair.subjects([("direct_files", "zzz", "owner")]) == [[]]
    # exactly-empty answers never reach the host oracle
    assert pair.port.stats["host_list_objects"] == before["host_list_objects"]
    pair.same_stats()


def test_engine_caps_replay_on_host(pair):
    """Queries past a tiny result cap are answered by the host oracle."""
    queries = [("cat_videos_videos", "view", "cat_videos_alice"), ("random_1_v", "r1", "random_1_u3")]
    before = pair.port.stats["host_list_objects"]
    pair.objects(queries, 0, result_cap=1)
    assert pair.port.stats["host_list_objects"] > before
    pair.same_stats()


def test_engine_pagination_tokens_chain(pair):
    query = ("random_5_v", "r2", "random_5_u3")
    full = pair.port.list_objects_batch([query])[0]
    assert len(full) > 3
    seen, token, pages = [], "", 0
    while True:
        page, next_token = pair.port.list_objects(*query, page_size=3, page_token=token)
        assert (page, next_token) == pair.jax.list_objects(*query, page_size=3, page_token=token)
        token = next_token
        assert len(page) <= 3
        seen += page
        pages += 1
        if not token:
            break
    assert seen == full and pages == -(-len(full) // 3)
    subs, token = pair.port.list_subjects("cat_videos_videos", "/d1/v1", "view", page_size=1)
    assert (subs, token) == pair.jax.list_subjects("cat_videos_videos", "/d1/v1", "view",
                                                   page_size=1)


@pytest.mark.parametrize("names,size,token", [
    (["a", "b", "c", "d", "e"], 2, ""), (["a", "b", "c", "d", "e"], 2, "4"),
    (["a", "b"], 0, ""), (["a", "b", "c"], 5, "1"), ([], 3, ""),
])
def test_paginate_names_equals_jax(names, size, token):
    assert tpaginate(names, size, token) == jpaginate(names, size, token)


@pytest.mark.parametrize("token", ["x", "-1"])
def test_paginate_names_rejects_bad_tokens(token):
    with pytest.raises(MalformedInputError):
        tpaginate(["a"], 1, token)


def test_engine_not_config_routes_every_query_to_host():
    ns = [JNamespace(name="n", relations=[
        Relation(name="allow"), Relation(name="deny"),
        Relation(name="access", subject_set_rewrite=SubjectSetRewrite(
            operation=Operator.AND,
            children=[ComputedSubjectSet(relation="allow"),
                      InvertResult(child=ComputedSubjectSet(relation="deny"))])),
    ])]
    p = ListPair(ns, ["n:d1#allow@u1", "n:d2#allow@u1", "n:d2#deny@u1"], max_depth=8)
    assert p.objects([("n", "access", "u1"), ("n", "allow", "u1")]) == [["d1"], ["d1", "d2"]]
    assert p.port.stats["host_cause"].get("island_host") == 2
    assert p.port.stats["device_list_objects"] == 0
    p.same_stats()


def test_engine_rebuilds_list_state_on_write():
    namespaces, tuples, _lo, _ls = cat_videos("")
    p = ListPair(namespaces, tuples, max_depth=8)
    assert p.objects([("videos", "view", "bob")]) == [["/d2", "/d2/v1"]]
    p.tm.write_relation_tuples([TTuple.from_string("videos:/d1#owner@bob")])
    p.jm.write_relation_tuples([JTuple.from_string("videos:/d1#owner@bob")])
    assert p.objects([("videos", "view", "bob")]) == \
        [["/d1", "/d1/v1", "/d1/v2", "/d2", "/d2/v1"]]
    assert p.subjects([("videos", "/d1/v2", "view")]) == \
        [["alice", "bob", "carol", "dana"]]
    # the write rides the overlay: one build, as in the JAX engine, and
    # the same device and host counts
    assert p.port.stats["snapshot_builds"] == p.jax.stats["snapshot_builds"] == 1
    p.same_stats()


# -- (d) the REST list routes ------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    namespaces, tuples, _lo, _ls = cat_videos("")
    cfg = TConfig({"limit": {"max_read_depth": 8, "page_size": 2}})
    cfg.set_namespaces(port_namespaces(namespaces))
    tm = TMemory()
    tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])
    registry = TRegistry(cfg, device="cpu", manager=tm)
    batcher = make_batcher(registry)
    srv = make_server(registry, "127.0.0.1", 0, batcher)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    batcher.close()


def _get(base, path, params):
    url = base + path + "?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


LO = "/relation-tuples/list-objects"
LS = "/relation-tuples/list-subjects"
REST_CASES = {
    "objects_page_1": (LO, {"namespace": "videos", "relation": "view", "subject_id": "alice"},
                       200, {"objects": ["/d1", "/d1/v1"], "next_page_token": "2"}),
    "objects_page_2": (LO, {"namespace": "videos", "relation": "view", "subject_id": "alice",
                            "page_token": "2", "page_size": "10"},
                       200, {"objects": ["/d1/v2", "/d2/v1"], "next_page_token": ""}),
    "objects_subject_set": (LO, {"namespace": "videos", "relation": "view",
                                 "subject_set.namespace": "groups",
                                 "subject_set.object": "eng",
                                 "subject_set.relation": "member"},
                            200, {"objects": ["/d1", "/d1/v1"], "next_page_token": "2"}),
    "objects_unknown_subject": (LO, {"namespace": "videos", "relation": "view",
                                     "subject_id": "ghost"},
                                200, {"objects": [], "next_page_token": ""}),
    # depth 1 reaches the direct owner edges and their computed view only
    "objects_depth": (LO, {"namespace": "videos", "relation": "view", "subject_id": "alice",
                           "max-depth": "1"},
                      200, {"objects": ["/d1", "/d2/v1"], "next_page_token": ""}),
    "subjects": (LS, {"namespace": "videos", "object": "/d1/v1", "relation": "view"},
                 200, {"subject_ids": ["alice", "carol"], "next_page_token": "2"}),
    "subjects_unknown_object": (LS, {"namespace": "videos", "object": "/zzz", "relation": "view"},
                                200, {"subject_ids": [], "next_page_token": ""}),
}


@pytest.mark.parametrize("case", sorted(REST_CASES))
def test_rest_list_routes(server, case):
    route, params, status, body = REST_CASES[case]
    assert _get(server, route, params) == (status, body)


@pytest.mark.parametrize("route,params,status", [
    (LO, {"namespace": "videos", "subject_id": "alice"}, 400),
    (LO, {"namespace": "videos", "relation": "view"}, 400),
    (LO, {"namespace": "videos", "relation": "view", "subject_id": "a", "page_token": "x"}, 400),
    (LO, {"namespace": "videos", "relation": "view", "subject_id": "a", "page_size": "x"}, 400),
    (LO, {"namespace": "nope", "relation": "view", "subject_id": "alice"}, 404),
    (LS, {"namespace": "videos", "relation": "view"}, 400),
    (LS, {"namespace": "nope", "object": "/d1", "relation": "view"}, 404),
])
def test_rest_list_route_errors(server, route, params, status):
    code, body = _get(server, route, params)
    assert code == status and body["error"]["code"] == status

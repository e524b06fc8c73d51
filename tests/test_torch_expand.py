"""The port's Expand path (keto_tpu_torch.engine.expand_kernel, the
engine's expand_batch and the host oracle's expand) held against the JAX
package's on identical inputs, on the CPU.

- the full-edge CSR and its packed tables equal the JAX package's
  build_full_csr / _pack_expand_csr / _merge_expand_dirty output
- expand_kernel_packed (plain versions of X1 and X2 around K2 and K4)
  returns a vector bit-identical to keto_tpu's, launch stats included,
  over the tests/test_expand_kernel.py fixtures and the overflow,
  truncation and dirty-row cases, and at a frontier of 32,768
- TorchCheckEngine(device="cpu").expand_batch trees equal
  TPUCheckEngine.expand_batch's exactly, and both equal their oracles
- the port's ReferenceEngine.expand equals keto_tpu's

Tolerance: exact equality; every output is an integer or a tree.
"""

import random

import numpy as np
import pytest
import torch

import keto_tpu.engine.expand_kernel as jek
import keto_tpu.engine.snapshot as jsnap
from keto_tpu.config import Config as JConfig
from keto_tpu.engine import delta as jdelta
from keto_tpu.engine.reference import ReferenceEngine as JReference
from keto_tpu.engine.tpu_engine import TPUCheckEngine
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.ketoapi import SubjectSet as JSubjectSet
from keto_tpu.namespace import Namespace as JNamespace
from keto_tpu.namespace.ast import ComputedSubjectSet, Relation, SubjectSetRewrite
from keto_tpu.storage import MemoryManager as JMemory

import keto_tpu_torch.engine.expand_kernel as tek
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.engine import delta as tdelta
from keto_tpu_torch.engine import snapshot as tsnap
from keto_tpu_torch.engine.reference import ReferenceEngine as TReference
from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.ketoapi import SubjectSet as TSubjectSet
from keto_tpu_torch.storage import MemoryManager as TMemory

from test_torch_kernel import layout, port_namespaces  # noqa: F401  (layout is a fixture)

PLAIN_NAMESPACES = ("files", "groups", "v")


# -- scenarios: (tuple strings, [(subject set string, depth)], global max depth) -


def single_level():
    return ["files:doc#owner@alice", "files:doc#owner@bob"], [("files:doc#owner", 5)], 5


def nested():
    tuples = [
        "files:doc#view@(groups:eng#member)", "groups:eng#member@alice",
        "groups:eng#member@(groups:leads#member)", "groups:leads#member@carol",
    ]
    queries = [("files:doc#view", d) for d in (1, 2, 3, 5)] + [("groups:eng#member", 5)]
    return tuples, queries + [("files:doc#missing", 5), ("files:nowhere#view", 3)], 5


def cycle():
    tuples = ["groups:a#member@(groups:b#member)", "groups:b#member@(groups:a#member)",
              "groups:b#member@bob"]
    return tuples, [("groups:a#member", 10), ("groups:b#member", 10), ("groups:a#member", 3)], 10


def self_cycle():
    return ["groups:g#member@(groups:g#member)", "groups:g#member@zoe"], [("groups:g#member", 8)], 8


def wide_fanout():
    tuples = [f"groups:g#member@u{i}" for i in range(200)]
    tuples += [f"groups:g#member@(groups:sub{j}#member)" for j in range(10)]
    tuples += [f"groups:sub{j}#member@m{j}" for j in range(10)]
    queries = [("groups:g#member", 5)] + [(f"groups:sub{j}#member", 2) for j in range(10)]
    return tuples, queries, 5


def subset_fanout():
    """Four sets of 20 nested sets each: 80 children at the first step."""
    tuples = [f"groups:g{k}#member@(groups:s{j}#member)" for k in range(4) for j in range(20)]
    tuples += [f"groups:s{j}#member@m{j}" for j in range(20)]
    return tuples, [(f"groups:g{k}#member", 5) for k in range(4)], 5


def random_graph(seed):
    def make():
        rng = random.Random(seed)
        objects = [f"o{i}" for i in range(12)]
        relations = ["r1", "r2"]
        tuples = set()
        for _ in range(60):
            obj, rel = rng.choice(objects), rng.choice(relations)
            if rng.random() < 0.45:
                tuples.add(f"v:{obj}#{rel}@(v:{rng.choice(objects)}#{rng.choice(relations)})")
            else:
                tuples.add(f"v:{obj}#{rel}@u{rng.randrange(8)}")
        queries = [(f"v:{o}#{r}", d) for o in objects[:6] for r in relations for d in (1, 2, 4, 6)]
        return sorted(tuples), queries, 6
    return make


SCENARIOS = {
    "single_level": single_level, "nested": nested, "cycle": cycle,
    "self_cycle": self_cycle, "wide_fanout": wide_fanout, "subset_fanout": subset_fanout,
    **{f"random_{s}": random_graph(s) for s in range(6)},
}


def jax_namespaces():
    return [JNamespace(name=n) for n in PLAIN_NAMESPACES]


def build_both(scenario, layout):
    tuples, queries, max_depth = SCENARIOS[scenario]()
    jt = [JTuple.from_string(s) for s in tuples]
    tt = [TTuple.from_string(s) for s in tuples]
    jsn = jsnap.build_snapshot(jt, jax_namespaces())
    tsn = tsnap.build_snapshot(tt, port_namespaces(jax_namespaces()), layout=layout)
    return jt, tt, jsn, tsn, queries, max_depth


def delta_ops(tuples, rng):
    """A few deletes of stored tuples and inserts over the stored names."""
    ops = [("delete", t) for t in rng.sample(tuples, min(3, len(tuples)))]
    for _ in range(3):
        a, b = rng.sample(tuples, 2)
        ops.append(("insert", JTuple(
            namespace=a.namespace, object=a.object, relation=b.relation,
            subject_id=b.subject_id, subject_set=b.subject_set,
        )))
    return ops


def jax_expand_tables(jsn, jt, delta=None) -> tuple[dict, int]:
    """The JAX engine's expand tables, as numpy, and fh_probes."""
    csr = jek.build_full_csr(jt, jsn)
    fh_probes = csr.pop("fh_probes")
    merged = TPUCheckEngine._merge_expand_dirty(
        TPUCheckEngine._pack_expand_csr(csr), delta or jdelta.empty_delta_tables()
    )
    return {k: np.asarray(v) for k, v in merged.items()}, fh_probes


def encode_queries(jsn, queries, B):
    view = jdelta.SnapshotView(jsn)
    q = np.zeros((4, B), dtype=np.int32)
    for i, (s, depth) in enumerate(queries):
        ss = JSubjectSet.from_string(s)
        q[2, i] = depth
        node = view.encode_node(ss.namespace, ss.object, ss.relation)
        if node is not None:
            q[0, i], q[1, i] = node
            q[3, i] = 1
    return q


def run_both(jsn, layout, tables, fh_probes, queries, max_depth, **caps):
    import jax.numpy as jnp

    B = 16 if len(queries) <= 16 else 64
    kw = dict(fh_probes=fh_probes, max_steps=max_depth + 2,
              frontier_cap=caps.get("frontier_cap", 4 * B), edge_cap=caps.get("edge_cap", 256),
              pool_cap=caps.get("pool_cap", max(32 * B, 4096)))
    qpack = encode_queries(jsn, queries, B)
    want = np.asarray(jek.expand_kernel_packed(
        {k: jnp.asarray(v) for k, v in tables.items()}, jnp.asarray(qpack), **kw
    ))
    got = tek.expand_kernel_packed(
        tek.expand_tables_from_numpy(tables, "cpu"), torch.from_numpy(qpack), layout=layout, **kw
    ).numpy()
    return got, want, B, kw


# -- (a) tables ------------------------------------------------------------------


@pytest.mark.parametrize("scenario", ["nested", "wide_fanout", "random_0", "random_3"])
def test_full_csr_and_tables_identical(layout, scenario):
    jt, tt, jsn, tsn, _q, _d = build_both(scenario, layout)
    want_csr = jek.build_full_csr(jt, jsn)
    got_csr = tek.build_full_csr(tt, tsn)
    assert set(got_csr) == set(want_csr)
    assert got_csr["fh_probes"] == want_csr["fh_probes"]
    for k in want_csr:
        np.testing.assert_array_equal(got_csr[k], want_csr[k], err_msg=k)
    want, _ = jax_expand_tables(jsn, jt)
    got = tek.pack_expand_tables(got_csr)
    assert set(got) == set(want) == set(tek.EXPAND_TABLE_KEYS)
    for k in tek.EXPAND_TABLE_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dirty_pack_identical(layout):
    jt, tt, jsn, tsn, _q, _d = build_both("random_1", layout)
    ops = delta_ops(jt, random.Random(5))
    jview = jdelta.SnapshotView(jsn, jdelta.build_vocab_overlay(jsn, ops))
    want, _ = jax_expand_tables(jsn, jt, jdelta.build_delta_tables(jview, ops))
    tops = [(op, TTuple.from_string(str(t))) for op, t in ops]
    tview = tdelta.SnapshotView(tsn, tdelta.build_vocab_overlay(tsn, tops))
    got = tek.pack_expand_tables(tek.build_full_csr(tt, tsn),
                                 tdelta.build_delta_tables(tview, tops))
    np.testing.assert_array_equal(got["dirty_pack"], want["dirty_pack"])
    assert (got["dirty_pack"][:, 0] >= 0).sum() >= 3


# -- (b) the whole launch ----------------------------------------------------------


def _stats(got, B):
    return got[3 * B + 1 : 3 * B + 1 + tek.N_LAUNCH_STATS]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_expand_kernel_packed_identical(layout, scenario):
    jt, _tt, jsn, _tsn, queries, max_depth = build_both(scenario, layout)
    tables, fh_probes = jax_expand_tables(jsn, jt)
    got, want, B, _kw = run_both(jsn, layout, tables, fh_probes, queries, max_depth)
    np.testing.assert_array_equal(got, want)
    assert 0 < _stats(got, B)[0] <= max_depth + 2


CAP_CASES = {
    # a row wider than the buffer: overflow, and the later tasks shift
    "tiny_edge_cap": ("wide_fanout", dict(edge_cap=8)),
    "tiny_edge_cap_random": ("random_2", dict(edge_cap=4)),
    # spans crossing the pool's end
    "tiny_pool_cap": ("random_4", dict(pool_cap=24)),
    # the frontier equals the batch: dedupe overflow
    "tiny_frontier_cap": ("subset_fanout", dict(frontier_cap=16)),
    # a 210-edge row past the 4F = 64 emission budget: truncation
    "row_past_budget": ("wide_fanout", dict(frontier_cap=16, edge_cap=512)),
}


@pytest.mark.parametrize("case", sorted(CAP_CASES))
def test_expand_kernel_packed_caps(layout, case):
    scenario, caps = CAP_CASES[case]
    jt, _tt, jsn, _tsn, queries, max_depth = build_both(scenario, layout)
    tables, fh_probes = jax_expand_tables(jsn, jt)
    got, want, B, kw = run_both(jsn, layout, tables, fh_probes, queries, max_depth, **caps)
    np.testing.assert_array_equal(got, want)
    _offs, _root, needs, _pool, _stats_ = tek.unpack_expand_results(got, B, kw["pool_cap"])
    assert needs.any()  # the case reached the flag it was built for


# past the one-block frontier the first X1 refused: 4 (2F + B) bytes
# of shared memory over 231,424 at F = 32,768
@pytest.mark.parametrize("scenario", ["wide_fanout", "random_3"])
def test_expand_kernel_packed_frontier_past_one_block(layout, scenario):
    jt, _tt, jsn, _tsn, queries, max_depth = build_both(scenario, layout)
    tables, fh_probes = jax_expand_tables(jsn, jt)
    got, want, B, kw = run_both(jsn, layout, tables, fh_probes, queries, max_depth,
                                frontier_cap=32768, edge_cap=1024)
    np.testing.assert_array_equal(got, want)
    assert _stats(got, B)[5] > 0  # edges emitted


def test_expand_kernel_packed_dirty_rows(layout):
    jt, _tt, jsn, _tsn, queries, max_depth = build_both("random_3", layout)
    ops = delta_ops(jt, random.Random(9))
    view = jdelta.SnapshotView(jsn, jdelta.build_vocab_overlay(jsn, ops))
    tables, fh_probes = jax_expand_tables(jsn, jt, jdelta.build_delta_tables(view, ops))
    got, want, B, kw = run_both(jsn, layout, tables, fh_probes, queries, max_depth)
    np.testing.assert_array_equal(got, want)
    needs = tek.unpack_expand_results(got, B, kw["pool_cap"])[2]
    assert 0 < needs.sum() < len(queries)


# -- (c) the engines -------------------------------------------------------------------


class ExpandPair:
    """The same store and config behind both engines and both oracles."""

    def __init__(self, tuples, max_depth, layout, namespaces=None):
        namespaces = namespaces or jax_namespaces()
        self.jcfg = JConfig({"limit": {"max_read_depth": max_depth}})
        self.jcfg.set_namespaces(namespaces)
        self.tcfg = TConfig({"limit": {"max_read_depth": max_depth}})
        self.tcfg.set_namespaces(port_namespaces(namespaces))
        self.jm, self.tm = JMemory(), TMemory()
        self.jm.write_relation_tuples([JTuple.from_string(s) for s in tuples])
        self.tm.write_relation_tuples([TTuple.from_string(s) for s in tuples])
        self.jax = TPUCheckEngine(self.jm, self.jcfg)
        self.port = TorchCheckEngine(self.tm, self.tcfg, device="cpu", layout=layout)

    def compare(self, subjects, max_depth=0, **caps):
        jsubs = [JSubjectSet.from_string(s) if "#" in s else s for s in subjects]
        tsubs = [TSubjectSet.from_string(s) if "#" in s else s for s in subjects]
        want = self.jax.expand_batch(jsubs, max_depth, **caps)
        got = self.port.expand_batch(tsubs, max_depth, **caps)
        joracle, toracle = JReference(self.jm, self.jcfg), TReference(self.tm, self.tcfg)
        for s, js, ts, g, w in zip(subjects, jsubs, tsubs, got, want):
            assert (g and g.to_dict()) == (w and w.to_dict()), s
            assert normalize(g) == normalize(toracle.expand(ts, max_depth)), s
            assert normalize(w) == normalize(joracle.expand(js, max_depth)), s
        for key in ("device_expands", "host_expands"):
            assert self.port.stats[key] == self.jax.stats[key], key
        return got


def normalize(tree):
    if tree is None:
        return None
    kids = sorted((normalize(c) for c in tree.children), key=repr)
    return (tree.type.value, str(tree.tuple) if tree.tuple else None, tuple(kids))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_trees_equal_jax_engine(layout, scenario):
    tuples, queries, max_depth = SCENARIOS[scenario]()
    pair = ExpandPair(tuples, max_depth, layout)
    by_depth: dict = {}
    for s, d in queries:
        by_depth.setdefault(d, []).append(s)
    for d, subjects in sorted(by_depth.items()):
        pair.compare(subjects, d)
    assert pair.port.stats["device_expands"] > 0


def test_engine_subject_ids_unknown_and_nil(layout):
    tuples, _q, max_depth = nested()
    pair = ExpandPair(tuples, max_depth, layout)
    got = pair.compare([
        "files:doc#view", "alice", "nope:doc#owner", "files:doc#missing",
        "groups:leads#member", "files:ghost#view",
    ], 4)
    assert got[0].type.value == "union" and got[1].type.value == "leaf"
    assert got[2] is None and got[3] is None and got[5] is None
    assert pair.port.stats == {**pair.port.stats, "device_expands": 2, "host_expands": 4}


def test_engine_overflow_replays_on_host(layout):
    pair = ExpandPair([f"files:doc#owner@user{i}" for i in range(40)], 5, layout)
    pair.compare(["files:doc#owner"], 3, edge_cap=8)
    assert pair.port.stats["host_expands"] == 1


def test_engine_rbac_shape(layout):
    """The chip smoke's expand shape (bench.py's config 3) at toy size:
    role member sets that nest earlier roles, docs with rewrite relations."""
    rng = random.Random(7)
    tuples = []
    for r in range(24):
        tuples += [f"role:r{r}#member@u{rng.randrange(40)}" for _ in range(4)]
        if r and rng.random() < 0.5:
            tuples.append(f"role:r{r}#member@(role:r{rng.randrange(r)}#member)")
    for d in range(30):
        tuples.append(f"doc:d{d}#owner@u{rng.randrange(40)}")
        tuples.append(f"doc:d{d}#editor@(role:r{rng.randrange(24)}#member)")
    namespaces = [
        JNamespace(name="role", relations=[Relation(name="member")]),
        JNamespace(name="doc", relations=[
            Relation(name="owner"),
            Relation(name="editor", subject_set_rewrite=SubjectSetRewrite(
                children=[ComputedSubjectSet(relation="owner")])),
        ]),
    ]
    pair = ExpandPair(sorted(set(tuples)), 6, layout, namespaces)
    subjects = [f"role:r{rng.randrange(24)}#member" for _ in range(40)]
    subjects += [f"doc:d{d}#editor" for d in range(8)]
    pair.compare(subjects, 6, frontier_cap=256, edge_cap=1024)
    assert pair.port.stats["host_expands"] == 0


def test_engine_rebuilds_expand_state_on_write(layout):
    tuples, _q, max_depth = nested()
    pair = ExpandPair(tuples, max_depth, layout)
    (before,) = pair.compare(["groups:eng#member"], 3)
    pair.tm.write_relation_tuples([TTuple.from_string("groups:eng#member@dave")])
    pair.jm.write_relation_tuples([JTuple.from_string("groups:eng#member@dave")])
    (after,) = pair.compare(["groups:eng#member"], 3)
    assert len(after.children) == len(before.children) + 1
    # the write rides the overlay (its dirty root replays on the host):
    # one build, as in the JAX engine
    assert pair.port.stats["snapshot_builds"] == pair.jax.stats["snapshot_builds"] == 1
    assert pair.port.stats["host_expands"] == pair.jax.stats["host_expands"] == 1


# -- (d) the host oracles ------------------------------------------------------------


@pytest.mark.parametrize("scenario", ["nested", "cycle", "self_cycle", "random_0", "random_5"])
def test_reference_expand_equals_jax_reference(scenario):
    tuples, queries, max_depth = SCENARIOS[scenario]()
    pair = ExpandPair(tuples, max_depth, "bucketized")
    joracle, toracle = JReference(pair.jm, pair.jcfg), TReference(pair.tm, pair.tcfg)
    for s, d in queries + [("alice", 2), ("u1", 0)]:
        js = JSubjectSet.from_string(s) if "#" in s else s
        ts = TSubjectSet.from_string(s) if "#" in s else s
        for depth in (0, 1, d):
            w, g = joracle.expand(js, depth), toracle.expand(ts, depth)
            assert (g and g.to_dict()) == (w and w.to_dict()), (s, depth)

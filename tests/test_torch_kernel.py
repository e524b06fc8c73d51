"""The port's check kernel (keto_tpu_torch.engine.kernel) held against the
JAX package's on identical inputs, on the CPU.

- snapshot: the port's builder packs the same tables as the JAX package's
  under both table layouts
- the plain versions of the four CUDA kernels against the JAX phase
  functions they replace
- check_kernel_packed: the whole int32 result vector, launch stats
  included, over the differential, island and host-fallback scenarios,
  with and without the delta overlay

Tolerance: exact equality; every output is an integer. The JAX side runs
on the CPU as the rest of the suite runs it (tests/conftest.py). The
CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import random

import numpy as np
import pytest
import torch

import keto_tpu.engine.kernel as jk
import keto_tpu.engine.snapshot as jsnap
from keto_tpu.engine import delta as jdelta
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

import keto_tpu_torch.engine.kernel as tk
from keto_tpu_torch.engine import delta as tdelta
from keto_tpu_torch.engine import snapshot as tsnap
from keto_tpu_torch.ketoapi import RelationTuple as TTuple
from keto_tpu_torch.namespace import Namespace as TNamespace

from test_reference_engine import REWRITE_CASES, REWRITE_NAMESPACES, REWRITE_TUPLES
from test_torch_cuda import DEDUPE_CASES, dedupe_case

LAYOUTS = ("compact", "bucketized")


# -- scenarios: (JAX namespaces, tuple strings, query strings, max depth) ------


def _ns(name, relations=()):
    return JNamespace(name=name, relations=list(relations))


def _union(*children):
    return SubjectSetRewrite(children=list(children))


def cat_videos():
    tuples = [
        "videos:/cats/1.mp4#owner@(videos:/cats#owner)",
        "videos:/cats/2.mp4#owner@(videos:/cats#owner)",
        "videos:/cats#owner@cat lady",
        "videos:/cats#view@(videos:/cats#owner)",
        "videos:/cats/1.mp4#view@(videos:/cats/1.mp4#owner)",
        "videos:/cats/1.mp4#view@*",
        "videos:/cats/2.mp4#view@(videos:/cats/2.mp4#owner)",
    ]
    queries = [
        "videos:/cats/1.mp4#view@*",
        "videos:/cats/1.mp4#view@cat lady",
        "videos:/cats/2.mp4#view@cat lady",
        "videos:/cats/2.mp4#view@john",
        "videos:/cats#view@cat lady",
        "videos:/cats#owner@cat lady",
        "videos:/cats/1.mp4#owner@cat lady",
        "videos:/cats/1.mp4#view@(videos:/cats#owner)",
    ]
    return [_ns("videos")], tuples, queries, 5


def rewrite_fixtures():
    return REWRITE_NAMESPACES, REWRITE_TUPLES, [q for q, _ in REWRITE_CASES], 100


def deep_chain():
    ns = _ns("deep", [
        Relation(name="owner"),
        Relation(name="parent"),
        Relation(name="editor", subject_set_rewrite=_union(ComputedSubjectSet(relation="owner"))),
        Relation(name="viewer", subject_set_rewrite=_union(
            ComputedSubjectSet(relation="editor"),
            TupleToSubjectSet(relation="parent", computed_subject_set_relation="viewer"),
        )),
    ])
    tuples = ["deep:deep_file#parent@(deep:folder_1#...)"]
    tuples += [f"deep:folder_{i}#parent@(deep:folder_{i + 1}#...)" for i in range(1, 24)]
    tuples += [f"deep:folder_{d}#owner@user_{d}" for d in (2, 4, 8, 16)]
    queries = [f"deep:deep_file#viewer@user_{d}" for d in (2, 4, 8, 16)]
    queries += ["deep:folder_3#viewer@user_4", "deep:deep_file#viewer@nobody"]
    return [ns], tuples, queries, 12


def random_monotone(seed=42):
    rng = random.Random(seed)
    rels = ["r0", "r1", "r2"]
    ns = _ns("rnd", [
        Relation(name="r0"),
        Relation(name="r1"),
        Relation(name="r2", subject_set_rewrite=_union(
            ComputedSubjectSet(relation="r0"),
            TupleToSubjectSet(relation="r1", computed_subject_set_relation="r2"),
        )),
    ])
    tuples = set()
    for _ in range(160):
        if rng.random() < 0.45:
            sub = f"(rnd:o{rng.randrange(30)}#{rng.choice(rels + ['...'])})"
        else:
            sub = f"u{rng.randrange(10)}"
        tuples.add(f"rnd:o{rng.randrange(30)}#{rng.choice(rels)}@{sub}")
    queries = [
        f"rnd:o{rng.randrange(30)}#{rng.choice(rels)}@u{rng.randrange(10)}"
        for _ in range(48)
    ]
    return [ns], sorted(tuples), queries, 8


def random_islands(seed=1234):
    rng = random.Random(seed)
    names = [f"r{i}" for i in range(6)]

    def rewrite(i):
        higher = names[i + 1:]
        if not higher or rng.random() < 0.3:
            return None

        def leaf():
            r = rng.choice(higher)
            if rng.random() < 0.5:
                return ComputedSubjectSet(relation=r)
            return TupleToSubjectSet(relation=rng.choice(names), computed_subject_set_relation=r)

        def node(budget):
            roll = rng.random()
            if budget <= 0 or roll < 0.45:
                return leaf()
            if roll < 0.6:
                return InvertResult(child=node(budget - 1))
            op = Operator.AND if rng.random() < 0.5 else Operator.OR
            return SubjectSetRewrite(
                operation=op, children=[node(budget - 1) for _ in range(rng.randrange(2, 4))]
            )

        rw = node(2)
        return rw if isinstance(rw, SubjectSetRewrite) else _union(rw)

    ns = _ns("rnd", [Relation(name=r, subject_set_rewrite=rewrite(i)) for i, r in enumerate(names)])
    tuples = set()
    for _ in range(150):
        if rng.random() < 0.4:
            sub = f"(rnd:o{rng.randrange(24)}#{rng.choice(names)})"
        else:
            sub = f"u{rng.randrange(8)}"
        tuples.add(f"rnd:o{rng.randrange(24)}#{rng.choice(names)}@{sub}")
    queries = [
        f"rnd:o{rng.randrange(24)}#{rng.choice(names)}@u{rng.randrange(8)}" for _ in range(48)
    ]
    return [ns], sorted(tuples), queries, 10


def host_causes():
    """Rewrite cap (K + 1 union children), relation not found, island
    overflow (fan-out into AND/NOT islands), step exhaustion (a chain
    longer than the step budget), unknown subjects."""
    K = 8
    wide = _ns("w", [Relation(name=f"r{i}") for i in range(K + 1)] + [
        Relation(name="wide", subject_set_rewrite=_union(
            *[ComputedSubjectSet(relation=f"r{i}") for i in range(K + 1)]
        )),
    ])
    known = _ns("n", [Relation(name="known")])
    acl = _ns("acl", [
        Relation(name="allow"), Relation(name="deny"), Relation(name="parent"),
        Relation(name="access", subject_set_rewrite=SubjectSetRewrite(
            operation=Operator.AND,
            children=[
                ComputedSubjectSet(relation="allow"),
                InvertResult(child=ComputedSubjectSet(relation="deny")),
            ],
        )),
        Relation(name="super", subject_set_rewrite=_union(
            TupleToSubjectSet(relation="parent", computed_subject_set_relation="access"),
        )),
    ])
    chain = _ns("d", [
        Relation(name="owner"), Relation(name="parent"),
        Relation(name="w", subject_set_rewrite=_union(
            ComputedSubjectSet(relation="owner"),
            TupleToSubjectSet(relation="parent", computed_subject_set_relation="v"),
        )),
        Relation(name="v", subject_set_rewrite=_union(ComputedSubjectSet(relation="w"))),
    ])
    tuples = [f"w:o#r{K}@alice", "n:o#rogue@u"]
    tuples += [f"acl:root#parent@(acl:doc{i}#...)" for i in range(40)]
    tuples += ["acl:doc39#allow@alice", "acl:doc3#allow@bob", "acl:doc3#deny@bob"]
    tuples += [f"d:f{i}#parent@(d:f{i + 1}#...)" for i in range(40)]
    tuples += ["d:f40#owner@user"]
    queries = [
        "w:o#wide@alice", "w:o#wide@bob", "n:o#rogue@u", "n:o#rogue@v",
        "acl:root#super@alice", "acl:doc3#access@bob", "acl:doc39#access@alice",
        "d:f0#v@user", "d:f25#v@user", "n:o#rogue@ghost",
    ]
    return [wide, known, acl, chain], tuples, queries, 40


SCENARIOS = {
    "cat_videos": cat_videos,
    "rewrite_fixtures": rewrite_fixtures,
    "deep_chain": deep_chain,
    "random_monotone": random_monotone,
    "random_islands": random_islands,
    "host_causes": host_causes,
}


def port_namespaces(namespaces):
    return [TNamespace.from_dict(ns.to_dict()) for ns in namespaces]


# -- fixtures --------------------------------------------------------------------


@pytest.fixture(scope="module", params=LAYOUTS)
def layout(request):
    """Pin the JAX package's process-global table layout (and drop its
    jit caches, whose traces bake the layout in) for one layout's tests."""
    import jax

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsnap, "_TABLE_LAYOUT", None)
        mp.setenv("KETO_TABLE_LAYOUT", request.param)
        jax.clear_caches()
        yield request.param
    jax.clear_caches()


def build_both(scenario, layout):
    namespaces, tuples, _queries, _depth = SCENARIOS[scenario]()
    jsn = jsnap.build_snapshot([JTuple.from_string(s) for s in tuples], namespaces)
    tsn = tsnap.build_snapshot(
        [TTuple.from_string(s) for s in tuples], port_namespaces(namespaces), layout=layout
    )
    return jsn, tsn


def jax_packed(jsn, delta=None, vocab=None) -> dict:
    packed = {k: np.asarray(v) for k, v in jk.snapshot_tables(jsn, delta).items()}
    if vocab is not None:
        packed.update(vocab)
    return packed


def encode_queries(jsn, queries, B, depth):
    """The [7, B] query pack, encoded as the JAX engine encodes it."""
    view = jdelta.SnapshotView(jsn)
    q = np.zeros((7, B), dtype=np.int32)
    q[2] = depth
    q[4] = -2
    for i, s in enumerate(queries):
        t = JTuple.from_string(s)
        node = view.encode_node(t.namespace, t.object, t.relation)
        if node is None:
            continue
        q[0, i], q[1, i] = node
        sub = view.encode_subject(t)
        if sub is not None:
            q[3, i], q[4, i], q[5, i] = sub
        q[6, i] = 1
    return q


def delta_ops(tuples, rng):
    """A few deletes of stored tuples and inserts over the stored names."""
    parsed = [JTuple.from_string(s) for s in tuples]
    ops = [("delete", t) for t in rng.sample(parsed, min(4, len(parsed)))]
    for _ in range(4):
        a, b = rng.sample(parsed, 2)
        ops.append(("insert", JTuple(
            namespace=a.namespace, object=a.object, relation=b.relation,
            subject_id=b.subject_id, subject_set=b.subject_set,
        )))
    return ops


# -- snapshot --------------------------------------------------------------------


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_snapshot_tables_identical(layout, scenario):
    jsn, tsn = build_both(scenario, layout)
    assert tsn.layout == jsnap.table_layout() == layout
    for attr in ("dh_probes", "rh_probes", "K", "n_config_rels", "wildcard_rel"):
        assert getattr(tsn, attr) == getattr(jsn, attr), attr
    assert tsn.island_circuits == jsn.island_circuits
    want = jax_packed(jsn)
    got = tk.pack_raw_tables({**tsn.device_arrays(), **tdelta.empty_delta_tables()})
    assert set(got) == set(tk.TABLE_KEYS)
    for k in tk.TABLE_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_delta_tables_identical(layout):
    namespaces, tuples, _q, _d = random_monotone()
    ops = delta_ops(tuples, random.Random(7))
    jsn, tsn = build_both("random_monotone", layout)
    jview = jdelta.SnapshotView(jsn, jdelta.build_vocab_overlay(jsn, ops))
    want = jk.pack_delta_tables(jdelta.build_delta_tables(jview, ops))
    tops = [(op, TTuple.from_string(str(t))) for op, t in ops]
    tview = tdelta.SnapshotView(tsn, tdelta.build_vocab_overlay(tsn, tops))
    got = tk.pack_raw_tables({**tsn.device_arrays(), **tdelta.build_delta_tables(tview, tops)})
    for k in ("dd_pack", "dirty_pack"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["dd_pack"][:, 5] == 0).sum() >= 1  # a tombstone is in the overlay


def test_hash_matches_numpy():
    rng = np.random.default_rng(0)
    parts = [rng.integers(-(2**31), 2**31, size=257, dtype=np.int64).astype(np.int32)
             for _ in range(5)]
    want = tsnap.hash_combine(*parts).astype(np.int64)
    got = tk.hash_combine(*[torch.from_numpy(p) for p in parts]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tk.mix32(torch.from_numpy(want)).numpy(), tsnap.mix32(want).astype(np.int64)
    )


# -- the plain kernels against the JAX phases ---------------------------------------


def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def _task_inputs(jsn, F, rng):
    """[F] task columns over B = 24 queries: about half the tasks probe a
    stored edge exactly (their object, relation and query subject come
    from one stored edge), the rest are random."""
    B = 24
    stored = np.flatnonzero(jsn.dh_val != -1)
    src = rng.choice(stored, size=B)
    qsub = np.zeros((B, 4), dtype=np.int32)
    qsub[:, 0], qsub[:, 1], qsub[:, 2] = jsn.dh_skind[src], jsn.dh_sa[src], jsn.dh_sb[src]
    q = rng.integers(0, B, F).astype(np.int32)
    exact = rng.random(F) < 0.5
    obj = np.where(exact, jsn.dh_obj[src][q], rng.integers(0, 40, F)).astype(np.int32)
    rel = np.where(exact, jsn.dh_rel[src][q], rng.integers(0, 8, F)).astype(np.int32)
    depth = rng.integers(-1, 4, F).astype(np.int32)
    live = rng.random(F) < 0.85
    return obj, rel, q, qsub, depth, live


@pytest.mark.parametrize("has_delta", [False, True])
@pytest.mark.parametrize("scenario", ["random_monotone", "rewrite_fixtures"])
def test_edge_probe_plain_matches_probe_phase(layout, scenario, has_delta):
    rng = np.random.default_rng(3)
    jsn, _ = build_both(scenario, layout)
    namespaces, tuples, _q, _d = SCENARIOS[scenario]()
    delta = None
    if has_delta:
        ops = delta_ops(tuples, random.Random(11))
        view = jdelta.SnapshotView(jsn, jdelta.build_vocab_overlay(jsn, ops))
        delta = jdelta.build_delta_tables(view, ops)
    packed = jax_packed(jsn, delta)
    F = 256
    obj, rel, q, qsub, depth, live = _task_inputs(jsn, F, rng)
    jt = {k: _jnp(v) for k, v in packed.items()}
    want = jk.probe_phase(
        jt, _jnp(obj), _jnp(rel), _jnp(qsub[q, 0]), _jnp(qsub[q, 1]), _jnp(qsub[q, 2]),
        _jnp(depth), _jnp(live), dh_probes=jsn.dh_probes, has_delta=has_delta,
    )
    tt = tk.tables_from_numpy(packed, "cpu")
    got = tk.edge_probe(
        tt, torch.from_numpy(obj), torch.from_numpy(rel), torch.from_numpy(q),
        torch.from_numpy(qsub), torch.from_numpy(depth), torch.from_numpy(live),
        dh_probes=jsn.dh_probes, spb=tsnap.slots_per_bucket(5, layout), has_delta=has_delta,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


@pytest.mark.parametrize("n_vals", [1, 2])
def test_pair_probe_plain_matches_multi_pair_key_probe(layout, n_vals):
    rng = np.random.default_rng(5)
    jsn, _ = build_both("random_monotone", layout)
    packed = jax_packed(jsn)
    F, S = 128, 3
    rows = np.flatnonzero(jsn.rh_row != -1)
    pick = rng.choice(rows, size=(F, S))
    obj = jsn.rh_obj[pick[:, 0]].astype(np.int32)
    rels = np.where(rng.random((F, S)) < 0.6, jsn.rh_rel[pick], rng.integers(0, 6, (F, S)))
    rels = rels.astype(np.int32)
    want = jk._multi_pair_key_probe(
        {k: _jnp(v) for k, v in packed.items()}, "rh", _jnp(obj), _jnp(rels),
        jsn.rh_probes, n_vals=n_vals,
    )
    got = tk.pair_probe(
        torch.from_numpy(packed["rh_pack"].copy()), torch.from_numpy(obj), torch.from_numpy(rels),
        probes=jsn.rh_probes, spb=tsnap.slots_per_bucket(2, layout), n_vals=n_vals,
    )
    want = np.asarray(want).reshape(F, S, n_vals)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any()


@pytest.mark.parametrize("n_vals", [1, 2])
def test_pair_probe_plain_matches_on_zero_tail_with_duplicate_keys(layout, n_vals):
    """A frontier as K4 leaves it: a live head whose (obj, rel) keys repeat
    (tasks of many queries on a dozen stored rows, slots without an
    instruction probing (obj, 0)) and a zero-filled tail that probes
    (0, 0) at every slot."""
    rng = np.random.default_rng(9)
    jsn, _ = build_both("random_monotone", layout)
    packed = jax_packed(jsn)
    F, S, n_live = 256, 3, 90
    pick = rng.choice(np.flatnonzero(jsn.rh_row != -1), size=12)
    src = pick[rng.integers(0, len(pick), n_live)]
    obj = np.zeros(F, np.int32)
    rels = np.zeros((F, S), np.int32)
    obj[:n_live] = jsn.rh_obj[src]
    rels[:n_live, 0] = jsn.rh_rel[src]
    lanes = jsn.rh_rel[pick[rng.integers(0, len(pick), (n_live, S - 1))]]
    rels[:n_live, 1:] = np.where(rng.random((n_live, S - 1)) < 0.5, 0, lanes)
    want = jk._multi_pair_key_probe(
        {k: _jnp(v) for k, v in packed.items()}, "rh", _jnp(obj), _jnp(rels),
        jsn.rh_probes, n_vals=n_vals,
    )
    got = tk.pair_probe(
        torch.from_numpy(packed["rh_pack"].copy()), torch.from_numpy(obj), torch.from_numpy(rels),
        probes=jsn.rh_probes, spb=tsnap.slots_per_bucket(2, layout), n_vals=n_vals,
    )
    want = np.asarray(want).reshape(F, S, n_vals)
    np.testing.assert_array_equal(got.numpy(), want)
    keys = np.unique(np.stack([np.repeat(obj, S), rels.ravel()], -1), axis=0)
    assert len(keys) < F * S // 8 and (want[:n_live, 0] >= 0).any()


def expand_both(jsn, layout, packed, cols, *, B, n_island_cap=0, has_delta=False):
    """The port's expand phase (glue + pair_probe + expand_gather) and the
    JAX expand_phase on the same task columns (q, ctx, obj, rel, depth,
    live): the candidate columns in the same order, the per-query causes
    and the island table must be equal. Returns the port's (candidates,
    causes)."""
    q, ctx, obj, rel, depth, live = cols
    isl = (np.zeros(max(n_island_cap, 1), np.int32),) * 2 + (np.int32(2),)
    ncr = max(jsn.n_config_rels, 1)
    jt = {k: _jnp(v) for k, v in packed.items()}
    jprog = jk.program_lookup(jt, _jnp(obj), _jnp(rel), _jnp(live), n_config_rels=ncr)
    (jch, jover, jisl) = jk.expand_phase(
        jt, _jnp(q), _jnp(ctx), _jnp(obj), _jnp(rel), _jnp(depth), _jnp(live),
        tuple(_jnp(x) for x in isl), K=jsn.K, rh_probes=jsn.rh_probes,
        n_config_rels=ncr, wildcard_rel=jsn.wildcard_rel, n_queries=B,
        n_island_cap=n_island_cap, has_delta=has_delta, prog=jprog,
    )
    tt = tk.tables_from_numpy(packed, "cpu")
    T = torch.from_numpy
    tprog = tk.program_lookup(tt, T(obj), T(rel), T(live), n_config_rels=ncr)
    tch, tover, tisl = tk.expand_phase(
        tt, T(q), T(ctx), T(obj), T(rel), T(depth), T(live),
        (T(isl[0]), T(isl[1]), torch.tensor(2, dtype=torch.int32)), tprog,
        K=jsn.K, rh_probes=jsn.rh_probes, spb_pair=tsnap.slots_per_bucket(2, layout),
        wildcard_rel=jsn.wildcard_rel, n_queries=B, n_island_cap=n_island_cap,
        has_delta=has_delta,
    )
    for name in ("q", "ctx", "obj", "rel", "depth", "valid"):
        np.testing.assert_array_equal(
            getattr(tch, name).numpy(), np.asarray(getattr(jch, name)), err_msg=name
        )
    np.testing.assert_array_equal(tover.numpy(), np.asarray(jover))
    for t_, j_ in zip(tisl, jisl):
        np.testing.assert_array_equal(np.asarray(t_), np.asarray(j_))
    return tch, tover


@pytest.mark.parametrize("has_delta", [False, True])
@pytest.mark.parametrize("n_island_cap", [0, 6])
@pytest.mark.parametrize("scenario", ["random_islands", "rewrite_fixtures", "host_causes"])
def test_expand_phase_matches(layout, scenario, n_island_cap, has_delta):
    """The port's expand phase against the JAX expand_phase on random
    tasks (expand_both)."""
    rng = np.random.default_rng(9)
    jsn, _ = build_both(scenario, layout)
    namespaces, tuples, _q, _d = SCENARIOS[scenario]()
    delta = None
    if has_delta:
        ops = delta_ops(tuples, random.Random(13))
        view = jdelta.SnapshotView(jsn, jdelta.build_vocab_overlay(jsn, ops))
        delta = jdelta.build_delta_tables(view, ops)
    packed = jax_packed(jsn, delta)
    F, B = 64, 16
    n_obj = max(jsn.obj_slots.values()) + 1
    q = rng.integers(0, B, F).astype(np.int32)
    ctx = q.copy()
    obj = rng.integers(0, n_obj, F).astype(np.int32)
    rel = rng.integers(0, len(jsn.rel_ids), F).astype(np.int32)
    depth = rng.integers(0, 4, F).astype(np.int32)
    live = rng.random(F) < 0.8
    tch, _ = expand_both(jsn, layout, packed, (q, ctx, obj, rel, depth, live), B=B,
                         n_island_cap=n_island_cap, has_delta=has_delta)
    assert tch.valid.any()


def fanout_snapshot():
    """K = 1, so S = 2: `view` = `member` over 200 objects whose member rows
    hold 0-12 subject sets (some of them the `...` wildcard), so a task's
    segment counts are its row's length and its computed slot's 1."""
    rng = random.Random(5)
    ns = _ns("f", [
        Relation(name="member"),
        Relation(name="view", subject_set_rewrite=_union(ComputedSubjectSet(relation="member"))),
    ])
    tuples = {
        f"f:o{i}#member@(f:o{rng.randrange(200)}#{rng.choice(['member', 'view', '...'])})"
        for i in range(200) for _ in range(rng.randrange(13))
    }
    return jsnap.build_snapshot([JTuple.from_string(s) for s in sorted(tuples)], [ns])


# name: (F tasks, live share); S = 2, so a 1,024-count tile of K3's scan
# (csrc/check_kernels.cu kScanTile) is 512 tasks
EXPAND_TILE_CASES = {
    "below_tile": (511, 0.9),
    "at_tile": (512, 0.9),
    "above_tile": (513, 0.9),
    "three_tiles_and_5": (3 * 512 + 5, 0.9),
    "past_total": (3 * 512 + 5, 0.1),
}


@pytest.mark.parametrize("case", sorted(EXPAND_TILE_CASES))
def test_expand_phase_matches_at_tiles(layout, case):
    """expand_gather_plain inside the port's expand phase against the JAX
    expand_phase where K3's tiles break: F * S one below, at and one above
    a tile and at three tiles and 10 slots, the last tasks dead (trailing
    empty segments); dense tasks overflow the frontier (total > F),
    sparse ones leave slots past the total, whose columns still come from
    the last segment."""
    F, live_share = EXPAND_TILE_CASES[case]
    rng = np.random.default_rng(F)
    jsn = fanout_snapshot()
    assert jsn.K == 1
    B = 64
    q = rng.integers(0, B, F).astype(np.int32)
    obj = rng.integers(0, max(jsn.obj_slots.values()) + 1, F).astype(np.int32)
    rel = rng.integers(0, len(jsn.rel_ids), F).astype(np.int32)
    depth = rng.integers(0, 4, F).astype(np.int32)
    live = rng.random(F) < live_share
    live[-(F // 20):] = False
    tch, tover = expand_both(jsn, layout, jax_packed(jsn), (q, q.copy(), obj, rel, depth, live),
                             B=B)
    dense = live_share > 0.5
    assert bool(tover.any()) == dense
    assert bool(tch.valid[-1]) is False or dense
    assert tch.valid.any()


@pytest.mark.parametrize("F", [16, 64, 256])
def test_dedupe_plain_matches_dedupe_phase(F):
    rng = np.random.default_rng(F)
    G, B = F, 12
    ctx = rng.integers(0, 6, G).astype(np.int32)  # narrow keys: many duplicates
    obj = rng.integers(0, 5, G).astype(np.int32)
    rel = rng.integers(0, 3, G).astype(np.int32)
    q = (ctx % B).astype(np.int32)
    depth = rng.integers(-1, 6, G).astype(np.int32)
    valid = rng.random(G) < 0.8
    jch = jk.Expansion(*(_jnp(x) for x in (q, ctx, obj, rel, depth, valid)))
    want = jk.dedupe_phase(jch, F, B)
    T = torch.from_numpy
    got = tk.dedupe_compact(tk.Expansion(T(q), T(ctx), T(obj), T(rel), T(depth), T(valid)),
                            F=F, n_queries=B)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert 0 < int(got[5]) < int(valid.sum())  # duplicates were dropped


@pytest.mark.parametrize("case", sorted(DEDUPE_CASES))
def test_dedupe_plain_matches_dedupe_phase_at_tiles(case):
    """dedupe_compact_plain against the JAX dedupe_phase where K4's tiles
    break (G one below, at and one above a tile, three tiles and 5), at
    Expand's G = 4F, with every candidate invalid, with every one kept and
    F short (overflow raised per query), and with one query owning every
    candidate, as in a filter walk: every frontier column, the zeros past
    n_new, n_new and the causes."""
    G, F, B, kind = DEDUPE_CASES[case]
    cols = dedupe_case(kind, G, B)
    want = jk.dedupe_phase(jk.Expansion(*(_jnp(x) for x in cols)), F, B)
    got = tk.dedupe_compact(tk.Expansion(*(torch.from_numpy(c) for c in cols)),
                            F=F, n_queries=B)
    for name, g, w in zip(("q", "ctx", "obj", "rel", "depth", "n_new", "overflow"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
    assert (int(got[5]) == 0) == (kind == "invalid")
    assert bool(got[6].any()) == (F < G and kind != "invalid")


def test_dedupe_rejects_too_many_candidates():
    with pytest.raises(ValueError):
        tk.dedupe_bits(1 << 29)


# -- the whole launch ------------------------------------------------------------


def run_both(jsn, layout, queries, max_depth, *, F, has_delta, delta=None, vocab=None):
    B = 16 if len(queries) <= 16 else 64
    cfg = jk.kernel_static_config(
        jsn, max_depth, F, n_island_cap=2 * B, has_delta=has_delta
    )
    qpack = encode_queries(jsn, queries, B, max_depth)
    packed = jax_packed(jsn, delta, vocab)
    want = np.asarray(jk.check_kernel_packed(
        {k: _jnp(v) for k, v in packed.items()}, _jnp(qpack), **cfg
    ))
    got = tk.check_kernel_packed(
        tk.tables_from_numpy(packed, "cpu"), torch.from_numpy(qpack), layout=layout, **cfg
    ).numpy()
    return got, want, cfg


@pytest.mark.parametrize("has_delta", [False, True])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_check_kernel_packed_identical(layout, scenario, has_delta):
    namespaces, tuples, queries, max_depth = SCENARIOS[scenario]()
    jsn, _ = build_both(scenario, layout)
    delta = vocab = None
    if has_delta:
        ops = delta_ops(tuples, random.Random(17))
        overlay = jdelta.build_vocab_overlay(jsn, ops)
        delta = jdelta.build_delta_tables(jdelta.SnapshotView(jsn, overlay), ops)
        vocab = {"objslot_ns": overlay.objslot_ns, "ns_has_config": overlay.ns_has_config}
    got, want, cfg = run_both(
        jsn, layout, queries, max_depth, F=256, has_delta=has_delta, delta=delta, vocab=vocab
    )
    np.testing.assert_array_equal(got, want)
    steps = got[-tk.N_LAUNCH_STATS + tk.STAT_STEPS]
    assert 0 < steps <= cfg["max_steps"]


def test_host_causes_are_all_raised(layout):
    """The host-cause scenario reaches every cause it was built for."""
    namespaces, tuples, queries, max_depth = host_causes()
    jsn, _ = build_both("host_causes", layout)
    got, want, cfg = run_both(jsn, layout, queries, max_depth, F=64, has_delta=False)
    np.testing.assert_array_equal(got, want)
    _ctx, needs_host, *_ = tk.unpack_results(got, 16, cfg["n_island_cap"], jsn.K)
    causes = set(needs_host[: len(queries)].tolist())
    assert {tk.CAUSE_REWRITE_CAP, tk.CAUSE_REL_NOT_FOUND} <= causes
    assert {tk.CAUSE_ISLAND_OVERFLOW, tk.CAUSE_STEP_EXHAUSTED} <= causes


@pytest.mark.parametrize("F", [16, 32])
def test_small_frontier_and_no_island_capacity(layout, F):
    """A frontier smaller than the fan-out truncates (frontier overflow),
    and a launch without island capacity sends AND/NOT to the host."""
    namespaces, tuples, queries, max_depth = rewrite_fixtures()
    jsn, _ = build_both("rewrite_fixtures", layout)
    qpack = encode_queries(jsn, queries[:16], 16, max_depth)
    packed = jax_packed(jsn)
    for island_cap in (0, 8):
        cfg = jk.kernel_static_config(jsn, max_depth, F, n_island_cap=island_cap,
                                      has_delta=False)
        want = np.asarray(jk.check_kernel_packed(
            {k: _jnp(v) for k, v in packed.items()}, _jnp(qpack), **cfg
        ))
        got = tk.check_kernel_packed(
            tk.tables_from_numpy(packed, "cpu"), torch.from_numpy(qpack), layout=layout, **cfg,
        ).numpy()
        np.testing.assert_array_equal(got, want)
        needs_host = tk.unpack_results(got, 16, cfg["n_island_cap"], jsn.K)[1]
        if island_cap == 0:
            assert tk.CAUSE_ISLAND_HOST in needs_host

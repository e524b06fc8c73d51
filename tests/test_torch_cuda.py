"""The CUDA kernels of keto_tpu_torch against their plain PyTorch versions,
on the card: each kernel alone on the same CUDA tensors, and whole check,
expand, ListObjects, ListSubjects, closure and filter launches against
the CPU run of the plain versions, under both table layouts and with the
delta overlay (or the dirty table) on and off; the closure powering's P1-P3
step by step on random waves, on shapes that change call after call, dense
frontiers, no edges and every poison mask (their persistent scratch read
back zero after every call), and whole device-powered builds against the
CPU's; L1's and X1's keyed rank on queries in runs, at random and all on
one query, past one block's frontier and shared memory; L2's merge path
from one task to 2^20 (empty tasks and slots, no candidate at all, one
task past the frontier, no reverse edges, POISON), L3's the same way
(no fe_pack edges, COMPUTED and TTU lanes, depths 0 and 1), K1's staged
loads at 1 to 64 probes under both layouts, with the overlay on and off,
and K2's shared probes at 1 to 64 probes, one or two value lanes, one or
three slots, on frontiers of one key, all distinct keys, a zero-filled
tail and keys scattered across warps, up to 2^20 tasks; L4's and X2's
one pool body at every alignment of the pool's start, pool caps from 0
past the used rows and batches past one block's shared memory; C1 from
0 to 16,387 queries, on batches all invalid, all uncovered or all dirty,
into memory full of garbage and in calls back to back, one kernel a
call; the microbenchmark primitives M1-M10 (keto_tpu_torch/tools) on the
TPU tools' draws and on edge sizes, M2's bulk-copied table at edge sizes
and indices, M3's bins and M4's cluster on skewed draws, ragged sizes
and M4's capacity, no memset in either, M5's one pass with F falling and
rising on one and two streams and across its epoch's wrap, M6's one
cooperative launch at its capacity, on two streams at once and replayed
from a CUDA graph, one kernel a call. Tolerance: exact equality (every
output is an integer, and M8's float32 add is one rounding either way).

These tests need an NVIDIA card and skip elsewhere; this file imports
nothing of the JAX package, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q
"""

import json
import random

import numpy as np
import pytest
import torch

from keto_tpu_torch.engine import cuda_ops
from keto_tpu_torch.engine import delta as tdelta
from keto_tpu_torch.engine import expand_kernel as tek
from keto_tpu_torch.engine import kernel as tk
from keto_tpu_torch.engine import reverse_kernel as trk
from keto_tpu_torch.engine import snapshot as tsnap
from keto_tpu_torch.ketoapi import RelationTuple
from keto_tpu_torch.namespace import Namespace

LAYOUTS = ("compact", "bucketized")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _computed(rel):
    return {"type": "computed_subject_set", "relation": rel}


def _ttu(rel, computed):
    return {"type": "tuple_to_subject_set", "relation": rel,
            "computed_subject_set_relation": computed}


def videos(seed=1):
    """The benchmark's shape: view = owner | parent->view, at toy size."""
    rng = random.Random(seed)
    ns = [{"name": "videos", "relations": [
        {"name": "owner"}, {"name": "parent"},
        {"name": "view", "rewrite": {"operator": "or", "children": [
            _computed("owner"), _ttu("parent", "view")]}},
    ]}]
    tuples, queries = [], []
    for d in range(12):
        tuples.append(f"videos:/d{d}#owner@user{rng.randrange(20)}")
        for f in range(10):
            tuples.append(f"videos:/d{d}/v{f}.mp4#parent@(videos:/d{d}#...)")
            if rng.random() < 0.25:
                tuples.append(f"videos:/d{d}/v{f}.mp4#owner@user{rng.randrange(20)}")
    for _ in range(60):
        queries.append(
            f"videos:/d{rng.randrange(12)}/v{rng.randrange(10)}.mp4#view@user{rng.randrange(20)}"
        )
    return ns, tuples, queries, 5


def islands():
    """AND/NOT islands under a TTU fan-out, and a deep parent chain."""
    ns = [{"name": "acl", "relations": [
        {"name": "allow"}, {"name": "deny"}, {"name": "parent"},
        {"name": "access", "rewrite": {"operator": "and", "children": [
            _computed("allow"), {"type": "invert", "inverted": _computed("deny")}]}},
        {"name": "super", "rewrite": {"operator": "or", "children": [
            _ttu("parent", "access"), _ttu("parent", "super")]}},
    ]}]
    tuples = [f"acl:root#parent@(acl:doc{i}#...)" for i in range(20)]
    tuples += [f"acl:doc{i}#parent@(acl:doc{i + 1}#...)" for i in range(19)]
    tuples += ["acl:doc7#allow@alice", "acl:doc3#allow@bob", "acl:doc3#deny@bob",
               "acl:doc19#allow@carol"]
    queries = ["acl:root#super@alice", "acl:root#super@bob", "acl:doc3#access@bob",
               "acl:doc0#super@carol", "acl:doc0#super@dave", "acl:root#allow@alice"]
    return ns, tuples, queries, 30


def random_monotone(seed=42):
    rng = random.Random(seed)
    rels = ["r0", "r1", "r2"]
    ns = [{"name": "rnd", "relations": [
        {"name": "r0"}, {"name": "r1"},
        {"name": "r2", "rewrite": {"operator": "or", "children": [
            _computed("r0"), _ttu("r1", "r2")]}},
    ]}]
    tuples = set()
    for _ in range(200):
        if rng.random() < 0.45:
            sub = f"(rnd:o{rng.randrange(30)}#{rng.choice(rels + ['...'])})"
        else:
            sub = f"u{rng.randrange(10)}"
        tuples.add(f"rnd:o{rng.randrange(30)}#{rng.choice(rels)}@{sub}")
    queries = [f"rnd:o{rng.randrange(30)}#{rng.choice(rels)}@u{rng.randrange(10)}"
               for _ in range(60)]
    return ns, sorted(tuples), queries, 8


def plain_only():
    """No subject sets at all: the CSR edge pack is empty."""
    ns = [{"name": "n"}]
    tuples = [f"n:o{i}#r@u{i % 7}" for i in range(40)]
    queries = [f"n:o{i}#r@u{i % 5}" for i in range(50)]
    return ns, tuples, queries, 5


SCENARIOS = {
    "videos": videos, "islands": islands, "random_monotone": random_monotone,
    "plain_only": plain_only,
}


def build(scenario, layout):
    ns, tuples, queries, depth = SCENARIOS[scenario]()
    parsed = [RelationTuple.from_string(s) for s in tuples]
    snap = tsnap.build_snapshot(parsed, [Namespace.from_dict(d) for d in ns], layout=layout)
    return snap, parsed, queries, depth


def qpack_for(snap, queries, B, depth):
    view = tdelta.SnapshotView(snap)
    cols = tsnap.encode_query_batch(view, [RelationTuple.from_string(q) for q in queries], B)
    q_obj, q_rel, q_skind, q_sa, q_sb, q_valid = cols
    return torch.from_numpy(tk.pack_queries(
        q_obj, q_rel, np.full(B, depth, np.int32), q_skind, q_sa, q_sb, q_valid
    ))


def delta_for(snap, parsed, rng):
    ops = [("delete", t) for t in rng.sample(parsed, 4)]
    for _ in range(4):
        a, b = rng.sample(parsed, 2)
        ops.append(("insert", RelationTuple(
            a.namespace, a.object, b.relation, b.subject_id, b.subject_set)))
    overlay = tdelta.build_vocab_overlay(snap, ops)
    view = tdelta.SnapshotView(snap, overlay)
    return tdelta.build_delta_tables(view, ops), overlay


@pytest.mark.cuda
@pytest.mark.parametrize("has_delta", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_check_launch_matches_plain(cuda, scenario, layout, has_delta):
    snap, parsed, queries, depth = build(scenario, layout)
    delta = None
    if has_delta:
        delta, _overlay = delta_for(snap, parsed, random.Random(3))
    B = 64
    cfg = tk.kernel_static_config(snap, depth, 4 * B, n_island_cap=2 * B, has_delta=has_delta)
    qpack = qpack_for(snap, queries, B, depth)
    want = tk.check_kernel_packed(tk.snapshot_tables(snap, "cpu", delta), qpack, **cfg)
    before = dict(cuda_ops.launches)
    got = tk.check_kernel_packed(tk.snapshot_tables(snap, cuda, delta), qpack.to(cuda), **cfg)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert all(cuda_ops.launches[k] > before[k] for k in cuda_ops.CHECK_KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_kernel_matches_plain_on_card(cuda, layout):
    """Random task columns through each wrapper and its plain version, both
    on the same CUDA tensors."""
    snap, parsed, _queries, _depth = build("random_monotone", layout)
    delta, _overlay = delta_for(snap, parsed, random.Random(4))
    tables = tk.snapshot_tables(snap, cuda, delta)
    g = torch.Generator(device="cpu").manual_seed(0)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32).to(cuda)

    F, B, S = 512, 64, snap.K + 1
    rows = torch.from_numpy(snap.dh_val != -1).nonzero()[:, 0]
    pick = rows[torch.randint(0, len(rows), (F,), generator=g)].numpy()
    obj = torch.from_numpy(snap.dh_obj[pick]).to(cuda)
    rel = torch.from_numpy(snap.dh_rel[pick]).to(cuda)
    q = ri(0, B, F)
    qsub = torch.stack([
        torch.from_numpy(snap.dh_skind[pick[:B]]), torch.from_numpy(snap.dh_sa[pick[:B]]),
        torch.from_numpy(snap.dh_sb[pick[:B]]), torch.zeros(B, dtype=torch.int32),
    ], dim=-1).to(cuda).contiguous()
    depth = ri(-1, 4, F)
    live = ri(0, 8, F) > 0
    spb8, spb16 = tsnap.slots_per_bucket(5, layout), tsnap.slots_per_bucket(2, layout)
    for has_delta in (False, True):
        kw = dict(dh_probes=snap.dh_probes, spb=spb8, has_delta=has_delta)
        dd = tables["dd_pack"] if has_delta else None
        got = cuda_ops.edge_probe(tables["dh_pack"], dd, obj, rel, q, qsub, depth, live, **kw)
        want = tk.edge_probe_plain(tables["dh_pack"], dd, obj, rel, q, qsub, depth, live, **kw)
        assert torch.equal(got, want)

    rels = torch.cat([rel[:, None], ri(0, 5, F, S - 1)], dim=1).contiguous()
    for pack, probes, n_vals in ((tables["rh_pack"], snap.rh_probes, 2),
                                 (tables["dirty_pack"], tdelta.DELTA_PROBES, 1)):
        kw = dict(probes=probes, spb=spb16, n_vals=n_vals)
        assert torch.equal(cuda_ops.pair_probe(pack, obj, rels, **kw),
                           tk.pair_probe_plain(pack, obj, rels, **kw))

    counts = ri(0, 3, F, S)
    starts = ri(0, max(len(snap.e_obj) - 3, 1), F, S)
    slot_ctx, crel, comp = ri(0, B, F, S), ri(0, 5, F, S), ri(0, 2, F, S)
    args = (counts, starts, slot_ctx, crel, comp, q, obj, depth, tables["e_pack"])
    *cols, over = cuda_ops.expand_gather(*args, wildcard_rel=snap.wildcard_rel, n_queries=B)
    ch, want_over = tk.expand_gather_plain(*args, wildcard_rel=snap.wildcard_rel, n_queries=B)
    for a, b in zip(cols, (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid)):
        assert torch.equal(a, b)
    assert torch.equal(over, want_over)

    ch = tk.Expansion(q, ri(0, 8, F), ri(0, 6, F), ri(0, 3, F), depth, live)
    got = cuda_ops.dedupe_compact(ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid,
                                  F=F, n_queries=B)
    want = tk.dedupe_compact_plain(ch, F=F, n_queries=B)
    for a, b in zip(got, want):
        assert torch.equal(a.to(b.dtype), b)


# -- K3 and K4 at the shapes their tiles stress ----------------------------------------
#
# csrc/check_kernels.cu scans K3's F * S slot counts and K4's G candidates
# in tiles of SCAN_TILE (kScanTile). The cases sit one below, at and one
# above a tile, at three tiles and 5, and in the regimes the scans keep
# apart. tests/test_torch_kernel.py holds the plain version of K4 to
# keto_tpu's dedupe_phase on the same cases.

SCAN_TILE = 1024
# name: (G, F, n_queries, kind)
DEDUPE_CASES = {
    "below_tile": (SCAN_TILE - 1, SCAN_TILE - 1, 64, "dups"),
    "at_tile": (SCAN_TILE, SCAN_TILE, 64, "dups"),
    "above_tile": (SCAN_TILE + 1, SCAN_TILE + 1, 64, "dups"),
    "three_tiles_and_5": (3 * SCAN_TILE + 5, 3 * SCAN_TILE + 5, 64, "dups"),
    "expand_4F": (4 * 1024, 1024, 256, "dups"),
    "all_invalid": (SCAN_TILE + 1, SCAN_TILE + 1, 64, "invalid"),
    "all_kept_overflow": (3 * SCAN_TILE + 5, 2500, 16, "distinct"),
    "one_query": (3 * SCAN_TILE + 5, 1000, 1, "one_query"),
}


def dedupe_case(kind: str, G: int, B: int, seed: int = 0) -> tuple:
    """(q, ctx, obj, rel, depth, valid) numpy columns of G candidates:
    "dups" draws narrow keys (duplicates and bucket collisions), root
    ctxs being the query ids; "invalid" the same, none valid; "distinct"
    gives every candidate its own key, all valid, so every one is kept;
    "one_query" puts every candidate in query 0, as a filter walk does."""
    rng = np.random.default_rng(seed)
    obj = rng.integers(0, 40 if G < 1 << 16 else 4096, G)
    rel = rng.integers(0, 3, G)
    depth = rng.integers(-1, 6, G)
    valid = rng.random(G) < 0.8
    if kind == "distinct":
        ctx, valid = np.arange(G), np.ones(G, bool)
        q = ctx % B
    elif kind == "one_query":
        q = ctx = np.zeros(G, np.int64)
        obj = rng.integers(0, 4000, G)
    else:
        q = ctx = rng.integers(0, B, G)
        if kind == "invalid":
            valid = np.zeros(G, bool)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    return i32(q), i32(ctx), i32(obj), i32(rel), i32(depth), valid


# name: (F, S, regime); SCAN_TILE counts a tile
GATHER_CASES = {
    "below_tile": (SCAN_TILE - 1, 1, "dense"),
    "at_tile": (SCAN_TILE // 2, 2, "dense"),
    "above_tile": (205, 5, "dense"),
    "three_tiles_and_5": (3 * SCAN_TILE + 5, 1, "dense"),
    "past_total": (3 * SCAN_TILE // 2 + 5, 2, "sparse"),
    "all_empty": (SCAN_TILE + 1, 2, "empty"),
    "long_segments": (4096, 4, "long"),
}


def gather_case(F: int, S: int, regime: str, seed: int = 0, n_edges: int = 500):
    """expand_gather's inputs over F tasks of S slots, and its keywords.
    Every regime leaves the last tasks' segments empty. "dense" counts 0-3
    a slot (total > F: overflow); "sparse" few non-empty slots (total <
    F: slots past the total); "empty" none; "long" a few segments of
    hundreds of candidates with thousands of empty ones between them."""
    rng = np.random.default_rng(seed)
    B, wildcard_rel = 64, 5
    if regime == "dense":
        counts = rng.integers(0, 4, (F, S))
    elif regime == "sparse":
        counts = (rng.random((F, S)) < 0.1) * rng.integers(1, 3, (F, S))
    elif regime == "long":
        counts = np.zeros((F, S), np.int64)
        counts.flat[[3, 2500, 7000, 9100, 12000]] = [700, 333, 901, 450, 600]
    else:
        counts = np.zeros((F, S), np.int64)
    counts[-(F // 20 + 1):] = 0
    starts = np.where(counts > 0, rng.integers(0, n_edges, (F, S)), -1)
    e_pack = np.stack([rng.integers(0, 1000, n_edges), rng.integers(0, 6, n_edges)], axis=1)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    args = (i32(counts), i32(starts), i32(rng.integers(0, B, (F, S))),
            i32(rng.integers(0, 6, (F, S))), i32(rng.integers(0, 2, (F, S))),
            i32(rng.integers(0, B, F)), i32(rng.integers(0, 1000, F)),
            i32(rng.integers(0, 5, F)), i32(e_pack))
    return args, dict(wildcard_rel=wildcard_rel, n_queries=B)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_expand_gather_tiles_on_card(cuda, case):
    """K3 against its plain version at the tile edges, every column of
    every output slot compared, those past the total included."""
    F, S, regime = GATHER_CASES[case]
    args, kw = gather_case(F, S, regime)
    args = tuple(torch.from_numpy(a).to(cuda) for a in args)
    *cols, over = cuda_ops.expand_gather(*args, **kw)
    ch, want_over = tk.expand_gather_plain(*args, **kw)
    for name, a, b in zip(("q", "ctx", "obj", "rel", "depth", "valid"), cols,
                          (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid)):
        assert torch.equal(a, b), name
    assert torch.equal(over, want_over)
    total = int(args[0].sum())
    assert (total > F) == bool(over.any())
    assert bool(ch.valid[min(total, F):].any()) is False
    if regime != "empty":
        assert ch.valid.any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DEDUPE_CASES) + ["large"])
def test_dedupe_compact_tiles_on_card(cuda, case):
    """K4 against its plain version at the tile edges and at ListObjects'
    G = F = 2^20: every column of the frontier, the zeroed tail past
    n_new included, n_new and the causes."""
    G, F, B, kind = DEDUPE_CASES.get(case, (1 << 20, 1 << 20, 256, "dups"))
    cols = [torch.from_numpy(c).to(cuda) for c in dedupe_case(kind, G, B)]
    got = cuda_ops.dedupe_compact(*cols, F=F, n_queries=B)
    want = tk.dedupe_compact_plain(tk.Expansion(*cols), F=F, n_queries=B)
    for name, a, b in zip(("q", "ctx", "obj", "rel", "depth", "n_new", "overflow"), got, want):
        assert torch.equal(a.to(b.dtype), b), name
    n_new = int(want[5])
    assert (n_new == 0) == (kind == "invalid")
    assert bool(want[6].any()) == (F < G and kind != "invalid")


# -- expand --------------------------------------------------------------------------


def rbac(seed=7):
    """bench.py's expand shape at toy size: role member sets nesting
    earlier roles, docs granting editors through roles."""
    rng = random.Random(seed)
    ns = [{"name": "role", "relations": [{"name": "member"}]},
          {"name": "doc", "relations": [
              {"name": "owner"},
              {"name": "editor", "rewrite": {"operator": "or",
                                             "children": [_computed("owner")]}}]}]
    tuples = set()
    for r in range(60):
        tuples.update(f"role:r{r}#member@u{rng.randrange(50)}" for _ in range(4))
        if r and rng.random() < 0.5:
            tuples.add(f"role:r{r}#member@(role:r{rng.randrange(r)}#member)")
    for d in range(80):
        tuples.add(f"doc:d{d}#owner@u{rng.randrange(50)}")
        tuples.add(f"doc:d{d}#editor@(role:r{rng.randrange(60)}#member)")
    queries = [f"role:r{rng.randrange(60)}#member" for _ in range(48)]
    queries += [f"doc:d{d}#editor" for d in range(12)] + ["doc:ghost#editor"]
    return ns, sorted(tuples), queries, 6


def fanout():
    """A 200-leaf row with nested sets, cycles and four 20-way fan-outs."""
    ns = [{"name": "groups"}]
    tuples = [f"groups:g#member@u{i}" for i in range(200)]
    tuples += [f"groups:g#member@(groups:s{j}#member)" for j in range(20)]
    tuples += [f"groups:f{k}#member@(groups:s{j}#member)" for k in range(4) for j in range(20)]
    tuples += [f"groups:s{j}#member@(groups:s{(j + 1) % 20}#member)" for j in range(20)]
    tuples += [f"groups:s{j}#member@m{j}" for j in range(20)]
    queries = ["groups:g#member"] + [f"groups:f{k}#member" for k in range(4)]
    queries += [f"groups:s{j}#member" for j in range(20)]
    return ns, tuples, queries, 6


EXPAND_SCENARIOS = {"rbac": rbac, "fanout": fanout}
EXPAND_CAPS = {
    "default": dict(frontier_cap=256, edge_cap=1024),
    "tiny": dict(frontier_cap=64, edge_cap=16, pool_cap=128),
}


def expand_inputs(scenario, layout, has_delta):
    ns, tuples, queries, depth = EXPAND_SCENARIOS[scenario]()
    parsed = [RelationTuple.from_string(s) for s in tuples]
    snap = tsnap.build_snapshot(parsed, [Namespace.from_dict(d) for d in ns], layout=layout)
    delta = delta_for(snap, parsed, random.Random(5))[0] if has_delta else None
    csr = tek.build_full_csr(parsed, snap)
    fh_probes = csr.pop("fh_probes")
    view = tdelta.SnapshotView(snap)
    B = 64
    q_obj, q_rel = np.zeros(B, np.int32), np.zeros(B, np.int32)
    q_valid = np.zeros(B, bool)
    for i, q in enumerate(queries):
        ns_, rest = q.split(":", 1)
        obj, rel = rest.split("#")
        node = view.encode_node(ns_, obj, rel)
        if node is not None:
            (q_obj[i], q_rel[i]), q_valid[i] = node, True
    qpack = torch.from_numpy(tek.pack_expand_queries(q_obj, q_rel, depth, q_valid))
    return tek.pack_expand_tables(csr, delta), qpack, fh_probes, depth


@pytest.mark.cuda
@pytest.mark.parametrize("caps", sorted(EXPAND_CAPS))
@pytest.mark.parametrize("has_delta", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("scenario", sorted(EXPAND_SCENARIOS))
def test_expand_launch_matches_plain(cuda, scenario, layout, has_delta, caps):
    packed, qpack, fh_probes, depth = expand_inputs(scenario, layout, has_delta)
    kw = dict(fh_probes=fh_probes, max_steps=depth + 2, layout=layout,
              **{"pool_cap": 4096, **EXPAND_CAPS[caps]})
    want = tek.expand_kernel_packed(tek.expand_tables_from_numpy(packed, "cpu"), qpack, **kw)
    before = dict(cuda_ops.launches)
    got = tek.expand_kernel_packed(tek.expand_tables_from_numpy(packed, cuda), qpack.to(cuda), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    used = ("pair_probe", "dedupe_compact") + cuda_ops.EXPAND_KERNELS
    assert all(cuda_ops.launches[k] > before[k] for k in used)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_expand_kernels_match_plain_on_card(cuda, layout):
    """Random task columns and buffers through X1 and X2 and their plain
    versions, both on the same CUDA tensors (the buffers they update in
    place are cloned for each)."""
    packed, _qpack, _fh, _depth = expand_inputs("rbac", layout, True)
    tables = tek.expand_tables_from_numpy(packed, cuda)
    g = torch.Generator(device="cpu").manual_seed(1)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32).to(cuda)

    n_rows = tables["f_row_ptr"].shape[0] - 1
    for F, B, E in ((512, 64, 64), (256, 256, 8), (1024, 16, 4096)):
        eb = tuple(ri(-1, 50, B * E) for _ in range(5))
        eb_count = ri(0, E // 2 + 1, B)
        needs_host = ri(0, 10, B) == 0
        cols = (ri(0, B, F), ri(0, 300, F), ri(0, 5, F), ri(-1, 5, F), ri(0, 8, F) > 0,
                ri(-1, n_rows + 1, F), ri(-1, 4, F))
        csr = (tables["f_row_ptr"], tables["f_skind"], tables["f_sa"], tables["f_sb"])
        outs = []
        for fn in (cuda_ops.expand_emit, tek.expand_emit_plain):
            bufs = (tuple(c.clone() for c in eb), eb_count.clone(), needs_host.clone())
            res = fn(*cols, *csr, *bufs, edge_cap=E)
            outs.append((res, bufs))
        (got, gbufs), (want, wbufs) = outs
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for a, b in zip((*gbufs[0], *gbufs[1:]), (*wbufs[0], *wbufs[1:])):
            assert torch.equal(a, b)
        root = ri(0, 2, B) > 0
        stats = ri(0, 100, tek.N_LAUNCH_STATS)
        for pool_cap in (0, 7, 16, 4 * B):
            args = (eb, eb_count, root, needs_host, stats)
            kw = dict(edge_cap=E, pool_cap=pool_cap)
            assert torch.equal(cuda_ops.pool_compact(*args, **kw),
                               tek.pool_compact_plain(*args, **kw))


# -- ListObjects / ListSubjects ----------------------------------------------------


LIST_SCENARIOS = {"videos": videos, "islands": islands, "random_monotone": random_monotone}
LIST_CAPS = {
    "default": dict(frontier_cap=256, result_cap=64, pool_cap=4096),
    "tiny": dict(frontier_cap=64, result_cap=4, pool_cap=40),
}


def list_inputs(scenario, layout, has_delta):
    """Both legs' packed tables and query packs for a scenario's queries:
    ListObjects asks for each query's (namespace, relation, subject),
    ListSubjects for its (namespace, object, relation)."""
    ns, tuples, queries, depth = LIST_SCENARIOS[scenario]()
    parsed = [RelationTuple.from_string(s) for s in tuples]
    namespaces = [Namespace.from_dict(d) for d in ns]
    snap = tsnap.build_snapshot(parsed, namespaces, layout=layout)
    delta = delta_for(snap, parsed, random.Random(6))[0] if has_delta else None
    view = tdelta.SnapshotView(snap)
    qs = [RelationTuple.from_string(q) for q in queries][:64]
    lo_q, _ = trk.pack_list_objects_queries(
        view, [(t.namespace, t.relation, t.subject_set or t.subject_id) for t in qs], 64, depth)
    ls_q, _ = trk.pack_list_subjects_queries(
        view, [(t.namespace, t.object, t.relation) for t in qs], 64, depth)
    rnp = trk.build_reverse_state(parsed, snap, namespaces)
    csr = tek.build_full_csr(parsed, snap)
    lo_kw = dict(rvh_probes=rnp["rvh_probes"], rsh_probes=rnp["rsh_probes"],
                 max_steps=depth + snap.n_config_rels + 4, wildcard_rel=snap.wildcard_rel,
                 n_config_rels=max(snap.n_config_rels, 1), has_delta=has_delta, layout=layout)
    ls_kw = dict(fsh_probes=csr["fh_probes"], max_steps=lo_kw["max_steps"],
                 wildcard_rel=snap.wildcard_rel, n_config_rels=lo_kw["n_config_rels"],
                 has_delta=has_delta, layout=layout)
    return (snap, trk.pack_reverse_tables(rnp, snap, delta), torch.from_numpy(lo_q), lo_kw,
            trk.pack_subjects_tables(csr, snap, delta), torch.from_numpy(ls_q), ls_kw)


@pytest.mark.cuda
@pytest.mark.parametrize("caps", sorted(LIST_CAPS))
@pytest.mark.parametrize("has_delta", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("scenario", sorted(LIST_SCENARIOS))
def test_list_launches_match_plain(cuda, scenario, layout, has_delta, caps):
    _snap, rev, lo_q, lo_kw, sub, ls_q, ls_kw = list_inputs(scenario, layout, has_delta)
    for fn, packed, to_tensors, qpack, kw, kernel in (
        (trk.list_objects_kernel_packed, rev, trk.reverse_tables_from_numpy, lo_q, lo_kw,
         "reverse_gather"),
        (trk.list_subjects_kernel_packed, sub, trk.subjects_tables_from_numpy, ls_q, ls_kw,
         "subjects_gather"),
    ):
        kw = {**kw, **LIST_CAPS[caps]}
        want = fn(to_tensors(packed, "cpu"), qpack, **kw)
        before = dict(cuda_ops.launches)
        got = fn(to_tensors(packed, cuda), qpack.to(cuda), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), fn.__name__
        used = ("pair_probe", "dedupe_compact", "list_emit", "list_pool_compact", kernel)
        assert all(cuda_ops.launches[k] > before[k] for k in used), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("N,B,R", [(700, 1, 8), (5000, 64, 16), (300_000, 256, 4096),
                                   (70_000, 16384, 2)])
def test_list_emit_matches_plain_on_card(cuda, N, B, R):
    """L1 on queries in random order, past one block, against its plain
    version; the buffers it updates in place are cloned for each side."""
    g = torch.Generator(device="cpu").manual_seed(N)
    q = torch.randint(0, B, (N,), generator=g, dtype=torch.int32).to(cuda)
    emit = (torch.randint(0, 3, (N,), generator=g) > 0).to(cuda)
    value = torch.randint(0, 1 << 20, (N,), generator=g, dtype=torch.int32).to(cuda)
    res = torch.full((B * R,), -1, dtype=torch.int32).to(cuda)
    res_count = torch.randint(0, R + 1, (B,), generator=g, dtype=torch.int32).to(cuda)
    needs = torch.randint(0, 3, (B,), generator=g, dtype=torch.int32).to(cuda)
    outs = []
    for fn in (cuda_ops.list_emit, trk.list_emit_plain):
        bufs = (res.clone(), res_count.clone(), needs.clone())
        landed = fn(q, emit, value, *bufs, result_cap=R)
        outs.append((landed, *bufs))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def keyed_queries(order: str, N: int, B: int, rng) -> np.ndarray:
    """The queries of N entries over B: sorted into runs (as L2's
    candidates and K4's frontier come), at random, or all one query."""
    if order == "runs":
        q = np.sort(rng.integers(0, B, N))
    elif order == "random":
        q = rng.integers(0, B, N)
    else:
        q = np.full(N, rng.integers(0, B))
    return q.astype(np.int32)


def on_card(cuda, a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(cuda)


# (order, N, B, R, overflows): ListObjects' step-2 launch (2^20 entries,
# the padding tail not emitting) in runs, at random and on one query (its
# cap overflows); ListSubjects' launch; one entry; one query; 16,384
# queries; caps that overflow; 65,536 queries, whose counts do not fit one
# block's shared memory (csrc/keyed_rank.cuh keeps them in its table).
# `overflows`: some emitting entry finds its query's R slots taken.
L1_CASES = {
    "runs_list_objects": ("runs", 1 << 20, 256, 4096, True),
    "random_list_objects": ("random", 1 << 20, 256, 4096, True),
    "one_key_list_objects": ("one_key", 1 << 20, 256, 4096, True),
    "runs_list_subjects": ("runs", 16384, 256, 2048, True),
    "runs_one_entry": ("runs", 1, 1, 1, False),
    "random_one_entry": ("random", 1, 256, 8, False),
    "one_key_one_query": ("one_key", 70_000, 1, 100_000, False),
    "runs_b16384": ("runs", 1 << 20, 16384, 64, True),
    "random_b16384": ("random", 1 << 20, 16384, 64, True),
    "runs_overflow": ("runs", 300_000, 256, 16, True),
    "random_overflow": ("random", 300_000, 256, 16, True),
    "runs_b65536": ("runs", 200_000, 65536, 4, True),
    "random_b65536": ("random", 200_000, 65536, 4, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(L1_CASES))
def test_list_emit_key_orders_on_card(cuda, case):
    """L1's keyed rank against its plain version for any order of the
    queries; the buffers it updates in place are cloned for each side.
    Each case reaches what it was built for: the landed count is each
    query's emitting entries up to its free slots, and where a query
    overflows, CAUSE_FRONTIER_OVERFLOW is raised on it."""
    order, N, B, R, overflows = L1_CASES[case]
    rng = np.random.default_rng(N + B)
    q = keyed_queries(order, N, B, rng)
    emit = (rng.random(N) < 0.7) & (np.arange(N) < int(0.6 * N))
    emit[0] = True
    args = (on_card(cuda, q), on_card(cuda, emit, torch.bool),
            on_card(cuda, rng.integers(0, 1 << 20, N)))
    res_count, needs = rng.integers(0, R + 1, B), rng.integers(0, 3, B)
    res = torch.full((B * R,), -1, dtype=torch.int32, device=cuda)
    outs = []
    for fn in (cuda_ops.list_emit, trk.list_emit_plain):
        bufs = (res.clone(), on_card(cuda, res_count), on_card(cuda, needs))
        landed = fn(*args, *bufs, result_cap=R)
        outs.append((landed, *bufs))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    per_query = np.bincount(q[emit], minlength=B)
    landed, want_needs = int(outs[1][0]), outs[1][3].cpu().numpy()
    assert landed == int(np.minimum(per_query, R - res_count).sum())
    assert (landed < int(emit.sum())) == overflows
    raised = (res_count + per_query > R) & (needs < tk.CAUSE_FRONTIER_OVERFLOW)
    assert raised.any() == overflows
    assert (want_needs[raised] == tk.CAUSE_FRONTIER_OVERFLOW).all()


def x1_reach(q, live, depth, row, dirty, row_ptr, eb_count, needs, E):
    """What one X1 step must do on these numpy inputs: the queries that
    only its buffer test flags (a row that does not fit, on a query not
    flagged before, by a dirty row or by the 4F cut), its emitted total
    before the 4F cut, and the rows' demand before the buffer test."""
    F, n_rows = q.shape[0], row_ptr.shape[0] - 1
    rc = np.clip(row, 0, n_rows)
    length = np.where(row == -1, 0, row_ptr[np.minimum(rc + 1, n_rows)] - row_ptr[rc])
    gated = live & (depth >= 2)
    dirty_task = gated & ((np.maximum(dirty, 0) & 1) != 0)
    emit = gated & ~dirty_task
    counts = np.where(emit, length, 0)
    order = np.argsort(q, kind="stable")
    cum = np.cumsum(counts[order]) - counts[order]
    first = np.r_[True, q[order][1:] != q[order][:-1]]
    alloc = np.empty(F, np.int64)
    alloc[order] = eb_count[q[order]] + cum - np.maximum.accumulate(np.where(first, cum, 0))
    over = emit & (alloc + counts > E)
    ends = np.cumsum(np.where(emit & ~over, counts, 0))
    trunc = emit & ~over & (ends > 4 * F)
    flagged = np.concatenate([q[dirty_task], q[trunc], np.flatnonzero(needs)])
    return np.setdiff1d(q[over], flagged), int(ends[-1]), int(counts.sum())


# (order, F, B, E, reaches): Expand's step-1 launch; frontiers of 32,768
# and 65,536 over 1,024 queries (the first X1 refused them: its one
# block's shared memory); 16,384 queries; every task on one query; 65,536
# queries. `reaches`: "drop", rows the buffer test drops; "flag", queries
# only it flags; "4F", emissions past the 4F budget.
X1_CASES = {
    "runs_f4096": ("runs", 4096, 1024, 16384, ("4F",)),
    "runs_f32768": ("runs", 32768, 1024, 256, ("drop", "flag", "4F")),
    "random_f32768": ("random", 32768, 1024, 256, ("drop", "flag", "4F")),
    "runs_f65536": ("runs", 65536, 1024, 512, ("drop", "flag", "4F")),
    "random_f65536": ("random", 65536, 1024, 512, ("drop", "flag", "4F")),
    "runs_f4096_b16384": ("runs", 4096, 16384, 64, ("4F",)),
    "random_f4096_b16384": ("random", 4096, 16384, 64, ("drop", "flag", "4F")),
    "one_key_f4096": ("one_key", 4096, 1024, 4096, ("drop",)),
    "runs_b65536": ("runs", 8192, 65536, 8, ("drop", "flag")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(X1_CASES))
def test_expand_emit_frontiers_on_card(cuda, case):
    """X1 against its plain version on tasks grouped by query and in
    random order, with rows that overflow the edge buffer and emissions
    past the 4F budget; the buffers it updates are cloned for each side.
    Each case reaches what it was built for (x1_reach), and the step
    emits its total up to 4F."""
    order, F, B, E, reaches = X1_CASES[case]
    rng = np.random.default_rng(F + B)
    n_rows = 5000
    row_ptr = np.concatenate([[0], np.cumsum(rng.integers(0, 17, n_rows))])
    n_edges = int(row_ptr[-1])
    csr = (row_ptr, rng.integers(0, 2, n_edges), rng.integers(0, 1 << 20, n_edges),
           rng.integers(0, 8, n_edges))
    cols = (keyed_queries(order, F, B, rng), rng.integers(0, 300, F), rng.integers(0, 5, F),
            rng.integers(1, 7, F))
    live = rng.random(F) < 0.9
    row = rng.integers(-1, n_rows + 1, F)
    dirty = np.where(rng.random(F) < 0.05, rng.integers(0, 4, F), -1)
    args = (*(on_card(cuda, c) for c in cols), on_card(cuda, live, torch.bool),
            on_card(cuda, row), on_card(cuda, dirty), *(on_card(cuda, c) for c in csr))
    eb_count, needs = rng.integers(0, E // 2 + 1, B), rng.random(B) < 0.1
    only_e, total, demand = x1_reach(cols[0], live, cols[3], row, dirty, row_ptr, eb_count,
                                     needs, E)
    outs = []
    for fn in (cuda_ops.expand_emit, tek.expand_emit_plain):
        eb = tuple(torch.full((B * E,), -1, dtype=torch.int32, device=cuda) for _ in range(5))
        bufs = (eb, on_card(cuda, eb_count), on_card(cuda, needs, torch.bool))
        outs.append((fn(*args, *bufs, edge_cap=E), bufs))
    torch.cuda.synchronize()
    (got, gbufs), (want, wbufs) = outs
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip((*gbufs[0], *gbufs[1:]), (*wbufs[0], *wbufs[1:])):
        assert torch.equal(a, b)
    assert (total < demand) == ("drop" in reaches)
    assert (len(only_e) > 0) == ("flag" in reaches)
    assert wbufs[2].cpu().numpy()[only_e].all()
    assert (total > 4 * F) == ("4F" in reaches)
    assert int(want[-1]) == min(total, 4 * F)


def profiled(call, calls: int = 20):
    """The CUDA events (kernels, memsets, copies) of `calls` calls, after
    one call that builds the library and the stream's scratch. A window
    in which the profiler saw no device event at all is taken again, up
    to three times (CUPTI on the H100 now and then hands back an empty
    window, as chip_smoke.py's device_ms notes); a window may lose a few
    records of a kernel, never add one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
        if events:
            break
    return events


@pytest.mark.cuda
def test_list_emit_and_expand_emit_launch_no_memset_on_card(cuda):
    """A call of L1 launches its three keyed-rank kernels and X1 its five,
    and neither a memset: the profiler sees those names and nothing else
    over 20 calls."""
    rng = np.random.default_rng(4)
    N, B, R = 1 << 16, 256, 64
    l1 = (on_card(cuda, keyed_queries("runs", N, B, rng)),
          on_card(cuda, rng.random(N) < 0.5, torch.bool), on_card(cuda, rng.integers(0, 9, N)),
          torch.full((B * R,), -1, dtype=torch.int32, device=cuda),
          torch.zeros(B, dtype=torch.int32, device=cuda),
          torch.zeros(B, dtype=torch.int32, device=cuda))
    F, B2, E = 4096, 1024, 64
    row_ptr = on_card(cuda, np.arange(0, 4 * 501, 4))
    x1 = (on_card(cuda, keyed_queries("runs", F, B2, rng)), *(on_card(cuda, rng.integers(0, 5, F))
                                                             for _ in range(2)),
          on_card(cuda, rng.integers(1, 7, F)), on_card(cuda, rng.random(F) < 0.9, torch.bool),
          on_card(cuda, rng.integers(-1, 501, F)), on_card(cuda, np.full(F, -1)), row_ptr,
          *(on_card(cuda, rng.integers(0, 2, 2000)) for _ in range(3)),
          tuple(torch.full((B2 * E,), -1, dtype=torch.int32, device=cuda) for _ in range(5)),
          torch.zeros(B2, dtype=torch.int32, device=cuda),
          torch.zeros(B2, dtype=torch.bool, device=cuda))
    calls = {
        ("list_emit_count_kernel", "list_emit_scan_kernel", "list_emit_rank_kernel"):
            lambda: cuda_ops.list_emit(*l1, result_cap=R),
        ("expand_emit_count_kernel", "expand_emit_scan_kernel", "expand_emit_rank_kernel",
         "expand_emit_offsets_kernel", "expand_emit_gather_kernel"):
            lambda: cuda_ops.expand_emit(*x1, edge_cap=E),
    }
    for kernels, call in calls.items():
        keys = [e.key for e in profiled(call)]
        assert len(keys) == len(kernels), keys
        assert all(any(k in key for key in keys) for k in kernels), keys


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_list_gathers_match_plain_on_card(cuda, layout):
    """Random task columns through L2, L3 and L4 and their plain versions,
    both on the same CUDA tensors."""
    snap, rev, _lo_q, lo_kw, sub, _ls_q, _ls_kw = list_inputs("random_monotone", layout, True)
    rt = trk.reverse_tables_from_numpy(rev, cuda)
    st = trk.subjects_tables_from_numpy(sub, cuda)
    g = torch.Generator(device="cpu").manual_seed(2)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32).to(cuda)

    n_obj, n_rel = len(snap.obj_slots), len(snap.rel_ids)
    ncr = max(snap.n_config_rels, 1)
    for F, B in ((512, 64), (4096, 16), (20000, 256)):
        q, obj, rel, depth = ri(0, B, F), ri(0, n_obj, F), ri(0, n_rel, F), ri(-1, 5, F)
        live = ri(0, 8, F) > 0
        ns_t = rt["objslot_ns"][obj.long()]
        spans = tk.pair_probe_plain(rt["rvh_pack"], obj, torch.zeros_like(obj)[:, None],
                                    probes=lo_kw["rvh_probes"],
                                    spb=tsnap.slots_per_bucket(2, layout), n_vals=2)[:, 0]
        rstart = spans[:, 0].contiguous()
        rlen = torch.where(rstart < 0, 0, spans[:, 1] - rstart).to(torch.int32).contiguous()
        args = (q, obj, rel, depth, live, ns_t, rstart, rlen, rt["rinstr_pack"], rt["rv_pack"],
                rt["objslot_ns"])
        kw = dict(wildcard_rel=snap.wildcard_rel, n_config_rels=ncr, n_queries=B)
        *cols, cause = cuda_ops.reverse_gather(*args, **kw)
        ch, want_cause = trk.reverse_gather_plain(*args, **kw)
        for a, b in zip(cols, (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid)):
            assert torch.equal(a, b)
        assert torch.equal(cause, want_cause)
        assert int(ch.valid.sum()) > 0

        K = snap.K
        ik, ir, ir2 = ri(0, 3, F, K), ri(0, n_rel, F, K), ri(0, n_rel, F, K)
        n_edges = st["fe_pack"].shape[0]
        start = ri(-1, n_edges, F, K + 1)
        spans3 = torch.stack([start, (start + ri(0, 4, F, K + 1)).clamp(max=n_edges)], dim=-1)
        args3 = (q, obj, depth, live, spans3.contiguous(), ik, ir, ir2, st["fe_pack"])
        kw3 = dict(wildcard_rel=snap.wildcard_rel, n_queries=B)
        *cols, emit, value, cause = cuda_ops.subjects_gather(*args3, **kw3)
        ch, want_emit, want_value, want_cause = trk.subjects_gather_plain(*args3, **kw3)
        for a, b in zip((*cols, emit, value, cause),
                        (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid, want_emit,
                         want_value, want_cause)):
            assert torch.equal(a, b)

        R = 8
        res = ri(-1, 1000, B * R)
        res_count = ri(0, R + 1, B)
        needs = ri(0, 9, B)
        stats = ri(0, 100, tk.N_LAUNCH_STATS)
        for pool_cap in (0, 7, B * R // 2, B * R // 2 + 3, 2 * B * R):
            args4 = (res, res_count, needs, stats)
            kw4 = dict(result_cap=R, pool_cap=pool_cap)
            assert torch.equal(cuda_ops.list_pool_compact(*args4, **kw4),
                               trk.list_pool_compact_plain(*args4, **kw4))



# -- the closure probe and the filter walk ------------------------------------------


def closure_inputs(scenario, layout, has_dirty, B=64, dirty_every=2):
    """The closure tables of a scenario (a dirty table over every
    `dirty_every`-th covered node when has_dirty) and the [7, B] pack of
    its queries at mixed depths."""
    from keto_tpu_torch.engine import closure as tcl
    from keto_tpu_torch.engine import closure_kernel as tck

    snap, _parsed, queries, depth = build(scenario, layout)
    graph = tcl.extract_graph(snap)
    built = tcl.power_closure(graph, snap, depth, 4096, 0)
    tables, cc_probes, ch_probes = tcl.pack_closure_tables(built, graph.R, layout)
    tables["cd_pack"] = (
        tcl.build_dirty_table(built.covered_keys[::dirty_every][:1000], graph.R, layout)
        if has_dirty else tcl.empty_dirty_table())
    qpack = qpack_for(snap, queries[:B], B, depth)
    qpack[2] = torch.from_numpy(np.random.default_rng(0).integers(0, depth + 2, B)).to(torch.int32)
    kw = dict(cc_probes=cc_probes, ch_probes=ch_probes, has_dirty=has_dirty, layout=layout)
    return tables, qpack, kw, tck


@pytest.mark.cuda
@pytest.mark.parametrize("has_dirty", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_closure_launch_matches_plain(cuda, scenario, layout, has_dirty):
    tables, qpack, kw, tck = closure_inputs(scenario, layout, has_dirty)
    want = tck.closure_kernel_packed(tck.closure_tables_from_numpy(tables, "cpu"), qpack, **kw)
    before = cuda_ops.launches["closure_probe"]
    dev = tck.closure_tables_from_numpy(tables, cuda)
    got = tck.closure_kernel_packed(dev, qpack.to(cuda), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert cuda_ops.launches["closure_probe"] == before + 1
    # the plain version on the same CUDA tensors, at a large random batch
    g = torch.Generator(device="cpu").manual_seed(3)
    big = qpack[:, torch.randint(0, qpack.shape[1], (16384,), generator=g)].contiguous()
    big[6, ::7] = 0
    a = cuda_ops.closure_probe(dev["cc_pack"], dev["ch_pack"], dev["cd_pack"], big.to(cuda), **kw)
    b = tck.closure_probe_plain(dev["cc_pack"], dev["ch_pack"], dev["cd_pack"], big.to(cuda),
                                **kw)
    assert torch.equal(a, b)


def closure_on_card(cuda, tables, tck):
    """The tables on the card, and a function of a query pack that runs C1
    and its plain version on the same CUDA tensors."""
    dev = tck.closure_tables_from_numpy(tables, cuda)

    def both(q, **kw):
        args = (dev["cc_pack"], dev["ch_pack"], dev["cd_pack"], q.to(cuda))
        return cuda_ops.closure_probe(*args, **kw), tck.closure_probe_plain(*args, **kw)

    return dev, both


def sampled(qpack, B, seed):
    g = torch.Generator().manual_seed(seed)
    return qpack[:, torch.randint(0, qpack.shape[1], (B,), generator=g)].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("has_dirty", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B", [0, 1, 4097, 16387])
def test_closure_probe_batch_sizes_on_card(cuda, B, layout, has_dirty):
    """C1 from an empty batch to past the engine's largest bucket, one
    query in seven invalid: every slot of the result, the stats tail's
    grid sums included."""
    tables, qpack, kw, tck = closure_inputs("videos", layout, has_dirty)
    q = sampled(qpack, B, B)
    q[6, ::7] = 0
    got, want = closure_on_card(cuda, tables, tck)[1](q, **kw)
    assert torch.equal(got, want)
    assert got[2 * B : 2 * B + 3].tolist() == [1, B, B]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["invalid", "uncovered", "dirty"])
def test_closure_probe_one_cause_batches_on_card(cuda, kind, layout):
    """Batches whose every query is invalid (nothing loaded), uncovered
    (objects no node has: every ch row read for nothing) or dirty (the
    dirty table over every covered node, the covered queries alone)."""
    tables, qpack, kw, tck = closure_inputs("videos", layout, kind == "dirty", dirty_every=1)
    q = sampled(qpack, 4097, 5)
    if kind == "invalid":
        q[6] = 0
    elif kind == "uncovered":
        q[0] += 1 << 24
        q[6] = 1
    _dev, both = closure_on_card(cuda, tables, tck)
    if kind == "dirty":
        _got, first = both(q, **kw)
        B = q.shape[1]
        q = q[:, first[B : 2 * B].cpu() == 2].contiguous()
    got, want = both(q, **kw)
    B = q.shape[1]
    cause = {"invalid": 3, "uncovered": 1, "dirty": 2}[kind]
    assert B > 100 and bool((want[B : 2 * B] == cause).all())
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_closure_probe_writes_every_stats_slot_on_card(cuda):
    """C1's result lands on memory full of garbage (a freed block of -7s
    the caching allocator hands out again): every slot, the eight of the
    stats tail among them, is written by the one launch."""
    tables, qpack, kw, tck = closure_inputs("videos", "bucketized", True)
    _dev, both = closure_on_card(cuda, tables, tck)
    q = sampled(qpack, 4097, 9).to(cuda)
    both(q, **kw)  # builds the library and the stream's grid scratch
    junk = torch.empty(2 * 4097 + tk.N_LAUNCH_STATS, dtype=torch.int32, device=cuda).fill_(-7)
    ptr = junk.data_ptr()
    del junk
    got, want = both(q, **kw)
    assert got.data_ptr() == ptr
    assert torch.equal(got, want)
    assert (got[-tk.N_LAUNCH_STATS:] != -7).all()


@pytest.mark.cuda
def test_closure_probe_calls_in_a_row_on_card(cuda):
    """Three calls of different B back to back on one stream, read only
    after the last: each call's grid sum finds the scratch at zero and
    leaves it so."""
    tables, qpack, kw, tck = closure_inputs("videos", "bucketized", True)
    dev, both = closure_on_card(cuda, tables, tck)
    qs = [sampled(qpack, B, B) for B in (4097, 1, 16387)]
    for q in qs:
        q[6, ::5] = 0
    got = [cuda_ops.closure_probe(dev["cc_pack"], dev["ch_pack"], dev["cd_pack"], q.to(cuda),
                                  **kw) for q in qs]
    torch.cuda.synchronize()
    for q, g in zip(qs, got):
        assert torch.equal(g, both(q, **kw)[1])
    assert not cuda_ops.grid_scratch(cuda, torch.cuda.current_stream().cuda_stream).any()


@pytest.mark.cuda
def test_closure_probe_launches_one_kernel_on_card(cuda):
    """A call of C1 launches its one kernel and no memset: the profiler
    sees nothing else over 20 calls (it may lose a few records, never add
    one)."""
    tables, qpack, kw, tck = closure_inputs("videos", "bucketized", True)
    dev, _both = closure_on_card(cuda, tables, tck)
    q = sampled(qpack, 4096, 1).to(cuda)
    events = profiled(lambda: cuda_ops.closure_probe(dev["cc_pack"], dev["ch_pack"],
                                                     dev["cd_pack"], q, **kw))
    assert len(events) == 1 and "closure_probe_kernel" in events[0].key, [e.key for e in events]
    assert 0 < events[0].count <= 20


def filter_inputs(scenario, layout, has_delta):
    from keto_tpu_torch.engine import filter_kernel as tfk

    snap, rev, _lo_q, lo_kw, _sub, _ls_q, _ls_kw = list_inputs(scenario, layout, has_delta)
    ns, tuples, queries, depth = LIST_SCENARIOS[scenario]()
    view = tdelta.SnapshotView(snap)
    packs = []
    for q in queries[:12]:
        t = RelationTuple.from_string(q)
        sub = view.encode_subject(t)
        ns_id, rel_id = view.ns_id(t.namespace), view.rel_id(t.relation)
        if sub is None or ns_id is None or rel_id is None:
            continue
        cand = sorted({s for (n, _o), s in snap.obj_slots.items() if n == ns_id})
        packs.append(torch.from_numpy(tfk.pack_filter_query(
            sub[1], int(tsnap.reverse_subject_tag(sub[0], sub[2])), rel_id, depth,
            np.array(cand, np.int32), 16 if len(cand) <= 16 else 64 if len(cand) <= 64 else 256)))
    kw = {k: v for k, v in lo_kw.items() if k not in ("frontier_cap",)}
    return rev, packs, kw, tfk


@pytest.mark.cuda
@pytest.mark.parametrize("frontier_cap", [4, 1024])
@pytest.mark.parametrize("has_delta", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("scenario", sorted(LIST_SCENARIOS))
def test_filter_launch_matches_plain(cuda, scenario, layout, has_delta, frontier_cap):
    rev, packs, kw, tfk = filter_inputs(scenario, layout, has_delta)
    assert packs
    cpu_tables = trk.reverse_tables_from_numpy(rev, "cpu")
    dev_tables = trk.reverse_tables_from_numpy(rev, cuda)
    for qc in packs:
        want = tfk.filter_kernel_packed(cpu_tables, qc, frontier_cap=frontier_cap, **kw)
        got = tfk.filter_kernel_packed(dev_tables, qc.to(cuda), frontier_cap=frontier_cap, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


def filter_columns(cuda, F, C, n, seed):
    """F1's inputs: a sorted column of n candidates padded to C, F random
    tasks (duplicate objects included, a quarter of them on a candidate),
    a hit mask with a tenth of the candidates already hit, and a status."""
    from keto_tpu_torch.engine import filter_kernel as tfk

    rng = np.random.default_rng(seed)
    cand = np.full(C, tfk.CAND_PAD, np.int32)
    cand[:n] = np.sort(rng.choice(4 * n, n, replace=False))
    cols = [torch.from_numpy(x).to(cuda) for x in (
        rng.integers(0, 4 * n + 8, F).astype(np.int32), rng.integers(0, 3, F).astype(np.int32),
        rng.integers(-1, 3, F).astype(np.int32))]
    live = torch.from_numpy(rng.random(F) < 0.9).to(cuda)
    head = torch.tensor([0, 0, 1, 0, n], dtype=torch.int32, device=cuda)
    hit = torch.from_numpy((rng.random(C) < 0.1) & (np.arange(C) < n)).to(torch.int32).to(cuda)
    status = torch.tensor([F, 0, int(hit.sum()), n], dtype=torch.int32, device=cuda)
    return [*cols, live, torch.from_numpy(cand).to(cuda), head], hit, status


@pytest.mark.cuda
@pytest.mark.parametrize("F,C,n", [(512, 16, 9), (4096, 16384, 9937), (70_000, 1024, 1000),
                                   (512, 1, 1), (4096, 1 << 20, 10**6)])
def test_filter_mark_matches_plain_on_card(cuda, F, C, n):
    """F1 on random task columns against its plain version on the same
    CUDA tensors, one slot and a 2^20-slot column of 10^6 candidates
    included; hit and status update in place, so each side works on its
    own clones."""
    from keto_tpu_torch.engine import filter_kernel as tfk

    cols, hit0, status0 = filter_columns(cuda, F, C, n, seed=F)
    outs = []
    for fn in (cuda_ops.filter_mark, tfk.filter_mark_plain):
        hit, status = hit0.clone(), status0.clone()
        marks = fn(*cols, hit, status)
        outs.append((marks.to(torch.int32), hit, status))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][0]) > 0


@pytest.mark.cuda
def test_filter_mark_calls_in_a_row_on_card(cuda):
    """F1's marks come from a one-launch grid sum over a scratch that each
    launch leaves at zero: five calls in a row on one hit mask, with no
    reset between them, then F1 and P2 calls interleaved on the same
    stream, each exact against its plain version."""
    from keto_tpu_torch.engine import closure_power as tcp
    from keto_tpu_torch.engine import filter_kernel as tfk

    cols, hit0, status0 = filter_columns(cuda, 4096, 16384, 10_000, seed=11)
    got = (hit0.clone(), status0.clone())
    want = (hit0.clone(), status0.clone())
    marks = []
    for k in range(5):
        obj = torch.roll(cols[0], 97 * k)  # another object column each call
        a = cuda_ops.filter_mark(obj, *cols[1:], *got)
        b = tfk.filter_mark_plain(obj, *cols[1:], *want)
        assert int(a) == int(b) > 0, k
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), k
        marks.append(int(a))
    assert len(set(marks)) > 1

    inputs = power_wave(2048, 7, 1000, 2000)
    e_src, e_dst, d_rows, _pois, R0, lvl0, counts0 = (t.to(cuda) for t in inputs)
    fresh = tcp.power_step_plain(R0, R0.clone(), e_src, e_dst, counts0.clone(),
                                 torch.zeros(tk.N_LAUNCH_STATS, dtype=torch.int32, device=cuda),
                                 torch.ones(1, dtype=torch.int32, device=cuda))
    for k in range(3):
        sides = []
        for fn in (cuda_ops.power_account, tcp.power_account_plain):
            lvl, status = lvl0.clone(), torch.zeros(1, dtype=torch.int32, device=cuda)
            sides.append((fn(fresh, lvl, counts0, d_rows, status, level=1, max_set_rows=k),
                          lvl, status))
        for a, b in zip(*sides):
            assert torch.equal(a, b), k
        hit, status = hit0.clone(), status0.clone()
        a = cuda_ops.filter_mark(*cols, hit, status)
        want_hit, want_status = hit0.clone(), status0.clone()
        assert int(a) == int(tfk.filter_mark_plain(*cols, want_hit, want_status)), k
        assert torch.equal(hit, want_hit) and torch.equal(status, want_status), k


@pytest.mark.cuda
def test_filter_mark_and_power_account_launch_one_kernel_on_card(cuda):
    """A call of F1 or P2 launches its one kernel and no memset: the
    profiler sees nothing else over 20 calls (it may lose a few records,
    never add one)."""
    cols, hit, status = filter_columns(cuda, 4096, 16384, 10_000, seed=3)
    e_src, e_dst, d_rows, _pois, R0, lvl0, counts0 = (t.to(cuda) for t in
                                                       power_wave(2048, 5, 1000, 2000))
    p2_status = torch.zeros(1, dtype=torch.int32, device=cuda)
    calls = {
        "filter_mark_staged_kernel": lambda: cuda_ops.filter_mark(*cols, hit, status),
        "power_account_vec_kernel": lambda: cuda_ops.power_account(
            R0, lvl0, counts0, d_rows, p2_status, level=1, max_set_rows=3),
    }
    for kernel, call in calls.items():
        events = profiled(call)
        assert len(events) == 1 and kernel in events[0].key, [e.key for e in events]
        assert 0 < events[0].count <= 20


# -- closure powering ----------------------------------------------------------------


def power_wave(lanes, seed, n_sub, n_edges, n_nodes=None, n_direct=None):
    """One wave's inputs laid out as power_closure_device lays them out: a
    random subgraph with a dummy node at n_sub, dst-sorted edges and direct
    rows padded with it, a few poisoned nodes, and lanes - 3 sources (the
    last word holds padding lanes) with their self bits, levels and counts.
    n_nodes (rows of the bit matrices, past n_sub) defaults to the
    layout's power of two, n_direct (direct nodes) to half of n_sub."""
    from keto_tpu_torch.engine import closure_power as tcp

    rng = np.random.default_rng(seed)
    Nq, Eq = n_nodes or tcp._next_pow2(n_sub + 1, 2), tcp._next_pow2(n_edges, 1)
    src, dst = rng.integers(0, n_sub, n_edges), rng.integers(0, n_sub, n_edges)
    order = np.argsort(dst, kind="stable")
    e_src, e_dst = np.full(Eq, n_sub, np.int32), np.full(Eq, n_sub, np.int32)
    e_src[:n_edges], e_dst[:n_edges] = src[order], dst[order]
    n_direct = n_sub // 2 if n_direct is None else n_direct
    dnodes = np.sort(rng.choice(n_sub, n_direct, replace=False)).astype(np.int32)
    d_rows = np.full(tcp._next_pow2(len(dnodes), 1), n_sub, np.int32)
    d_rows[:len(dnodes)] = dnodes
    pois = np.zeros(Nq, np.uint8)
    pois[rng.choice(n_sub, 3, replace=False)] = 1
    nl = lanes - 3
    snode, lane_ids = rng.integers(0, n_sub, nl), np.arange(nl)
    R0 = np.zeros((Nq, lanes // 32), np.uint32)
    np.bitwise_or.at(R0, (snode, lane_ids // 32), np.uint32(1) << (lane_ids % 32).astype(np.uint32))
    lvl0 = np.full((len(d_rows), lanes), -1, np.int8)
    if n_direct:
        pos = np.searchsorted(dnodes, snode).clip(0, len(dnodes) - 1)
        at_d = dnodes[pos] == snode
        lvl0[pos[at_d], lane_ids[at_d]] = 0
    counts0 = np.zeros(lanes, np.int32)
    counts0[:nl] = 1
    return [torch.from_numpy(a) for a in (e_src, e_dst, d_rows, pois, R0.view(np.int32), lvl0,
                                          counts0)]


@pytest.mark.cuda
@pytest.mark.parametrize("max_set_rows", [1 << 20, 3, 0])
@pytest.mark.parametrize("lanes,n_sub,n_edges,n_nodes,n_direct", [
    (32, 40, 70, None, None), (64, 40, 70, None, None), (256, 300, 500, None, None),
    (2048, 1000, 2000, None, None), (8192, 3000, 5000, None, None),
    (32, 6, 12, 7, 0), (64, 6, 12, 7, 0)])
def test_power_kernels_match_plain_on_card(cuda, lanes, n_sub, n_edges, n_nodes, n_direct,
                                           max_set_rows):
    """P1, P2 and P3 against their plain versions on the same CUDA tensors
    at every step of a wave (1, 2, 8, 64 and 256 words a row; 7 nodes with
    only the dummy direct row, so N W is no multiple of 4 and D = 1; with
    a row-cap kill, one that kills every source after its first step, and
    poisoned nodes), each side updating its own clones; then the whole wave
    on the card against the CPU's."""
    from keto_tpu_torch.engine import closure_power as tcp

    inputs = power_wave(lanes, lanes + max_set_rows, n_sub, n_edges, n_nodes, n_direct)
    e_src, e_dst, d_rows, pois, R0, lvl0, counts0 = (t.to(cuda) for t in inputs)
    R, F, lvl, counts = R0.clone(), R0, lvl0.clone(), counts0.clone()
    stats = torch.zeros(tk.N_LAUNCH_STATS, dtype=torch.int32, device=cuda)
    status = tcp._popcount(R0).sum().to(torch.int32).reshape(1)
    before = {k: cuda_ops.launches[k] for k in cuda_ops.POWER_KERNELS}
    level, killed = 0, False
    while level < 12 and int(status[0]):
        sides = []
        for fn in (cuda_ops.power_step, tcp.power_step_plain):
            r, c, st = R.clone(), counts.clone(), stats.clone()
            sides.append((fn(F, r, e_src, e_dst, c, st, status), r, c, st))
        for a, b in zip(*sides):
            assert torch.equal(a, b), level
        fresh, R, counts, stats = sides[0]
        level += 1
        sides = []
        for fn in (cuda_ops.power_account, tcp.power_account_plain):
            lv, st = lvl.clone(), status.clone()
            sides.append((fn(fresh, lv, counts, d_rows, st, level=level,
                             max_set_rows=max_set_rows), lv, st))
        for a, b in zip(*sides):
            assert torch.equal(a, b), level
        F, lvl, status = sides[0]
        killed |= bool((counts > max_set_rows).any())
    summary = cuda_ops.power_poison(R, pois, counts, stats)
    assert torch.equal(summary, tcp.power_poison_plain(R, pois, counts, stats))
    S = lanes
    assert level == 1 if max_set_rows == 0 else level >= 2
    assert summary[S:2 * S].any() and killed == (max_set_rows < 1 << 20)
    assert {k: cuda_ops.launches[k] - before[k] for k in before} == {
        "power_step": level, "power_account": level, "power_poison": 1}

    got = tcp.closure_power_wave(e_src, e_dst, d_rows, pois, R0, lvl0, counts0, max_depth=12,
                                 max_set_rows=max_set_rows)
    want = tcp.closure_power_wave(*inputs, max_depth=12, max_set_rows=max_set_rows)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def scratch_is_zero(cuda) -> bool:
    """P1's and P3's accumulator and the grid-sum word of this stream are
    all zero, as every launch must leave them (P1's lists are written
    before they are read)."""
    stream = torch.cuda.current_stream().cuda_stream
    acc, _lists = cuda_ops.power_scratch(cuda, stream)
    return not acc.any() and not cuda_ops.grid_scratch(cuda, stream).any()


def step_both(cuda, F, R, e_src, e_dst, counts, stats, status):
    """P1 and its plain version on clones of R, counts and stats: asserts
    fresh and the three updated tensors equal and the scratch left zero;
    returns the kernel's (fresh, R, counts, stats)."""
    from keto_tpu_torch.engine import closure_power as tcp

    sides = []
    for fn in (cuda_ops.power_step, tcp.power_step_plain):
        r, c, st = R.clone(), counts.clone(), stats.clone()
        sides.append((fn(F, r, e_src, e_dst, c, st, status), r, c, st))
    for a, b in zip(*sides):
        assert torch.equal(a, b)
    assert scratch_is_zero(cuda)
    return sides[0]


def poison_both(cuda, R, pois, counts, stats):
    from keto_tpu_torch.engine import closure_power as tcp

    got = cuda_ops.power_poison(R, pois, counts, stats)
    assert torch.equal(got, tcp.power_poison_plain(R, pois, counts, stats))
    assert scratch_is_zero(cuda)
    return got


@pytest.mark.cuda
def test_power_kernels_shapes_in_a_row_on_card(cuda):
    """P1 and P3 on one stream whose shapes change call after call (W =
    64, then 1, then 256, then 64 at another N): the cached accumulator
    grows, each whole wave stays exact, and after every call the scratch
    is zero again."""
    from keto_tpu_torch.engine import closure_power as tcp

    shapes = [(2048, 1000, 2000, None), (32, 6, 12, 7), (8192, 3000, 5000, None),
              (2048, 300, 500, None)]
    for k, (lanes, n_sub, n_edges, n_nodes) in enumerate(shapes):
        inputs = power_wave(lanes, 40 + k, n_sub, n_edges, n_nodes, 0 if n_nodes else None)
        e_src, e_dst, d_rows, pois, R0, lvl0, counts0 = (t.to(cuda) for t in inputs)
        R, F, lvl, counts = R0.clone(), R0, lvl0.clone(), counts0.clone()
        stats = torch.zeros(tk.N_LAUNCH_STATS, dtype=torch.int32, device=cuda)
        status = tcp._popcount(R0).sum().to(torch.int32).reshape(1)
        level = 0
        while level < 12 and int(status[0]):
            fresh, R, counts, stats = step_both(cuda, F, R, e_src, e_dst, counts, stats, status)
            level += 1
            F = cuda_ops.power_account(fresh, lvl, counts, d_rows, status, level=level,
                                       max_set_rows=1 << 20)
        assert level >= 2, k
        summary = poison_both(cuda, R, pois, counts, stats)
        assert summary[lanes:2 * lanes].any(), k


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32, 64, 128, 2048, 8192])
def test_power_step_dense_frontier_on_card(cuda, lanes):
    """P1 with every word of F set on every node (so every gathered word is
    non-zero, every destination word is touched, and many edges race to
    set each bit), against R empty and against R already holding half the
    bits."""
    e_src, e_dst, _d, _pois, R0, _lvl, counts0 = (t.to(cuda) for t in
                                                  power_wave(lanes, 9, 500, 1000))
    F = torch.full_like(R0, -1)
    for R in (torch.zeros_like(R0), torch.full_like(R0, 0x55555555)):
        stats = torch.zeros(tk.N_LAUNCH_STATS, dtype=torch.int32, device=cuda)
        status = torch.full((1,), 32 * F.numel(), dtype=torch.int32, device=cuda)
        fresh, *_ = step_both(cuda, F, R, e_src, e_dst, counts0, stats, status)
        assert fresh.any()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32, 64, 2048])
def test_power_step_no_edges_and_padding_on_card(cuda, lanes):
    """P1 with no edge at all (E = 0), and with every edge a padding edge at
    the dummy node: fresh is all zero, R and the counts stay, the stats
    count one step."""
    e_src, _e_dst, _d, _pois, R0, _lvl, counts0 = (t.to(cuda) for t in
                                                   power_wave(lanes, 3, 40, 70))
    dummy = 40
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    pad = torch.full_like(e_src, dummy)
    for src, dst in ((none, none), (pad, pad)):
        stats = torch.zeros(tk.N_LAUNCH_STATS, dtype=torch.int32, device=cuda)
        status = torch.ones(1, dtype=torch.int32, device=cuda)
        fresh, R, counts, stats = step_both(cuda, R0, R0.clone(), src, dst, counts0, stats,
                                            status)
        assert not fresh.any() and torch.equal(R, R0) and torch.equal(counts, counts0)
        assert stats[0] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes", [7, 16, 37, 512, 1029, 32768])
@pytest.mark.parametrize("lanes", [32, 2048, 8192])
def test_power_poison_masks_on_card(cuda, n_nodes, lanes):
    """P3 with no node poisoned, every node poisoned and a few at random,
    at N a multiple of 16 and not (7, 37, 1,029: the mask's tail is read
    byte by byte), within one 512-node tile and across many."""
    rng = np.random.default_rng(n_nodes + lanes)
    W = lanes // 32
    r = rng.integers(0, 1 << 32, (n_nodes, W), dtype=np.uint64)
    r[rng.random((n_nodes, W)) >= 0.25] = 0
    R = torch.from_numpy(r.astype(np.uint32).view(np.int32)).to(cuda)
    counts = torch.from_numpy(rng.integers(0, 9, lanes).astype(np.int32)).to(cuda)
    stats = torch.from_numpy(rng.integers(0, 100, tk.N_LAUNCH_STATS).astype(np.int32)).to(cuda)
    some = np.zeros(n_nodes, np.uint8)
    k = min(3, n_nodes)
    some[rng.choice(n_nodes, k, replace=False)] = rng.integers(1, 256, k)
    for mask in (np.zeros(n_nodes, np.uint8), np.ones(n_nodes, np.uint8), some):
        poison_both(cuda, R, torch.from_numpy(mask).to(cuda), counts, stats)


@pytest.mark.cuda
def test_power_step_and_poison_launch_no_memset_on_card(cuda):
    """A call of P1 launches its gather and its walk, and P3 its one
    kernel; neither a memset: the profiler sees those names and nothing
    else over 20 calls."""
    e_src, e_dst, _d, pois, R0, _lvl, counts0 = (t.to(cuda) for t in
                                                 power_wave(2048, 5, 1000, 2000))
    R, counts = R0.clone(), counts0.clone()
    stats = torch.zeros(tk.N_LAUNCH_STATS, dtype=torch.int32, device=cuda)
    status = torch.ones(1, dtype=torch.int32, device=cuda)
    calls = {
        ("power_step_gather_kernel", "power_step_walk_kernel"):
            lambda: cuda_ops.power_step(R0, R, e_src, e_dst, counts, stats, status),
        ("power_poison_kernel",): lambda: cuda_ops.power_poison(R0, pois, counts0, stats),
    }
    for kernels, call in calls.items():
        keys = [e.key for e in profiled(call)]
        assert len(keys) == len(kernels), keys
        assert all(any(k in key for key in keys) for k in kernels), keys
    assert scratch_is_zero(cuda)


def deep_chains(n_chains=60, depth=9, seed=5):
    """view = owner | parent->view chains with a tail owner each, direct
    viewer grants and one AND island that poisons the chains reaching it."""
    rng = random.Random(seed)
    ns = [{"name": "deep", "relations": [
        {"name": "owner"}, {"name": "parent"}, {"name": "allow"}, {"name": "deny"},
        {"name": "gate", "rewrite": {"operator": "and", "children": [
            _computed("allow"), {"type": "invert", "inverted": _computed("deny")}]}},
        {"name": "viewer", "rewrite": {"operator": "or", "children": [
            _computed("owner"), _ttu("parent", "viewer")]}},
    ]}]
    tuples = []
    for c in range(n_chains):
        tuples += [f"deep:c{c}f{i}#parent@(deep:c{c}f{i + 1}#...)" for i in range(depth)]
        tuples.append(f"deep:c{c}f{depth}#owner@u{rng.randrange(16)}")
        tuples.append(f"deep:c{c}f{rng.randrange(depth)}#viewer@u{rng.randrange(16)}")
    tuples += ["deep:c0f3#viewer@(deep:g#gate)", "deep:g#allow@u1"]
    return ns, tuples, depth + 4


@pytest.mark.cuda
@pytest.mark.parametrize("max_set_rows,budget", [(4096, 256 << 20), (3, 256 << 20),
                                                 (4096, 0)])
def test_power_closure_device_on_card_equals_cpu(cuda, max_set_rows, budget):
    from keto_tpu_torch.engine import closure as tcl
    from keto_tpu_torch.engine import closure_power as tcp

    ns, tuples, depth = deep_chains()
    snap = tsnap.build_snapshot([RelationTuple.from_string(s) for s in tuples],
                                [Namespace.from_dict(d) for d in ns], layout="bucketized")
    graph = tcl.extract_graph(snap)
    want, wrec = tcp.power_closure_device(graph, snap, depth, max_set_rows, 0, device="cpu",
                                          budget_bytes=budget)
    before = cuda_ops.launches["power_step"]
    got, rec = tcp.power_closure_device(graph, snap, depth, max_set_rows, 0, device=cuda,
                                        budget_bytes=budget)
    for k in ("covered_keys", "ent_obj", "ent_rel", "ent_skind", "ent_sa", "ent_sb", "ent_req"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (got.n_nodes, got.vocab_fp, got.n_entries) == (want.n_nodes, want.vocab_fp,
                                                          want.n_entries)
    assert {k: rec[k] for k in ("waves", "steps", "lanes", "nodes", "edges", "hbm")} == {
        k: wrec[k] for k in ("waves", "steps", "lanes", "nodes", "edges", "hbm")}
    assert cuda_ops.launches["power_step"] - before == rec["steps"]
    host = tcl.power_closure(graph, snap, depth, max_set_rows, 0)
    assert np.array_equal(got.covered_keys, host.covered_keys)
    assert np.array_equal(got.ent_req, host.ent_req)
    assert 0 < len(got.covered_keys) < len(graph.universe)


def _same(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("F,CAP,F_large", [(256, 512, 4099), (16384, 32768, 1 << 20),
                                           (5001, 4096, (1 << 20) + 5)])
def test_microbench_kernels_match_plain_on_card(cuda, F, CAP, F_large):
    """M1-M7 against their plain versions on the same CUDA tensors, on the
    TPU tool's draws (its hash probe with planted keys so both probe arms
    hit), M3, M5 and M6 also at a larger F; ragged sizes included."""
    from keto_tpu_torch.tools import microbench as mb

    inp = mb.make_inputs(F, CAP, seed=F)
    inp["keys"] = mb.plant_keys(inp["keys"], inp["qk"], min(F // 4, 1024))
    ops = mb.ops(inp, cuda, large=mb.make_inputs(F_large, CAP, seed=F_large))
    assert len(ops) == 10
    for o in ops:
        before = cuda_ops.launches[o.kernel]
        got = o.run()
        assert cuda_ops.launches[o.kernel] == before + 1, o.op
        assert _same(got, o.plain()), o.op


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 4, 2047, 2048, 2049, 4096 * 3 + 1, (1 << 20) + 3])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_pack_kernels_edge_counts_on_card(cuda, n, density):
    """M5 and M6: survivors in input order and zeros past the count for
    empty, full and ragged columns, across tile and block boundaries."""
    from keto_tpu_torch.tools import microbench as mb

    g = torch.Generator().manual_seed(n)
    keep = (torch.rand(n, 1, generator=g) < density).to(torch.int32)
    vals = torch.randint(1, 1 << 20, (n, 1), generator=g, dtype=torch.int32)
    want = mb.pack_plain(keep, vals)
    for fn in (cuda_ops.mb_pack_onepass, cuda_ops.mb_pack):
        out, cnt = fn(keep.to(cuda), vals.to(cuda))
        assert torch.equal(out.cpu(), want[0]) and torch.equal(cnt.cpu(), want[1]), fn


def pack_column(cuda, n, seed):
    g = torch.Generator().manual_seed(seed)
    keep = (torch.rand(n, 1, generator=g) < 0.5).to(torch.int32)
    vals = torch.randint(1, 1 << 20, (n, 1), generator=g, dtype=torch.int32)
    return keep.to(cuda), vals.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n_streams", [1, 2])
def test_pack_onepass_calls_in_a_row_on_card(cuda, n_streams):
    """M5 called back to back with F falling and rising, read only after
    the last call, on one stream or alternating between two (each with
    its own look-back scratch): every call exact, every ticket counter
    back at 0."""
    from keto_tpu_torch.tools import microbench as mb

    cols = [pack_column(cuda, n, i) for i, n in enumerate([(1 << 20) + 3, 5, 4097] * 2)]
    streams = [torch.cuda.Stream() for _ in range(n_streams)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for i, (keep, vals) in enumerate(cols):
        with torch.cuda.stream(streams[i % n_streams]):
            got.append(cuda_ops.mb_pack_onepass(keep, vals))
    torch.cuda.synchronize()
    for (keep, vals), g in zip(cols, got):
        assert _same(g, mb.pack_plain(keep, vals))
    for st in streams:
        buf, _epoch = cuda_ops._onepass_scratch[(cols[0][0].device.index, st.cuda_stream)]
        assert int(buf[0]) == 0


@pytest.mark.cuda
def test_pack_onepass_epoch_wraps_on_card(cuda):
    """A call at epoch 1 leaves its status words behind; the counter is
    then set to the last epoch, so the next call stamps ONEPASS_EPOCHS and
    the one after wraps to 1, which must zero the words first or read the
    first call's prefixes as its own. Each call on other data, exact."""
    from keto_tpu_torch.tools import microbench as mb

    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    cols = [pack_column(cuda, (1 << 20) + 3, seed) for seed in (1, 2, 3)]
    key = (cols[0][0].device.index, st.cuda_stream)
    epochs = []
    with torch.cuda.stream(st):
        for i, (keep, vals) in enumerate(cols):
            if i == 1:
                buf, _epoch = cuda_ops._onepass_scratch[key]
                cuda_ops._onepass_scratch[key] = (buf, cuda_ops.ONEPASS_EPOCHS - 1)
            got = cuda_ops.mb_pack_onepass(keep, vals)
            epochs.append(cuda_ops._onepass_scratch[key][1])
            st.synchronize()
            assert _same(got, mb.pack_plain(keep, vals)), i
    assert epochs == [1, cuda_ops.ONEPASS_EPOCHS, 1]


@pytest.mark.cuda
def test_pack_onepass_launches_one_kernel_on_card(cuda):
    """A call of M5 launches its one kernel and no memset (its scratch is
    zeroed when allocated, and its counter returned to 0 by the launch):
    the profiler sees nothing else over 20 calls."""
    keep, vals = pack_column(cuda, 1 << 20, 0)
    events = profiled(lambda: cuda_ops.mb_pack_onepass(keep, vals))
    assert len(events) == 1 and "pack_onepass_kernel" in events[0].key, [e.key for e in events]
    assert 0 < events[0].count <= 20


@pytest.mark.cuda
def test_pack_capacity_on_card(cuda):
    """M6 at exactly its capacity, every tile's block resident at once,
    and one input past it refused before any launch."""
    from keto_tpu_torch.tools import microbench as mb

    cap = cuda_ops.pack_capacity(cuda)
    assert cap >= 132 * 8192  # at least a block of 8,192 inputs on every SM
    keep, vals = pack_column(cuda, cap, 7)
    assert _same(cuda_ops.mb_pack(keep, vals), mb.pack_plain(keep, vals))
    keep, vals = pack_column(cuda, cap + 1, 8)
    before = cuda_ops.launches["mb_pack"]
    with pytest.raises(ValueError, match="cooperative"):
        cuda_ops.mb_pack(keep, vals)
    assert cuda_ops.launches["mb_pack"] == before


@pytest.mark.cuda
def test_pack_two_streams_at_once_on_card(cuda):
    """M6 on two streams at once, neither waiting for the other, on
    columns of both tile sizes, each call's counts its own: every call
    exact."""
    from keto_tpu_torch.tools import microbench as mb

    cols = [pack_column(cuda, n, 20 + i)
            for i, n in enumerate([(1 << 20) + 3, 16385, 1 << 20, 4097, (1 << 19) + 5, 1])]
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for i, (keep, vals) in enumerate(cols):
        with torch.cuda.stream(streams[i % 2]):
            got.append(cuda_ops.mb_pack(keep, vals))
    torch.cuda.synchronize()
    for (keep, vals), g in zip(cols, got):
        assert _same(g, mb.pack_plain(keep, vals))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, (1 << 20) + 3])
def test_pack_graph_replays_on_card(cuda, n):
    """A CUDA graph of one M6 call, replayed three times on inputs
    changed in place between replays: each replay equals pack_plain on
    the inputs it saw (nothing of an earlier call carries over)."""
    from keto_tpu_torch.tools import microbench as mb

    keep, vals = pack_column(cuda, n, 30)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_ops.mb_pack(keep, vals)  # the library, the capacity: outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, cnt = cuda_ops.mb_pack(keep, vals)
    for seed in (31, 32, 33):
        k2, v2 = pack_column(cuda, n, seed)
        if seed == 32:
            k2.fill_(1)
        keep.copy_(k2)
        vals.copy_(v2)
        graph.replay()
        torch.cuda.synchronize()
        assert _same((out, cnt), mb.pack_plain(keep, vals)), seed


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, 1 << 20])
def test_pack_launches_one_kernel_on_card(cuda, n):
    """A call of M6 launches its one kernel and no memset: the profiler
    sees nothing else over 20 calls."""
    keep, vals = pack_column(cuda, n, 0)
    events = profiled(lambda: cuda_ops.mb_pack(keep, vals))
    assert len(events) == 1 and "pack_kernel" in events[0].key, [e.key for e in events]
    assert 0 < events[0].count <= 20


def probe_case(cuda, case: str):
    """(tab, idx) on the card for M2: the tool's draw at F = 16,384 into
    CAP = 32,768, at F = 0, 1 and 16,385, into CAP = 4, into the largest
    table a block's shared memory holds, with every index 0 or CAP - 1,
    and from a table that is a 16-byte-aligned view at a nonzero offset."""
    from keto_tpu_torch.tools import microbench as mb

    F, cap = {"F0": (0, 32768), "F1": (1, 32768), "F16385": (16385, 32768),
              "cap4": (16384, 4), "cap_max": (16384, cuda_ops.MAX_DYNAMIC_SMEM // 16 * 4)}.get(
                  case, (16384, 32768))
    inp = mb.make_inputs(max(F, 1), cap, seed=F + cap)
    tab, idx = torch.from_numpy(inp["tab"]), torch.from_numpy(inp["idx"])[:F]
    if case == "first":
        idx.zero_()
    elif case == "last":
        idx.fill_(cap - 1)
    tab = tab.to(cuda)
    if case == "offset":
        tab = torch.cat([torch.full((8, 1), -1, dtype=torch.int32, device=cuda), tab])[8:]
    return tab, idx.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tool", "F0", "F1", "F16385", "cap4", "cap_max", "first",
                                  "last", "offset"])
def test_probe_smem_shapes_on_card(cuda, case):
    """M2 against its plain version on the edge sizes and indices of
    probe_case, the table staged by its bulk copy."""
    from keto_tpu_torch.tools import microbench as mb

    tab, idx = probe_case(cuda, case)
    if case == "offset":
        assert tab.storage_offset() == 8 and tab.data_ptr() % 16 == 0
    before = cuda_ops.launches["mb_probe_smem"]
    got = cuda_ops.mb_probe_smem(tab, idx)
    assert cuda_ops.launches["mb_probe_smem"] == before + 1
    assert _same(got, mb.probe_plain(tab, idx))


@pytest.mark.cuda
def test_probe_smem_refuses_past_shared_memory_on_card(cuda):
    """A table 4 words past one block's shared memory is refused before
    any launch."""
    tab, idx = probe_case(cuda, "cap_max")
    big = torch.zeros(tab.numel() + 4, 1, dtype=torch.int32, device=cuda)
    before = cuda_ops.launches["mb_probe_smem"]
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ops.mb_probe_smem(big, idx)
    assert cuda_ops.launches["mb_probe_smem"] == before


@pytest.mark.cuda
def test_probe_smem_launches_one_kernel_on_card(cuda):
    """A call of M2 launches its one kernel (no copy, no memset, no
    attribute call on the stream): the profiler sees nothing else."""
    tab, idx = probe_case(cuda, "tool")
    events = profiled(lambda: cuda_ops.mb_probe_smem(tab, idx))
    assert len(events) == 1 and "probe_smem_kernel" in events[0].key, [e.key for e in events]
    assert 0 < events[0].count <= 20


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [1, 7, 4096])
def test_scatmax_kernels_under_contention_on_card(cuda, n_out):
    """M3 and M4 with many updates a bucket, negative priorities included
    (the output starts at zero, so they never win)."""
    from keto_tpu_torch.tools import microbench as mb

    g = torch.Generator().manual_seed(n_out)
    b = torch.randint(0, n_out, (100_003, 1), generator=g, dtype=torch.int32)
    p = torch.randint(-(1 << 30), 1 << 30, (100_003, 1), generator=g, dtype=torch.int32)
    want = mb.scatmax_plain(b, p, n_out=n_out)
    for fn in (cuda_ops.mb_scatmax, cuda_ops.mb_scatmax_smem):
        assert torch.equal(fn(b.to(cuda), p.to(cuda), n_out=n_out).cpu(), want), fn


def scatmax_case(cuda, case: str, F: int, n_out: int):
    """(b, p) [F, 1] on the card: buckets uniform in [0, n_out), or all in
    one bucket, or all in one range of M3's bins (2^14 buckets) or one
    slice of M4's cluster, or sorted; priorities positive, of both signs,
    or half of them 0."""
    g = torch.Generator().manual_seed(F + n_out)
    b = torch.randint(0, max(n_out, 1), (F, 1), generator=g, dtype=torch.int32)
    p = torch.randint(1, 1 << 30, (F, 1), generator=g, dtype=torch.int32)
    if case == "one_bucket":
        b[:] = n_out // 3
    elif case == "one_range":
        lo = (n_out // 2) & ~((1 << 14) - 1)
        b = lo + torch.randint(0, min(1 << 14, n_out - lo), (F, 1), generator=g, dtype=torch.int32)
    elif case == "one_slice":
        b = torch.randint(0, max(n_out // 8, 1), (F, 1), generator=g, dtype=torch.int32)
    elif case == "negative":
        p = torch.randint(-(1 << 30), 1 << 30, (F, 1), generator=g, dtype=torch.int32)
    elif case == "zero":
        p[torch.rand(F, 1, generator=g) < 0.5] = 0
    elif case == "sorted":
        b = b.sort(dim=0).values
    return b.to(cuda), p.to(cuda)


SCATMAX_SIZES = (0, 1, 4097, (1 << 20) - 1, 1 << 20, (1 << 20) + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("F", SCATMAX_SIZES)
@pytest.mark.parametrize("case", ["uniform", "one_bucket", "one_range", "sorted", "negative",
                                  "zero"])
def test_scatmax_bins_on_card(cuda, case, F):
    """M3 against its plain version, on both sides of the size where it
    starts to bin (2^20), with an uneven last tile at 2^20 + 3, every update in
    one bucket or one range, the updates sorted by bucket (a few long runs
    a range), priorities that never win, into 2F buckets and into a count
    that is no multiple of a range (2F + 5)."""
    from keto_tpu_torch.tools import microbench as mb

    for n_out in (max(2 * F, 1), 2 * F + 5):
        b, p = scatmax_case(cuda, case, F, n_out)
        got = cuda_ops.mb_scatmax(b, p, n_out=n_out)
        assert _same(got, mb.scatmax_plain(b, p, n_out=n_out)), n_out


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [1, 1 << 14, (1 << 26) + (1 << 14) + 7])
def test_scatmax_wide_outputs_on_card(cuda, n_out):
    """M3 binned into one range, into exactly one range, and into more
    buckets than 2^10 ranges of 2^14 cover (each owner then walks its
    range in parts of 2^14), every bucket written."""
    from keto_tpu_torch.tools import microbench as mb

    b, p = scatmax_case(cuda, "uniform", (1 << 20) + 9, n_out)
    got = cuda_ops.mb_scatmax(b, p, n_out=n_out)
    assert _same(got, mb.scatmax_plain(b, p, n_out=n_out))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [0, 1, 16384, (1 << 20) + 3])
@pytest.mark.parametrize("case", ["uniform", "one_bucket", "one_slice", "negative", "zero"])
def test_scatmax_cluster_on_card(cuda, case, F):
    """M4 against its plain version on every update in one bucket or one
    block's slice, priorities that never win, into 2F buckets (at most
    the cluster's capacity) and into a count that is no multiple of the
    slices (8 x 1,001 + 3)."""
    from keto_tpu_torch.tools import microbench as mb

    cap = cuda_ops.library().keto_mb_scatmax_smem_capacity()
    for n_out in (min(max(2 * F, 1), cap), 8 * 1001 + 3):
        b, p = scatmax_case(cuda, case, F, n_out)
        got = cuda_ops.mb_scatmax_smem(b, p, n_out=n_out)
        assert _same(got, mb.scatmax_plain(b, p, n_out=n_out)), n_out


@pytest.mark.cuda
def test_scatmax_cluster_capacity_on_card(cuda):
    """M4 at exactly its cluster's capacity, every slice full, and one
    bucket past it refused before any launch."""
    from keto_tpu_torch.tools import microbench as mb

    cap = cuda_ops.library().keto_mb_scatmax_smem_capacity()
    assert cap >= 8 * (cuda_ops.MAX_DYNAMIC_SMEM // 4)  # a cluster of 8 blocks or more
    b, p = scatmax_case(cuda, "uniform", 1 << 20, cap)
    assert _same(cuda_ops.mb_scatmax_smem(b, p, n_out=cap), mb.scatmax_plain(b, p, n_out=cap))
    before = cuda_ops.launches["mb_scatmax_smem"]
    with pytest.raises(ValueError, match="cluster"):
        cuda_ops.mb_scatmax_smem(b, p, n_out=cap + 1)
    assert cuda_ops.launches["mb_scatmax_smem"] == before


@pytest.mark.cuda
def test_scatmax_kernels_launch_no_memset_on_card(cuda):
    """At F = 2^20, a call of M3 launches its bin and own kernels and no
    memset, and a call of M4 its one cluster kernel: the profiler sees
    those names and nothing else over 20 calls."""
    from keto_tpu_torch.tools import microbench as mb

    inp = mb.make_inputs(1 << 20, mb.CAP_TOOL)
    b, p = (torch.from_numpy(inp[k]).to(cuda) for k in ("buck", "prio"))
    keys = [e.key for e in profiled(lambda: cuda_ops.mb_scatmax(b, p, n_out=2 << 20))]
    assert len(keys) == 2 and not any("emset" in k for k in keys), keys
    assert any("scatmax_bin_kernel" in k for k in keys), keys
    assert any("scatmax_own_kernel" in k for k in keys), keys
    small = b[:16384] % 32768, p[:16384]
    events = profiled(lambda: cuda_ops.mb_scatmax_smem(*small, n_out=32768))
    assert len(events) == 1 and "scatmax_cluster_kernel" in events[0].key, [
        e.key for e in events]
    assert 0 < events[0].count <= 20


@pytest.mark.cuda
def test_feasibility_kernels_match_plain_on_card(cuda):
    """M8-M10 on the TPU tool's constants, then on wider shapes."""
    from keto_tpu_torch.tools import microbench_feasibility as mf

    for o in mf.ops(cuda):
        before = cuda_ops.launches[o.kernel]
        assert _same(o.run(), o.plain()), o.op
        assert cuda_ops.launches[o.kernel] == before + 1
    g = torch.Generator().manual_seed(3)
    x, y = torch.randn(3, 1001, generator=g), torch.randn(3, 1001, generator=g)
    assert torch.equal(cuda_ops.mb_add(x.to(cuda), y.to(cuda)).cpu(), x + y)
    tab = torch.randint(-100, 100, (1024, 260), generator=g, dtype=torch.int32)
    idx = torch.randint(0, 1024, (777,), generator=g, dtype=torch.int32)
    assert torch.equal(cuda_ops.mb_row_gather(idx.to(cuda), tab.to(cuda)).cpu(),
                       mf.row_gather_plain(idx, tab))
    bidx = torch.randint(0, 256, (300,), generator=g, dtype=torch.int32)
    got = cuda_ops.mb_block_gather(bidx.to(cuda), tab.to(cuda), block_rows=4)
    assert torch.equal(got.cpu(), mf.block_gather_plain(bidx, tab, block_rows=4))


@pytest.mark.cuda
def test_microbench_entry_points_on_card(cuda, capsys):
    """Both tools on the card: every op line well formed, every probe ok."""
    from keto_tpu_torch.tools import microbench as mb
    from keto_tpu_torch.tools import microbench_feasibility as mf

    assert mb.main(["--n", "2"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert len(lines) == 16 and lines[-1]["op"] == "device"
    assert torch.cuda.get_device_name(0) in lines[-1]["note"]
    assert all(line["ms"] > 0 and line["bound_ms"] > 0 for line in lines[:-1])
    assert mf.main([]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [line.get("ok") for line in lines[1:]] == [True, True, True]


# -- L2 reverse_gather and K1 edge_probe at the shapes their designs stress ---------
#
# L2 is a tile pass, a scan pass and a merge-path gather over the [F]
# task offsets (csrc/list_kernels.cu); K1 issues every bucket-row load of
# both tables before any compare (csrc/check_kernels.cu). The draws hold
# the cases the designs must get right against the plain versions.

L2_CASES = ("mixed", "total_zero", "one_big", "no_redges")


def l2_inputs(cuda, F, B, case, seed=0):
    """Drawn L2 inputs: dead tasks and a run of them (zero-count tasks),
    empty rows and entries (zero-count slots), the wildcard relation, and
    relations past the config's; rinstr rows holding COMPUTED, TTU and
    POISON entries, POISON under namespace -1 and under a task's own.
    "total_zero": no task has a candidate; "one_big": one task whose row
    alone holds 2F + 3 edges; "no_redges": an empty rv_pack."""
    rng = np.random.default_rng(seed + F + B)
    RK, ncr, wildcard, n_obj = 3, 6, 5, 40
    n_red = 0 if case == "no_redges" else 300
    q = rng.integers(0, B, F)
    obj, rel = rng.integers(0, n_obj, F), rng.integers(0, ncr + 2, F)
    depth, live = rng.integers(-1, 4, F), rng.random(F) < 0.7
    live[F // 3: F // 3 + F // 5] = False
    ns_t = rng.integers(0, 3, F)
    rstart = rng.integers(-1, max(n_red, 1), F)
    rlen = np.where(rstart < 0, 0, rng.integers(0, 4, F))
    if case == "one_big":
        i = F // 2
        live[i], depth[i], rel[i], rstart[i], rlen[i] = True, 2, 0, 0, 2 * F + 3
    kinds = rng.choice([0, trk.RINSTR_COMPUTED, trk.RINSTR_TTU], (ncr, RK))
    rin = rng.integers(0, 3, (ncr, RK))
    kinds[1, 2], rin[1, 2] = trk.RINSTR_POISON, -1
    kinds[2, 1], rin[2, 1] = trk.RINSTR_POISON, 1
    if case == "total_zero":
        live[:] = False
    rinstr = np.stack([kinds, rng.integers(0, ncr + 2, (ncr, RK)),
                       rng.integers(0, ncr + 2, (ncr, RK)), rin], -1).reshape(ncr, 4 * RK)
    rv_pack = np.stack([rng.integers(0, n_obj, n_red), rng.integers(0, ncr + 2, n_red),
                        rng.integers(0, ncr + 2, n_red), np.zeros(n_red, np.int64)], -1)

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(cuda)

    args = (t(q), t(obj), t(rel), t(depth), t(live, torch.bool), t(ns_t), t(rstart), t(rlen),
            t(rinstr), t(rv_pack.reshape(n_red, 4)), t(rng.integers(0, 3, n_obj)))
    return args, dict(wildcard_rel=wildcard, n_config_rels=ncr, n_queries=B)


@pytest.mark.cuda
@pytest.mark.parametrize("case", L2_CASES)
@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("F", [1, 255, 257, 16_384, 1 << 20])
def test_reverse_gather_merge_path_on_card(cuda, F, B, case):
    args, kw = l2_inputs(cuda, F, B, case)
    *cols, cause = cuda_ops.reverse_gather(*args, **kw)
    ch, want_cause = trk.reverse_gather_plain(*args, **kw)
    for a, b in zip(cols, (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid)):
        assert torch.equal(a, b)
    assert torch.equal(cause, want_cause)
    if case == "total_zero":
        assert not bool(ch.valid.any()) and int(want_cause.max()) == 0
    if case == "one_big":
        assert int(want_cause.max()) >= 2
    if case == "mixed" and F >= 16_384:
        assert int(want_cause.max()) == 8 and bool(ch.valid.any())


@pytest.mark.cuda
@pytest.mark.parametrize("dh_probes", [1, 8, 9, 64])
@pytest.mark.parametrize("has_delta", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_edge_probe_staged_loads_on_card(cuda, layout, has_delta, dh_probes):
    """K1 against its plain version at 1 to 64 probes, both layouts, with
    the overlay on and off, over 1,000 tasks (not a multiple of a block's
    16): half probe a stored edge's key, the rest random subjects; dead
    and depth-0 tasks among them."""
    snap, parsed, _queries, _depth = build("random_monotone", layout)
    delta, _overlay = delta_for(snap, parsed, random.Random(5))
    tables = tk.snapshot_tables(snap, cuda, delta)
    rng = np.random.default_rng(dh_probes)
    F = 1000
    rows = np.flatnonzero(snap.dh_val != -1)
    pick = rows[rng.integers(0, len(rows), F)]
    sub = np.stack([snap.dh_skind[pick], snap.dh_sa[pick], snap.dh_sb[pick],
                    np.zeros(F, np.int32)], -1)
    q = np.where(rng.random(F) < 0.5, np.arange(F), rng.integers(0, F, F))

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(cuda)

    args = (tables["dh_pack"], tables["dd_pack"] if has_delta else None,
            t(snap.dh_obj[pick]), t(snap.dh_rel[pick]), t(q), t(sub),
            t(rng.integers(-1, 4, F)), t(rng.random(F) < 0.85, torch.bool))
    kw = dict(dh_probes=dh_probes, spb=tsnap.slots_per_bucket(5, layout), has_delta=has_delta)
    got = cuda_ops.edge_probe(*args, **kw)
    want = tk.edge_probe_plain(*args, **kw)
    assert torch.equal(got, want)
    assert bool(want.any()) and not bool(want.all())


@pytest.mark.cuda
def test_reverse_gather_and_edge_probe_launches_on_card(cuda):
    """A call of L2 launches its three kernels and no memset, and a call of
    K1 its one kernel: the profiler sees those names and nothing else over
    20 calls."""
    args, kw = l2_inputs(cuda, 1 << 16, 256, "mixed")
    snap, parsed, _queries, _depth = build("random_monotone", "bucketized")
    delta, _overlay = delta_for(snap, parsed, random.Random(5))
    tables = tk.snapshot_tables(snap, cuda, delta)
    F = 4096
    cols = [torch.from_numpy(a[np.arange(F) % len(a)]).to(cuda)
            for a in (snap.dh_obj, snap.dh_rel)]
    qsub = torch.zeros(F, 4, dtype=torch.int32, device=cuda)
    k1 = (tables["dh_pack"], tables["dd_pack"], *cols,
          torch.arange(F, dtype=torch.int32, device=cuda), qsub,
          torch.ones(F, dtype=torch.int32, device=cuda),
          torch.ones(F, dtype=torch.bool, device=cuda))
    calls = {
        ("reverse_tile_kernel", "reverse_scan_kernel", "reverse_merge_kernel"):
            lambda: cuda_ops.reverse_gather(*args, **kw),
        ("edge_probe_staged_kernel",): lambda: cuda_ops.edge_probe(
            *k1, dh_probes=snap.dh_probes, spb=tsnap.slots_per_bucket(5, "bucketized"),
            has_delta=True),
    }
    for kernels, call in calls.items():
        events = profiled(call)
        keys = [e.key for e in events]
        assert len(keys) == len(kernels), keys
        assert all(any(k in key for key in keys) for k in kernels), keys
        assert all(0 < e.count <= 20 for e in events), keys


# L3 is L2's tile pass, scan pass and merge-path gather over the full-edge
# spans and the instruction lanes (csrc/list_kernels.cu); K2 shares one
# probe among the equal (obj, rel) keys of a warp (csrc/check_kernels.cu).
# The draws hold the cases the designs must get right against the plain
# versions.

L3_CASES = ("mixed", "total_zero", "one_big", "no_edges")


def l3_inputs(cuda, F, B, case, seed=0):
    """Drawn L3 inputs: dead tasks and a run of them (zero-count tasks),
    depths -1 to 3 (0 and 1 among them), spans with negative starts and
    rows of 0-3 edges (zero-count slots), lanes COMPUTED, TTU and none,
    fe_pack edges of both subject kinds with the wildcard relation among
    their relations. "total_zero": no task live, so no candidate at all;
    "one_big": one task whose own row alone holds 2F + 3 edges; "no_edges":
    an empty fe_pack."""
    rng = np.random.default_rng(seed + F + B)
    K, wildcard, n_rel = 2, 5, 7
    n_edges = 0 if case == "no_edges" else 300
    q = rng.integers(0, B, F)
    obj = rng.integers(0, 40, F)
    depth, live = rng.integers(-1, 4, F), rng.random(F) < 0.7
    live[F // 3: F // 3 + F // 5] = False
    start = rng.integers(-1, max(n_edges, 1), (F, K + 1))
    end = np.where(start < 0, rng.integers(-2, 3, (F, K + 1)),
                   start + rng.integers(0, 4, (F, K + 1)))
    ik = rng.choice([0, tsnap.INSTR_COMPUTED, tsnap.INSTR_TTU], (F, K))
    if case == "one_big":
        i = F // 2
        live[i], depth[i], start[i, 0], end[i, 0] = True, 2, 0, 2 * F + 3
    if case == "total_zero":
        live[:] = False
    fe = np.stack([rng.integers(0, 2, n_edges), rng.integers(0, 50, n_edges),
                   rng.integers(0, n_rel, n_edges), np.zeros(n_edges, np.int64)], -1)

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(cuda)

    args = (t(q), t(obj), t(depth), t(live, torch.bool), t(np.stack([start, end], -1)), t(ik),
            t(rng.integers(0, n_rel, (F, K))), t(rng.integers(0, n_rel, (F, K))),
            t(fe.reshape(n_edges, 4)))
    return args, dict(wildcard_rel=wildcard, n_queries=B)


@pytest.mark.cuda
@pytest.mark.parametrize("case", L3_CASES)
@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("F", [1, 255, 257, 16_384, 1 << 20])
def test_subjects_gather_merge_path_on_card(cuda, F, B, case):
    args, kw = l3_inputs(cuda, F, B, case)
    *cols, emit, value, cause = cuda_ops.subjects_gather(*args, **kw)
    ch, want_emit, want_value, want_cause = trk.subjects_gather_plain(*args, **kw)
    for a, b in zip((*cols, emit, value, cause), (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth,
                                                  ch.valid, want_emit, want_value, want_cause)):
        assert torch.equal(a, b)
    if case == "total_zero":
        assert not bool(ch.valid.any() | want_emit.any()) and int(want_cause.max()) == 0
    if case == "one_big":
        assert int(want_cause.max()) == 2
    if case == "mixed" and F >= 16_384:
        assert bool(ch.valid.any()) and bool(want_emit.any())


K2_FRONTIERS = ("equal", "distinct", "zero_tail", "scattered")


def k2_inputs(cuda, F, S, kind, spb, probes, seed=0):
    """A [cap, 4] pair table and an [F] x [F, S] frontier of one of four
    kinds: every key equal; every (task, slot) key distinct; a live head of
    keys drawn from 64 and the zero-filled tail K4 leaves; eight keys
    scattered over the whole frontier, so equal keys meet within a warp and
    across warps. A third of the frontier's distinct keys are planted in
    the first row of their probe sequence, and a fifth of those again in
    another slot of their first two rows with other values (a key two slots
    match takes each lane's max). The rest of the table is random: every
    probed slot is read and compared, hit or not."""
    rng = np.random.default_rng(seed + F + S + probes)
    if kind == "equal":
        obj, rels = np.full(F, 7), np.full((F, S), 3)
    elif kind == "distinct":
        obj = rng.permutation(1 << 20)[:F]
        rels = np.broadcast_to(np.arange(1, S + 1), (F, S))
    else:
        pool = np.stack([rng.integers(1, 1 << 20, 64), rng.integers(0, 6, 64)], -1)
        pick = pool[rng.integers(0, 8 if kind == "scattered" else 64, (F, S))]
        obj, rels = pick[:, 0, 0], pick[..., 1]
        if kind == "zero_tail":
            obj[F // 3:], rels[F // 3:] = 0, 0
    cap = 8192
    pack = np.stack([rng.integers(1, 1 << 20, cap), rng.integers(0, 6, cap),
                     rng.integers(0, 1 << 24, cap), rng.integers(0, 1 << 24, cap)], -1)
    keys = np.unique(np.stack([np.broadcast_to(obj[:, None], rels.shape).ravel(),
                               rels.ravel()], -1), axis=0)
    planted = keys[rng.random(len(keys)) < 1 / 3]
    h1 = tk.hash_combine(torch.from_numpy(planted[:, 0]), torch.from_numpy(planted[:, 1]))
    h2 = tk.mix32(h1 ^ 0x9E3779B9) | 1
    nb = cap // spb
    again = rng.random(len(planted)) < 0.2
    for row, sel in ((0, np.ones(len(planted), bool)), (1 if spb == 1 else 0, again)):
        b = ((h1 + row * h2).numpy() & (nb - 1))[sel]
        slot = b * spb + rng.integers(0, spb, len(b))
        pack[slot, :2] = planted[sel]
        pack[slot, 2:] = rng.integers(0, 1 << 24, (len(b), 2))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.int32).to(cuda)

    return t(pack), t(obj), t(rels)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1000, 10_000, 40_000])
@pytest.mark.parametrize("kind", K2_FRONTIERS)
@pytest.mark.parametrize("probes", [1, 12, 16, 17, 64])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("n_vals", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pair_probe_shared_keys_on_card(cuda, layout, n_vals, S, probes, kind, F):
    """K2 against its plain version, every slot of every task, dead and
    equal keys included, on frontiers that are no multiple of a block or
    a warp: 1,000 tasks (two items a warp, pair_probe_two_kernel), 10,000
    (4 or 8 a warp) and 40,000 (16 or 32 a warp)."""
    spb = tsnap.slots_per_bucket(2, layout)
    pack, obj, rels = k2_inputs(cuda, F, S, kind, spb, probes)
    kw = dict(probes=probes, spb=spb, n_vals=n_vals)
    got = cuda_ops.pair_probe(pack, obj, rels, **kw)
    want = tk.pair_probe_plain(pack, obj, rels, **kw)
    assert torch.equal(got, want)
    if kind != "equal":
        assert bool((want >= 0).any()) and bool((want < 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zero_tail", "distinct"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pair_probe_frontier_2_20_on_card(cuda, layout, kind):
    """K2 at ListObjects' frontier of 2^20 tasks, one slot, both lanes."""
    spb = tsnap.slots_per_bucket(2, layout)
    pack, obj, rels = k2_inputs(cuda, 1 << 20, 1, kind, spb, 16)
    kw = dict(probes=16, spb=spb, n_vals=2)
    assert torch.equal(cuda_ops.pair_probe(pack, obj, rels, **kw),
                       tk.pair_probe_plain(pack, obj, rels, **kw))


@pytest.mark.cuda
def test_subjects_gather_and_pair_probe_launches_on_card(cuda):
    """A call of L3 launches its three kernels and no memset, and a call of
    K2 its one kernel: the profiler sees those names and nothing else over
    20 calls."""
    args, kw = l3_inputs(cuda, 1 << 16, 256, "mixed")
    pack, obj, rels = k2_inputs(cuda, 8192, 3, "zero_tail", 16, 16)
    small = k2_inputs(cuda, 1000, 1, "zero_tail", 16, 16)
    calls = {
        ("subjects_tile_kernel", "subjects_scan_kernel", "subjects_merge_kernel"):
            lambda: cuda_ops.subjects_gather(*args, **kw),
        ("pair_probe_shared_kernel",): lambda: cuda_ops.pair_probe(pack, obj, rels, probes=16,
                                                                   spb=16, n_vals=2),
        ("pair_probe_two_kernel",): lambda: cuda_ops.pair_probe(*small, probes=16, spb=16,
                                                                n_vals=2),
    }
    for kernels, call in calls.items():
        events = profiled(call)
        keys = [e.key for e in events]
        assert len(keys) == len(kernels), keys
        assert all(any(k in key for key in keys) for k in kernels), keys
        assert all(0 < e.count <= 20 for e in events), keys


# L4 and X2 are one body, csrc/pool.cuh: one launch in which every block
# scans the counts into shared memory, writes its slice of the header and
# its run of the pool's 16-byte words (cut on absolute addresses, so the
# pool's start, 2B + 9 or 3B + 9 ints into the vector, sets the scalar
# head and tail); past 57,856 queries the counts no longer fit and two
# tile-sum launches come first. The whole packed vector must equal the
# plain version's.

POOL_BATCHES = (1, 3, 256, 257, 258, 259, 16_384, 57_857)


def pool_inputs(cuda, kernel, B, counts, seed=0):
    """A list or expand pool's inputs at B queries, buffer cap `cap`, and
    the pool caps each is compacted into: 0, 7, one below the first
    query's count, an odd cut through the used rows, and past them. Counts
    "mixed": the first four at, past, below and to the cap, the rest
    drawn from -3 to cap + 3 (negative, zero, at and past the cap);
    "zero": every query empty; "sparse": nine queries in ten empty, so
    runs of empty queries lie between used rows; "long": the same as
    "mixed" at a cap of 4,096, so a warp's 128 pool ints are most often
    one query's rows (as on ListObjects' launch)."""
    rng = np.random.default_rng(seed + B)
    cap = 4096 if counts == "long" else 8 if B > 1000 else 16
    if counts == "zero":
        c = np.zeros(B, np.int64)
    elif counts == "sparse":
        c = np.where(rng.random(B) < 0.9, 0, rng.integers(1, cap + 1, B))
    else:
        c = rng.integers(-3, cap + 4, B)
        c[:4] = np.array([cap, cap + 2, -1, 5])[: min(B, 4)]
    total = int(np.clip(c, 0, cap).sum())
    caps = sorted({0, 7, max(int(np.clip(c[0], 0, cap)) - 1, 0), total // 2 | 1, total + 5})
    stats = on_card(cuda, rng.integers(0, 100, tk.N_LAUNCH_STATS))
    if kernel == "list_pool_compact":
        args = (on_card(cuda, rng.integers(-1, 1000, B * cap)), on_card(cuda, c),
                on_card(cuda, np.where(rng.random(B) < 0.3, rng.integers(0, 9, B), 0)), stats)
        return args, [dict(result_cap=cap, pool_cap=p) for p in caps]
    eb = tuple(on_card(cuda, rng.integers(-1, 1000, B * cap)) for _ in range(5))
    flags = [on_card(cuda, rng.random(B) < 0.3, torch.bool) for _ in range(2)]
    return (eb, on_card(cuda, c), *flags, stats), [dict(edge_cap=cap, pool_cap=p) for p in caps]


@pytest.mark.cuda
@pytest.mark.parametrize("counts,B", [(c, B) for c in ("mixed", "zero", "sparse")
                                      for B in POOL_BATCHES]
                         + [("long", B) for B in POOL_BATCHES[:6]])
@pytest.mark.parametrize("kernel", ["list_pool_compact", "pool_compact"])
def test_pool_compactions_on_card(cuda, kernel, B, counts):
    """L4 and X2 against their plain versions, the whole packed vector, at
    one to 57,857 queries (every alignment of the pool's start), pool caps
    from 0 up past the used rows, queries of up to 16 rows and of
    thousands."""
    args, kws = pool_inputs(cuda, kernel, B, counts)
    x2 = kernel == "pool_compact"
    plain = tek.pool_compact_plain if x2 else trk.list_pool_compact_plain
    first = int(args[1][0].clamp(0, kws[0]["edge_cap" if x2 else "result_cap"]))
    for kw in kws:
        got = getattr(cuda_ops, kernel)(*args, **kw)
        want = plain(*args, **kw)
        assert torch.equal(got, want), kw
        if kw["pool_cap"] < first:  # the first query's span crosses the pool's end
            assert int(want[(2 * B if x2 else B) + 1]) >= (1 if x2 else 2)


@pytest.mark.cuda
def test_pool_compactions_launch_one_kernel_on_card(cuda):
    """A call of L4 or X2 launches the one pool_compact_kernel and no
    memset: the profiler sees that name and nothing else over 20 calls."""
    l4, l4_kws = pool_inputs(cuda, "list_pool_compact", 256, "mixed")
    x2, x2_kws = pool_inputs(cuda, "pool_compact", 1024, "mixed")
    for call in (lambda: cuda_ops.list_pool_compact(*l4, **l4_kws[-1]),
                 lambda: cuda_ops.pool_compact(*x2, **x2_kws[-1])):
        events = profiled(call)
        keys = [e.key for e in events]
        assert len(keys) == 1 and "pool_compact_kernel" in keys[0], keys
        assert 0 < events[0].count <= 20, keys

"""The CUDA kernels of keto_tpu_torch against their plain PyTorch versions,
on the card: each kernel alone on the same CUDA tensors, and whole
check launches against the CPU run of the plain versions, under both
table layouts and with the delta overlay on and off. Tolerance: exact
equality (every output is an integer).

These tests need an NVIDIA card and skip elsewhere; this file imports
nothing of the JAX package, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q
"""

import random

import pytest
import torch

from keto_tpu_torch.engine import cuda_ops
from keto_tpu_torch.engine import delta as tdelta
from keto_tpu_torch.engine import kernel as tk
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
    import numpy as np

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
    assert all(cuda_ops.launches[k] > before[k] for k in cuda_ops.KERNELS)


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

"""The CUDA kernels of keto_tpu_torch against their plain PyTorch versions,
on the card: each kernel alone on the same CUDA tensors, and whole check,
expand, ListObjects, ListSubjects, closure and filter launches against
the CPU run of the plain versions, under both table layouts and with the
delta overlay (or the dirty table) on and off; the closure powering's P1-P3
step by step on random waves, and whole device-powered builds against the
CPU's; the microbenchmark primitives M1-M10 (keto_tpu_torch/tools) on the
TPU tools' draws and on edge sizes. Tolerance: exact equality (every
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
        for pool_cap in (16, 4 * B):
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
        for pool_cap in (7, B * R // 2, 2 * B * R):
            args4 = (res, res_count, needs, stats)
            kw4 = dict(result_cap=R, pool_cap=pool_cap)
            assert torch.equal(cuda_ops.list_pool_compact(*args4, **kw4),
                               trk.list_pool_compact_plain(*args4, **kw4))



# -- the closure probe and the filter walk ------------------------------------------


def closure_inputs(scenario, layout, has_dirty, B=64):
    """The closure tables of a scenario (a dirty table over every other
    covered node when has_dirty) and the [7, B] pack of its queries at
    mixed depths."""
    from keto_tpu_torch.engine import closure as tcl
    from keto_tpu_torch.engine import closure_kernel as tck

    snap, _parsed, queries, depth = build(scenario, layout)
    graph = tcl.extract_graph(snap)
    built = tcl.power_closure(graph, snap, depth, 4096, 0)
    tables, cc_probes, ch_probes = tcl.pack_closure_tables(built, graph.R, layout)
    tables["cd_pack"] = (tcl.build_dirty_table(built.covered_keys[::2][:1000], graph.R, layout)
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


@pytest.mark.cuda
@pytest.mark.parametrize("F,C,n", [(512, 16, 9), (4096, 16384, 9937), (70_000, 1024, 1000)])
def test_filter_mark_matches_plain_on_card(cuda, F, C, n):
    """F1 on random task columns, duplicate objects included, against its
    plain version on the same CUDA tensors; hit and status update in
    place, so each side works on its own clones."""
    from keto_tpu_torch.engine import filter_kernel as tfk

    rng = np.random.default_rng(F)
    cand = np.full(C, tfk.CAND_PAD, np.int32)
    cand[:n] = np.sort(rng.choice(4 * n, n, replace=False))
    cols = [torch.from_numpy(x).to(cuda) for x in (
        rng.integers(0, 4 * n + 8, F).astype(np.int32), rng.integers(0, 3, F).astype(np.int32),
        rng.integers(-1, 3, F).astype(np.int32))]
    live = torch.from_numpy(rng.random(F) < 0.9).to(cuda)
    cand_t = torch.from_numpy(cand).to(cuda)
    head = torch.tensor([0, 0, 1, 0, n], dtype=torch.int32, device=cuda)
    hit0 = torch.from_numpy((rng.random(C) < 0.1) & (np.arange(C) < n)).to(torch.int32).to(cuda)
    status0 = torch.tensor([F, 0, int(hit0.sum()), n], dtype=torch.int32, device=cuda)
    outs = []
    for fn in (cuda_ops.filter_mark, tfk.filter_mark_plain):
        hit, status = hit0.clone(), status0.clone()
        marks = fn(*cols, live, cand_t, head, hit, status)
        outs.append((marks.to(torch.int32), hit, status))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][0]) > 0


# -- closure powering ----------------------------------------------------------------


def power_wave(lanes, seed, n_sub, n_edges):
    """One wave's inputs laid out as power_closure_device lays them out: a
    random subgraph with a dummy node at n_sub, dst-sorted edges and direct
    rows padded with it, a few poisoned nodes, and lanes - 3 sources (the
    last word holds padding lanes) with their self bits, levels and counts."""
    from keto_tpu_torch.engine import closure_power as tcp

    rng = np.random.default_rng(seed)
    Nq, Eq = tcp._next_pow2(n_sub + 1, 2), tcp._next_pow2(n_edges, 1)
    src, dst = rng.integers(0, n_sub, n_edges), rng.integers(0, n_sub, n_edges)
    order = np.argsort(dst, kind="stable")
    e_src, e_dst = np.full(Eq, n_sub, np.int32), np.full(Eq, n_sub, np.int32)
    e_src[:n_edges], e_dst[:n_edges] = src[order], dst[order]
    dnodes = np.sort(rng.choice(n_sub, n_sub // 2, replace=False)).astype(np.int32)
    d_rows = np.full(tcp._next_pow2(len(dnodes), 1), n_sub, np.int32)
    d_rows[:len(dnodes)] = dnodes
    pois = np.zeros(Nq, np.uint8)
    pois[rng.choice(n_sub, 3, replace=False)] = 1
    nl = lanes - 3
    snode, lane_ids = rng.integers(0, n_sub, nl), np.arange(nl)
    R0 = np.zeros((Nq, lanes // 32), np.uint32)
    np.bitwise_or.at(R0, (snode, lane_ids // 32), np.uint32(1) << (lane_ids % 32).astype(np.uint32))
    lvl0 = np.full((len(d_rows), lanes), -1, np.int8)
    pos = np.searchsorted(dnodes, snode).clip(0, len(dnodes) - 1)
    at_d = dnodes[pos] == snode
    lvl0[pos[at_d], lane_ids[at_d]] = 0
    counts0 = np.zeros(lanes, np.int32)
    counts0[:nl] = 1
    return [torch.from_numpy(a) for a in (e_src, e_dst, d_rows, pois, R0.view(np.int32), lvl0,
                                          counts0)]


@pytest.mark.cuda
@pytest.mark.parametrize("max_set_rows", [1 << 20, 3])
@pytest.mark.parametrize("lanes,n_sub,n_edges", [(32, 40, 70), (256, 300, 500),
                                                 (8192, 3000, 5000)])
def test_power_kernels_match_plain_on_card(cuda, lanes, n_sub, n_edges, max_set_rows):
    """P1, P2 and P3 against their plain versions on the same CUDA tensors
    at every step of a wave (1, 8 and 256 words a row; with a row-cap kill;
    with poisoned nodes), each side updating its own clones; then the whole
    wave on the card against the CPU's."""
    from keto_tpu_torch.engine import closure_power as tcp

    inputs = power_wave(lanes, lanes + max_set_rows, n_sub, n_edges)
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
    assert level >= 2 and summary[S:2 * S].any() and killed == (max_set_rows == 3)
    assert {k: cuda_ops.launches[k] - before[k] for k in before} == {
        "power_step": level, "power_account": level, "power_poison": 1}

    got = tcp.closure_power_wave(e_src, e_dst, d_rows, pois, R0, lvl0, counts0, max_depth=12,
                                 max_set_rows=max_set_rows)
    want = tcp.closure_power_wave(*inputs, max_depth=12, max_set_rows=max_set_rows)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


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
    for fn in (cuda_ops.mb_pack_block, cuda_ops.mb_pack):
        out, cnt = fn(keep.to(cuda), vals.to(cuda))
        assert torch.equal(out.cpu(), want[0]) and torch.equal(cnt.cpu(), want[1]), fn


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

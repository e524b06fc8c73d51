"""Closure powering on the device: the Leopard index's reachability
powered as bit-packed boolean matrix products, P1 `power_step`, P2
`power_account` and P3 `power_poison` (csrc/closure_power_kernels.cu),
each beside its plain PyTorch version.

The host builder (engine/closure.py power_closure) is a multi-source
level-synchronous BFS over the cost-1 folded edge CSR: exact least
distances, `req = dist + 1` subject entries, poison one ring past the
subject horizon, per-source row caps. This module computes the same
ClosureBuild, array for array, with the sources of one wave packed 32 to
a word:

  * R [N, W] (seen) and F [N, W] (frontier) hold one row per node of the
    wave's subgraph and one bit per source: lane s of word w is source
    w * 32 + s. Words are int32 tensors holding uint32 bits.
  * P1, one step: fresh = (OR of F[src] over each node's in-edges) & ~R,
    then R |= fresh and each source's reach count grows by its fresh
    bits. The words are ORed directly, never unpacked.
  * P2: the step's level is written at direct-incidence nodes where a
    source reached them first (`req = level + 1`), sources whose reach
    exceeds `max_set_rows` stop expanding (F = fresh & ~kill; R keeps
    their bits, as the host builder keeps them), and the next frontier's
    popcount goes to the 4-byte status the host reads once a step.
  * P3, after the loop: a source that reached a poisoned node (AND/NOT
    islands, relation not found), reading the final R, one ring past the
    horizon; it packs [counts | poison | stats] into one vector.

The loop runs while `level < max_depth` and the frontier is non-empty,
with keto_tpu's launch counters in the stats tail. The host then turns a
wave's levels into entries (the R·D product over each direct node's
span, min-req dedupe, `per_src` cap) exactly as keto_tpu's
`power_closure_device` does, and the waves concatenate into the host
builder's global order.

Waves: a wave powers a contiguous range of sources over the induced
subgraph of their weak components (reachability never leaves one),
padded to powers of two with a dummy node at index n_sub that owns no
bits, and bisected while `(Eq + 2 Nq + Dq) * lanes` exceeds the scratch
budget, keto_tpu's rule. The budget is an argument here, not an
environment read. The dispatchers take the plain versions for CPU tensors
and the kernels for CUDA tensors.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import cuda_ops
from .closure import (
    MAX_CLOSURE_NODES,
    ClosureBuild,
    ClosureGraph,
    _expand_spans,
    node_poison_keys,
    snapshot_vocab_fp,
)
from .kernel import N_LAUNCH_STATS, update_launch_stats
from .snapshot import GraphSnapshot


class PoweringUnsupported(Exception):
    """The device powering cannot honour the host contract for this
    (graph, limits) shape; the caller powers on the host instead. Raised
    before any launch."""


# int8 level planes: first-discovery levels go up to max_depth inclusive
# (the poison ring), so the depth must fit the plane's type
_MAX_INT8_DEPTH = 100

# wave width floor and ceiling: lanes are packed 32 to a word
_MIN_LANES = 32
_MAX_LANES = 8192

# keto_tpu's default scratch budget a wave (KETO_CLOSURE_POWER_MB = 256)
DEFAULT_POWER_BUDGET = 256 << 20

_BITS = 32


def _next_pow2(n: int, floor: int) -> int:
    """Shape quantum: a wave's (nodes, edges, d-nodes, lanes) padded up to
    a power of two, keto_tpu's shapes."""
    cap = max(int(n), floor)
    return 1 << (cap - 1).bit_length()


def _require_index_limit(s: int, e: int, Nq: int, Eq: int, Dq: int, lanes: int) -> None:
    """Raise PoweringUnsupported when the planned wave of sources [s, e)
    would break a 32-bit limit of P1-P3's wrappers: N·W and E·W (P1), N·W
    and the level plane's D·32W (P2), N·W (P3)."""
    limit = cuda_ops.INDEX_LIMIT
    W = lanes // 32
    for what, n in (("N·W", Nq * W), ("E·W", Eq * W), ("D·32W", Dq * lanes)):
        if n >= limit:
            raise PoweringUnsupported(
                f"the wave of sources [{s}, {e}) has {what} = {n} words, past the kernels' "
                f"32-bit index limit {limit}")


def _components(n_nodes: int, e_src: np.ndarray, e_dst: np.ndarray) -> np.ndarray:
    """Weakly-connected component label (the least node index in the
    component) of each node, by min-label propagation with pointer
    jumping: O(E) a round, O(log N) rounds."""
    label = np.arange(n_nodes, dtype=np.int64)
    if len(e_src) == 0:
        return label
    while True:
        before = label
        m = np.minimum(label[e_src], label[e_dst])
        label = label.copy()
        np.minimum.at(label, e_src, m)
        np.minimum.at(label, e_dst, m)
        label = np.minimum(label, label[label])
        label = label[label]
        if np.array_equal(label, before):
            return label


def estimate_power_bytes(n_nodes: int, n_edges: int, n_dnode: int, lanes: int) -> dict:
    """keto_tpu's device-buffer accounting of one wave, kept so that
    records compare: the adjacency operands, the packed bit matrices with
    the level plane, and the unpacked uint8 planes its step materializes
    ("scratch"). P1-P3 never unpack: device_power_bytes is what they hold."""
    words = lanes // 32
    return {
        "adjacency_pack": 4 * (2 * n_edges + n_dnode) + n_nodes,
        "bit_matrix": 2 * n_nodes * words * 4 + n_dnode * lanes,
        "scratch": (n_edges + 2 * n_nodes) * lanes,
    }


def device_power_bytes(n_nodes: int, n_edges: int, n_dnode: int, lanes: int) -> dict:
    """The buffers one wave of P1-P3 holds at its peak, by
    estimate_power_bytes's keys: the adjacency operands; R0, R and F with
    the level plane and its seed; and, in place of the unpacked planes,
    two more packed [N, W] matrices (P1's accumulator or fresh, and P2's
    next frontier)."""
    words = lanes // 32
    return {
        "adjacency_pack": 4 * (2 * n_edges + n_dnode) + n_nodes,
        "bit_matrix": 3 * n_nodes * words * 4 + 2 * n_dnode * lanes,
        "scratch": 2 * n_nodes * words * 4,
    }


# -- bit planes of int32 words (plain versions and glue) ------------------------------


def _popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64 (SWAR in int64, since the CPU
    build of PyTorch has no uint32 shifts)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 words -> [..., W * 32] uint8 bit planes; lane s of
    word w is plane w * 32 + s."""
    bits = torch.arange(_BITS, dtype=torch.int64, device=words.device)
    u = (words.to(torch.int64)[..., None] >> bits) & 1
    return u.reshape(*words.shape[:-1], words.shape[-1] * _BITS).to(torch.uint8)


def _pack(planes: torch.Tensor) -> torch.Tensor:
    """[..., S] 0/1 planes -> [..., S // 32] int32 words (the inverse of
    _unpack)."""
    bits = torch.arange(_BITS, dtype=torch.int64, device=planes.device)
    b = planes.reshape(*planes.shape[:-1], -1, _BITS).to(torch.int64)
    v = (b << bits).sum(dim=-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


# -- P1-P3: plain versions and dispatchers ----------------------------------------------


def power_step_plain(F, R, e_src, e_dst, counts, stats, status) -> torch.Tensor:
    """One powering step over the edges (e_src, e_dst). Returns fresh
    [N, W]: the bits whose source first reaches the node at this step.
    Updates in place: R |= fresh, counts[s] += fresh bits of source s, and
    the launch stats (status[0] is the popcount of F before the step)."""
    N, W = F.shape
    g = F[e_src.long()]  # [E, W]
    n_children = _popcount(g).sum()
    n_hits = (g != 0).any(dim=1).sum()
    gu = _unpack(g)
    nu = torch.zeros(N, W * _BITS, dtype=torch.uint8, device=F.device).scatter_reduce(
        0, e_dst.long()[:, None].expand_as(gu), gu, "amax")
    fresh = _pack(nu) & ~R
    R.bitwise_or_(fresh)
    counts.add_(_unpack(fresh).sum(dim=0, dtype=torch.int32))
    n_tasks = status[0]
    stats.copy_(update_launch_stats(stats, n_tasks, n_tasks, n_hits, n_children,
                                    _popcount(fresh).sum()))
    return fresh


def power_account_plain(fresh, lvl, counts, d_rows, status, *, level: int,
                        max_set_rows: int) -> torch.Tensor:
    """The step's bookkeeping after P1. Returns the next frontier F =
    fresh & ~kill, kill holding the sources whose reach count exceeds
    max_set_rows. Updates in place: lvl[j, s] = level where it is < 0 and
    fresh has bit s at node d_rows[j]; status[0] = popcount of F."""
    freshd = _unpack(fresh[d_rows.long()])
    lvl.copy_(torch.where((lvl < 0) & (freshd > 0), level, lvl))
    kill = _pack((counts > max_set_rows).to(torch.uint8)[None, :])[0]
    F = fresh & ~kill[None, :]
    status[0] = _popcount(F).sum()
    return F


def power_poison_plain(R, pois_mask, counts, stats) -> torch.Tensor:
    """The wave's summary [counts(S) | poison(S) | stats(8)] int32; poison
    is 1 for a source whose seen row set meets a node of pois_mask."""
    seen = _unpack(R)
    pois = torch.where(pois_mask[:, None] > 0, seen, 0).amax(dim=0).to(torch.int32)
    return torch.cat([counts, pois, stats]).to(torch.int32)


def power_step(F, R, e_src, e_dst, counts, stats, status) -> torch.Tensor:
    fn = power_step_plain if F.device.type == "cpu" else cuda_ops.power_step
    return fn(F, R, e_src, e_dst, counts, stats, status)


def power_account(fresh, lvl, counts, d_rows, status, *, level: int,
                  max_set_rows: int) -> torch.Tensor:
    fn = power_account_plain if fresh.device.type == "cpu" else cuda_ops.power_account
    return fn(fresh, lvl, counts, d_rows, status, level=level, max_set_rows=max_set_rows)


def power_poison(R, pois_mask, counts, stats) -> torch.Tensor:
    fn = power_poison_plain if R.device.type == "cpu" else cuda_ops.power_poison
    return fn(R, pois_mask, counts, stats)


def closure_power_wave(e_src, e_dst, d_rows, pois_mask, R0, lvl0, counts0, *,
                       max_depth: int, max_set_rows: int):
    """One powering wave to a fixpoint or the depth budget: keto_tpu's
    `closure_power_wave` on the same inputs (e_src, e_dst [E] int32 sorted
    by dst; d_rows [D] int32; pois_mask [N] uint8; R0 [N, W] int32 words;
    lvl0 [D, S] int8; counts0 [S] int32). Returns (lvl [D, S] int8,
    summary [counts(S) | poison(S) | stats(8)] int32), bit for bit. The
    host reads the 4-byte frontier popcount once a step."""
    dev = R0.device
    R = R0.clone()
    F = R0
    lvl = lvl0.clone()
    counts = counts0.clone()
    stats = torch.zeros(N_LAUNCH_STATS, dtype=torch.int32, device=dev)
    status = _popcount(R0).sum().to(torch.int32).reshape(1)
    level = 0
    while level < max_depth and int(status[0]) != 0:
        fresh = power_step(F, R, e_src, e_dst, counts, stats, status)
        level += 1
        F = power_account(fresh, lvl, counts, d_rows, status, level=level,
                          max_set_rows=max_set_rows)
    return lvl, power_poison(R, pois_mask, counts, stats)


# -- the build --------------------------------------------------------------------------


def _by_component(labels: np.ndarray):
    order = np.argsort(labels, kind="stable")
    return labels[order], order


def _members(sorted_labels: np.ndarray, order: np.ndarray, comps: np.ndarray) -> np.ndarray:
    """Ascending indices whose label is one of `comps` (unique):
    np.flatnonzero(np.isin(labels, comps)) in O(k log k) for k members,
    not O(len(labels))."""
    lo = np.searchsorted(sorted_labels, comps, "left")
    hi = np.searchsorted(sorted_labels, comps, "right")
    return np.sort(order[_expand_spans(lo, hi - lo)])


def power_closure_device(
    graph: ClosureGraph,
    snapshot: GraphSnapshot,
    max_depth: int,
    max_set_rows: int,
    base_version: int,
    sources: Optional[np.ndarray] = None,
    *,
    device,
    budget_bytes: int = DEFAULT_POWER_BUDGET,
) -> tuple[ClosureBuild, dict]:
    """`power_closure` powered in waves on `device`: the same ClosureBuild,
    array for array. Returns (build, record); the record holds keto_tpu's
    waves, steps, lanes, nodes, edges, hbm (its buffer estimate) and
    build_s, and prep_s (host subgraph preparation), wave_s (uploads,
    seeds, launches and readbacks) and device_hbm (the widest wave's
    buffers as P1-P3 hold them, device_power_bytes).
    Raises PoweringUnsupported, before any launch, when the int8 level
    plane or the node cap cannot hold the build, or a planned wave would
    break the kernels' 32-bit index limit (cuda_ops.INDEX_LIMIT)."""
    t0 = time.perf_counter()
    if int(max_depth) > _MAX_INT8_DEPTH:
        raise PoweringUnsupported(f"max_depth {max_depth} exceeds the int8 level plane")
    R = graph.R
    srcs = np.asarray(sources, dtype=np.int64) if sources is not None else graph.universe
    n_src = len(srcs)
    build = ClosureBuild(
        snapshot_version=snapshot.version, base_version=base_version,
        covered_keys=np.zeros(0, np.int64),
        ent_obj=np.zeros(0, np.int32), ent_rel=np.zeros(0, np.int32),
        ent_skind=np.zeros(0, np.int32), ent_sa=np.zeros(0, np.int32),
        ent_sb=np.zeros(0, np.int32), ent_req=np.zeros(0, np.int32),
        n_nodes=n_src, vocab_fp=snapshot_vocab_fp(snapshot),
        max_depth=int(max_depth), max_set_rows=int(max_set_rows),
    )
    record = {
        "waves": 0, "steps": 0, "lanes": 0, "nodes": 0, "edges": 0,
        "hbm": {"adjacency_pack": 0, "bit_matrix": 0, "scratch": 0},
        "prep_s": 0.0, "wave_s": 0.0,
        "device_hbm": {"adjacency_pack": 0, "bit_matrix": 0, "scratch": 0},
    }
    if n_src == 0:
        build.build_s = record["build_s"] = time.perf_counter() - t0
        return build, record

    # -- host prepack: node universe, dst-sorted edge index arrays ---------------
    all_keys = np.unique(np.concatenate([srcs, graph.e_src_keys, graph.e_dst,
                                         graph.d_node_keys]))
    n_nodes = len(all_keys)
    if n_nodes > MAX_CLOSURE_NODES:
        raise PoweringUnsupported(f"{n_nodes} nodes exceeds the node cap")
    e_counts = np.diff(graph.e_ptr)
    e_src = np.repeat(np.searchsorted(all_keys, graph.e_src_keys), e_counts).astype(np.int32)
    e_dst = np.searchsorted(all_keys, graph.e_dst).astype(np.int32)
    order = np.argsort(e_dst, kind="stable")
    e_src, e_dst = e_src[order], e_dst[order]
    d_rows = np.searchsorted(all_keys, graph.d_node_keys).astype(np.int32)
    d_counts = np.diff(graph.d_ptr)
    pois_mask = node_poison_keys(graph, all_keys).astype(np.uint8)
    src_node = np.searchsorted(all_keys, srcs).astype(np.int32)
    record.update(nodes=n_nodes, edges=len(e_src))

    comp = _components(n_nodes, e_src, e_dst)
    # nodes, edges (by source: both endpoints share a component) and
    # direct rows grouped by component, with each component's counts: a
    # range's subgraph size is a sum over its components, and only a wave
    # that runs selects its subgraph, without a pass over the whole graph
    e_comp, d_comp = comp[e_src], comp[d_rows]
    n_by, e_by, d_by = _by_component(comp), _by_component(e_comp), _by_component(d_comp)
    n_size, e_size, d_size = (np.bincount(c, minlength=n_nodes) for c in (comp, e_comp, d_comp))
    # node index -> index within the running wave's subgraph; a wave
    # writes it at its own nodes only and reads nothing else
    remap = np.empty(n_nodes, dtype=np.int32)

    uncovered = np.zeros(n_src, dtype=bool)
    parts: list[tuple] = []
    hbm_hw, dev_hw = dict(record["hbm"]), dict(record["device_hbm"])

    waves: list[tuple] = []

    def plan_range(s: int, e: int) -> None:
        """Plan the waves of sources [s, e): the induced subgraph of their
        weak components, bisected while the scratch rule exceeds the
        budget. The bisection depends on sizes only, so the whole plan,
        and any wave past the kernels' 32-bit limit, is known before any
        launch. Ranges stay contiguous in source order, so the waves'
        entry blocks concatenate into the host builder's p_src-major
        order."""
        nl = e - s
        lanes = _next_pow2(nl, _MIN_LANES)
        wave_comps = np.unique(comp[src_node[s:e]])
        n_sub, n_esub, n_dsub = (int(c[wave_comps].sum()) for c in (n_size, e_size, d_size))
        # the dummy node rides at index n_sub: padded edges and d-rows
        # point at it; it owns no self bits, no poison, no entries
        Nq = _next_pow2(n_sub + 1, 2)
        Eq = _next_pow2(n_esub, 1)
        Dq = _next_pow2(n_dsub, 1)
        if (Eq + 2 * Nq + Dq) * lanes > budget_bytes and nl > _MIN_LANES:
            mid = s + (((nl + 1) // 2 + 31) // 32) * 32
            plan_range(s, mid)
            plan_range(mid, e)
            return
        _require_index_limit(s, e, Nq, Eq, Dq, lanes)
        waves.append((s, e, lanes, wave_comps, n_sub, n_esub, n_dsub, Nq, Eq, Dq))

    def run_wave(s: int, e: int, lanes: int, wave_comps: np.ndarray, n_sub: int, n_esub: int,
                 n_dsub: int, Nq: int, Eq: int, Dq: int) -> None:
        """Power one planned wave of sources [s, e) and keep its entries."""
        tp = time.perf_counter()
        nl = e - s
        nodes_sel = _members(*n_by, wave_comps)
        e_sel = _members(*e_by, wave_comps)
        d_sel = _members(*d_by, wave_comps)

        # index within the subgraph: monotone in node index, so the
        # dst-sorted edges stay sorted, with the dummy last
        remap[nodes_sel] = np.arange(n_sub, dtype=np.int32)

        def sub(nodes: np.ndarray) -> np.ndarray:
            return remap[nodes]

        dummy = np.int32(n_sub)
        we_src = np.full(Eq, dummy, dtype=np.int32)
        we_dst = np.full(Eq, dummy, dtype=np.int32)
        we_src[:n_esub] = sub(e_src[e_sel])
        we_dst[:n_esub] = sub(e_dst[e_sel])
        wd_rows = np.full(Dq, dummy, dtype=np.int32)
        wd_rows[:n_dsub] = sub(d_rows[d_sel])
        wpois = np.zeros(Nq, dtype=np.uint8)
        wpois[:n_sub] = pois_mask[nodes_sel]
        lane_ids = np.arange(nl)
        # the seeds, as index lists: source s (lane l) has seen its own
        # node at level 0 (one bit of R0), and so its own direct row when
        # it has one (level 0 in lvl0)
        r_rows = sub(src_node[s:e]).astype(np.int64)
        r_bits = (np.uint32(1) << (lane_ids % 32).astype(np.uint32)).view(np.int32)
        l_rows = l_lanes = np.zeros(0, dtype=np.int64)
        if n_dsub:
            sub_dkeys = graph.d_node_keys[d_sel]
            dpos = np.clip(np.searchsorted(sub_dkeys, srcs[s:e]), 0, n_dsub - 1)
            at_d = sub_dkeys[dpos] == srcs[s:e]
            l_rows, l_lanes = dpos[at_d], lane_ids[at_d]
        for hw, est in ((hbm_hw, estimate_power_bytes), (dev_hw, device_power_bytes)):
            for k, v in est(Nq, Eq, Dq, lanes).items():
                hw[k] = max(hw[k], v)
        record["lanes"] = max(record["lanes"], lanes)

        tw = time.perf_counter()
        record["prep_s"] += tw - tp

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(device)

        # the seed planes are made where they are used: [Nq, W] and
        # [Dq, lanes] would otherwise be filled and copied a wave; each
        # (node, word) gets distinct bits, so the sum is their OR
        R0 = torch.zeros((Nq, lanes // 32), dtype=torch.int32, device=device)
        R0.index_put_((put(r_rows), put(lane_ids // 32)), put(r_bits), accumulate=True)
        lvl0 = torch.full((Dq, lanes), -1, dtype=torch.int8, device=device)
        lvl0[put(l_rows), put(l_lanes)] = 0
        counts0 = torch.zeros(lanes, dtype=torch.int32, device=device)
        counts0[:nl] = 1
        lvl, summary = closure_power_wave(
            put(we_src), put(we_dst), put(wd_rows), put(wpois), R0, lvl0, counts0,
            max_depth=int(max_depth), max_set_rows=int(max_set_rows),
        )
        # levels >= 0 are first discoveries; entries need req = level + 1
        # <= max_depth (the extra ring only feeds poison). Only those
        # (d-node, lane, req) triples come back, not the whole plane.
        if n_dsub:
            plane = lvl[:n_dsub, :nl]
            dn, lane = torch.nonzero((plane >= 0) & (plane < int(max_depth)), as_tuple=True)
            req = plane[dn, lane].to(torch.int32) + 1
            dn, lane, req = dn.cpu().numpy(), lane.cpu().numpy(), req.cpu().numpy()
        else:
            dn = lane = np.zeros(0, dtype=np.int64)
            req = np.zeros(0, dtype=np.int32)
        summary = summary.cpu().numpy()
        record["wave_s"] += time.perf_counter() - tw
        counts = summary[:lanes]
        pois = summary[lanes:2 * lanes]
        record["waves"] += 1
        record["steps"] += int(summary[2 * lanes])

        # reach-cap and poison uncoverage, the host builder's predicates
        uncovered[s:e] |= (counts[:nl] > max_set_rows) | (pois[:nl] > 0)
        if len(dn):
            # the R·D product over each direct node's entry span, then the
            # (src, subject) dedupe keeping the least req: lexsort with req
            # fastest, first of each group wins, as the host builder
            gdn = d_sel[dn]
            pos = _expand_spans(graph.d_ptr[gdn], d_counts[gdn])
            p_src = np.repeat(s + lane, d_counts[gdn])
            p_req = np.repeat(req, d_counts[gdn])
            p_skind, p_sa, p_sb = graph.d_skind[pos], graph.d_sa[pos], graph.d_sb[pos]
            srt = np.lexsort((p_req, p_sb, p_sa, p_skind, p_src))
            p_src, p_req = p_src[srt], p_req[srt]
            p_skind, p_sa, p_sb = p_skind[srt], p_sa[srt], p_sb[srt]
            first = np.ones(len(p_src), dtype=bool)
            first[1:] = ~(
                (p_src[1:] == p_src[:-1]) & (p_skind[1:] == p_skind[:-1])
                & (p_sa[1:] == p_sa[:-1]) & (p_sb[1:] == p_sb[:-1])
            )
            p_src, p_req = p_src[first], p_req[first]
            p_skind, p_sa, p_sb = p_skind[first], p_sa[first], p_sb[first]
            # a wave's entries belong to its own sources [s, e)
            uncovered[s:e] |= np.bincount(p_src - s, minlength=nl) > max_set_rows
            parts.append((p_src, p_req, p_skind, p_sa, p_sb))

    tp = time.perf_counter()
    for base in range(0, n_src, _MAX_LANES):
        plan_range(base, min(base + _MAX_LANES, n_src))
    record["prep_s"] += time.perf_counter() - tp
    for wave in waves:
        run_wave(*wave)
    record["hbm"], record["device_hbm"] = hbm_hw, dev_hw

    if parts:
        p_src, p_req, p_skind, p_sa, p_sb = (np.concatenate(c) for c in zip(*parts))
    else:
        p_src = np.zeros(0, np.int64)
        p_req = np.zeros(0, np.int32)
        p_skind = p_sa = p_sb = np.zeros(0, np.int32)
    keep = ~uncovered[p_src] if len(p_src) else np.zeros(0, dtype=bool)
    p_src, p_req = p_src[keep], p_req[keep]
    p_skind, p_sa, p_sb = p_skind[keep], p_sa[keep], p_sb[keep]
    node_keys = srcs[p_src]
    build.covered_keys = np.sort(srcs[np.flatnonzero(~uncovered)])
    build.ent_obj = (node_keys // R).astype(np.int32)
    build.ent_rel = (node_keys % R).astype(np.int32)
    build.ent_skind = p_skind.astype(np.int32)
    build.ent_sa = p_sa.astype(np.int32)
    build.ent_sb = p_sb.astype(np.int32)
    build.ent_req = p_req.astype(np.int32)
    build.n_entries = len(p_req)
    build.build_s = record["build_s"] = time.perf_counter() - t0
    return build, record

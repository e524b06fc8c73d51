"""Batched BFS check kernel in PyTorch: the four hot phases as
hand-written CUDA kernels (engine/cuda_ops.py, csrc/check_kernels.cu),
each beside its plain PyTorch version, and the glue that drives them.

All branches of all in-flight checks advance together as one frontier
of tasks (query, ctx, object slot, relation, remaining depth). Per step:

  1. flag tasks whose (ns, rel) program needs the host (AND/NOT without
     island capacity, missing relation config, oversized rewrites)
  2. K1 `edge_probe`: probe every task against the direct-edge table
     (and the delta overlay) and OR hits into the per-ctx accumulators
  3. expand every live task: the subject-set CSR row plus its rewrite
     instructions (COMPUTED keeps the depth, TTU and subject-set children
     go one level down). K2 `pair_probe` finds each (obj, relation) row
     span (and dirty rows); K3 `expand_gather` scans the per-slot counts
     and gathers the candidate children in scan order
  4. K4 `dedupe_compact`: drop duplicate (ctx, obj, rel) candidates,
     keeping the deepest, and compact the survivors into the next
     frontier

The loop is driven from the host: one 4-byte readback of the loop
predicate per step, with the JAX kernel's early exit, so the step count
in the launch stats is the same.

Every plain version computes what the JAX package's phase computes, bit
for bit: the 32-bit hashes run in int64 masked to 32 bits, because PyTorch
on the CPU has no uint32 shifts or scatter-max. A dispatcher takes the
plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel (engine/cuda_ops.py) or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_ops
from .delta import DELTA_PROBES, DIRTY_FOR_CHECK, empty_delta_tables
from .snapshot import (
    EMPTY,
    FLAG_CONFIG_MISSING,
    FLAG_HOST_ONLY,
    FLAG_ISLAND,
    INSTR_COMPUTED,
    INSTR_NONE,
    INSTR_TTU,
    GraphSnapshot,
    slots_per_bucket,
)

# host-replay cause codes (0 = answered on the device), priority-ordered:
# a query flagged for several reasons reports the highest code
CAUSE_STEP_EXHAUSTED = 1  # step budget ran out with live tasks
CAUSE_FRONTIER_OVERFLOW = 2  # expansion truncated / survivors > F
CAUSE_ISLAND_OVERFLOW = 3  # island instance table full
CAUSE_DIRTY = 4  # delta-dirty CSR row
CAUSE_REL_NOT_FOUND = 5  # relation missing from a configured namespace
CAUSE_CONFIG_MISSING = 6  # FLAG_CONFIG_MISSING program
CAUSE_REWRITE_CAP = 7  # FLAG_HOST_ONLY program
CAUSE_ISLAND_HOST = 8  # AND/NOT program, launch without island capacity

CAUSE_NAMES = {
    CAUSE_STEP_EXHAUSTED: "step_exhausted",
    CAUSE_FRONTIER_OVERFLOW: "frontier_overflow",
    CAUSE_ISLAND_OVERFLOW: "island_overflow",
    CAUSE_DIRTY: "dirty_row",
    CAUSE_REL_NOT_FOUND: "relation_not_found",
    CAUSE_CONFIG_MISSING: "config_missing",
    CAUSE_REWRITE_CAP: "rewrite_cap",
    CAUSE_ISLAND_HOST: "island_host",
}
CAUSE_NAME_UNINDEXED = "unindexed"  # query vocabulary never reached the device

# launch stats: the 8-slot counter vector appended to the packed result
N_LAUNCH_STATS = 8
STAT_STEPS = 0  # loop iterations executed
STAT_FRONTIER_SUM = 1  # sum of n_tasks over executed steps
STAT_FRONTIER_MAX = 2  # max n_tasks over executed steps
STAT_LIVE_SUM = 3  # sum of live tasks (seed padding excluded)
STAT_PROBE_HITS = 4  # direct-edge probe hits
STAT_EDGE_ROWS = 5  # valid expansion candidates
STAT_DEDUPE_KEPT = 6  # dedupe survivors admitted to the next frontier
STAT_RESERVED = 7

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9

TABLE_KEYS = (
    "objslot_ns", "ns_has_config", "prog_flags",
    "dh_pack", "rh_pack", "e_pack", "instr_pack", "dd_pack", "dirty_pack",
)


# -- 32-bit hashing in int64 (the plain versions' uint32 stand-in) -------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_combine(*parts: torch.Tensor) -> torch.Tensor:
    """The snapshot builder's hash_combine; int32 parts are read as uint32."""
    shape = torch.broadcast_shapes(*(p.shape for p in parts))
    h = torch.full(shape, _GOLDEN, dtype=torch.int64, device=parts[0].device)
    for p in parts:
        h = mix32(h ^ (p.to(torch.int64) & _M32))
    return h


def _bucket_rows(pack: torch.Tensor, h1, h2, probes: int, spb: int) -> torch.Tensor:
    """Every slot row a probe chain of `probes` slots can touch: PB =
    ceil(probes/spb) bucket rows along (h1 + jb*h2) mod (cap/spb).
    Returns [..., PB*spb, w]."""
    cap, w = pack.shape
    nb = cap // spb
    PB = (probes + spb - 1) // spb
    jb = torch.arange(PB, dtype=torch.int64, device=pack.device)
    bidx = (h1[..., None] + jb * h2[..., None]) & (nb - 1)
    rows = pack.reshape(nb, spb * w)[bidx]
    return rows.reshape(*h1.shape, PB * spb, w)


# -- K1 edge_probe -------------------------------------------------------------


def _edge_key_probe_plain(pack, key, probes: int, spb: int):
    """5-key probe of a packed [cap, 8] edge table against a [F, 8] key
    matrix: whole-row match on lanes 0-4, value from lane 5 (EMPTY floor).
    Returns (found[F], value[F])."""
    h1 = hash_combine(key[:, 0], key[:, 1], key[:, 2], key[:, 3], key[:, 4])
    h2 = mix32(h1 ^ _GOLDEN) | 1
    rows = _bucket_rows(pack, h1, h2, probes, spb)  # [F, PB*spb, 8]
    lane = torch.arange(8, device=pack.device)
    match = ((rows == key[:, None, :]) | (lane >= 5)).all(-1)
    found = match.any(-1)
    masked = torch.where(match[:, :, None] & (lane == 5), rows, int(EMPTY))
    return found, masked.amax(dim=(1, 2))


def edge_probe_plain(
    dh_pack, dd_pack, obj, rel, q, qsub, depth, live, *,
    dh_probes: int, spb: int, has_delta: bool,
):
    """Direct-edge hits[F] (bool): the edge (obj, rel, subject of query q)
    exists with a live value (1), an overlay entry for the exact key
    overrides the compacted table, and the task is live with depth >= 1."""
    sub = qsub[q.long()]
    z = torch.zeros_like(obj)
    key = torch.stack([obj, rel, sub[:, 0], sub[:, 1], sub[:, 2], z, z, z], dim=-1)
    hit, val = _edge_key_probe_plain(dh_pack, key, dh_probes, spb)
    hit = hit & (val == 1)
    if has_delta:
        in_delta, dval = _edge_key_probe_plain(dd_pack, key, DELTA_PROBES, spb)
        hit = torch.where(in_delta, dval == 1, hit)
    return hit & live & (depth >= 1)


# -- K2 pair_probe -------------------------------------------------------------


def pair_probe_plain(pack, obj, rels, *, probes: int, spb: int, n_vals: int):
    """(obj, rel) probe of a packed [cap, 4] table for every (task, slot)
    of the [F, S] relation matrix: [F, S, n_vals] value lanes 2.. of the
    matching slot, EMPTY on a miss."""
    objs = obj[:, None].expand_as(rels)
    h1 = hash_combine(objs, rels)
    h2 = mix32(h1 ^ _GOLDEN) | 1
    rows = _bucket_rows(pack, h1, h2, probes, spb)  # [F, S, PB*spb, 4]
    z = torch.zeros_like(rels)
    key = torch.stack([objs, rels, z, z], dim=-1)
    lane = torch.arange(4, device=pack.device)
    match = ((rows == key[:, :, None, :]) | (lane >= 2)).all(-1)
    masked = torch.where(match[..., None], rows, int(EMPTY))
    return masked.amax(dim=-2)[..., 2 : 2 + n_vals].contiguous()


# -- K3 expand_gather ----------------------------------------------------------


@dataclass
class Expansion:
    """Candidate children of one expansion phase (pre-dedupe), [G] each."""

    q: torch.Tensor
    ctx: torch.Tensor
    obj: torch.Tensor
    rel: torch.Tensor
    depth: torch.Tensor
    valid: torch.Tensor  # bool


def expand_gather_plain(
    counts, starts, slot_ctx, crel, is_comp, q, obj, depth, e_pack, *,
    wildcard_rel: int, n_queries: int,
):
    """Candidate children in scan order: the per-(task, slot) counts
    [F, S] are scanned, output j < min(total, F) belongs to the segment
    whose offset is the last <= j, and reads edge `start + within` of the
    CSR (or, for a COMPUTED slot, the task's own object). Segments cut
    off by the frontier cap flag their query with CAUSE_FRONTIER_OVERFLOW.
    Returns (Expansion, overflow[B])."""
    F, S = counts.shape
    dev = counts.device
    flat = counts.reshape(-1)
    offsets = torch.cumsum(flat, 0, dtype=torch.int32) - flat
    total = offsets[-1] + flat[-1]
    truncated = ((offsets + flat) > F) & (flat > 0)
    overflow = torch.zeros(n_queries, dtype=torch.int32, device=dev).scatter_reduce(
        0, q.long().repeat_interleave(S),
        torch.where(truncated, CAUSE_FRONTIER_OVERFLOW, 0).to(torch.int32), "amax",
    )
    j = torch.arange(F, dtype=torch.int32, device=dev)
    seg = torch.searchsorted(offsets, j, right=True).to(torch.int32) - 1
    seg = seg.clamp(0, F * S - 1).long()
    in_range = j < total.clamp(max=F)
    ti = seg // S
    src_comp = is_comp.reshape(-1)[seg] != 0
    src_obj = obj[ti]
    src_depth = depth[ti]
    src_slot0 = (seg % S) == 0
    within = j - offsets[seg]
    n_edges = e_pack.shape[0]
    e = (starts.reshape(-1)[seg] + within).clamp(0, max(n_edges - 1, 0)).long()
    if n_edges:
        edge_obj, edge_rel = e_pack[e, 0], e_pack[e, 1]
    else:
        edge_obj = torch.zeros(F, dtype=torch.int32, device=dev)
        edge_rel = torch.zeros(F, dtype=torch.int32, device=dev)
    children = Expansion(
        q=q[ti],
        ctx=slot_ctx.reshape(-1)[seg],
        obj=torch.where(src_comp, src_obj, edge_obj),
        rel=torch.where(src_slot0, edge_rel, crel.reshape(-1)[seg]),
        depth=torch.where(src_comp, src_depth, src_depth - 1),
        valid=in_range & ~(src_slot0 & (edge_rel == wildcard_rel)),
    )
    return children, overflow


# -- K4 dedupe_compact ---------------------------------------------------------


def dedupe_bits(G: int) -> int:
    """Index bits of the dedupe priority for G candidates (max 28)."""
    idx_bits = max(1, (G - 1).bit_length())
    if idx_bits > 28:
        raise ValueError(
            f"dedupe candidate count {G} needs {idx_bits} index bits; "
            "max 28 (shrink frontier_cap)"
        )
    return idx_bits


def dedupe_capacity(G: int) -> int:
    cap = 1
    while cap < 2 * G:
        cap *= 2
    return cap


def dedupe_compact_plain(ch: Expansion, *, F: int, n_queries: int):
    """Sort-free dedupe on (ctx, obj, rel) keeping the deepest copy, then
    stream compaction of the survivors, in candidate order, into the next
    [F] frontier. Candidates race for a hash bucket with priority
    (depth << idx_bits) | index; losing to the same key drops a duplicate,
    losing to a different key (a collision) keeps the candidate.
    Returns (q, ctx, obj, rel, depth, n_new, overflow[B])."""
    G = ch.q.shape[0]
    dev = ch.q.device
    cap = dedupe_capacity(G)
    idx_bits = dedupe_bits(G)
    depth_max = (1 << (32 - idx_bits)) - 1
    h = hash_combine(ch.ctx, ch.obj, ch.rel)
    bucket = torch.where(ch.valid, h & (cap - 1), cap)
    idx = torch.arange(G, dtype=torch.int64, device=dev)
    prio = (ch.depth.to(torch.int64).clamp(0, depth_max) << idx_bits) | idx
    winner = torch.zeros(cap + 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, bucket, prio, "amax"
    )
    winner_idx = winner[bucket.clamp(0, cap - 1)] & ((1 << idx_bits) - 1)
    won = ch.valid & (winner_idx == idx)
    keys = torch.stack([ch.ctx, ch.obj, ch.rel], dim=-1)
    same_key = (keys[winner_idx] == keys).all(-1)
    keep = ch.valid & (won | ~same_key)
    pos = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    overflow = torch.zeros(n_queries, dtype=torch.int32, device=dev).scatter_reduce(
        0, ch.q.long(),
        torch.where(keep & (pos >= F), CAUSE_FRONTIER_OVERFLOW, 0).to(torch.int32),
        "amax",
    )
    dest = torch.where(keep & (pos < F), pos, F).long()

    def compact(col):
        out = torch.zeros(F + 1, dtype=torch.int32, device=dev)
        return out.scatter(0, dest, col)[:F]

    n_new = torch.clamp(keep.sum().to(torch.int32), max=F)
    return (
        compact(ch.q), compact(ch.ctx), compact(ch.obj), compact(ch.rel),
        compact(ch.depth), n_new, overflow,
    )


# -- dispatch: plain version for CPU tensors, the CUDA kernel otherwise --------


def edge_probe(tables, obj, rel, q, qsub, depth, live, *, dh_probes, spb, has_delta):
    dd_pack = tables["dd_pack"] if has_delta else None
    if obj.device.type == "cpu":
        return edge_probe_plain(
            tables["dh_pack"], dd_pack, obj, rel, q, qsub, depth, live,
            dh_probes=dh_probes, spb=spb, has_delta=has_delta,
        )
    return cuda_ops.edge_probe(
        tables["dh_pack"], dd_pack, obj, rel, q, qsub, depth, live,
        dh_probes=dh_probes, spb=spb, has_delta=has_delta,
    )


def pair_probe(pack, obj, rels, *, probes, spb, n_vals):
    fn = pair_probe_plain if obj.device.type == "cpu" else cuda_ops.pair_probe
    return fn(pack, obj, rels, probes=probes, spb=spb, n_vals=n_vals)


def expand_gather(counts, starts, slot_ctx, crel, is_comp, q, obj, depth, e_pack,
                  *, wildcard_rel, n_queries):
    args = (counts, starts, slot_ctx, crel, is_comp, q, obj, depth, e_pack)
    if q.device.type == "cpu":
        return expand_gather_plain(*args, wildcard_rel=wildcard_rel, n_queries=n_queries)
    *cols, overflow = cuda_ops.expand_gather(
        *args, wildcard_rel=wildcard_rel, n_queries=n_queries
    )
    return Expansion(*cols), overflow


def dedupe_compact(ch: Expansion, *, F: int, n_queries: int):
    if ch.q.device.type == "cpu":
        return dedupe_compact_plain(ch, F=F, n_queries=n_queries)
    return cuda_ops.dedupe_compact(
        ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid, F=F, n_queries=n_queries
    )


# -- the glue between the kernels ----------------------------------------------


def program_lookup(tables, obj, rel, live, *, n_config_rels: int):
    """Per task: (ns, has_prog, pid, flags) of its (ns, rel) program."""
    ns = tables["objslot_ns"][obj.clamp(min=0).long()]
    has_prog = (rel < n_config_rels) & live
    pid = torch.where(has_prog, ns * n_config_rels + rel, 0)
    flags = torch.where(has_prog, tables["prog_flags"][pid.long()], 0)
    return ns, has_prog, pid, flags


def flag_phase(tables, rel, live, prog, *, n_config_rels: int, island_is_host: bool):
    """Per-task host-replay cause codes (0 = stays on the device). A
    data-only relation visited inside a namespace that has a relation
    config is Keto's "relation not found" error: host replay."""
    ns, _has_prog, _pid, flags = prog
    code = torch.where((flags & FLAG_HOST_ONLY) != 0, CAUSE_REWRITE_CAP, 0)
    code = torch.where((flags & FLAG_CONFIG_MISSING) != 0, CAUSE_CONFIG_MISSING, code)
    if island_is_host:
        code = torch.where((flags & FLAG_ISLAND) != 0, CAUSE_ISLAND_HOST, code)
    rel_nf = (rel >= n_config_rels) & (tables["ns_has_config"][ns.long()] != 0)
    code = torch.maximum(code, torch.where(rel_nf, CAUSE_REL_NOT_FOUND, 0))
    return torch.where(live, code, 0).to(torch.int32)


def _scatter_max(target, index, values):
    return target.scatter_reduce(0, index.long(), values.to(target.dtype), "amax")


def expand_phase(
    tables, q, ctx, obj, rel, depth, live, isl_state, prog, *,
    K: int, rh_probes: int, spb_pair: int, wildcard_rel: int, n_queries: int,
    n_island_cap: int, has_delta: bool,
):
    """Expand every live task through its CSR row and rewrite
    instructions. Monotone programs' children inherit the task's ctx; an
    island program allocates an island instance whose instruction slots
    seed fresh leaf ctxs (B + idx*K + k). Returns (candidates, per-query
    cause codes, island state)."""
    F = q.shape[0]
    NI = n_island_cap
    B = n_queries
    dev = q.device
    _ns, has_prog, pid, prog_flags = prog

    ipack = tables["instr_pack"][pid.long()].reshape(F, K, 4)
    mask_prog = has_prog[:, None]
    ik = torch.where(mask_prog, ipack[..., 0], INSTR_NONE)
    ir = torch.where(mask_prog, ipack[..., 1], 0)
    ir2 = torch.where(mask_prog, ipack[..., 2], 0)
    rels = torch.cat([rel[:, None], ir], dim=1)  # [F, S]

    spans = pair_probe(tables["rh_pack"], obj, rels, probes=rh_probes, spb=spb_pair, n_vals=2)
    starts = spans[..., 0]
    row_len = torch.where(starts < 0, 0, spans[..., 1] - starts)

    can_expand = live & (depth >= 1)
    is_comp = (ik == INSTR_COMPUTED) & live[:, None]
    is_ttu = (ik == INSTR_TTU) & can_expand[:, None]
    counts = torch.cat([
        torch.where(can_expand, row_len[:, 0], 0)[:, None],
        torch.where(is_comp, 1, torch.where(is_ttu, row_len[:, 1:], 0)),
    ], dim=1).to(torch.int32)

    overflow_q = torch.zeros(B, dtype=torch.int32, device=dev)
    if has_delta:
        dirty_vals = pair_probe(
            tables["dirty_pack"], obj, rels, probes=DELTA_PROBES, spb=spb_pair, n_vals=1
        )[..., 0]
        row_dirty = (dirty_vals.clamp(min=0) & DIRTY_FOR_CHECK) != 0
        dirty = (can_expand & row_dirty[:, 0]) | (is_ttu & row_dirty[:, 1:]).any(1)
        overflow_q = _scatter_max(overflow_q, q, torch.where(dirty, CAUSE_DIRTY, 0))

    isl_parent, isl_pid, n_isl = isl_state
    if NI > 0:
        is_island = ((prog_flags & FLAG_ISLAND) != 0) & live
        inc = is_island.to(torch.int32)
        rank = torch.cumsum(inc, 0, dtype=torch.int32) - inc
        idx = n_isl + rank
        isl_ok = is_island & (idx < NI)
        overflow_q = _scatter_max(
            overflow_q, q, torch.where(is_island & (idx >= NI), CAUSE_ISLAND_OVERFLOW, 0)
        )
        dest = torch.where(isl_ok, idx, NI).long()
        pad = torch.zeros(1, dtype=torch.int32, device=dev)
        isl_parent = torch.cat([isl_parent, pad]).scatter(0, dest, ctx)[:NI]
        isl_pid = torch.cat([isl_pid, pad]).scatter(0, dest, pid.to(torch.int32))[:NI]
        n_isl = torch.clamp(n_isl + inc.sum(dtype=torch.int32), max=NI)
        leaf = B + idx[:, None] * K + torch.arange(K, dtype=torch.int32, device=dev)
        slot_ctx = torch.cat(
            [ctx[:, None], torch.where(isl_ok[:, None], leaf, ctx[:, None])], dim=1
        )
        # an overflowed island must not seed leaves under the parent ctx
        suppress = (is_island & ~isl_ok)[:, None]
        counts = torch.cat([counts[:, :1], torch.where(suppress, 0, counts[:, 1:])], dim=1)
    else:
        slot_ctx = ctx[:, None].expand(F, K + 1)

    zcol = torch.zeros(F, 1, dtype=torch.int32, device=dev)
    crel = torch.cat([zcol, torch.where(ik == INSTR_COMPUTED, ir, ir2)], dim=1)
    comp = torch.cat([zcol, is_comp.to(torch.int32)], dim=1)
    children, overflow_exp = expand_gather(
        counts.contiguous(), starts.contiguous(), slot_ctx.to(torch.int32).contiguous(),
        crel.to(torch.int32).contiguous(), comp.contiguous(), q, obj, depth,
        tables["e_pack"], wildcard_rel=wildcard_rel, n_queries=B,
    )
    overflow_q = torch.maximum(overflow_q, overflow_exp)
    return children, overflow_q, (isl_parent, isl_pid, n_isl)


@dataclass
class _State:
    t_q: torch.Tensor  # [F] owning query
    t_ctx: torch.Tensor  # [F] accumulator id (0..B-1 are the query roots)
    t_obj: torch.Tensor  # [F] object slot
    t_rel: torch.Tensor  # [F] relation id
    t_depth: torch.Tensor  # [F] remaining depth
    n_tasks: torch.Tensor  # 0-d int32
    ctx_hit: torch.Tensor  # [B + NI*K] int32 0/1
    needs_host: torch.Tensor  # [B] int32 cause code
    isl_parent: torch.Tensor  # [max(NI, 1)]
    isl_pid: torch.Tensor  # [max(NI, 1)]
    n_isl: torch.Tensor  # 0-d int32
    stats: torch.Tensor  # [N_LAUNCH_STATS] int32


def seed_state(q_obj, q_rel, q_depth, q_valid, *, frontier_cap: int,
               n_island_cap: int, K: int) -> _State:
    """One task per query in root ctx i; invalid queries seed inert tasks
    (depth -1: no probes, no expansion)."""
    B = q_obj.shape[0]
    F = frontier_cap
    dev = q_obj.device
    pad = F - B

    def padded(x):
        return torch.cat([x.to(torch.int32), torch.zeros(pad, dtype=torch.int32, device=dev)])

    arange_b = torch.arange(B, dtype=torch.int32, device=dev)
    depth0 = torch.where(padded(q_valid) != 0, padded(q_depth), -1).to(torch.int32)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    NI = max(n_island_cap, 1)
    return _State(
        t_q=padded(arange_b), t_ctx=padded(arange_b), t_obj=padded(q_obj),
        t_rel=padded(q_rel), t_depth=depth0,
        n_tasks=torch.tensor(B, dtype=torch.int32, device=dev),
        ctx_hit=torch.zeros(B + n_island_cap * K, dtype=torch.int32, device=dev),
        needs_host=torch.zeros(B, dtype=torch.int32, device=dev),
        isl_parent=torch.zeros(NI, dtype=torch.int32, device=dev),
        isl_pid=torch.zeros(NI, dtype=torch.int32, device=dev),
        n_isl=z.clone(),
        stats=torch.zeros(N_LAUNCH_STATS, dtype=torch.int32, device=dev),
    )


def update_launch_stats(stats, n_tasks, n_live, n_hits, n_children, n_kept):
    """One step's counter accumulation."""
    one = torch.ones((), dtype=torch.int32, device=stats.device)
    zero = torch.zeros_like(one)
    inc = torch.stack([
        one, n_tasks.to(torch.int32), zero, n_live.to(torch.int32),
        n_hits.to(torch.int32), n_children.to(torch.int32), n_kept.to(torch.int32), zero,
    ])
    stats = stats + inc
    stats[STAT_FRONTIER_MAX] = torch.maximum(stats[STAT_FRONTIER_MAX], n_tasks)
    return stats


def _step(tables, st: _State, qsub, cfg: dict) -> _State:
    F = cfg["frontier_cap"]
    B = qsub.shape[0]
    ncr = cfg["n_config_rels"]
    layout = cfg["layout"]
    dev = st.t_q.device
    idx = torch.arange(F, dtype=torch.int32, device=dev)
    q, ctx = st.t_q, st.t_ctx
    qi, ci = q.long(), ctx.long()
    obj, rel, depth = st.t_obj, st.t_rel, st.t_depth
    root_done = (st.ctx_hit[:B] != 0) | (st.needs_host > 0)
    live = (idx < st.n_tasks) & ~root_done[qi] & (st.ctx_hit[ci] == 0)

    prog = program_lookup(tables, obj, rel, live, n_config_rels=ncr)
    flagged = flag_phase(
        tables, rel, live, prog, n_config_rels=ncr,
        island_is_host=cfg["n_island_cap"] == 0,
    )
    hit = edge_probe(
        tables, obj, rel, q, qsub, depth, live, dh_probes=cfg["dh_probes"],
        spb=slots_per_bucket(5, layout), has_delta=cfg["has_delta"],
    )
    ctx_hit = _scatter_max(st.ctx_hit, ctx, hit)
    needs_host = _scatter_max(st.needs_host, q, flagged)
    live = live & ~((ctx_hit[:B] != 0) | (needs_host > 0))[qi] & (ctx_hit[ci] == 0)

    children, overflow_q, isl_state = expand_phase(
        tables, q, ctx, obj, rel, depth, live,
        (st.isl_parent, st.isl_pid, st.n_isl), prog,
        K=cfg["K"], rh_probes=cfg["rh_probes"], spb_pair=slots_per_bucket(2, layout),
        wildcard_rel=cfg["wildcard_rel"], n_queries=B,
        n_island_cap=cfg["n_island_cap"], has_delta=cfg["has_delta"],
    )
    needs_host = torch.maximum(needs_host, overflow_q)
    nt_q, nt_ctx, nt_obj, nt_rel, nt_depth, n_new, overflow2 = dedupe_compact(
        children, F=F, n_queries=B
    )
    needs_host = torch.maximum(needs_host, overflow2)
    stats = update_launch_stats(
        st.stats, st.n_tasks, (live & (depth >= 0)).sum(), hit.sum(),
        children.valid.sum(), n_new,
    )
    return _State(
        nt_q, nt_ctx, nt_obj, nt_rel, nt_depth, n_new.to(torch.int32),
        ctx_hit, needs_host, *isl_state, stats,
    )


def check_kernel_packed(
    tables: dict,
    qpack: torch.Tensor,
    *,
    K: int,
    dh_probes: int,
    rh_probes: int,
    max_steps: int,
    wildcard_rel: int,
    n_config_rels: int,
    frontier_cap: int,
    layout: str,
    n_island_cap: int = 0,
    has_delta: bool = True,
) -> torch.Tensor:
    """One batched check launch. `qpack` is the [7, B] int32 query pack
    (obj, rel, depth, skind, sa, sb, valid); the result is one int32
    vector [n_isl, ctx_hit(B + NI*K), needs_host(B), isl_parent(max(NI,1)),
    isl_pid(max(NI,1)), stats(N_LAUNCH_STATS)], the JAX kernel's layout."""
    cfg = dict(
        K=K, dh_probes=dh_probes, rh_probes=rh_probes, wildcard_rel=wildcard_rel,
        n_config_rels=n_config_rels, frontier_cap=frontier_cap, layout=layout,
        n_island_cap=n_island_cap, has_delta=has_delta,
    )
    B = qpack.shape[1]
    qpack = qpack.to(torch.int32)
    z = torch.zeros_like(qpack[3])
    qsub = torch.stack([qpack[3], qpack[4], qpack[5], z], dim=-1).contiguous()
    st = seed_state(
        qpack[0], qpack[1], qpack[2], qpack[6],
        frontier_cap=frontier_cap, n_island_cap=n_island_cap, K=K,
    )
    step = 0
    while step < max_steps:
        # the loop predicate: the one 4-byte readback of each step
        busy = (st.n_tasks > 0) & ~((st.ctx_hit[:B] != 0) | (st.needs_host > 0)).all()
        if not bool(busy):
            break
        st = _step(tables, st, qsub, cfg)
        step += 1
    # step budget spent with live tasks: the device did not finish, so
    # those queries go to the host rather than reporting NotMember
    if step >= max_steps:
        live = torch.arange(frontier_cap, device=qpack.device) < st.n_tasks
        needs_host = _scatter_max(
            st.needs_host, st.t_q,
            torch.where(live, CAUSE_STEP_EXHAUSTED, 0).to(torch.int32),
        )
    else:
        needs_host = st.needs_host
    return torch.cat([
        st.n_isl.reshape(1), st.ctx_hit, needs_host, st.isl_parent, st.isl_pid, st.stats,
    ]).to(torch.int32)


def pack_queries(q_obj, q_rel, q_depth, q_skind, q_sa, q_sb, q_valid) -> np.ndarray:
    """Host-side [7, B] int32 query pack."""
    return np.stack([
        q_obj, q_rel, q_depth, q_skind, q_sa, q_sb, np.asarray(q_valid).astype(np.int32),
    ]).astype(np.int32)


def unpack_results(flat: np.ndarray, B: int, n_island_cap: int, K: int):
    """(ctx_hit, needs_host, isl_parent, isl_pid, n_isl, stats) views of
    check_kernel_packed's result vector."""
    NI = max(n_island_cap, 1)
    NC = B + n_island_cap * K
    n_isl = int(flat[0])
    ctx_hit = flat[1 : 1 + NC].astype(bool)
    needs_host = flat[1 + NC : 1 + NC + B]
    isl_parent = flat[1 + NC + B : 1 + NC + B + NI]
    isl_pid = flat[1 + NC + B + NI : 1 + NC + B + 2 * NI]
    base = 1 + NC + B + 2 * NI
    return ctx_hit, needs_host, isl_parent, isl_pid, n_isl, flat[base : base + N_LAUNCH_STATS]


# -- tables --------------------------------------------------------------------


def _pack_columns(cols, width: int) -> np.ndarray:
    out = np.zeros((cols[0].shape[0], width), dtype=np.int32)
    for i, col in enumerate(cols):
        out[:, i] = col
    return out


def pack_pair_table(obj, rel, val) -> np.ndarray:
    """Interleave three (obj, rel) -> val columns into [cap, 4] rows."""
    return _pack_columns([obj, rel, val], 4)


def pack_rh_span_table(rh_obj, rh_rel, rh_row, row_ptr) -> np.ndarray:
    """(obj, rel) -> CSR span as [cap, 4] rows (obj, rel, row_start,
    row_end): the span rides the probe's own bucket-row read. EMPTY rows
    pack (-1, -1)."""
    valid = rh_row != EMPTY
    if row_ptr.shape[0] >= 2:
        rc = np.clip(rh_row, 0, row_ptr.shape[0] - 2)
        start = np.where(valid, row_ptr[rc], EMPTY)
        end = np.where(valid, row_ptr[rc + 1], EMPTY)
    else:
        start = end = np.full(rh_row.shape, EMPTY, np.int32)
    return _pack_columns([rh_obj, rh_rel, start, end], 4)


def pack_instr_table(instr_kind, instr_rel, instr_rel2) -> np.ndarray:
    """Interleave the K-slot instruction columns into [NP, K*4] rows of
    (kind, rel, rel2, 0) lanes: one row read per task."""
    NP, K = instr_kind.shape
    ipack = np.zeros((NP, K, 4), dtype=np.int32)
    ipack[..., 0] = instr_kind
    ipack[..., 1] = instr_rel
    ipack[..., 2] = instr_rel2
    return ipack.reshape(NP, K * 4)


def pack_raw_tables(raw: dict) -> dict:
    """Interleave the snapshot's columns into the packed device layout:
    [cap, 8] edge rows (obj, rel, skind, sa, sb, val, 0, 0), [cap, 4]
    pair rows (obj, rel, val, val2), the (obj, rel) edge pack and the
    [NP, K*4] instruction rows. The rh table carries each row's CSR span
    (row_start, row_end) in its value lanes."""
    out = {k: np.asarray(raw[k], dtype=np.int32) for k in ("objslot_ns", "ns_has_config", "prog_flags")}
    out["dh_pack"] = _pack_columns(
        [raw[f"dh_{c}"] for c in ("obj", "rel", "skind", "sa", "sb", "val")], 8
    )
    out["rh_pack"] = pack_rh_span_table(raw["rh_obj"], raw["rh_rel"], raw["rh_row"], raw["row_ptr"])
    out["e_pack"] = np.stack([raw["e_obj"], raw["e_rel"]], axis=-1).astype(np.int32)
    out["instr_pack"] = pack_instr_table(raw["instr_kind"], raw["instr_rel"], raw["instr_rel2"])
    out.update(pack_delta_tables(raw))
    return out


def pack_delta_tables(delta: dict) -> dict:
    """The overlay's packed tables: [cap, 8] dd rows (obj, rel, skind, sa,
    sb, val, 0, 0) and [cap, 4] dirty rows (obj, rel, val, 0)."""
    return {
        "dd_pack": _pack_columns(
            [delta[f"dd_{c}"] for c in ("obj", "rel", "skind", "sa", "sb", "val")], 8
        ),
        "dirty_pack": pack_pair_table(delta["dirty_obj"], delta["dirty_rel"],
                                      delta["dirty_val"]),
    }


def tables_from_numpy(packed: dict, device, keys=TABLE_KEYS) -> dict:
    """Packed numpy tables (this package's packers, or the JAX package's
    packed device tables read back as numpy) -> int32 tensors on
    `device`: the check kernel's tables, or those of `keys`. Keys the
    kernel does not read are left out."""
    return {
        k: torch.from_numpy(np.require(packed[k], np.int32, ("C", "W"))).to(device)
        for k in keys
        if k in packed
    }


def snapshot_tables(snapshot: GraphSnapshot, device, delta: dict | None = None) -> dict:
    """Device tables of a snapshot; the overlay defaults to empty."""
    raw = dict(snapshot.device_arrays())
    raw.update(delta or empty_delta_tables())
    return tables_from_numpy(pack_raw_tables(raw), device)


def refresh_delta_tables(tables: dict, delta: dict, vocab_arrays: dict, device) -> dict:
    """A new table dict with only the overlay packs (dd_pack, dirty_pack)
    and the vocab-dependent arrays (objslot_ns, ns_has_config, which
    grow with the overlay's vocabulary) uploaded; the compacted tables
    are the same tensors."""
    out = dict(tables)
    raw = {k: np.asarray(v, dtype=np.int32) for k, v in vocab_arrays.items()}
    raw.update(pack_delta_tables(delta))
    out.update(tables_from_numpy(raw, device, tuple(raw)))
    return out


def kernel_static_config(
    snapshot: GraphSnapshot, max_depth: int, frontier_cap: int,
    n_island_cap: int = 0, has_delta: bool = True,
) -> dict:
    """The check kernel's static arguments for a snapshot. Monotone-only
    configs force n_island_cap=0; has_delta=False skips the overlay."""
    return dict(
        K=snapshot.K,
        dh_probes=snapshot.dh_probes,
        rh_probes=snapshot.rh_probes,
        # depth decrements bound chain steps; computed hops at constant
        # depth are bounded by the relation count
        max_steps=int(max_depth + snapshot.n_config_rels + 4),
        wildcard_rel=snapshot.wildcard_rel,
        n_config_rels=max(snapshot.n_config_rels, 1),
        frontier_cap=frontier_cap,
        layout=snapshot.layout,
        n_island_cap=n_island_cap if snapshot.island_circuits else 0,
        has_delta=has_delta,
    )

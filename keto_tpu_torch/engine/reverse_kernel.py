"""Batched ListObjects and ListSubjects in PyTorch: two BFS walks whose hot
phases run as hand-written CUDA kernels (engine/cuda_ops.py,
csrc/list_kernels.cu), each beside its plain PyTorch version.

ListObjects ("which objects can this subject reach?") walks the
transposed mirror backwards. Its tasks are seeded from the reverse-seed
CSR row of the query's subject key at depth - 1 (the direct hit consumes
one level); per step, every live task (query, obj, rel, depth):
  1. is flagged like a check task (missing config, relation not found,
     islands, oversized programs) and, with the overlay, when its
     reverse-edge row is dirty
  2. L1 `list_emit`: emits obj into its query's result buffer when the
     node matches the query's (namespace, relation) at depth >= 0
  3. L2 `reverse_gather`: expands to its predecessors: the reverse-edge
     row of obj inverts the subject-set edge (an edge whose subject
     relation is the task's relation) and inverted TTU entries (an edge
     of relation rel_t from an object of the entry's namespace), both one
     level down; inverted COMPUTED entries keep the object at the same
     depth; a POISON entry (an AND island pulls from this relation) flags
     the query instead
  4. K4 `dedupe_compact` keeps the deepest copy of each (query, obj, rel)

ListSubjects ("which subjects reach this object?") walks forward from the
query's node over the full-edge CSR plus the rewrite instructions, with
check's depth rules; L3 `subjects_gather` expands a step and marks the
plain-subject edges of each task's own row, which L1 emits.

K2 `pair_probe` serves every span, reverse-dirty and dirty-row probe.
After the loop, L4 `list_pool_compact` packs the one int32 vector the
host reads back: [offsets(B+1) | needs_host(B) | stats | pool]. Query i's
results are pool[offsets[i]:offsets[i+1]]; a node revisited at another
depth emits again, so the host dedupes.

The loops are driven from the host with one 4-byte readback per step,
whose predicate is the JAX kernel's: steps left, tasks left and some
query not yet flagged. Every plain version computes what the JAX
package's reverse kernel computes, bit for bit; a dispatcher takes it
only for CPU tensors and launches the CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ketoapi import RelationTuple, SubjectSet
from . import cuda_ops
from .delta import DELTA_PROBES, DIRTY_FOR_EXPAND, SnapshotView, empty_delta_tables
from .kernel import (
    CAUSE_DIRTY,
    CAUSE_FRONTIER_OVERFLOW,
    CAUSE_ISLAND_HOST,
    CAUSE_STEP_EXHAUSTED,
    N_LAUNCH_STATS,
    Expansion,
    _pack_columns,
    _scatter_max,
    dedupe_compact,
    flag_phase,
    pack_instr_table,
    pack_pair_table,
    pack_rh_span_table,
    pair_probe,
    program_lookup,
    tables_from_numpy,
    update_launch_stats,
)
from .snapshot import (
    EMPTY,
    INSTR_COMPUTED,
    INSTR_TTU,
    RINSTR_COMPUTED,
    RINSTR_POISON,
    RINSTR_TTU,
    GraphSnapshot,
    build_reverse_programs,
    build_reverse_tables,
    reverse_subject_tag,
    slots_per_bucket,
)

REVERSE_TABLE_KEYS = (
    "rvh_pack", "rv_pack", "rsh_pack", "rs_pack", "rinstr_pack",
    "objslot_ns", "ns_has_config", "prog_flags", "rd_pack",
)
SUBJECTS_TABLE_KEYS = (
    "fsh_pack", "fe_pack", "instr_pack", "objslot_ns", "ns_has_config", "prog_flags",
    "dirty_pack",
)


# -- host state and tables -------------------------------------------------------


def build_reverse_state(tuples: Sequence, snapshot: GraphSnapshot, namespaces,
                        view=None) -> dict:
    """The transposed mirror and the inverted programs of the tuples the
    view knows (the others are skipped, as build_full_csr skips them)."""
    view = view or SnapshotView(snapshot)
    n_t = len(tuples)
    cols = np.zeros((5, n_t), dtype=np.int32)
    keep = np.zeros(n_t, dtype=bool)
    for i, t in enumerate(tuples):
        node = view.encode_node(t.namespace, t.object, t.relation)
        subject = view.encode_subject(t)
        if node is None or subject is None:
            continue
        cols[0, i], cols[1, i] = node
        cols[2, i], cols[3, i], cols[4, i] = subject
        keep[i] = True
    return _reverse_state_from_encoded(*cols[:, keep], snapshot, namespaces)


def build_reverse_state_columnar(cols, snapshot: GraphSnapshot, namespaces) -> dict:
    """build_reverse_state from TupleColumns: the edges encoded under the
    snapshot's base vocabulary, vectorised (snapshot.encode_edge_columns),
    in the store's row order."""
    from .snapshot import encode_edge_columns

    t_obj, t_rel, t_skind, t_sa, t_sb, keep = encode_edge_columns(cols, snapshot)
    k = np.flatnonzero(keep)
    return _reverse_state_from_encoded(t_obj[k], t_rel[k], t_skind[k], t_sa[k], t_sb[k],
                                       snapshot, namespaces)


def _reverse_state_from_encoded(t_obj, t_rel, t_skind, t_sa, t_sb,
                                snapshot: GraphSnapshot, namespaces) -> dict:
    state = build_reverse_tables(t_obj, t_rel, t_skind, t_sa, t_sb, snapshot.layout)
    kind, relp, relt, ns, RK, host_all = build_reverse_programs(
        namespaces, snapshot.ns_ids, snapshot.rel_ids, snapshot.n_config_rels
    )
    # garbage: edges a compaction's row rewrites left in the CSRs
    state.update(rinstr_kind=kind, rinstr_relp=relp, rinstr_relt=relt, rinstr_ns=ns,
                 RK=RK, host_all=host_all, garbage=0)
    return state


def pack_rinstr_table(kind, relp, relt, ns) -> np.ndarray:
    """Interleave the inverted-instruction columns into [NR, RK*4] rows of
    (kind, rel_p, rel_t, ns) lanes: one row read per task."""
    NR, RK = kind.shape
    out = np.zeros((NR, RK, 4), dtype=np.int32)
    for lane, col in enumerate((kind, relp, relt, ns)):
        out[..., lane] = col
    return out.reshape(NR, RK * 4)


def pack_reverse_tables(rnp: dict, snapshot: GraphSnapshot,
                        delta: Optional[dict] = None) -> dict[str, np.ndarray]:
    """Host reverse state (and the overlay's reverse-dirty columns, empty
    by default) -> the ListObjects tables. Spans resolve into the
    row-hash value lanes, as in the check tables."""
    delta = delta or empty_delta_tables()
    return {
        "rvh_pack": pack_rh_span_table(rnp["rvh_obj"], rnp["rvh_rel"], rnp["rvh_row"],
                                       rnp["rv_row_ptr"]),
        "rv_pack": pack_pair_table(rnp["rv_pobj"], rnp["rv_prel"], rnp["rv_sb"]),
        "rsh_pack": pack_rh_span_table(rnp["rsh_obj"], rnp["rsh_tag"], rnp["rsh_row"],
                                       rnp["rs_row_ptr"]),
        "rs_pack": _pack_columns([rnp["rs_obj"], rnp["rs_rel"]], 2),
        "rinstr_pack": pack_rinstr_table(rnp["rinstr_kind"], rnp["rinstr_relp"],
                                         rnp["rinstr_relt"], rnp["rinstr_ns"]),
        "objslot_ns": np.asarray(snapshot.objslot_ns, dtype=np.int32),
        "ns_has_config": np.asarray(snapshot.ns_has_config, dtype=np.int32),
        "prog_flags": np.asarray(snapshot.prog_flags, dtype=np.int32),
        "rd_pack": pack_pair_table(delta["rd_obj"], delta["rd_tag"], delta["rd_val"]),
    }


def pack_subjects_tables(csr: dict, snapshot: GraphSnapshot,
                         delta: Optional[dict] = None) -> dict[str, np.ndarray]:
    """The full-edge CSR (expand_kernel.build_full_csr) and the overlay's
    dirty rows (empty by default) -> the ListSubjects tables: the
    span-resolved row table, (skind, sa, sb) edge rows and the check
    tables' instruction rows."""
    delta = delta or empty_delta_tables()
    return {
        "fsh_pack": pack_rh_span_table(csr["fh_obj"], csr["fh_rel"], csr["fh_row"],
                                       csr["f_row_ptr"]),
        "fe_pack": pack_pair_table(csr["f_skind"], csr["f_sa"], csr["f_sb"]),
        "instr_pack": pack_instr_table(snapshot.instr_kind, snapshot.instr_rel,
                                       snapshot.instr_rel2),
        "objslot_ns": np.asarray(snapshot.objslot_ns, dtype=np.int32),
        "ns_has_config": np.asarray(snapshot.ns_has_config, dtype=np.int32),
        "prog_flags": np.asarray(snapshot.prog_flags, dtype=np.int32),
        "dirty_pack": pack_pair_table(delta["dirty_obj"], delta["dirty_rel"],
                                      delta["dirty_val"]),
    }


def reverse_tables_from_numpy(packed: dict, device) -> dict[str, torch.Tensor]:
    """Packed ListObjects tables (pack_reverse_tables, or the JAX
    package's reverse tables read back as numpy) -> int32 tensors."""
    return tables_from_numpy(packed, device, REVERSE_TABLE_KEYS)


def subjects_tables_from_numpy(packed: dict, device) -> dict[str, torch.Tensor]:
    """Packed ListSubjects tables (pack_subjects_tables, or the JAX
    package's) -> int32 tensors."""
    return tables_from_numpy(packed, device, SUBJECTS_TABLE_KEYS)


# -- L1 list_emit ------------------------------------------------------------------


def list_emit_plain(q, emit, value, res, res_count, needs_host, *, result_cap: int):
    """Per-query bump allocation of at most one result per entry: an
    emitting entry's slot is res_count[q] plus the number of emitting
    entries of its query at lower indices (a stable sort by query with
    the others last, and a segmented scan). A slot at or past the result
    cap flags the query with CAUSE_FRONTIER_OVERFLOW (by max); the others
    write `value` to res[q * R + slot]. Updates res, res_count and
    needs_host in place; returns the landed count (0-d int32)."""
    N = q.shape[0]
    B = res_count.shape[0]
    R = result_cap
    dev = q.device
    ql = q.long()
    inc = emit.to(torch.int32)
    order = torch.argsort(ql + torch.where(emit, 0, B), stable=True)
    sq = ql[order]
    scounts = inc[order]
    cum = torch.cumsum(scounts, 0, dtype=torch.int32) - scounts
    seg_first = torch.ones(N, dtype=torch.bool, device=dev)
    seg_first[1:] = sq[1:] != sq[:-1]
    seg_base = torch.cummax(torch.where(seg_first, cum, 0), 0).values
    within = torch.empty_like(cum)
    within[order] = cum - seg_base
    alloc = res_count[ql] + within
    over = emit & (alloc >= R)
    needs_host.scatter_reduce_(
        0, ql, torch.where(over, CAUSE_FRONTIER_OVERFLOW, 0).to(torch.int32), "amax"
    )
    land = emit & ~over
    res[(ql * R + alloc)[land]] = value[land]
    res_count.scatter_add_(0, ql, land.to(torch.int32))
    return land.sum().to(torch.int32)


def list_emit(q, emit, value, res, res_count, needs_host, *, result_cap: int):
    fn = list_emit_plain if q.device.type == "cpu" else cuda_ops.list_emit
    return fn(q, emit, value, res, res_count, needs_host, result_cap=result_cap)


# -- the covering-segment map shared by L2 and L3 -----------------------------------


def _slot_scan(counts, q, n_queries: int):
    """Exclusive scan of the per-(task, slot) counts [F, S]; a segment the
    frontier cap cuts off flags its query. Returns (offsets [F*S], output
    slot j's segment [F], its offset within the segment, in-range mask,
    causes [B])."""
    F, S = counts.shape
    dev = counts.device
    flat = counts.reshape(-1)
    offsets = torch.cumsum(flat, 0, dtype=torch.int32) - flat
    total = offsets[-1] + flat[-1]
    truncated = ((offsets + flat) > F) & (flat > 0)
    cause = torch.zeros(n_queries, dtype=torch.int32, device=dev).scatter_reduce(
        0, q.long().repeat_interleave(S),
        torch.where(truncated, CAUSE_FRONTIER_OVERFLOW, 0).to(torch.int32), "amax",
    )
    j = torch.arange(F, dtype=torch.int32, device=dev)
    seg = (torch.searchsorted(offsets, j, right=True) - 1).clamp(0, F * S - 1)
    return seg, j - offsets[seg], j < total.clamp(max=F), cause


# -- L2 reverse_gather ----------------------------------------------------------------


def reverse_gather_plain(q, obj, rel, depth, live, ns_t, rstart, rlen, rinstr_pack, rv_pack,
                         objslot_ns, *, wildcard_rel: int, n_config_rels: int,
                         n_queries: int):
    """ListObjects' predecessor expansion. Per task, S = 1 + RK slots: the
    reverse-edge row (its subject-set edges, when depth >= 1 and the
    relation is not the wildcard), then one per inverted entry of the
    task's relation: COMPUTED counts 1 at any depth when its namespace is
    the task's; TTU counts the reverse-edge row when depth >= 1. A POISON
    entry of the task's namespace (or any, -1) flags the query with
    CAUSE_ISLAND_HOST. Candidates come in scan order, F of them.
    Returns (Expansion with ctx = q, causes [B])."""
    F = q.shape[0]
    RK = rinstr_pack.shape[1] // 4
    S = 1 + RK
    dev = q.device
    has_ri = live & (rel < n_config_rels)
    ripack = rinstr_pack[torch.where(has_ri, rel, 0).long()].reshape(F, RK, 4)
    rik = torch.where(has_ri[:, None], ripack[..., 0], 0)
    rip, rit, rin = ripack[..., 1], ripack[..., 2], ripack[..., 3]
    nsc = ns_t[:, None]
    poison = live & ((rik == RINSTR_POISON) & ((rin == -1) | (rin == nsc))).any(1)
    can_es = live & (depth >= 1) & (rel != wildcard_rel)
    is_rc = (rik == RINSTR_COMPUTED) & live[:, None] & (rin == nsc)
    is_rt = (rik == RINSTR_TTU) & (live & (depth >= 1))[:, None]
    counts = torch.cat([
        torch.where(can_es, rlen, 0)[:, None],
        torch.where(is_rc, 1, torch.where(is_rt, rlen[:, None], 0)),
    ], dim=1).to(torch.int32)
    zcol = torch.zeros(F, 1, dtype=torch.int32, device=dev)
    kind = torch.cat([zcol, torch.where(is_rc, 1, torch.where(is_rt, 2, 0))], dim=1)

    seg, within, in_range, cause = _slot_scan(counts, q, n_queries)
    cause = _scatter_max(cause, q, torch.where(poison, CAUSE_ISLAND_HOST, 0))
    ti = seg // S
    src_kind = kind.reshape(-1)[seg]
    src_relp = torch.cat([zcol, rip], dim=1).reshape(-1)[seg]
    src_relt = torch.cat([zcol, rit], dim=1).reshape(-1)[seg]
    src_ns = torch.cat([zcol - 2, rin], dim=1).reshape(-1)[seg]
    n_redges = rv_pack.shape[0]
    e = (rstart[ti] + within).clamp(0, max(n_redges - 1, 0)).long()
    if n_redges:
        p_obj, p_rel, e_sb = rv_pack[e, 0], rv_pack[e, 1], rv_pack[e, 2]
    else:
        p_obj = p_rel = e_sb = torch.zeros(F, dtype=torch.int32, device=dev)
    p_ns = objslot_ns[p_obj.clamp(0, objslot_ns.shape[0] - 1).long()]
    is_es = src_kind == 0
    is_c = src_kind == 1
    cond = torch.where(is_es, e_sb == rel[ti], is_c | ((p_rel == src_relt) & (p_ns == src_ns)))
    src_q = q[ti]
    children = Expansion(
        q=src_q, ctx=src_q,
        obj=torch.where(is_c, obj[ti], p_obj),
        rel=torch.where(is_es, p_rel, src_relp),
        depth=torch.where(is_c, depth[ti], depth[ti] - 1),
        valid=in_range & cond,
    )
    return children, cause


def reverse_gather(q, obj, rel, depth, live, ns_t, rstart, rlen, rinstr_pack, rv_pack,
                   objslot_ns, *, wildcard_rel: int, n_config_rels: int, n_queries: int):
    args = (q, obj, rel, depth, live, ns_t, rstart, rlen, rinstr_pack, rv_pack, objslot_ns)
    kw = dict(wildcard_rel=wildcard_rel, n_config_rels=n_config_rels, n_queries=n_queries)
    if q.device.type == "cpu":
        return reverse_gather_plain(*args, **kw)
    *cols, cause = cuda_ops.reverse_gather(*args, **kw)
    return Expansion(*cols), cause


# -- L3 subjects_gather ---------------------------------------------------------------


def subjects_gather_plain(q, obj, depth, live, spans, ik, ir, ir2, fe_pack, *,
                          wildcard_rel: int, n_queries: int):
    """ListSubjects' expansion. Per task, S = K + 1 slots over the full-CSR
    spans [F, S, 2]: its own row when depth >= 1, then its instructions
    (COMPUTED counts 1 and TTU its row, both only when depth >= 1).
    Candidates come in scan order, F of them: a plain-subject edge of a
    task's own row is a result (emit, value = its subject id); subject-set
    edges (not the wildcard relation) and TTU rows' subject-set edges go
    one level down, COMPUTED swaps the relation at the same depth, and a
    child needs depth >= 1. Returns (Expansion with ctx = q, emit [F],
    value [F], causes [B])."""
    F = q.shape[0]
    dev = q.device
    starts = spans[..., 0]
    row_len = torch.where(starts < 0, 0, spans[..., 1] - starts)
    can_row = live & (depth >= 1)
    is_comp = (ik == INSTR_COMPUTED) & can_row[:, None]
    is_ttu = (ik == INSTR_TTU) & can_row[:, None]
    counts = torch.cat([
        torch.where(can_row, row_len[:, 0], 0)[:, None],
        torch.where(is_comp, 1, torch.where(is_ttu, row_len[:, 1:], 0)),
    ], dim=1).to(torch.int32)
    S = counts.shape[1]
    zcol = torch.zeros(F, 1, dtype=torch.int32, device=dev)
    kind = torch.cat([zcol, torch.where(is_comp, 1, torch.where(is_ttu, 2, 0))], dim=1)
    crel = torch.cat([zcol, torch.where(ik == INSTR_COMPUTED, ir, ir2)], dim=1)

    seg, within, in_range, cause = _slot_scan(counts, q, n_queries)
    ti = seg // S
    src_kind = kind.reshape(-1)[seg]
    n_edges = fe_pack.shape[0]
    e = (starts.reshape(-1)[seg] + within).clamp(0, max(n_edges - 1, 0)).long()
    if n_edges:
        e_skind, e_sa, e_sb = fe_pack[e, 0], fe_pack[e, 1], fe_pack[e, 2]
    else:
        e_skind = e_sa = e_sb = torch.zeros(F, dtype=torch.int32, device=dev)
    is_row = src_kind == 0
    is_c = src_kind == 1
    child_depth = torch.where(is_c, depth[ti], depth[ti] - 1)
    cond = torch.where(is_row, (e_skind == 1) & (e_sb != wildcard_rel), is_c | (e_skind == 1))
    src_q = q[ti]
    children = Expansion(
        q=src_q, ctx=src_q,
        obj=torch.where(is_c, obj[ti], e_sa),
        rel=torch.where(is_row, e_sb, crel.reshape(-1)[seg]),
        depth=child_depth,
        valid=in_range & cond & (child_depth >= 1),
    )
    return children, in_range & is_row & (e_skind == 0), e_sa, cause


def subjects_gather(q, obj, depth, live, spans, ik, ir, ir2, fe_pack, *,
                    wildcard_rel: int, n_queries: int):
    args = (q, obj, depth, live, spans, ik, ir, ir2, fe_pack)
    kw = dict(wildcard_rel=wildcard_rel, n_queries=n_queries)
    if q.device.type == "cpu":
        return subjects_gather_plain(*args, **kw)
    *cols, emit, value, cause = cuda_ops.subjects_gather(*args, **kw)
    return Expansion(*cols), emit, value, cause


# -- L4 list_pool_compact -------------------------------------------------------------


def list_pool_compact_plain(res, res_count, needs_host, stats, *, result_cap: int,
                            pool_cap: int):
    """The packed result vector [offsets(B+1) | needs_host(B) | stats |
    pool(pool_cap)]: query i's results are pool rows offsets[i]:offsets[i+1],
    EMPTY past the used rows; a query whose span crosses the pool's end is
    flagged (by max); offsets are clamped to the pool."""
    B = res_count.shape[0]
    R = result_cap
    dev = res_count.device
    counts = res_count.clamp(0, R)
    offs = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev), torch.cumsum(counts, 0, dtype=torch.int32)
    ])
    j = torch.arange(pool_cap, dtype=torch.int32, device=dev)
    seg = torch.searchsorted(offs[1:], j, right=True)
    seg_c = seg.clamp(0, B - 1)
    within = j - offs[seg_c]
    valid = (j < offs[B]) & (seg < B)
    src = (seg_c * R + within).clamp(0, B * R - 1)
    pool = torch.where(valid, res[src], int(EMPTY))
    over = torch.where((offs[1:] > pool_cap) & (counts > 0), CAUSE_FRONTIER_OVERFLOW, 0)
    return torch.cat([
        offs.clamp(max=pool_cap), torch.maximum(needs_host, over.to(torch.int32)),
        stats.to(torch.int32), pool,
    ]).to(torch.int32)


def list_pool_compact(res, res_count, needs_host, stats, *, result_cap: int, pool_cap: int):
    fn = list_pool_compact_plain if res.device.type == "cpu" else cuda_ops.list_pool_compact
    return fn(res, res_count, needs_host, stats, result_cap=result_cap, pool_cap=pool_cap)


# -- the launches ---------------------------------------------------------------------


def _probe(pack, obj, rel, *, probes: int, spb: int, n_vals: int):
    """K2 on one relation per task: [F, n_vals]."""
    return pair_probe(pack, obj.contiguous(), rel.reshape(-1, 1).contiguous(),
                      probes=probes, spb=spb, n_vals=n_vals)[:, 0]


def _span(spans):
    start = spans[..., 0]
    return start, torch.where(start < 0, 0, spans[..., 1] - start)


def _buffers(B: int, R: int, dev):
    return (torch.full((B * R,), int(EMPTY), dtype=torch.int32, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.zeros(N_LAUNCH_STATS, dtype=torch.int32, device=dev))


def _busy(n_tasks, needs_host) -> bool:
    """The loop predicate: the one 4-byte readback of each step."""
    return bool((n_tasks > 0) & ~(needs_host > 0).all())


def _flag_exhausted(needs_host, t_q, n_tasks, step: int, max_steps: int):
    """Step budget spent with live tasks: those queries' enumerations may
    be incomplete, so they go to the host. A loop that stopped because
    every query was flagged is not exhausted."""
    if step < max_steps:
        return needs_host
    live = torch.arange(t_q.shape[0], device=t_q.device) < n_tasks
    return _scatter_max(needs_host, t_q, torch.where(live, CAUSE_STEP_EXHAUSTED, 0))


def list_objects_kernel_packed(
    tables: dict,
    qpack: torch.Tensor,
    *,
    rvh_probes: int,
    rsh_probes: int,
    max_steps: int,
    wildcard_rel: int,
    n_config_rels: int,
    frontier_cap: int,
    result_cap: int,
    pool_cap: int,
    has_delta: bool,
    layout: str,
) -> torch.Tensor:
    """One batched ListObjects launch. `qpack` is the [6, B] int32 query
    pack (subject id or slot, reverse_subject_tag, target namespace,
    target relation, depth, valid); the result is L4's int32 vector, the
    JAX kernel's layout."""
    B = qpack.shape[1]
    F = frontier_cap
    R = result_cap
    NCR = max(n_config_rels, 1)
    dev = qpack.device
    qpack = qpack.to(torch.int32)
    q_sa, q_tag, q_ns, q_rel, q_depth = qpack[0], qpack[1], qpack[2], qpack[3], qpack[4]
    q_valid = qpack[5] != 0
    spb = slots_per_bucket(2, layout)

    # seeds: the reverse-seed CSR row of each query's subject key, at
    # depth - 1 (the direct hit consumes one level)
    s_start, s_len = _span(_probe(tables["rsh_pack"], q_sa, q_tag, probes=rsh_probes,
                                  spb=spb, n_vals=2))
    seed_counts = torch.where(q_valid, s_len, 0).to(torch.int32)
    needs_host = torch.zeros(B, dtype=torch.int32, device=dev)
    if has_delta:
        # the subject's direct edges changed: its seed row is stale
        rd = _probe(tables["rd_pack"], q_sa, q_tag, probes=DELTA_PROBES, spb=spb, n_vals=1)
        needs_host = torch.where(q_valid & (rd[:, 0].clamp(min=0) != 0), CAUSE_DIRTY, 0)
        needs_host = needs_host.to(torch.int32)
    offsets = torch.cumsum(seed_counts, 0, dtype=torch.int32) - seed_counts
    total = offsets[-1] + seed_counts[-1]
    needs_host = torch.maximum(needs_host, torch.where(
        ((offsets + seed_counts) > F) & (seed_counts > 0), CAUSE_FRONTIER_OVERFLOW, 0
    ).to(torch.int32))
    j = torch.arange(F, dtype=torch.int32, device=dev)
    seg = (torch.searchsorted(offsets, j, right=True) - 1).clamp(0, B - 1)
    in_range = j < total.clamp(max=F)
    n_sedges = tables["rs_pack"].shape[0]
    e = (s_start[seg] + (j - offsets[seg])).clamp(0, max(n_sedges - 1, 0)).long()
    if n_sedges:
        seed_obj, seed_rel = tables["rs_pack"][e, 0], tables["rs_pack"][e, 1]
    else:
        seed_obj = seed_rel = torch.zeros(F, dtype=torch.int32, device=dev)
    t_q = torch.where(in_range, seg, 0).to(torch.int32)
    t_obj = torch.where(in_range, seed_obj, 0).to(torch.int32)
    t_rel = torch.where(in_range, seed_rel, 0).to(torch.int32)
    t_depth = torch.where(in_range, q_depth[seg] - 1, -1).to(torch.int32)
    n_tasks = total.clamp(max=F).to(torch.int32)

    res, res_count, stats = _buffers(B, R, dev)
    idx = torch.arange(F, dtype=torch.int32, device=dev)
    step = 0
    while step < max_steps and _busy(n_tasks, needs_host):
        q, obj, rel, depth = t_q, t_obj, t_rel, t_depth
        live = (idx < n_tasks) & (needs_host[q.long()] == 0)
        prog = program_lookup(tables, obj, rel, live, n_config_rels=NCR)
        ns_t = prog[0]
        flagged = flag_phase(tables, rel, live, prog, n_config_rels=NCR, island_is_host=True)
        needs_host = _scatter_max(needs_host, q, flagged)
        if has_delta:
            rd = _probe(tables["rd_pack"], obj, torch.zeros_like(obj), probes=DELTA_PROBES,
                        spb=spb, n_vals=1)[:, 0]
            row_dirty = live & (rd.clamp(min=0) != 0)
            needs_host = _scatter_max(needs_host, q, torch.where(row_dirty, CAUSE_DIRTY, 0))

        # the node matches its query's target: a result
        ql = q.long()
        match = live & (rel == q_rel[ql]) & (ns_t == q_ns[ql]) & (depth >= 0)
        landed = list_emit(q, match, obj, res, res_count, needs_host, result_cap=R)

        rstart, rlen = _span(_probe(tables["rvh_pack"], obj, torch.zeros_like(obj),
                                    probes=rvh_probes, spb=spb, n_vals=2))
        children, cause = reverse_gather(
            q, obj, rel, depth, live, ns_t.to(torch.int32), rstart.contiguous(),
            rlen.to(torch.int32).contiguous(), tables["rinstr_pack"], tables["rv_pack"],
            tables["objslot_ns"], wildcard_rel=wildcard_rel, n_config_rels=NCR, n_queries=B,
        )
        needs_host = torch.maximum(needs_host, cause)
        t_q, _ctx, t_obj, t_rel, t_depth, n_new, overflow = dedupe_compact(
            children, F=F, n_queries=B
        )
        needs_host = torch.maximum(needs_host, overflow)
        stats = update_launch_stats(
            stats, n_tasks, (live & (depth >= 0)).sum(), landed, children.valid.sum(), n_new
        )
        n_tasks = n_new.to(torch.int32)
        step += 1
    needs_host = _flag_exhausted(needs_host, t_q, n_tasks, step, max_steps)
    return list_pool_compact(res, res_count, needs_host, stats, result_cap=R, pool_cap=pool_cap)


def list_subjects_kernel_packed(
    tables: dict,
    qpack: torch.Tensor,
    *,
    fsh_probes: int,
    max_steps: int,
    wildcard_rel: int,
    n_config_rels: int,
    frontier_cap: int,
    result_cap: int,
    pool_cap: int,
    has_delta: bool,
    layout: str,
) -> torch.Tensor:
    """One batched ListSubjects launch. `qpack` is the [4, B] int32 query
    pack (obj, rel, depth, valid); the result is L4's int32 vector of
    plain subject ids, the JAX kernel's layout."""
    B = qpack.shape[1]
    F = frontier_cap
    R = result_cap
    NCR = max(n_config_rels, 1)
    K = tables["instr_pack"].shape[1] // 4
    if F < B:
        raise ValueError(f"frontier_cap {F} is below the batch size {B}")
    dev = qpack.device
    qpack = qpack.to(torch.int32)
    spb = slots_per_bucket(2, layout)

    def padded(x):
        return torch.cat([x.to(torch.int32), torch.zeros(F - B, dtype=torch.int32, device=dev)])

    t_q = padded(torch.arange(B, dtype=torch.int32, device=dev))
    t_obj, t_rel = padded(qpack[0]), padded(qpack[1])
    t_depth = torch.where(padded(qpack[3]) != 0, padded(qpack[2]), -1).to(torch.int32)
    n_tasks = torch.tensor(B, dtype=torch.int32, device=dev)
    needs_host = torch.zeros(B, dtype=torch.int32, device=dev)
    res, res_count, stats = _buffers(B, R, dev)
    idx = torch.arange(F, dtype=torch.int32, device=dev)
    step = 0
    while step < max_steps and _busy(n_tasks, needs_host):
        q, obj, rel, depth = t_q, t_obj, t_rel, t_depth
        live = (idx < n_tasks) & (needs_host[q.long()] == 0)
        prog = program_lookup(tables, obj, rel, live, n_config_rels=NCR)
        flagged = flag_phase(tables, rel, live, prog, n_config_rels=NCR, island_is_host=True)
        needs_host = _scatter_max(needs_host, q, flagged)
        _ns, has_prog, pid, _flags = prog
        ipack = tables["instr_pack"][pid.long()].reshape(F, K, 4)
        ik = torch.where(has_prog[:, None], ipack[..., 0], 0)
        ir, ir2 = ipack[..., 1], ipack[..., 2]
        rels = torch.cat([rel[:, None], ir], dim=1).contiguous()
        spans = pair_probe(tables["fsh_pack"], obj, rels, probes=fsh_probes, spb=spb, n_vals=2)
        if has_delta:
            dirty_vals = pair_probe(tables["dirty_pack"], obj, rels, probes=DELTA_PROBES,
                                    spb=spb, n_vals=1)[..., 0]
            row_dirty = (dirty_vals.clamp(min=0) & DIRTY_FOR_EXPAND) != 0
            can_row = live & (depth >= 1)
            is_ttu = (ik == INSTR_TTU) & can_row[:, None]
            dirty = (can_row & row_dirty[:, 0]) | (is_ttu & row_dirty[:, 1:]).any(1)
            needs_host = _scatter_max(needs_host, q, torch.where(dirty, CAUSE_DIRTY, 0))

        children, emit, value, cause = subjects_gather(
            q, obj, depth, live, spans, ik.to(torch.int32).contiguous(), ir.contiguous(),
            ir2.contiguous(), tables["fe_pack"], wildcard_rel=wildcard_rel, n_queries=B,
        )
        needs_host = torch.maximum(needs_host, cause)
        landed = list_emit(children.q, emit, value, res, res_count, needs_host, result_cap=R)
        t_q, _ctx, t_obj, t_rel, t_depth, n_new, overflow = dedupe_compact(
            children, F=F, n_queries=B
        )
        needs_host = torch.maximum(needs_host, overflow)
        stats = update_launch_stats(
            stats, n_tasks, (live & (depth >= 0)).sum(), landed, children.valid.sum(), n_new
        )
        n_tasks = n_new.to(torch.int32)
        step += 1
    needs_host = _flag_exhausted(needs_host, t_q, n_tasks, step, max_steps)
    return list_pool_compact(res, res_count, needs_host, stats, result_cap=R, pool_cap=pool_cap)


def pack_list_objects_queries(view, queries: Sequence[tuple], B: int, depth: int):
    """The [6, B] int32 ListObjects pack of (namespace, relation, subject)
    queries, and the indices of the queries whose names the view does not
    know: no edge can seed or match them, so their answer is empty."""
    q = np.zeros((6, B), dtype=np.int32)
    q[4] = depth
    unknown: set[int] = set()
    for i, (ns_name, rel_name, subject) in enumerate(queries):
        proxy = RelationTuple(namespace=ns_name, object="", relation=rel_name)
        if isinstance(subject, SubjectSet):
            proxy.subject_set = subject
        else:
            proxy.subject_id = subject
        ns_id, rel_id = view.ns_id(ns_name), view.rel_id(rel_name)
        sub = view.encode_subject(proxy)
        if ns_id is None or rel_id is None or sub is None:
            unknown.add(i)
            continue
        skind, sa, sb = sub
        q[:4, i] = sa, reverse_subject_tag(skind, sb), ns_id, rel_id
        q[5, i] = 1
    return q, unknown


def pack_list_subjects_queries(view, queries: Sequence[tuple], B: int, depth: int):
    """The [4, B] int32 ListSubjects pack of (namespace, object, relation)
    queries, and the indices of the queries whose node the view does not
    know (their answer is empty)."""
    q = np.zeros((4, B), dtype=np.int32)
    q[2] = depth
    unknown: set[int] = set()
    for i, (ns_name, obj_name, rel_name) in enumerate(queries):
        node = view.encode_node(ns_name, obj_name, rel_name)
        if node is None:
            unknown.add(i)
            continue
        q[0, i], q[1, i] = node
        q[3, i] = 1
    return q, unknown


def unpack_list_results(flat: np.ndarray, B: int):
    """(offsets[B+1], needs_host[B] cause codes, pool values, stats)."""
    offs = flat[: B + 1]
    needs = flat[B + 1 : 2 * B + 1]
    stats = flat[2 * B + 1 : 2 * B + 1 + N_LAUNCH_STATS]
    pool = flat[2 * B + 1 + N_LAUNCH_STATS :]
    return offs, needs, pool, stats


def decode_pool_slice(pool: np.ndarray, lo: int, hi: int) -> list[int]:
    """Ordered, deduplicated ids of one query's pool span (a node revisited
    at another depth in a later step emits again)."""
    return list(dict.fromkeys(pool[lo:hi].tolist()))

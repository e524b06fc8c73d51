"""BatchFilter's shared-frontier walk in PyTorch: one subject, one sorted
candidate column, one reverse walk whose candidate intersection runs as
F1 `filter_mark` (csrc/closure_filter_kernels.cu) beside its plain
PyTorch version.

"Of these 10,000 search results, which may this user see?" is 10,000
checks that share one subject. The walk expands the subject's reverse-
reachable set once, over the transposed mirror of ListObjects
(engine/reverse_kernel.py), and intersects each step's frontier with the
whole candidate column. Seeds are the reverse-seed CSR row of the
subject's key at depth - 1 (the direct hit consumes one level); per
step, every frontier task (obj, rel, depth):
  1. flags the walk like a ListObjects task (missing config, relation
     not found, islands, oversized programs; with the overlay, a dirty
     reverse-edge row): the walk is shared, so any flag sends every
     candidate it has not resolved to the host
  2. F1: a task of the query's relation at depth >= 0 marks its object's
     slot in the sorted candidate column (a lower-bound binary search)
  3. L2 `reverse_gather` with one query expands its predecessors through
     the reverse-edge CSR and the inverted COMPUTED and TTU entries; a
     POISON entry (an AND island pulls from the relation) flags the walk
  4. K4 `dedupe_compact` keeps the deepest copy of each (obj, rel)
K2 `pair_probe` serves the seed span, the reverse-edge spans and the
reverse-dirty probes. A clean walk that drains its frontier is complete:
hits are members, unmarked candidates definitive non-members.

The loop is driven from the host with one 16-byte readback a step, the
walk's status [n_tasks, cause, n_hit, n_cand], under the JAX kernel's
predicate: steps left, tasks left, no cause, and not every candidate hit.
A step that raises the cause still finishes its marking, expansion and
stats. The result is the JAX kernel's vector [hit(C) | cause(1) |
stats(8)], bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_ops
from .delta import DELTA_PROBES
from .kernel import (
    CAUSE_DIRTY,
    CAUSE_FRONTIER_OVERFLOW,
    CAUSE_STEP_EXHAUSTED,
    N_LAUNCH_STATS,
    dedupe_compact,
    flag_phase,
    program_lookup,
    update_launch_stats,
)
from .reverse_kernel import _probe, _span, reverse_gather
from .snapshot import slots_per_bucket

# sorted-candidate padding: no object slot reaches it
CAND_PAD = np.int32(2**31 - 1)


def filter_mark_plain(obj, rel, depth, live, cand, head, hit, status) -> torch.Tensor:
    """The candidate intersection of one step: a live task of relation
    head[2] at depth >= 0 whose object is in the sorted column `cand`
    (lower bound) sets that slot of `hit`. Updates hit and status[2] (the
    count of set slots) in place; returns the matching tasks' count."""
    C = cand.shape[0]
    match = live & (rel == head[2]) & (depth >= 0)
    pos = torch.searchsorted(cand, obj).clamp(0, C - 1)
    found = match & (cand[pos] == obj)
    before = hit.sum()
    hit[pos[found]] = 1
    status[2] += hit.sum() - before
    return found.sum().to(torch.int32)


def filter_mark(obj, rel, depth, live, cand, head, hit, status) -> torch.Tensor:
    fn = filter_mark_plain if obj.device.type == "cpu" else cuda_ops.filter_mark
    return fn(obj, rel, depth, live, cand, head, hit, status)


def filter_kernel_packed(
    tables: dict,
    qcpack: torch.Tensor,
    *,
    rvh_probes: int,
    rsh_probes: int,
    max_steps: int,
    wildcard_rel: int,
    n_config_rels: int,
    frontier_cap: int,
    has_delta: bool,
    layout: str,
) -> torch.Tensor:
    """One BatchFilter walk over the ListObjects tables. `qcpack` is the
    [5 + C] int32 pack (subject id or slot, reverse_subject_tag, target
    relation, depth, n_cand, the sorted candidate column padded with
    CAND_PAD); the result is [hit(C) | cause(1) | stats(N_LAUNCH_STATS)]."""
    F = frontier_cap
    NCR = max(n_config_rels, 1)
    dev = qcpack.device
    qcpack = qcpack.to(torch.int32).contiguous()
    head, cand = qcpack[:5], qcpack[5:]
    C = cand.shape[0]
    spb = slots_per_bucket(2, layout)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    # seeds: the reverse-seed CSR row of the subject key, at depth - 1
    s_start, s_len = _span(_probe(tables["rsh_pack"], head[0:1], head[1:2], probes=rsh_probes,
                                  spb=spb, n_vals=2))
    s_start, s_len = s_start[0], s_len[0]
    cause = zero
    if has_delta:
        # the subject's direct edges changed: its seed row is stale
        rd = _probe(tables["rd_pack"], head[0:1], head[1:2], probes=DELTA_PROBES, spb=spb,
                    n_vals=1)[0, 0]
        cause = torch.where(rd.clamp(min=0) != 0, CAUSE_DIRTY, 0).to(torch.int32)
    cause = torch.maximum(cause, torch.where(s_len > F, CAUSE_FRONTIER_OVERFLOW, 0))
    j = torch.arange(F, dtype=torch.int32, device=dev)
    in_range = j < s_len.clamp(max=F)
    n_sedges = tables["rs_pack"].shape[0]
    e = (s_start + j).clamp(0, max(n_sedges - 1, 0)).long()
    if n_sedges:
        seed_obj, seed_rel = tables["rs_pack"][e, 0], tables["rs_pack"][e, 1]
    else:
        seed_obj = seed_rel = torch.zeros(F, dtype=torch.int32, device=dev)
    t_obj = torch.where(in_range, seed_obj, 0).to(torch.int32)
    t_rel = torch.where(in_range, seed_rel, 0).to(torch.int32)
    t_depth = torch.where(in_range, head[3] - 1, -1).to(torch.int32)
    n_tasks = s_len.clamp(max=F).to(torch.int32)
    hit = torch.zeros(C, dtype=torch.int32, device=dev)
    stats = torch.zeros(N_LAUNCH_STATS, dtype=torch.int32, device=dev)
    # the walk's status, read back once a step: [n_tasks, cause, n_hit, n_cand]
    status = torch.stack([n_tasks, cause.to(torch.int32), zero, head[4]]).contiguous()

    q = torch.zeros(F, dtype=torch.int32, device=dev)
    step = 0
    while True:
        n_live, walk_cause, n_hit, n_cand = status.tolist()
        all_hit = n_hit >= n_cand
        if not (step < max_steps and n_live > 0 and walk_cause == 0 and not all_hit):
            break
        obj, rel, depth = t_obj, t_rel, t_depth
        live = j < status[0]
        prog = program_lookup(tables, obj, rel, live, n_config_rels=NCR)
        ns_t = prog[0]
        flagged = flag_phase(tables, rel, live, prog, n_config_rels=NCR, island_is_host=True)
        cause = torch.maximum(status[1], flagged.max())
        if has_delta:
            rd = _probe(tables["rd_pack"], obj, torch.zeros_like(obj), probes=DELTA_PROBES,
                        spb=spb, n_vals=1)[:, 0]
            row_dirty = live & (rd.clamp(min=0) != 0)
            cause = torch.maximum(cause, torch.where(row_dirty.any(), CAUSE_DIRTY, 0))

        marks = filter_mark(obj, rel, depth, live, cand, head, hit, status)

        rstart, rlen = _span(_probe(tables["rvh_pack"], obj, torch.zeros_like(obj),
                                    probes=rvh_probes, spb=spb, n_vals=2))
        children, gather_cause = reverse_gather(
            q, obj, rel, depth, live, ns_t.to(torch.int32), rstart.contiguous(),
            rlen.to(torch.int32).contiguous(), tables["rinstr_pack"], tables["rv_pack"],
            tables["objslot_ns"], wildcard_rel=wildcard_rel, n_config_rels=NCR, n_queries=1,
        )
        _q, _ctx, t_obj, t_rel, t_depth, n_new, overflow = dedupe_compact(
            children, F=F, n_queries=1
        )
        cause = torch.maximum(torch.maximum(cause, gather_cause[0]), overflow[0])
        stats = update_launch_stats(
            stats, status[0], (live & (depth >= 0)).sum(), marks, children.valid.sum(), n_new
        )
        status[0] = n_new
        status[1] = cause
        step += 1
    # the budget ran out with live tasks and unmarked candidates: the walk
    # did not finish, so unmarked candidates are not negatives
    n_live, walk_cause, n_hit, n_cand = status.tolist()
    if step >= max_steps and n_live > 0 and n_hit < n_cand:
        walk_cause = max(walk_cause, CAUSE_STEP_EXHAUSTED)
    return torch.cat([
        hit, torch.tensor([walk_cause], dtype=torch.int32, device=dev), stats,
    ]).to(torch.int32)


def pack_filter_query(sa: int, tag: int, rel: int, depth: int, cand_sorted: np.ndarray,
                      C: int) -> np.ndarray:
    """The [5 + C] int32 filter pack: the query scalars and the sorted
    candidate column padded to C with CAND_PAD."""
    n = len(cand_sorted)
    pad = np.full(C, CAND_PAD, dtype=np.int32)
    pad[:n] = np.asarray(cand_sorted, dtype=np.int32)
    return np.concatenate([np.array([sa, tag, rel, depth, n], dtype=np.int32), pad])


def unpack_filter_results(flat: np.ndarray, C: int):
    """(hit[C] bool, cause int, stats[N_LAUNCH_STATS]) of one filter
    result vector."""
    return flat[:C].astype(bool), int(flat[C]), flat[C + 1 : C + 1 + N_LAUNCH_STATS]

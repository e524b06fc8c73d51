"""Batched Expand in PyTorch: a device BFS gather over the full-edge CSR
and exact host assembly of the trees.

Keto's Expand (internal/expand/engine.go:35-104) is a depth-first walk
that reads one page of tuples per tree node. Here all B expand queries
walk breadth-first in lockstep over a full-edge CSR (subject-id leaves
and subject-set children, unlike the check kernel's subject-set-only
CSR), and every discovered edge lands in a bounded per-query buffer; the
host then runs the reference's exact DFS (visited-set cycle cut,
restDepth <= 1 leaves, nil-vs-leaf rules) over the gathered adjacency,
touching no store. Expand follows stored tuples only: no rewrites.

Per step, every live task (query, obj, rel, depth):
  1. K2 `pair_probe` finds its full-CSR row and its dirty-row mark
  2. X1 `expand_emit`: tasks at depth >= 2 append their row's edges to
     their query's buffer (a per-query bump allocation in task order),
     flag buffer overflow, dirty rows and rows past the step's 4F
     emission budget, and produce the subject-set children at depth - 1
  3. K4 `dedupe_compact` keeps the deepest copy of each (query, obj,
     rel) child with depth >= 2 and compacts them into the next frontier
After the loop, X2 `pool_compact` gathers the used buffer entries into a
dense pool and packs the one int32 result vector the host reads back.

The loop is driven from the host with one 4-byte readback per step.
Every plain version computes what the JAX package's expand kernel
computes, bit for bit; a dispatcher takes it only for CPU tensors and
launches the CUDA kernel (engine/cuda_ops.py) for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ketoapi import RelationTuple, SubjectSet, Tree, TreeNodeType
from . import cuda_ops
from .delta import DELTA_PROBES, DIRTY_FOR_EXPAND, SnapshotView, empty_delta_tables
from .kernel import (
    N_LAUNCH_STATS,
    Expansion,
    _pack_columns,
    dedupe_compact,
    pair_probe,
    tables_from_numpy,
    update_launch_stats,
)
from .snapshot import (
    EMPTY,
    GraphSnapshot,
    group_rows_csr,
    slots_per_bucket,
    vocab_by_id,
)

EXPAND_TABLE_KEYS = ("fh_pack", "f_row_ptr", "f_skind", "f_sa", "f_sb", "dirty_pack")
# edge slots one step may emit, per frontier task
EMIT_PER_TASK = 4


# -- full-edge CSR (host build) ------------------------------------------------


def build_full_csr(
    tuples: Sequence[RelationTuple], snapshot: GraphSnapshot, view=None
) -> dict[str, np.ndarray]:
    """Group all edges by (obj_slot, rel), in tuple order within a row.
    Tuples whose names the view does not know are skipped."""
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
    return full_csr_from_encoded(*cols[:, keep], layout=snapshot.layout)


def full_csr_from_encoded(t_obj, t_rel, t_skind, t_sa, t_sb, *, layout: str) -> dict:
    """Row-hash table and CSR of pre-encoded full edges."""
    fh_obj, fh_rel, fh_row, fh_probes, row_ptr, (f_skind, f_sa, f_sb) = group_rows_csr(
        t_obj, t_rel, (t_skind, t_sa, t_sb), layout
    )
    return {
        "fh_obj": fh_obj, "fh_rel": fh_rel, "fh_row": fh_row, "fh_probes": fh_probes,
        "f_row_ptr": row_ptr, "f_skind": f_skind, "f_sa": f_sa, "f_sb": f_sb,
    }


def columnar_subject_order(cols, keep):
    """The rows of `keep` in a columnar CSR's within-row child order: the
    store's identity-key order restricted to the subject fields (the
    (ns, obj, rel) prefix is constant within a row), which is the host
    oracle's paged read order, so device trees list children as it does."""
    k = np.flatnonzero(np.asarray(keep))
    return k[np.lexsort((cols.srel[k], cols.sobj[k], cols.sns[k], np.asarray(cols.skind)[k]))]


def build_full_csr_columnar(cols, snapshot: GraphSnapshot) -> dict:
    """build_full_csr from TupleColumns: the edges encoded under the
    snapshot's base vocabulary, vectorised (snapshot.encode_edge_columns),
    with no RelationTuple object on the way."""
    from .snapshot import encode_edge_columns

    t_obj, t_rel, t_skind, t_sa, t_sb, keep = encode_edge_columns(cols, snapshot)
    order = columnar_subject_order(cols, keep)
    return full_csr_from_encoded(t_obj[order], t_rel[order], t_skind[order], t_sa[order],
                                 t_sb[order], layout=snapshot.layout)


def pack_expand_tables(csr: dict, delta: Optional[dict] = None) -> dict[str, np.ndarray]:
    """Host full-CSR arrays (and the overlay's dirty-row columns, empty by
    default) -> the expand kernel's packed tables: [cap, 4] row-hash rows
    (obj, rel, row, 0), the CSR columns and the [cap, 4] dirty rows."""
    delta = delta or empty_delta_tables()
    out = {k: np.asarray(csr[k], dtype=np.int32) for k in ("f_row_ptr", "f_skind", "f_sa", "f_sb")}
    out["fh_pack"] = _pack_columns([csr["fh_obj"], csr["fh_rel"], csr["fh_row"]], 4)
    out["dirty_pack"] = _pack_columns(
        [delta["dirty_obj"], delta["dirty_rel"], delta["dirty_val"]], 4
    )
    return out


def expand_tables_from_numpy(packed: dict, device) -> dict[str, torch.Tensor]:
    """Packed numpy expand tables (pack_expand_tables, or the JAX package's
    expand tables read back as numpy) -> int32 tensors on `device`."""
    return tables_from_numpy(packed, device, EXPAND_TABLE_KEYS)


# -- X1 expand_emit ------------------------------------------------------------


def row_span(f_row_ptr, row):
    """(start, length) of each CSR row; an EMPTY row is (0, 0)."""
    n_rows = f_row_ptr.shape[0] - 1
    row_c = row.clamp(0, n_rows).long()
    start = f_row_ptr[row_c]
    end = f_row_ptr[(row_c + 1).clamp(max=n_rows)]
    empty = row == int(EMPTY)
    return torch.where(empty, 0, start), torch.where(empty, 0, end - start)


def expand_emit_plain(
    t_q, t_obj, t_rel, t_depth, live, row, dirty, f_row_ptr, f_skind, f_sa, f_sb,
    eb, eb_count, needs_host, *, edge_cap: int,
):
    """One step's emission. Tasks that are live at depth >= 2 on a clean
    row take edge slots of their query's buffer in task order (a stable
    sort by query with dead tasks last, a segmented exclusive scan, and
    back); a task whose row does not fit the buffer is dropped and flags
    its query, but still shifts the later tasks of its query. Emission
    slots j < 4F map to tasks through the exclusive scan of the emitted
    counts; a row past the budget is written and counted in part, and
    flags its query. Updates the five [B*E] buffers `eb`, `eb_count` and
    `needs_host` in place. Returns the [4F] child candidates (q, ctx, obj,
    rel, depth, valid) and the step's emitted-edge count (0-d)."""
    F = t_q.shape[0]
    B = eb_count.shape[0]
    E = edge_cap
    G = EMIT_PER_TASK * F
    dev = t_q.device
    n_edges = f_skind.shape[0]
    q = t_q.long()
    start, length = row_span(f_row_ptr, row)
    emit = live & (t_depth >= 2)
    task_dirty = emit & ((dirty.clamp(min=0) & DIRTY_FOR_EXPAND) != 0)
    needs_host[q[task_dirty]] = True
    emit = emit & ~task_dirty
    counts = torch.where(emit, length, 0).to(torch.int32)

    # per-query bump allocation, from counts before the overflow mask
    order = torch.argsort(q + torch.where(live, 0, B), stable=True)
    sq = q[order]
    scounts = counts[order]
    cum = torch.cumsum(scounts, 0, dtype=torch.int32) - scounts
    seg_first = torch.ones(F, dtype=torch.bool, device=dev)
    seg_first[1:] = sq[1:] != sq[:-1]
    seg_base = torch.cummax(torch.where(seg_first, cum, 0), 0).values
    alloc = torch.empty_like(cum)
    alloc[order] = eb_count[sq] + (cum - seg_base)

    overflow = emit & ((alloc + counts) > E)
    needs_host[q[overflow]] = True
    emit = emit & ~overflow

    flat = torch.where(emit, counts, 0)
    offsets = torch.cumsum(flat, 0, dtype=torch.int32) - flat
    total = offsets[-1] + flat[-1]
    j = torch.arange(G, dtype=torch.int32, device=dev)
    seg = (torch.searchsorted(offsets, j, right=True) - 1).clamp(0, F - 1)
    within = j - offsets[seg]
    in_range = j < total.clamp(max=G)
    e = (start[seg] + within).clamp(0, max(n_edges - 1, 0)).long()
    if n_edges:
        c_skind, c_sa, c_sb = f_skind[e], f_sa[e], f_sb[e]
    else:
        c_skind = c_sa = c_sb = torch.zeros(G, dtype=torch.int32, device=dev)
    dest_q = t_q[seg]
    dest = dest_q.long() * E + alloc[seg] + within
    write = in_range & (dest >= 0) & (dest < B * E)
    for col, val in zip(eb, (t_obj[seg], t_rel[seg], c_skind, c_sa, c_sb)):
        col[dest[write]] = val[write]
    landed = in_range & emit[seg]
    eb_count.scatter_add_(0, dest_q.long(), landed.to(torch.int32))
    trunc = (offsets + flat) > G
    needs_host[q[emit & trunc]] = True

    child_depth = t_depth[seg] - 1
    valid = in_range & (c_skind == 1) & (child_depth >= 2) & emit[seg]
    emitted = landed.sum().to(torch.int32)
    return dest_q, dest_q, c_sa, c_sb, child_depth, valid, emitted


def expand_emit(t_q, t_obj, t_rel, t_depth, live, row, dirty, f_row_ptr, f_skind, f_sa,
                f_sb, eb, eb_count, needs_host, *, edge_cap: int):
    fn = expand_emit_plain if t_q.device.type == "cpu" else cuda_ops.expand_emit
    *cols, emitted = fn(
        t_q, t_obj, t_rel, t_depth, live, row, dirty, f_row_ptr, f_skind, f_sa, f_sb,
        eb, eb_count, needs_host, edge_cap=edge_cap,
    )
    return Expansion(*cols), emitted


# -- X2 pool_compact -----------------------------------------------------------


def pool_compact_plain(eb, eb_count, root, needs_host, stats, *, edge_cap: int, pool_cap: int):
    """The packed result vector [offsets(B+1) | root(B) | needs_host(B) |
    stats | pool(pool_cap * 5)]: query i's edge records are pool rows
    offsets[i]:offsets[i+1], EMPTY past the used rows; a query whose span
    crosses the pool's end is flagged; offsets are clamped to the pool."""
    B = eb_count.shape[0]
    E = edge_cap
    dev = eb_count.device
    counts = eb_count.clamp(0, E)
    offs = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev), torch.cumsum(counts, 0, dtype=torch.int32)
    ])
    j = torch.arange(pool_cap, dtype=torch.int32, device=dev)
    seg = torch.searchsorted(offs[1:], j, right=True)
    seg_c = seg.clamp(0, B - 1)
    within = j - offs[seg_c]
    valid = (j < offs[B]) & (seg < B)
    src = (seg_c * E + within).clamp(0, B * E - 1)
    pool = torch.stack([torch.where(valid, col[src], int(EMPTY)) for col in eb], dim=1)
    needs = needs_host | ((offs[1:] > pool_cap) & (counts > 0))
    return torch.cat([
        offs.clamp(max=pool_cap), root.to(torch.int32), needs.to(torch.int32),
        stats.to(torch.int32), pool.reshape(-1),
    ])


def pool_compact(eb, eb_count, root, needs_host, stats, *, edge_cap: int, pool_cap: int):
    fn = pool_compact_plain if eb_count.device.type == "cpu" else cuda_ops.pool_compact
    return fn(eb, eb_count, root, needs_host, stats, edge_cap=edge_cap, pool_cap=pool_cap)


# -- the launch ----------------------------------------------------------------


def expand_kernel_packed(
    tables: dict,
    qpack: torch.Tensor,
    *,
    fh_probes: int,
    max_steps: int,
    frontier_cap: int,
    edge_cap: int,
    pool_cap: int,
    layout: str,
) -> torch.Tensor:
    """One batched expand launch. `qpack` is the [4, B] int32 query pack
    (obj, rel, depth, valid); the result is pool_compact's int32 vector,
    the JAX kernel's layout. Query i's seed task carries depth -1 when it
    is invalid; its root is flagged for the host when its row is dirty."""
    B = qpack.shape[1]
    F = frontier_cap
    E = edge_cap
    if F < B:
        raise ValueError(f"frontier_cap {F} is below the batch size {B}")
    dev = qpack.device
    qpack = qpack.to(torch.int32)
    q_obj, q_rel, q_depth, q_valid = qpack[0], qpack[1], qpack[2], qpack[3] != 0
    spb = slots_per_bucket(2, layout)

    def probe(pack, obj, rel, probes):
        return pair_probe(
            pack, obj.contiguous(), rel.reshape(-1, 1).contiguous(),
            probes=probes, spb=spb, n_vals=1,
        ).reshape(-1)

    fh_pack, dirty_pack = tables["fh_pack"], tables["dirty_pack"]
    f_row_ptr = tables["f_row_ptr"]
    csr_cols = (f_row_ptr, tables["f_skind"], tables["f_sa"], tables["f_sb"])

    _, root_len = row_span(f_row_ptr, probe(fh_pack, q_obj, q_rel, fh_probes))
    root = (root_len > 0) & q_valid
    root_dirty = probe(dirty_pack, q_obj, q_rel, DELTA_PROBES).clamp(min=0) & DIRTY_FOR_EXPAND
    needs_host = q_valid & (root_dirty != 0)

    def padded(x):
        return torch.cat([x.to(torch.int32), torch.zeros(F - B, dtype=torch.int32, device=dev)])

    t_q = padded(torch.arange(B, dtype=torch.int32, device=dev))
    t_obj, t_rel = padded(q_obj), padded(q_rel)
    t_depth = torch.where(padded(q_valid) != 0, padded(q_depth), -1).to(torch.int32)
    n_tasks = torch.tensor(B, dtype=torch.int32, device=dev)
    eb = (
        torch.full((B * E,), int(EMPTY), dtype=torch.int32, device=dev),
        torch.full((B * E,), int(EMPTY), dtype=torch.int32, device=dev),
        *(torch.zeros(B * E, dtype=torch.int32, device=dev) for _ in range(3)),
    )
    eb_count = torch.zeros(B, dtype=torch.int32, device=dev)
    stats = torch.zeros(N_LAUNCH_STATS, dtype=torch.int32, device=dev)
    no_hits = torch.zeros((), dtype=torch.int32, device=dev)
    idx = torch.arange(F, dtype=torch.int32, device=dev)
    for _ in range(max_steps):
        # the loop predicate: the one 4-byte readback of each step
        if not bool(n_tasks > 0):
            break
        live = (idx < n_tasks) & ~needs_host[t_q.long()]
        row = probe(fh_pack, t_obj, t_rel, fh_probes)
        dirty = probe(dirty_pack, t_obj, t_rel, DELTA_PROBES)
        children, emitted = expand_emit(
            t_q, t_obj, t_rel, t_depth, live, row, dirty, *csr_cols, eb, eb_count,
            needs_host, edge_cap=E,
        )
        t_q, _ctx, t_obj, t_rel, n_depth, n_new, overflow_q = dedupe_compact(
            children, F=F, n_queries=B
        )
        needs_host |= overflow_q > 0
        stats = update_launch_stats(
            stats, n_tasks, (live & (t_depth >= 0)).sum(), no_hits, emitted, n_new
        )
        t_depth = n_depth
        n_tasks = n_new.to(torch.int32)
    return pool_compact(
        eb, eb_count, root, needs_host, stats, edge_cap=E, pool_cap=pool_cap
    )


def pack_expand_queries(q_obj, q_rel, depth: int, q_valid) -> np.ndarray:
    """Host-side [4, B] int32 query pack."""
    B = len(q_obj)
    return np.stack([
        q_obj, q_rel, np.full(B, depth, dtype=np.int32), np.asarray(q_valid).astype(np.int32),
    ]).astype(np.int32)


def unpack_expand_results(flat: np.ndarray, B: int, pool_cap: int):
    """(offsets[B+1], root[B] bool, needs_host[B] bool, pool columns
    (pobj, prel, skind, sa, sb) each [pool_cap], stats) views of
    expand_kernel_packed's result vector."""
    offs = flat[: B + 1]
    root = flat[B + 1 : 2 * B + 1].astype(bool)
    needs = flat[2 * B + 1 : 3 * B + 1].astype(bool)
    stats = flat[3 * B + 1 : 3 * B + 1 + N_LAUNCH_STATS]
    pool = flat[3 * B + 1 + N_LAUNCH_STATS :].reshape(pool_cap, 5)
    return offs, root, needs, tuple(pool[:, c] for c in range(5)), stats


# -- host assembly -------------------------------------------------------------


class _ChainLookup:
    """id -> name: the overlay's few entries first, then the base's, so a
    delta refresh extends a decoder without copying the base dicts."""

    __slots__ = ("base", "extra")

    def __init__(self, base, extra: dict):
        self.base = base
        self.extra = extra

    def __getitem__(self, key):
        v = self.extra.get(key)
        if v is None:
            return self.base[key]
        return v


# the decoder's memos stop growing here: they cover a serving hot set
# without a scan of a 1e7 vocabulary turning into its reverse dict
_DECODER_MEMO_CAP = 200_000


class ExpandDecoder:
    """Reverse vocabularies that decode device ids back to names, with
    memos of the decoded subject sets (tree assembly resolves the same hot
    (slot, relation) pairs across every tree of a batch) and subject
    names (ListSubjects' results)."""

    def __init__(self, snapshot: Optional[GraphSnapshot]):
        self._ss_memo: dict = {}
        self._subj_memo: dict = {}
        if snapshot is not None:
            self.ns_names = {v: k for k, v in snapshot.ns_ids.items()}
            self.rel_names = {v: k for k, v in snapshot.rel_ids.items()}
            self.slot_to_obj = vocab_by_id(snapshot.obj_slots)
            self.subj_names = vocab_by_id(snapshot.subj_ids)

    def extended(self, overlay) -> "ExpandDecoder":
        """This decoder with a VocabOverlay's names added, in O(overlay):
        the base's reverse dicts are shared, the memos start empty."""
        if overlay is None:
            return self
        d = ExpandDecoder(None)
        d.ns_names = _ChainLookup(self.ns_names, {v: k for k, v in overlay.ns_ids.items()})
        d.rel_names = _ChainLookup(self.rel_names, {v: k for k, v in overlay.rel_ids.items()})
        d.slot_to_obj = _ChainLookup(self.slot_to_obj,
                                     {v: k for k, v in overlay.obj_slots.items()})
        d.subj_names = _ChainLookup(self.subj_names, {v: k for k, v in overlay.subj_ids.items()})
        return d

    def subject_set(self, obj_slot: int, rel: int) -> SubjectSet:
        key = (obj_slot, rel)
        ss = self._ss_memo.get(key)
        if ss is None:
            ns_id, obj = self.slot_to_obj[obj_slot]
            ss = SubjectSet(namespace=self.ns_names[ns_id], object=obj,
                            relation=self.rel_names[rel])
            if len(self._ss_memo) < _DECODER_MEMO_CAP:
                self._ss_memo[key] = ss
        return ss

    def subject_name(self, subj_id: int) -> str:
        name = self._subj_memo.get(subj_id)
        if name is None:
            name = self.subj_names[subj_id]
            if len(self._subj_memo) < _DECODER_MEMO_CAP:
                self._subj_memo[subj_id] = name
        return name


def _node_tuple(subject_set: SubjectSet) -> RelationTuple:
    return RelationTuple(namespace="", object="", relation="", subject_set=subject_set)


def assemble_tree(
    root: SubjectSet,
    root_slot: int,
    root_rel: int,
    depth: int,
    adjacency: dict[tuple[int, int], list[tuple[int, int, int]]],
    root_has_children: bool,
    decoder: ExpandDecoder,
) -> Optional[Tree]:
    """The reference's DFS over the gathered adjacency: visited-set cycle
    cut, restDepth accounting, nil-vs-leaf rules."""
    visited: set[tuple[int, int]] = set()

    def leaf(skind: int, sa: int, sb: int) -> Tree:
        t = RelationTuple(namespace="", object="", relation="")
        if skind == 1:
            t.subject_set = decoder.subject_set(sa, sb)
        else:
            t.subject_id = decoder.subj_names[sa]
        return Tree(type=TreeNodeType.LEAF, tuple=t)

    def build(obj_slot: int, rel: int, rest: int) -> Optional[Tree]:
        key = (obj_slot, rel)
        if key in visited:
            return None  # cycle cut: nil, the parent renders a leaf
        visited.add(key)
        children = adjacency.get(key)
        if not children:
            return None  # no matching tuples: nil
        node = Tree(type=TreeNodeType.UNION,
                    tuple=_node_tuple(decoder.subject_set(obj_slot, rel)))
        if rest <= 1:
            node.type = TreeNodeType.LEAF
            return node
        for skind, sa, sb in children:
            child = build(sa, sb, rest - 1) if skind == 1 else None
            node.children.append(child if child is not None else leaf(skind, sa, sb))
        return node

    if depth <= 1:
        # the root expands nothing: a leaf if its row is non-empty, else nil
        if not root_has_children:
            return None
        return Tree(type=TreeNodeType.LEAF, tuple=_node_tuple(root))
    return build(root_slot, root_rel, depth)


def decode_edge_buffer(
    eb_pobj, eb_prel, eb_skind, eb_sa, eb_sb, count: int, base: int
) -> dict[tuple[int, int], list[tuple[int, int, int]]]:
    """Edge records [base : base + count] -> adjacency keyed by parent
    node, deduped in first-emission order (a node expanded at two BFS
    steps emits its row twice)."""
    adjacency: dict[tuple[int, int], list[tuple[int, int, int]]] = {}
    seen: set[tuple] = set()
    end = base + count
    rows = zip(
        eb_pobj[base:end].tolist(), eb_prel[base:end].tolist(),
        eb_skind[base:end].tolist(), eb_sa[base:end].tolist(), eb_sb[base:end].tolist(),
    )
    for rec in rows:
        if rec in seen:
            continue
        seen.add(rec)
        adjacency.setdefault((rec[0], rec[1]), []).append(rec[2:])
    return adjacency

"""Leopard closure index, host half: per-node transitive-closure sets
packed into device hash tables, so that a deep check is one probe step.

Zanzibar's Leopard index answers a deep recursive check as a set
membership instead of a per-level walk: for every (object, relation)
node, the closure of subjects that reach it through the monotone rewrite
fragment, each with the least depth it needs. The closure is powered on
the host over the snapshot's own mirrors (sparse, level-synchronous,
min-plus over the required depth), and the product R·D (reachability
times direct-edge incidence) is packed into the same bucketized hash
layout as every other device table; engine/closure_kernel.py probes it.

The contract:
  - an answer comes from the index only when it was built from the very
    snapshot object the engine's state wraps (vocabulary ids never alias
    across rebuilds) and the query's node is covered and not dirty;
    anything else falls back to the BFS kernel under a cause-coded
    counter. A stale index costs latency, never a wrong answer.
  - "covered" means the powering proved the node's whole reachable
    region monotone (no AND/NOT islands, no host-only rewrites, no
    missing-config or relation-not-found semantics) and its closure set
    fits `closure.max_set_rows`; a covered node answers positives and
    negatives, with the exact least depth (`req`) of each entry.

A write keeps the engine's base snapshot and puts the ops in its delta
overlay, which the index has not seen: the index then declines every
query with `lag` until a compaction or a rebuild makes a new base, which
`ensure_for` powers (never on the check submit path). It marks no dirty
nodes and catches up no ops; the dirty-node table (`build_dirty_table`)
is kept so the kernel's dirty branch has real inputs in the tests.

`powering="device"` powers the closure on the index's device instead of
with numpy (engine/closure_power.py), array for array the same build.
Only `PoweringUnsupported`, raised before any launch, sends a build back
to the host builder, counted; a kernel that fails to build or launch
raises.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .delta import DeltaOverflow, _fixed_capacity_table
from .kernel import _pack_columns, pack_pair_table
from .snapshot import (
    EMPTY,
    FLAG_CONFIG_MISSING,
    FLAG_HOST_ONLY,
    FLAG_ISLAND,
    INSTR_COMPUTED,
    INSTR_TTU,
    GraphSnapshot,
    _build_hash_table,
)

# fixed-shape dirty-node table; probed DELTA_PROBES deep
CDIRTY_CAPACITY = 16384
# a graph whose node universe exceeds this serves without an index
MAX_CLOSURE_NODES = 1 << 20
DEFAULT_MAX_SET_ROWS = 4096

# host-side fallback causes (no launch happened); the kernel-side causes
# are in engine/closure_kernel.py. A disabled engine counts nothing.
CAUSE_UNBUILT = "unbuilt"
CAUSE_STALE_SNAPSHOT = "stale_snapshot"
# an index behind the state's covered version: the state wraps the
# index's base snapshot and an overlay of writes the index has not seen
CAUSE_LAG = "lag"


def _expand_spans(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate the ranges [starts[i], starts[i] + counts[i])."""
    if len(starts) == 0 or counts.sum() == 0:
        return np.zeros(0, dtype=np.int64)
    reps = np.repeat(starts.astype(np.int64), counts)
    total = int(counts.sum())
    offs = np.arange(total, dtype=np.int64)
    base = np.repeat(np.cumsum(counts) - counts, counts)
    return reps + (offs - base)


@dataclass
class ClosureGraph:
    """The powering operands of one snapshot, keyed by int64 node keys
    obj * R + rel: the cost-1 edge CSR (computed rewrites folded away),
    the folded direct-subject incidence, per-(ns, rel) poison, and the
    candidate sources."""

    R: int  # rel-id stride of the node key
    n_obj: int
    e_src_keys: np.ndarray  # [n_src] unique source keys, sorted
    e_ptr: np.ndarray  # [n_src + 1]
    e_dst: np.ndarray  # [n_edges] dst node keys
    d_node_keys: np.ndarray  # [n_dn] unique node keys, sorted
    d_ptr: np.ndarray  # [n_dn + 1]
    d_skind: np.ndarray
    d_sa: np.ndarray
    d_sb: np.ndarray
    fpoison: np.ndarray  # [n_ns, R] bool, folded through the 0-cost closure
    universe: np.ndarray  # sorted unique node keys
    objslot_ns: np.ndarray


@dataclass
class ClosureBuild:
    """One powering product over a ClosureGraph."""

    snapshot_version: int
    base_version: int
    covered_keys: np.ndarray  # sorted node keys proven covered
    # entries: (node obj, node rel, skind, sa, sb) -> least required depth
    ent_obj: np.ndarray
    ent_rel: np.ndarray
    ent_skind: np.ndarray
    ent_sa: np.ndarray
    ent_sb: np.ndarray
    ent_req: np.ndarray
    n_nodes: int = 0
    n_entries: int = 0
    build_s: float = 0.0
    vocab_fp: int = 0  # snapshot_vocab_fp of the snapshot it was powered over
    # entries were trimmed to req <= max_depth and coverage judged under
    # max_set_rows: the build is valid only for the same pair
    max_depth: int = 0
    max_set_rows: int = 0


def _rel_closure0(n_rels: int, comp_edges: list[tuple[int, int]]) -> list[set]:
    """closure0[r] = {r} and every relation reachable from r through
    computed rewrites (same depth)."""
    closure = [{r} for r in range(n_rels)]
    adj: dict[int, set[int]] = {}
    for a, b in comp_edges:
        adj.setdefault(a, set()).add(b)
    changed = True
    while changed:
        changed = False
        for r in range(n_rels):
            add = set()
            for m in closure[r]:
                add |= adj.get(m, set())
            if not add <= closure[r]:
                closure[r] |= add
                changed = True
    return closure


def snapshot_vocab_fp(snapshot: GraphSnapshot) -> int:
    """Fingerprint of a snapshot's id assignment: the direct-edge table
    hashes every encoded id in play."""
    h = hashlib.sha256()
    for a in (
        snapshot.dh_obj, snapshot.dh_rel, snapshot.dh_skind,
        snapshot.dh_sa, snapshot.dh_sb, snapshot.objslot_ns,
    ):
        h.update(np.ascontiguousarray(a).tobytes())
    return int.from_bytes(h.digest()[:8], "big") >> 1


def extract_graph(snapshot: GraphSnapshot) -> Optional[ClosureGraph]:
    """The powering operands of a snapshot's host mirrors, or None when
    the graph exceeds the closure's limits (node-key overflow, universe
    cap): the engine then serves without an index."""
    slot_ns = snapshot.objslot_ns
    R = max(len(snapshot.rel_ids), 1)
    n_obj = max(len(snapshot.obj_slots), 1)
    if max(n_obj, len(slot_ns)) * R >= (1 << 31):
        return None
    n_cfg = snapshot.n_config_rels
    n_ns = max(len(snapshot.ns_ids), 1)
    W = snapshot.wildcard_rel

    def key(obj, rel):
        return obj.astype(np.int64) * R + rel.astype(np.int64)

    # per-namespace rewrite structure (programs are object-independent)
    closure0: list[list[set]] = []
    ttu_by_rel: list[list[list[tuple[int, int]]]] = []  # [ns][r] -> [(trel, crel)]
    for ns in range(n_ns):
        comp = []
        ttus: list[list[tuple[int, int]]] = [[] for _ in range(R)]
        for r in range(n_cfg):
            pid = ns * n_cfg + r
            if pid >= len(snapshot.instr_kind):
                continue
            for k in range(snapshot.K):
                ik = int(snapshot.instr_kind[pid][k])
                if ik == INSTR_COMPUTED:
                    comp.append((r, int(snapshot.instr_rel[pid][k])))
                elif ik == INSTR_TTU:
                    ttus[r].append((int(snapshot.instr_rel[pid][k]),
                                    int(snapshot.instr_rel2[pid][k])))
        c0 = _rel_closure0(R, comp)
        closure0.append(c0)
        # T(r) = the TTUs of every r' in closure0(r)
        ttu_by_rel.append([[t for m in c0[r] for t in ttus[m]] for r in range(R)])

    # per-(ns, rel) poison, folded through closure0
    poison0 = np.zeros((n_ns, R), dtype=bool)
    has_cfg = snapshot.ns_has_config[:n_ns].astype(bool)
    for ns in range(n_ns):
        for r in range(R):
            if r < n_cfg:
                pid = ns * n_cfg + r
                flags = int(snapshot.prog_flags[pid]) if pid < len(snapshot.prog_flags) else 0
                if flags & (FLAG_HOST_ONLY | FLAG_CONFIG_MISSING | FLAG_ISLAND):
                    poison0[ns, r] = True
            elif has_cfg[ns]:
                # a data relation in a configured namespace: the
                # reference's relation-not-found error
                poison0[ns, r] = True
    fpoison = np.zeros((n_ns, R), dtype=bool)
    for ns in range(n_ns):
        for r in range(R):
            fpoison[ns, r] = any(poison0[ns, m] for m in closure0[ns][r])

    # raw content: direct edges and CSR rows
    dmask = snapshot.dh_val == 1
    d_obj, d_rel = snapshot.dh_obj[dmask], snapshot.dh_rel[dmask]
    d_skind, d_sa, d_sb = snapshot.dh_skind[dmask], snapshot.dh_sa[dmask], snapshot.dh_sb[dmask]
    rmask = snapshot.rh_row != EMPTY
    r_obj, r_rel, r_row = snapshot.rh_obj[rmask], snapshot.rh_rel[rmask], snapshot.rh_row[rmask]
    r_start = snapshot.row_ptr[r_row]
    r_count = snapshot.row_ptr[r_row + 1] - r_start
    e_payload_obj, e_payload_rel = snapshot.e_obj, snapshot.e_rel
    r_ns = slot_ns[np.clip(r_obj, 0, len(slot_ns) - 1)]
    d_ns = slot_ns[np.clip(d_obj, 0, len(slot_ns) - 1)]

    # fold content to parent relations: P0(ns, x) = {r : x in closure0(r)}
    p0: list[dict[int, np.ndarray]] = []
    for ns in range(n_ns):
        inv: dict[int, list[int]] = {}
        for r in range(R):
            for m in closure0[ns][r]:
                inv.setdefault(m, []).append(r)
        p0.append({x: np.array(sorted(v), dtype=np.int64) for x, v in inv.items()})

    def fold_sources(objs, rels, nss, fold_map):
        """(obj, x) content rows -> (row index, parent rel) per parent."""
        out_idx: list[np.ndarray] = []
        out_rel: list[np.ndarray] = []
        for ns in range(n_ns):
            m = nss == ns
            if not m.any():
                continue
            idx = np.flatnonzero(m)
            for x, parents in fold_map[ns].items():
                mm = idx[rels[idx] == x]
                if len(mm) == 0:
                    continue
                out_idx.append(np.repeat(mm, len(parents)))
                out_rel.append(np.tile(parents, len(mm)))
        if not out_idx:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(out_idx), np.concatenate(out_rel)

    # folded direct incidence: (o, r) owns subject s when some x in
    # closure0(r) has the raw direct edge (o, x, s)
    fd_idx, fd_rel = fold_sources(d_obj, d_rel, d_ns, p0)
    fd_key = d_obj[fd_idx].astype(np.int64) * R + fd_rel
    fd_skind, fd_sa, fd_sb = d_skind[fd_idx], d_sa[fd_idx], d_sb[fd_idx]

    # folded expand-subject edges: rows (o, x) expand from (o, r) for r in
    # P0(x); wildcard-relation sets are skipped
    fe_idx, fe_rel = fold_sources(r_obj, r_rel, r_ns, p0)
    src_keys_rows = r_obj[fe_idx].astype(np.int64) * R + fe_rel
    epos = _expand_spans(r_start[fe_idx], r_count[fe_idx])
    esrc = np.repeat(src_keys_rows, r_count[fe_idx])
    edst_obj = e_payload_obj[epos] if len(epos) else np.zeros(0, np.int32)
    edst_rel = e_payload_rel[epos] if len(epos) else np.zeros(0, np.int32)
    keep = edst_rel != W
    e1_src = esrc[keep]
    e1_dst = key(edst_obj[keep], edst_rel[keep])

    # folded TTU edges: rows (o, trel) jump from (o, r) for every
    # (trel, crel) in T(r) to (child obj, crel); wildcard sets kept
    tt_src: list[np.ndarray] = []
    tt_dst: list[np.ndarray] = []
    for ns in range(n_ns):
        m = r_ns == ns
        if not m.any():
            continue
        idx = np.flatnonzero(m)
        pairs: dict[int, list[tuple[int, int]]] = {}
        for r in range(R):
            for trel, crel in ttu_by_rel[ns][r]:
                pairs.setdefault(trel, []).append((r, crel))
        for trel, rcs in pairs.items():
            rows = idx[r_rel[idx] == trel]
            if len(rows) == 0:
                continue
            pos = _expand_spans(r_start[rows], r_count[rows])
            robj = np.repeat(r_obj[rows].astype(np.int64), r_count[rows])
            cobj = e_payload_obj[pos].astype(np.int64)
            for r, crel in rcs:
                tt_src.append(robj * R + r)
                tt_dst.append(cobj * R + crel)
    if tt_src:
        e1_src = np.concatenate([e1_src] + tt_src)
        e1_dst = np.concatenate([e1_dst] + tt_dst)

    def group(keys, vals):
        if len(keys) == 0:
            return np.zeros(0, np.int64), np.zeros(1, np.int64), np.zeros(0, np.int64)
        order = np.argsort(keys, kind="stable")
        k, v = keys[order], vals[order]
        uniq, starts = np.unique(k, return_index=True)
        return uniq, np.append(starts, len(k)).astype(np.int64), v

    e_src_keys, e_ptr, e_dst = group(e1_src, e1_dst)
    dk_keys, d_ptr, d_order = group(fd_key, np.arange(len(fd_key), dtype=np.int64))
    if len(d_order):
        fd_skind, fd_sa, fd_sb = fd_skind[d_order], fd_sa[d_order], fd_sb[d_order]

    # the universe: every node whose folded structure is non-trivial
    universe = np.unique(np.concatenate([e_src_keys, dk_keys]))
    if len(universe) > MAX_CLOSURE_NODES:
        return None
    return ClosureGraph(
        R=R, n_obj=n_obj, e_src_keys=e_src_keys, e_ptr=e_ptr, e_dst=e_dst,
        d_node_keys=dk_keys, d_ptr=d_ptr, d_skind=fd_skind, d_sa=fd_sa, d_sb=fd_sb,
        fpoison=fpoison, universe=universe, objslot_ns=slot_ns,
    )


def _lookup_spans(sorted_keys: np.ndarray, ptr: np.ndarray, queries: np.ndarray):
    """(starts, counts) of each query key's group in a grouped CSR
    (count 0 for absent keys)."""
    if len(sorted_keys) == 0 or len(queries) == 0:
        z = np.zeros(len(queries), dtype=np.int64)
        return z, z
    pos = np.searchsorted(sorted_keys, queries)
    pos_c = np.clip(pos, 0, len(sorted_keys) - 1)
    hit = sorted_keys[pos_c] == queries
    starts = np.where(hit, ptr[pos_c], 0)
    counts = np.where(hit, ptr[np.clip(pos_c + 1, 0, len(ptr) - 1)] - ptr[pos_c], 0)
    return starts, counts


def node_poison_keys(graph: ClosureGraph, keys: np.ndarray) -> np.ndarray:
    """Per-node poison: key (o, r) is poisoned when the folded (ns(o), r)
    cell is (relation-not-found, AND/NOT islands, host-only rewrites)."""
    obj = (keys // graph.R).astype(np.int64)
    rel = (keys % graph.R).astype(np.int64)
    slot_ns = graph.objslot_ns
    nss = np.clip(slot_ns[np.clip(obj, 0, len(slot_ns) - 1)], 0, graph.fpoison.shape[0] - 1)
    return graph.fpoison[nss, np.clip(rel, 0, graph.fpoison.shape[1] - 1)]


def power_closure(
    graph: ClosureGraph,
    snapshot: GraphSnapshot,
    max_depth: int,
    max_set_rows: int,
    base_version: int,
    sources: Optional[np.ndarray] = None,
) -> ClosureBuild:
    """Multi-source level-synchronous powering: each source's reach grows
    one cost-1 edge per round, and the first round that discovers a node
    is its least distance. Sources whose reach or subject set outgrows
    `max_set_rows`, or that reach a poisoned node, leave the coverage.
    `sources` overrides the powered node set."""
    t0 = time.perf_counter()
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
    if n_src == 0:
        build.build_s = time.perf_counter() - t0
        return build

    uncovered = np.zeros(n_src, dtype=bool)

    # reach pairs as (src_index << 32) | dst_key, dst_key < 2^31
    def pair(src_idx, dst):
        return (src_idx.astype(np.int64) << 32) | dst.astype(np.int64)

    seen = pair(np.arange(n_src, dtype=np.int64), srcs)
    order = np.argsort(seen)
    seen = seen[order]
    seen_level = np.zeros(n_src, dtype=np.int32)[order]
    f_src = np.arange(n_src, dtype=np.int64)
    f_dst = srcs.copy()
    level = 0
    # one level past the subject horizon: relation-not-found and island
    # semantics fire at a node reached with remaining depth 0, so poison
    # must propagate from that ring; the req <= max_depth trim below
    # drops the entries it contributes
    while len(f_src) and level < max_depth:
        starts, counts = _lookup_spans(graph.e_src_keys, graph.e_ptr, f_dst)
        pos = _expand_spans(starts, counts)
        n_src_rep = np.repeat(f_src, counts)
        n_dst = graph.e_dst[pos] if len(pos) else np.zeros(0, np.int64)
        if len(n_dst) == 0:
            break
        cand = pair(n_src_rep, n_dst)
        cand, first = np.unique(cand, return_index=True)
        n_src_rep, n_dst = n_src_rep[first], n_dst[first]
        # drop pairs already seen (seen stays sorted)
        ins_c = np.clip(np.searchsorted(seen, cand), 0, len(seen) - 1)
        fresh = ~((len(seen) > 0) & (seen[ins_c] == cand))
        cand, n_src_rep, n_dst = cand[fresh], n_src_rep[fresh], n_dst[fresh]
        if len(cand) == 0:
            break
        level += 1
        seen = np.concatenate([seen, cand])
        seen_level = np.concatenate([seen_level, np.full(len(cand), level, dtype=np.int32)])
        order = np.argsort(seen, kind="stable")
        seen, seen_level = seen[order], seen_level[order]
        # per-source reach cap: oversized sources leave the coverage and
        # stop expanding
        over = np.bincount((seen >> 32).astype(np.int64), minlength=n_src) > max_set_rows
        if over.any():
            uncovered |= over
            live = ~uncovered[n_src_rep]
            n_src_rep, n_dst = n_src_rep[live], n_dst[live]
        f_src, f_dst = n_src_rep, n_dst

    r_src = (seen >> 32).astype(np.int64)
    r_dst = (seen & 0xFFFFFFFF).astype(np.int64)

    # a reachable poisoned node uncovers the source
    if len(r_dst):
        bad = node_poison_keys(graph, r_dst)
        if bad.any():
            uncovered[np.unique(r_src[bad])] = True

    # subject product R·D: reach pairs joined with the folded direct sets
    starts, counts = _lookup_spans(graph.d_node_keys, graph.d_ptr, r_dst)
    pos = _expand_spans(starts, counts)
    p_src = np.repeat(r_src, counts)
    p_req = np.repeat(seen_level + 1, counts)  # the direct probe costs 1
    if len(pos):
        p_skind, p_sa, p_sb = graph.d_skind[pos], graph.d_sa[pos], graph.d_sb[pos]
        # dedupe (src, subject) keeping the least required depth
        order = np.lexsort((p_req, p_sb, p_sa, p_skind, p_src))
        p_src, p_req = p_src[order], p_req[order]
        p_skind, p_sa, p_sb = p_skind[order], p_sa[order], p_sb[order]
        first = np.ones(len(p_src), dtype=bool)
        first[1:] = ~(
            (p_src[1:] == p_src[:-1]) & (p_skind[1:] == p_skind[:-1])
            & (p_sa[1:] == p_sa[:-1]) & (p_sb[1:] == p_sb[:-1])
        )
        p_src, p_req = p_src[first], p_req[first]
        p_skind, p_sa, p_sb = p_skind[first], p_sa[first], p_sb[first]
        # entries past the global depth clamp can never be asked for
        fits = p_req <= max_depth
        p_src, p_req = p_src[fits], p_req[fits]
        p_skind, p_sa, p_sb = p_skind[fits], p_sa[fits], p_sb[fits]
        uncovered |= np.bincount(p_src, minlength=n_src) > max_set_rows
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
    build.build_s = time.perf_counter() - t0
    return build


def _empty_columns(width: int) -> list[np.ndarray]:
    return [np.full(64, EMPTY, np.int32) for _ in range(width)]


def pack_closure_tables(build: ClosureBuild, R: int, layout: str) -> tuple[dict, int, int]:
    """The closure kernel's tables in `layout`: `cc_pack`, the covered
    nodes as (obj, rel) -> 1 pair rows, and `ch_pack`, the entries as
    (obj, rel, skind, sa, sb) -> req edge rows. Returns (tables, cc_probes,
    ch_probes); the dirty table (`cd_pack`) is built apart."""
    cov_obj = (build.covered_keys // R).astype(np.int32)
    cov_rel = (build.covered_keys % R).astype(np.int32)
    if len(cov_obj):
        *cc, cc_probes = _build_hash_table(
            (cov_obj, cov_rel), np.ones(len(cov_obj), dtype=np.int32), layout
        )
    else:
        cc, cc_probes = _empty_columns(3), 1
    if len(build.ent_obj):
        *ch, ch_probes = _build_hash_table(
            (build.ent_obj, build.ent_rel, build.ent_skind, build.ent_sa, build.ent_sb),
            build.ent_req.astype(np.int32), layout,
        )
    else:
        ch, ch_probes = _empty_columns(6), 1
    tables = {"cc_pack": pack_pair_table(*cc), "ch_pack": _pack_columns(ch, 8)}
    return tables, cc_probes, ch_probes


def empty_dirty_table() -> np.ndarray:
    e = np.full(CDIRTY_CAPACITY, EMPTY, np.int32)
    return pack_pair_table(e, e, e)


def build_dirty_table(dirty_keys: np.ndarray, R: int, layout: str) -> Optional[np.ndarray]:
    """The fixed-shape dirty-node pair table of node keys, or None when
    they do not fit its capacity and probe depth."""
    if len(dirty_keys) == 0:
        return empty_dirty_table()
    if len(dirty_keys) * 4 > CDIRTY_CAPACITY:
        return None
    obj = (dirty_keys // R).astype(np.int32)
    rel = (dirty_keys % R).astype(np.int32)
    try:
        cols = _fixed_capacity_table(
            (obj, rel), np.ones(len(obj), dtype=np.int32), CDIRTY_CAPACITY, layout
        )
    except DeltaOverflow:
        return None
    return pack_pair_table(*cols)


class ClosureView:
    """One consistent handle the submit path captures: device tables and
    static probe depths of one build."""

    __slots__ = ("tables", "cc_probes", "ch_probes", "layout")

    def __init__(self, tables, cc_probes, ch_probes, layout):
        self.tables = tables
        self.cc_probes = cc_probes
        self.ch_probes = ch_probes
        self.layout = layout


POWERINGS = ("host", "device")


class ClosureIndex:
    """Per-engine Leopard index: one build, its tables on `device`, powered
    on the host or (`powering="device"`) on `device`. Thread-safe;
    powering runs outside the lock."""

    def __init__(self, nid: str, device, max_set_rows: int = DEFAULT_MAX_SET_ROWS,
                 powering: str = "host"):
        if powering not in POWERINGS:
            raise ValueError(f"closure.powering must be one of {POWERINGS}, not {powering!r}")
        self.nid = nid
        self.device = device
        self.max_set_rows = int(max_set_rows)
        self.powering = powering
        # the device buffers of the last device build's widest wave, as
        # P1-P3 hold them (closure_power.device_power_bytes)
        self._power_hbm: dict = {}
        self._mu = threading.Lock()
        self._graph: Optional[ClosureGraph] = None
        self._build: Optional[ClosureBuild] = None
        self._view: Optional[ClosureView] = None
        self._snapshot: Optional[GraphSnapshot] = None
        self._synced_version = -1
        # seconds of the last build's stages
        self.last_build: dict = {}
        self.stats = {"builds": 0, "device_builds": 0, "device_fallbacks": 0,
                      "power_waves": 0, "power_steps": 0}

    def ensure_for(self, state, max_depth: int) -> bool:
        """Build the index for `state`'s base snapshot unless it is built
        for that very snapshot object; returns whether it serves `state`.
        Over an unchanged base the index is not powered again, whatever
        the overlay holds: a powering would read the same pre-write base.
        It serves again once a compaction or a rebuild makes a new base.
        Never called on the check submit path: a powering there would
        stall a batch."""
        snap = state.snapshot
        with self._mu:
            same_snapshot = self._build is not None and self._snapshot is snap
        if not same_snapshot:
            self._rebuild(snap, state.base_version, max_depth)
        return self.view_for(state)[0] is not None

    def _rebuild(self, snap: GraphSnapshot, base_version: int, max_depth: int) -> None:
        from .closure_kernel import closure_tables_from_numpy

        t0 = time.perf_counter()
        graph = extract_graph(snap)
        t1 = time.perf_counter()
        build, split = None, {}
        if graph is not None:
            build, split = self._power(graph, snap, max_depth, base_version)
            self.stats["builds"] += 1
        t2 = time.perf_counter()
        view = None
        if build is not None:
            # no cd_pack: the index serves no overlay (CAUSE_LAG), so no
            # node turns dirty
            tables, cc_probes, ch_probes = pack_closure_tables(build, graph.R, snap.layout)
            t3 = time.perf_counter()
            dev = closure_tables_from_numpy(tables, self.device)
            view = ClosureView(dev, cc_probes, ch_probes, snap.layout)
        t4 = time.perf_counter()
        self.last_build = {"extract_s": t1 - t0, "power_s": t2 - t1, **split}
        if build is not None:
            self.last_build.update(pack_s=t3 - t2, upload_s=t4 - t3)
        with self._mu:
            self._graph = graph
            self._build = build
            self._snapshot = snap
            self._synced_version = base_version if build is not None else -1
            self._view = view

    def _power(self, graph: ClosureGraph, snap: GraphSnapshot, max_depth: int,
               base_version: int) -> tuple[ClosureBuild, dict]:
        """Power one build with the configured builder: (build, the part of
        last_build it adds). On the device, the build's seconds split into
        host subgraph preparation and waves; a PoweringUnsupported shape
        is powered on the host, counted, with its reason kept."""
        fallback = {}
        if self.powering == "device":
            from .closure_power import PoweringUnsupported, power_closure_device

            try:
                build, record = power_closure_device(
                    graph, snap, max_depth, self.max_set_rows, base_version,
                    device=self.device)
            except PoweringUnsupported as exc:
                self.stats["device_fallbacks"] += 1
                fallback = {"power_fallback": str(exc)}
            else:
                self.stats["device_builds"] += 1
                self.stats["power_waves"] += record["waves"]
                self.stats["power_steps"] += record["steps"]
                self._power_hbm = dict(record["device_hbm"])
                return build, {"power_prep_s": record["prep_s"],
                               "power_wave_s": record["wave_s"]}
        return power_closure(graph, snap, max_depth, self.max_set_rows, base_version), fallback

    def view_for(self, state) -> tuple[Optional[ClosureView], Optional[str]]:
        """The device view for one submit, or (None, cause). Never touches
        the store."""
        with self._mu:
            view, build, snap_ref = self._view, self._build, self._snapshot
            synced = self._synced_version
        if build is None:
            return None, CAUSE_UNBUILT
        if view is None or snap_ref is not state.snapshot:
            # object identity: entries live in the build snapshot's ids
            return None, CAUSE_STALE_SNAPSHOT
        if synced < state.covered_version:
            # the state's overlay holds writes the index never saw: a
            # deleted grant would still read as allowed
            return None, CAUSE_LAG
        return view, None

    def needs_rebuild(self) -> bool:
        with self._mu:
            return self._build is None

    def describe(self) -> dict:
        with self._mu:
            build = self._build
            return {
                "built": build is not None,
                "synced_version": self._synced_version,
                "covered_nodes": len(build.covered_keys) if build is not None else 0,
                "entries": build.n_entries if build is not None else 0,
                "universe": len(self._graph.universe) if self._graph is not None else 0,
                "powering": self.powering,
                "power_hbm": dict(self._power_hbm),
                **self.last_build,
                **self.stats,
            }

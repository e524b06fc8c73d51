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
    across rebuilds), its synced version has reached the state's covered
    version (every write since the base is folded into its dirty marks),
    and the query's node is covered and not dirty; anything else falls
    back to the BFS kernel under a cause-coded counter. A lagging index
    costs latency, never a wrong answer.
  - "covered" means the powering proved the node's whole reachable
    region monotone (no AND/NOT islands, no host-only rewrites, no
    missing-config or relation-not-found semantics) and its closure set
    fits `closure.max_set_rows`; a covered node answers positives and
    negatives, with the exact least depth (`req`) of each entry.
  - a write marks nodes dirty instead of powering again: an op's change
    sites are its object's consulting relations (the per-namespace
    `consult` map), and every transitive ancestor over the transposed
    dependency CSR is marked (`catch_up`, `apply_changes`); the marks go
    to the device as the `cd` table, which C1 probes. `refresh_dirty`
    then powers only the dirty nodes again from the store's current
    content, read region by region, and merges their rows back. Past
    DIRTY_COMPACT_THRESHOLD marks, or a truncated change log, the index
    turns stale until a new base is powered.

`powering="device"` powers the closure on the index's device instead of
with numpy (engine/closure_power.py), array for array the same build, a
refresh's dirty sources included. Only `PoweringUnsupported`, raised
before any launch, sends a build back to the host powering, counted; a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .delta import DeltaOverflow, SnapshotView, _fixed_capacity_table
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
    vocab_by_id,
)

# fixed-shape dirty-node table; probed DELTA_PROBES deep
CDIRTY_CAPACITY = 16384
# past this many dirty nodes the index turns stale instead of adding
# fallbacks (the dirty table is a quarter full at this count)
DIRTY_COMPACT_THRESHOLD = CDIRTY_CAPACITY // 4
# a graph whose node universe exceeds this serves without an index
MAX_CLOSURE_NODES = 1 << 20
DEFAULT_MAX_SET_ROWS = 4096
# versions a check may catch a lagging index up inline
DEFAULT_LAG_BUDGET = 64

# host-side fallback causes (no launch happened); the kernel-side causes
# are in engine/closure_kernel.py. A disabled engine counts nothing.
CAUSE_UNBUILT = "unbuilt"
CAUSE_STALE_SNAPSHOT = "stale_snapshot"
# an index behind the state's covered version: the state's overlay holds
# writes the index has not folded into its dirty marks
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
    the folded direct-subject incidence, per-(ns, rel) poison, the
    candidate sources, and for dirty marking the transposed dependency
    CSR and the per-namespace consult map."""

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
    t_dst_keys: np.ndarray  # unique edge destinations, sorted
    t_ptr: np.ndarray
    t_src: np.ndarray  # their predecessors' node keys
    # consult[ns][x]: the sorted relations r whose node (o, r) an op at
    # row (o, x) changes
    consult: list
    universe: np.ndarray  # sorted unique node keys
    # slot -> ns under the vocabulary the graph was encoded with
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


def extract_graph(
    snapshot: GraphSnapshot,
    content: Optional[tuple] = None,
    objslot_ns: Optional[np.ndarray] = None,
) -> Optional[ClosureGraph]:
    """The powering operands of a snapshot's host mirrors, or None when
    the graph exceeds the closure's limits (node-key overflow, universe
    cap): the engine then serves without an index.

    `content` replaces the snapshot's edge tables by encoded edge arrays
    (t_obj, t_rel, t_skind, t_sa, t_sb), the dirty refresh's store read;
    `objslot_ns` replaces the slot -> namespace array for content encoded
    under an overlay view, whose slots lie past the base array."""
    slot_ns = objslot_ns if objslot_ns is not None else snapshot.objslot_ns
    # the node-key stride is the base's relation count, for every build
    # and refresh of one index (merged entries mix): rows with overlay-era
    # relations never reach here (_store_content skips them)
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
    if content is not None:
        t_obj, t_rel, t_skind, t_sa, t_sb = (np.asarray(a, dtype=np.int32) for a in content)
        d_obj, d_rel, d_skind, d_sa, d_sb = t_obj, t_rel, t_skind, t_sa, t_sb
        # the subject-set rows grouped into a local CSR, by (obj, rel)
        is_set = t_skind == 1
        s_obj, s_rel = t_obj[is_set], t_rel[is_set]
        e_payload_obj, e_payload_rel = t_sa[is_set], t_sb[is_set]
        if len(s_obj):
            order = np.lexsort((np.arange(len(s_obj)), s_rel, s_obj))
            s_obj, s_rel = s_obj[order], s_rel[order]
            e_payload_obj, e_payload_rel = e_payload_obj[order], e_payload_rel[order]
            change = np.empty(len(s_obj), dtype=bool)
            change[0] = True
            change[1:] = (s_obj[1:] != s_obj[:-1]) | (s_rel[1:] != s_rel[:-1])
            starts = np.flatnonzero(change)
            r_obj, r_rel = s_obj[starts], s_rel[starts]
            r_start = starts.astype(np.int64)
            r_count = np.append(starts[1:], len(s_obj)) - starts
        else:
            r_obj = r_rel = np.zeros(0, np.int32)
            r_start = r_count = np.zeros(0, np.int64)
    else:
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

    # namespaces first seen in an overlay have no config: a trivial
    # closure0, no rewrites, no poison; their rows stay in the fold
    n_ns_total = max([n_ns] + [int(a.max()) + 1 for a in (r_ns, d_ns) if len(a)])
    if n_ns_total > n_ns:
        trivial_c0 = [{r} for r in range(R)]
        trivial_ttu: list[list[tuple[int, int]]] = [[] for _ in range(R)]
        closure0 += [trivial_c0] * (n_ns_total - n_ns)
        ttu_by_rel += [trivial_ttu] * (n_ns_total - n_ns)
        fpoison = np.pad(fpoison, ((0, n_ns_total - n_ns), (0, 0)))
        n_ns = n_ns_total

    # fold content to parent relations: P0(ns, x) = {r : x in closure0(r)};
    # the consult map adds the TTUs: an op at row (o, x) changes the
    # nodes (o, r) for r in consult[ns][x]
    p0: list[dict[int, np.ndarray]] = []
    consult: list[dict[int, np.ndarray]] = []
    for ns in range(n_ns):
        inv: dict[int, list[int]] = {}
        cons: dict[int, set[int]] = {}
        for r in range(R):
            for m in closure0[ns][r]:
                inv.setdefault(m, []).append(r)
                cons.setdefault(m, set()).add(r)
            for trel, _crel in ttu_by_rel[ns][r]:
                cons.setdefault(trel, set()).add(r)
        p0.append({x: np.array(sorted(v), dtype=np.int64) for x, v in inv.items()})
        consult.append({x: np.array(sorted(v), dtype=np.int64) for x, v in cons.items()})

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

    # the edges by source (powering) and by destination (dirty marking)
    e_src_keys, e_ptr, e_dst = group(e1_src, e1_dst)
    t_dst_keys, t_ptr, t_src = group(e1_dst, e1_src)
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
        fpoison=fpoison, t_dst_keys=t_dst_keys, t_ptr=t_ptr, t_src=t_src, consult=consult,
        universe=universe, objslot_ns=slot_ns,
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
    """One consistent handle the submit path captures: the device tables
    and static probe depths of one build, its dirty marks (`has_dirty`:
    the launch probes the cd table) and the version they are synced to."""

    __slots__ = ("tables", "cc_probes", "ch_probes", "layout", "has_dirty",
                 "snapshot_version", "synced_version", "R")

    def __init__(self, tables, cc_probes, ch_probes, layout, has_dirty, snapshot_version,
                 synced_version, R):
        self.tables = tables
        self.cc_probes = cc_probes
        self.ch_probes = ch_probes
        self.layout = layout
        self.has_dirty = has_dirty
        self.snapshot_version = snapshot_version
        self.synced_version = synced_version
        self.R = R


POWERINGS = ("host", "device")


def _node_row(encoder, t, R: int):
    """(node, row) of one stored tuple under `encoder`: `row` is its
    (obj, rel, skind, sa, sb) content row, or None when the tuple cannot
    be keyed; `node` is the tuple's (obj, rel) when its node encodes but
    its subject does not (its region must stay dirty), else None."""
    node = encoder.encode_node(t.namespace, t.object, t.relation)
    if node is not None and node[1] >= R:
        # an overlay-era relation on the node: a predecessor reaches it
        # only through an edge row reported (or included) under its key
        return None, None
    subj = encoder.encode_subject(t)
    if node is None or subj is None or (subj[0] == 1 and subj[2] >= R):
        # a row whose node does not encode is reachable only through an
        # edge whose own row is present or itself reported
        return node, None
    return None, (node[0], node[1], subj[0], subj[1], subj[2])


def _content_arrays(rows: list) -> tuple:
    cols = np.array(rows, dtype=np.int32).reshape(-1, 5)
    return tuple(np.ascontiguousarray(cols[:, i]) for i in range(5))


class ClosureIndex:
    """Per-engine Leopard index: one build, its tables on `device`,
    powered on the host or (`powering="device"`) on `device`, and the
    dirty marks of the writes since its base. Thread-safe; powering and
    every store read run outside the lock."""

    def __init__(self, nid: str, device, max_set_rows: int = DEFAULT_MAX_SET_ROWS,
                 powering: str = "host", lag_budget_versions: int = DEFAULT_LAG_BUDGET):
        if powering not in POWERINGS:
            raise ValueError(f"closure.powering must be one of {POWERINGS}, not {powering!r}")
        self.nid = nid
        self.device = device
        self.max_set_rows = int(max_set_rows)
        self.powering = powering
        self.lag_budget_versions = int(lag_budget_versions)
        # the device buffers of the last device build's widest wave, as
        # P1-P3 hold them (closure_power.device_power_bytes)
        self._power_hbm: dict = {}
        self._mu = threading.Lock()
        self._graph: Optional[ClosureGraph] = None
        self._build: Optional[ClosureBuild] = None
        self._view: Optional[ClosureView] = None
        self._snapshot: Optional[GraphSnapshot] = None
        self._synced_version = -1
        self._dirty: set[int] = set()
        # a dirty overflow or a truncated change log: powering required
        self._stale = False
        # what ops encode through for dirty marking: the base snapshot's
        # view, then the overlay view the engine serves (ensure_for) or
        # the last refresh read its content under. It must cover every
        # object the graph's edges reach, or a write there marks nothing.
        self._encoder: Optional[SnapshotView] = None
        # bumped by every apply_changes: a refresh whose re-mark read
        # predates a mark aborts its install (the marks would be cleared
        # while the synced version moved past them)
        self._marks_gen = 0
        # seconds of the last build's and the last refresh's stages
        self.last_build: dict = {}
        self.last_refresh: dict = {}
        self.stats = {"builds": 0, "applied_ops": 0, "dirty_nodes": 0, "rebuild_pending": 0,
                      "refreshes": 0, "scoped_refreshes": 0, "refresh_rows_read": 0,
                      "full_refresh_reads": 0, "device_builds": 0, "device_fallbacks": 0,
                      "power_waves": 0, "power_steps": 0}

    # -- build -----------------------------------------------------------------

    def ensure_for(self, state, manager, max_depth: int) -> bool:
        """Build the index for `state`'s base snapshot unless it is built
        for that very snapshot object, then fold every write between the
        base version and the state's covered version into the dirty
        marks. Returns whether it serves `state`. Never called on the
        check submit path: a powering there would stall a batch."""
        snap = state.snapshot
        with self._mu:
            same_snapshot = self._build is not None and self._snapshot is snap
            current = same_snapshot and not self._stale
            # a stale index over an unchanged base is not powered again:
            # the powering would read the same base, and the catch-up
            # would re-mark the same oversized set (or meet the same
            # truncated log). The engine's compaction makes a new base.
            stuck = same_snapshot and self._stale
            # a base whose universe extract_graph refused is refused again
            # over the same snapshot: skip the re-extraction that the
            # maintainer's every pass would otherwise repeat
            refused = self._graph is None and self._snapshot is snap
            if current:
                # the ops at objects first seen after the base mark their
                # own sites under the served overlay, and the dirty
                # refresh powers them into coverage
                self._encoder = state.view
        if not current and not stuck and not refused:
            self._rebuild(snap, state.base_version, max_depth)
        return self.catch_up(manager, state.covered_version)

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
            tables, cc_probes, ch_probes = pack_closure_tables(build, graph.R, snap.layout)
            tables["cd_pack"] = empty_dirty_table()
            t3 = time.perf_counter()
            dev = closure_tables_from_numpy(tables, self.device)
            view = ClosureView(dev, cc_probes, ch_probes, snap.layout, False,
                               build.snapshot_version, base_version, graph.R)
        t4 = time.perf_counter()
        self.last_build = {"extract_s": t1 - t0, "power_s": t2 - t1, **split}
        if build is not None:
            self.last_build.update(pack_s=t3 - t2, upload_s=t4 - t3)
        with self._mu:
            self._graph = graph
            self._build = build
            self._snapshot = snap
            self._encoder = SnapshotView(snap)
            self._dirty = set()
            self._stale = build is None
            self._synced_version = base_version if build is not None else -1
            self._view = view

    def _power(self, graph: ClosureGraph, snap: GraphSnapshot, max_depth: int,
               base_version: int, sources=None) -> tuple[ClosureBuild, dict]:
        """Power one build, or the `sources` of a refresh, with the
        configured powering: (build, the part of last_build it adds). On
        the device, the build's seconds split into host subgraph
        preparation and waves; a PoweringUnsupported shape is powered on
        the host, counted, with its reason kept."""
        fallback = {}
        if self.powering == "device":
            from .closure_power import PoweringUnsupported, power_closure_device

            try:
                build, record = power_closure_device(
                    graph, snap, max_depth, self.max_set_rows, base_version, sources=sources,
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
        return power_closure(graph, snap, max_depth, self.max_set_rows, base_version,
                             sources=sources), fallback

    # -- dirty marks -------------------------------------------------------------

    def catch_up(self, manager, through_version: int) -> bool:
        """Fold the ops committed in (synced, through_version] into the
        dirty marks, read from the store's change log outside the lock.
        Returns whether the index serves through_version."""
        with self._mu:
            if self._build is None or self._stale:
                return False
            synced = self._synced_version
        if synced >= through_version:
            return True
        ops = manager.changes_since(synced, nid=self.nid)
        if ops is None:
            # a truncated change log: the gap cannot be marked
            self.mark_stale()
            return False
        return self.apply_changes(ops, through_version)

    def _sites(self, graph: ClosureGraph, nodes) -> list[int]:
        """The change sites of (obj, rel) nodes: each node and its
        object's consulting relations."""
        sites: list[int] = []
        slot_ns = graph.objslot_ns
        for obj, rel in nodes:
            ns = int(slot_ns[obj]) if obj < len(slot_ns) else 0
            cons = graph.consult[ns].get(rel) if ns < len(graph.consult) else None
            rels = set(cons.tolist()) if cons is not None else set()
            rels.add(rel)
            sites += [int(obj) * graph.R + int(r) for r in rels]
        return sites

    def apply_changes(self, changes, through_version: int) -> bool:
        """Mark the transitive ancestors of every change's sites dirty,
        then advance the synced version; `changes` are (op,
        RelationTuple) pairs. Ops at or below the synced version are
        already marked or refreshed."""
        from .closure_kernel import closure_tables_from_numpy

        with self._mu:
            build, graph, encoder = self._build, self._graph, self._encoder
            if build is None or graph is None or self._stale:
                return False
            if through_version <= self._synced_version:
                # a replay must not mark again nodes a refresh cleared
                return True
        nodes = []
        for _op, t in changes:
            # the graph's own encoder: a write at an object a refresh
            # brought in must mark, which the base snapshot cannot encode
            node = encoder.encode_node(t.namespace, t.object, t.relation)
            if node is None or node[1] >= graph.R:
                # names the encoder lacks: their influence on a covered
                # node flows through an edge whose own op marks
                continue
            nodes.append(node)
        new_dirty = self._ancestors(graph, self._sites(graph, nodes))
        with self._mu:
            if self._build is not build or self._stale:
                return False
            self._marks_gen += 1
            self._dirty |= new_dirty
            self.stats["applied_ops"] += len(changes)
            self.stats["dirty_nodes"] = len(self._dirty)
            cd = None
            if len(self._dirty) <= DIRTY_COMPACT_THRESHOLD:
                cd = build_dirty_table(
                    np.fromiter(self._dirty, dtype=np.int64, count=len(self._dirty)),
                    graph.R, self._snapshot.layout)
            if cd is None:
                self._stale = True
                self.stats["rebuild_pending"] += 1
                return False
            old = self._view
            tables = {**old.tables, **closure_tables_from_numpy({"cd_pack": cd}, self.device)}
            self._synced_version = max(self._synced_version, through_version)
            self._view = ClosureView(tables, old.cc_probes, old.ch_probes, old.layout,
                                     bool(self._dirty), old.snapshot_version,
                                     self._synced_version, old.R)
            return True

    @staticmethod
    def _ancestors(graph: ClosureGraph, sites: list[int]) -> set[int]:
        """Reverse BFS over the transposed dependency CSR from every
        change site (a site is its own ancestor)."""
        out: set[int] = set(sites)
        frontier = np.array(sorted(out), dtype=np.int64)
        while len(frontier):
            starts, counts = _lookup_spans(graph.t_dst_keys, graph.t_ptr, frontier)
            pos = _expand_spans(starts, counts)
            preds = graph.t_src[pos] if len(pos) else np.zeros(0, np.int64)
            fresh = [p for p in np.unique(preds).tolist() if p not in out]
            out.update(fresh)
            frontier = np.array(fresh, dtype=np.int64)
        return out

    def mark_stale(self) -> None:
        """The change log lost the thread: the index declines every query
        until it is powered again."""
        with self._mu:
            self._stale = True

    # -- the dirty refresh ---------------------------------------------------------

    def refresh_dirty(self, manager, max_depth: int, view=None) -> bool:
        """Power only the dirty nodes again from the store's current
        content and merge their rows into the build: the hits resume
        without a powering of the whole universe or a compaction.

        Writes may land meanwhile. The refresh catches up through the
        store version v1, reads the content (which may hold ops past v1),
        reads the version again (v2) and marks (v1, v2]; only the nodes
        those marks did not reach are refreshed. Such a node has the same
        closure at v1, at v2 and when the content was read, so installing
        its rows and advancing the synced version to v2 never answers
        ahead of the serving state. Every store read runs outside the
        lock.

        `view` is the engine's current SnapshotView: the content encodes
        through its overlay, so that names first seen after the base
        refresh under the ids queries encode to. Rows that still fail to
        encode keep their region dirty (`skipped` sites): a refresh
        narrows the dirty set, it never covers over missing rows."""
        from .closure_kernel import closure_tables_from_numpy

        with self._mu:
            build, graph, snap = self._build, self._graph, self._snapshot
            if build is None or graph is None or self._stale or not self._dirty:
                return False
        t0 = time.perf_counter()
        v1 = manager.version(nid=self.nid)
        if not self.catch_up(manager, v1):
            return False
        with self._mu:
            if self._build is not build or self._stale:
                return False
            dirty_before = set(self._dirty)
        encoder = view if view is not None else SnapshotView(snap)
        t1 = time.perf_counter()
        content, skipped, scoped, rows = self._refresh_content(manager, encoder, dirty_before)
        t2 = time.perf_counter()
        v2 = manager.version(nid=self.nid)
        if v2 != v1:
            ops2 = manager.changes_since(v1, nid=self.nid)
            if ops2 is None:
                self.mark_stale()
                return False
            self.apply_changes(ops2, v2)
        with self._mu:
            if self._build is not build or self._stale:
                return False
            remarked = self._dirty - dirty_before
            marks_gen = self._marks_gen
        # regions whose rows did not encode stay dirty, marked like a live
        # op's sites under the graph's overlay-extended namespaces
        if skipped:
            remarked |= self._ancestors(graph, self._sites(graph, sorted(skipped)))
        refresh = dirty_before - remarked
        if not refresh:
            return False
        slot_ns = view.overlay.objslot_ns if view is not None and view.overlay is not None \
            else None
        t3 = time.perf_counter()
        g2 = extract_graph(snap, content, objslot_ns=slot_ns)
        if g2 is None:
            self.mark_stale()
            return False
        keys = np.array(sorted(refresh), dtype=np.int64)
        waves, steps = self.stats["power_waves"], self.stats["power_steps"]
        t4 = time.perf_counter()
        fresh, split = self._power(g2, snap, max_depth, build.base_version, sources=keys)
        t5 = time.perf_counter()
        split.update(power_waves=self.stats["power_waves"] - waves,
                     power_steps=self.stats["power_steps"] - steps)
        merged = self._merge_refresh(build, graph, keys, fresh)
        t6 = time.perf_counter()
        tables, cc_probes, ch_probes = pack_closure_tables(merged, graph.R, snap.layout)
        t7 = time.perf_counter()
        dev = closure_tables_from_numpy(tables, self.device)
        t8 = time.perf_counter()
        with self._mu:
            if self._build is not build or self._stale:
                return False
            if self._marks_gen != marks_gen:
                # a catch-up marked nodes after the re-mark read: the
                # install would clear them with the synced version past
                # them. The next pass retries over the fresh marks.
                return False
            self._build = merged
            # the refresh content informs the dependency graph, and its
            # view becomes the op encoder: a later write at an object the
            # refreshed rows reach must mark its ancestors. A full read
            # replaces the graph; a region read covers only the walked
            # neighbourhood, so its edges join the old CSR (marking too
            # much costs a refresh, too little a stale answer)
            self._graph = self._merge_dependency(graph, g2) if scoped else g2
            self._encoder = encoder
            self._dirty -= refresh
            self._synced_version = max(self._synced_version, v2)
            cd = build_dirty_table(np.fromiter(self._dirty, dtype=np.int64,
                                               count=len(self._dirty)), graph.R, snap.layout)
            if cd is None:
                self._stale = True
                return False
            dev.update(closure_tables_from_numpy({"cd_pack": cd}, self.device))
            self._view = ClosureView(dev, cc_probes, ch_probes, snap.layout, bool(self._dirty),
                                     merged.snapshot_version, self._synced_version, graph.R)
            self.stats["dirty_nodes"] = len(self._dirty)
            self.stats["refreshes"] += 1
        self.last_refresh = {
            "catch_up_s": t1 - t0, "content_s": t2 - t1, "rows": rows, "scoped": scoped,
            "sources": len(keys), "extract_s": t4 - t3, "power_s": t5 - t4, **split,
            "merge_s": t6 - t5, "pack_s": t7 - t6, "upload_s": t8 - t7,
        }
        return True

    def _refresh_content(self, manager, encoder, dirty_keys):
        """(content, skipped sites, scoped, rows read) for one refresh:
        the dirty nodes' regions, read object by object, when the dirty
        set decodes and its regions fit the walk budget (a cost that
        follows the dirty set, not the store), else the whole store.
        `scoped` tells the caller to merge the dependency graph, not
        replace it."""
        R = max(len(encoder.snapshot.rel_ids), 1)
        slots = sorted({int(k) // R for k in dirty_keys})
        budget = max(4096, 4 * self.max_set_rows)
        decoded = self._decode_slots(encoder, slots)
        if decoded is not None:
            region = self._region_content(manager, encoder, decoded, budget)
            if region is not None:
                content, skipped, rows = region
                self.stats["refresh_rows_read"] += rows
                self.stats["scoped_refreshes"] += 1
                return content, skipped, True, rows
        content, skipped = self._store_content(manager, encoder)
        self.stats["refresh_rows_read"] += len(content[0])
        self.stats["full_refresh_reads"] += 1
        return content, skipped, False, len(content[0])

    def _store_content(self, manager, encoder):
        """Encoded (obj, rel, skind, sa, sb) arrays of the whole store
        under `encoder`'s vocabulary, and the (obj, rel) sites of the rows
        whose node encodes but whose subject does not: the caller keeps
        their regions dirty."""
        R = max(len(encoder.snapshot.rel_ids), 1)
        rows: list = []
        skipped: set[tuple[int, int]] = set()
        for t in manager.all_relation_tuples(nid=self.nid):
            node, row = _node_row(encoder, t, R)
            if row is not None:
                rows.append(row)
            elif node is not None:
                skipped.add((int(node[0]), int(node[1])))
        return _content_arrays(rows), skipped

    @staticmethod
    def _decode_slots(encoder, slots) -> Optional[dict]:
        """slot -> (namespace, object) for exactly the requested slots, or
        None when one does not decode (the full read then)."""
        base, overlay = encoder.snapshot, encoder.overlay
        ns_names = {v: k for k, v in base.ns_ids.items()}
        if overlay is not None:
            ns_names.update({v: k for k, v in overlay.ns_ids.items()})
        want = set(int(s) for s in slots)
        out: dict[int, tuple[str, str]] = {}

        def take(ns_id, obj_name, slot):
            if ns_names.get(int(ns_id)) is not None:
                out[int(slot)] = (ns_names[int(ns_id)], obj_name)

        base_by_id = vocab_by_id(base.obj_slots)
        for slot in want:
            key = base_by_id.get(slot)
            if key is not None:
                take(*key, slot)
        if overlay is not None:
            for (ns_id, obj_name), slot in overlay.obj_slots.items():
                if slot in want:
                    take(ns_id, obj_name, slot)
        return out if len(out) == len(want) else None

    def _region_content(self, manager, encoder, dirty_objs: dict, budget_objs: int):
        """The dirty nodes' regions by per-object store queries, following
        subject-set children: every node a refresh source reaches lies at
        an object the walk visits (a folded edge targets a row's
        subject-set object). Returns (content, skipped sites, rows read),
        or None past `budget_objs` distinct objects (the full read then).
        Rows encode as in _store_content."""
        from ..ketoapi import RelationQuery

        R = max(len(encoder.snapshot.rel_ids), 1)
        rows: list = []
        skipped: set[tuple[int, int]] = set()
        n_read = 0
        visited: set[tuple[str, str]] = set(dirty_objs.values())
        frontier = set(visited)
        while frontier:
            nxt: set[tuple[str, str]] = set()
            for ns_name, obj_name in frontier:
                page = ""
                while True:
                    tuples, page = manager.get_relation_tuples(
                        RelationQuery(namespace=ns_name, object=obj_name),
                        page_token=page, page_size=2048, nid=self.nid)
                    for t in tuples:
                        n_read += 1
                        if t.subject_set is not None:
                            nxt.add((t.subject_set.namespace, t.subject_set.object))
                        node, row = _node_row(encoder, t, R)
                        if row is not None:
                            rows.append(row)
                        elif node is not None:
                            skipped.add((int(node[0]), int(node[1])))
                    if not page:
                        break
            frontier = nxt - visited
            visited |= frontier
            if len(visited) > budget_objs:
                return None
        return _content_arrays(rows), skipped, n_read

    @staticmethod
    def _merge_dependency(old: ClosureGraph, region: ClosureGraph) -> ClosureGraph:
        """The dependency graph after a region refresh: the union of the
        old transposed CSR and the region's (the refreshed rows may reach
        objects the base cannot express; edges the region no longer holds
        stay, as marking too much is safe). The per-namespace program
        structure (consult, poison, slot namespaces) is the same in both
        up to overlay-era extensions, so the longer is kept."""
        def pairs(g: ClosureGraph) -> np.ndarray:
            if len(g.t_src) == 0:
                return np.zeros((0, 2), dtype=np.int64)
            return np.stack([np.repeat(g.t_dst_keys, np.diff(g.t_ptr)), g.t_src], axis=1)

        allp = np.concatenate([pairs(old), pairs(region)], axis=0)
        if len(allp):
            allp = np.unique(allp, axis=0)
            src = allp[:, 1]
            uniq, starts = np.unique(allp[:, 0], return_index=True)
            ptr = np.append(starts, len(allp)).astype(np.int64)
        else:
            uniq, ptr, src = np.zeros(0, np.int64), np.zeros(1, np.int64), np.zeros(0, np.int64)
        return dataclasses.replace(
            old, t_dst_keys=uniq, t_ptr=ptr, t_src=src,
            objslot_ns=old.objslot_ns if len(old.objslot_ns) >= len(region.objslot_ns)
            else region.objslot_ns,
            consult=region.consult if len(region.consult) >= len(old.consult) else old.consult,
            fpoison=region.fpoison if region.fpoison.shape[0] >= old.fpoison.shape[0]
            else old.fpoison,
        )

    @staticmethod
    def _merge_refresh(build: ClosureBuild, graph: ClosureGraph, keys: np.ndarray,
                       fresh: ClosureBuild) -> ClosureBuild:
        """`build` with every row of the nodes `keys` replaced by
        `fresh`'s, coverage and entries both (a refreshed node may gain or
        lose coverage: its caps and poison were judged again)."""
        keep = ~np.isin(build.ent_obj.astype(np.int64) * graph.R + build.ent_rel, keys)
        covered = np.union1d(np.setdiff1d(build.covered_keys, keys), fresh.covered_keys)

        def cat(name):
            return np.concatenate([getattr(build, name)[keep], getattr(fresh, name)])

        return ClosureBuild(
            snapshot_version=build.snapshot_version, base_version=build.base_version,
            covered_keys=covered, ent_obj=cat("ent_obj"), ent_rel=cat("ent_rel"),
            ent_skind=cat("ent_skind"), ent_sa=cat("ent_sa"), ent_sb=cat("ent_sb"),
            ent_req=cat("ent_req"), n_nodes=build.n_nodes,
            n_entries=int(keep.sum()) + fresh.n_entries, vocab_fp=build.vocab_fp,
            max_depth=build.max_depth, max_set_rows=build.max_set_rows,
        )

    # -- the submit path's view ------------------------------------------------------

    def view_for(self, state) -> tuple[Optional[ClosureView], Optional[str]]:
        """The device view for one submit, or (None, cause). Never touches
        the store: the catch-up is the maintainer's, or the engine's
        bounded inline one."""
        with self._mu:
            view, build, snap_ref, stale = self._view, self._build, self._snapshot, self._stale
        if build is None:
            return None, CAUSE_UNBUILT
        if stale or view is None or snap_ref is not state.snapshot:
            # object identity: entries live in the build snapshot's ids
            return None, CAUSE_STALE_SNAPSHOT
        if view.synced_version < state.covered_version:
            # the overlay holds writes not yet marked: a deleted grant
            # would still read as allowed
            return None, CAUSE_LAG
        return view, None

    def lag_versions(self, store_version: int) -> int:
        with self._mu:
            synced = self._synced_version
        return 0 if synced < 0 else max(0, store_version - synced)

    def needs_rebuild(self) -> bool:
        with self._mu:
            return self._stale or self._build is None

    def describe(self) -> dict:
        with self._mu:
            build = self._build
            return {
                "built": build is not None,
                "stale": self._stale,
                "synced_version": self._synced_version,
                "covered_nodes": len(build.covered_keys) if build is not None else 0,
                "entries": build.n_entries if build is not None else 0,
                "universe": len(self._graph.universe) if self._graph is not None else 0,
                "powering": self.powering,
                "power_hbm": dict(self._power_hbm),
                **self.last_build,
                **self.stats,
                "dirty_nodes": len(self._dirty),
            }

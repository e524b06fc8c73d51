"""Incremental compaction: fold the pending write ops into a new base
snapshot by copying its tables and patching only what the ops touch.

When the fixed-shape delta overlay overflows (engine/delta.py,
DELTA_COMPACT_THRESHOLD ops), the engine merges the ops here before it
pays a full rebuild (store ingest, vocabulary encoding, hash-table
construction over every edge):

  - direct-edge hash table (dh_*): open addressing with value liveness.
    An insert claims the first free slot on its probe chain, which is
    safe because entries are never removed: a delete keeps its key and
    sets val = 0, so no chain breaks. K1 and its plain version already
    treat only val == 1 as live.
  - subject-set CSR (rh_* / row_ptr / e_*): each affected (obj, rel) row
    is rewritten at the tail of the edge arrays and its row-hash entry
    repointed there; the old span becomes garbage, counted on the
    snapshot (merge_garbage). Past GARBAGE_FRACTION of the edges the
    engine rebuilds in full.
  - vocabularies: names first seen in the ops take ids after the base's,
    exactly as the delta overlay gives them, so existing encodings stay
    valid: a dict vocabulary is copied and updated, an ArrayMap merges
    them in sorted with the base's ids kept.

Every table keeps the snapshot's layout (snapshot.layout). The merge
answers None, and the caller rebuilds, when the op batch is too large a
fraction of the graph, the CSR's garbage passes its limit, or a row
table cannot take the rewritten rows.

The arithmetic, the probe sequence and the winner rules are the JAX
package's (keto_tpu/engine/compact.py), so both packages merge the same
ops into the same arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ketoapi import RelationTuple
from .snapshot import (
    EMPTY,
    _GOLDEN,
    GraphSnapshot,
    _build_hash_table,
    hash_combine,
    mix32,
    probe_slot,
    slots_per_bucket,
    vocab_merged,
)

# merge only while the op batch is a small fraction of the graph: past
# this a rebuild costs about the same and resets load and garbage
MAX_OPS_FRACTION = 8  # ops <= n_tuples / MAX_OPS_FRACTION
MIN_OPS_CAP = 65536  # floor, so that small graphs still merge
MAX_PROBES = 32  # probe limit after an insert; past it the table rehashes
MAX_LOAD = 0.40  # occupancy past which a table rehashes (builds run at 0.25)
GARBAGE_FRACTION = 0.25  # rewritten-row garbage that forces a rebuild
GARBAGE_FLOOR = 65536  # edges; below this, garbage never forces a rebuild


class MergeFallback(Exception):
    """The merge does not apply: the caller rebuilds in full."""


def _hash_insert(key_cols, val_col, new_keys, new_vals, base_probes: int, layout: str) -> int:
    """Upsert deduplicated (new_keys -> new_vals) into an occupied
    open-addressing table, in place (the arrays are the caller's copies).
    An existing key takes the new value; a new key claims the first free
    slot on its chain. Returns the table's new probe limit; raises
    MergeFallback past MAX_PROBES."""
    n = len(new_vals)
    if n == 0:
        return base_probes
    cap = len(val_col)
    spb = slots_per_bucket(len(new_keys), layout)
    h1 = hash_combine(*new_keys)
    h2 = mix32(h1 ^ _GOLDEN) | np.uint32(1)
    pending = np.arange(n)
    probe = np.zeros(n, dtype=np.uint32)
    max_probes = base_probes
    while len(pending):
        if int(probe[pending].min()) + 1 > MAX_PROBES:
            raise MergeFallback("probe limit exceeded on merge insert")
        slots = probe_slot(h1[pending], h2[pending], probe[pending], cap, spb).astype(np.int64)
        match = np.ones(len(pending), dtype=bool)
        for col, k in zip(key_cols, new_keys):
            match &= col[slots] == k[pending]
        if match.any():
            val_col[slots[match]] = new_vals[pending[match]]
            max_probes = max(max_probes, int(probe[pending[match]].max()) + 1)
        free = (key_cols[0][slots] == EMPTY) & ~match
        if free.any():
            # among pending keys probing the same free slot, the first wins
            order = np.argsort(slots[free], kind="stable")
            idx = pending[free][order]
            fslots = slots[free][order]
            uniq, first = np.unique(fslots, return_index=True)
            winners = idx[first]
            for col, k in zip(key_cols, new_keys):
                col[uniq] = k[winners]
            val_col[uniq] = new_vals[winners]
            max_probes = max(max_probes, int(probe[winners].max()) + 1)
            placed = np.zeros(n, dtype=bool)
            placed[winners] = True
            placed[pending[match]] = True
            rest = pending[~placed[pending]]
        else:
            rest = pending[~match]
        probe[rest] += 1
        pending = rest
    return max_probes


def _rehash_table(key_cols, val_col, new_keys, new_vals, drop_zero_vals: bool, layout: str):
    """Rebuild an open-addressing table from its live entries plus
    (new_keys -> new_vals), growing it as needed: integer work only, no
    store ingest. New entries win a key collision; with drop_zero_vals,
    tombstones (val 0) are dropped. Safe on a table _hash_insert left
    half-written: its written slots hold only op data that new_keys and
    new_vals supply again. Returns (key_cols, val_col, probe_limit)."""
    live = np.flatnonzero((key_cols[0] != EMPTY) & ((val_col != 0) if drop_zero_vals else True))
    all_keys = [np.concatenate([nk, col[live]]).astype(np.int32)
                for nk, col in zip(new_keys, key_cols)]
    all_vals = np.concatenate([new_vals, val_col[live]]).astype(np.int32)
    # keep each key's first occurrence: the new entries come first
    _, first = np.unique(np.stack(all_keys, axis=1), axis=0, return_index=True)
    keep = np.sort(first)
    all_keys = [c[keep] for c in all_keys]
    all_vals = all_vals[keep]
    if drop_zero_vals:
        alive = all_vals != 0
        all_keys = [c[alive] for c in all_keys]
        all_vals = all_vals[alive]
    *cols, vals, probes = _build_hash_table(tuple(all_keys), all_vals, layout, min_capacity=64)
    return list(cols), vals, probes


def _host_row_lookup(rh_obj, rh_rel, rh_row, probes: int, obj: int, rel: int,
                     layout: str) -> int:
    """One host probe of an (obj, rel) -> row table; -1 when absent."""
    cap = len(rh_obj)
    spb = slots_per_bucket(2, layout)
    h1 = hash_combine(np.asarray([obj], dtype=np.int32), np.asarray([rel], dtype=np.int32))
    h2 = mix32(h1 ^ _GOLDEN) | np.uint32(1)
    for p in range(probes):
        # array arithmetic: uint32 wraparound is meant here
        slot = int(probe_slot(h1, h2, np.uint32(p), cap, spb)[0])
        if rh_obj[slot] == obj and rh_rel[slot] == rel:
            return int(rh_row[slot])
        if rh_obj[slot] == EMPTY:
            return -1
    return -1


def patch_csr(rh_cols, rh_probes: int, row_ptr: np.ndarray, payloads: tuple,
              per_row: dict, layout: str):
    """Rewrite the affected rows of a hash-addressed CSR at its tail.

    `per_row` maps (obj, rel) -> {"ins": [payload tuples], "del": {payload
    tuples}}. Returns (rh_cols, rh_probes, row_ptr, payloads,
    garbage_edges), all fresh arrays: the inputs are never written
    (concurrent readers hold them)."""
    rh_obj, rh_rel, rh_row = (np.array(c) for c in rh_cols)
    tail: list[tuple[np.ndarray, ...]] = []
    new_row_keys: list[tuple[int, int]] = []
    new_row_ids: list[int] = []
    ends: list[int] = []
    garbage = 0
    pos = int(row_ptr[-1])
    next_row = len(row_ptr) - 1
    for (obj, rel), ch in per_row.items():
        row = _host_row_lookup(rh_obj, rh_rel, rh_row, rh_probes, obj, rel, layout)
        if row >= 0:
            lo, hi = int(row_ptr[row]), int(row_ptr[row + 1])
            base = tuple(p[lo:hi] for p in payloads)
            garbage += hi - lo
        else:
            base = tuple(p[0:0] for p in payloads)
        if ch["del"] and len(base[0]):
            keep = np.array([t not in ch["del"] for t in zip(*(c.tolist() for c in base))],
                            dtype=bool)
            base = tuple(c[keep] for c in base)
        # inserts not already in the row: a row carries no duplicate edge
        if ch["ins"]:
            existing = set(zip(*(c.tolist() for c in base))) if len(base[0]) else set()
            fresh = [t for t in ch["ins"] if t not in existing]
        else:
            fresh = []
        cols = tuple(
            np.concatenate([base[i], np.array([t[i] for t in fresh], dtype=np.int32)])
            .astype(np.int32)
            for i in range(len(payloads))
        )
        tail.append(cols)
        pos += len(cols[0])
        ends.append(pos)
        # new and rewritten rows alike: the upsert below inserts the key
        # or repoints its entry at the tail row
        new_row_keys.append((obj, rel))
        new_row_ids.append(next_row)
        next_row += 1

    new_payloads = tuple(
        np.concatenate([payloads[i]] + [t[i] for t in tail]).astype(np.int32)
        for i in range(len(payloads))
    )
    new_row_ptr = np.concatenate([row_ptr, np.array(ends, dtype=np.int32)]).astype(np.int32)
    keys = np.array(new_row_keys, dtype=np.int32).reshape(-1, 2)
    key_tuple = (keys[:, 0].copy(), keys[:, 1].copy())
    vals = np.array(new_row_ids, dtype=np.int32)
    n_live = int(np.count_nonzero(rh_obj != EMPTY))
    rehash = n_live + len(vals) > MAX_LOAD * len(rh_row)
    if not rehash:
        try:
            new_probes = _hash_insert([rh_obj, rh_rel], rh_row, key_tuple, vals, rh_probes,
                                      layout)
        except MergeFallback:
            rehash = True  # pathological clustering: rebuild the row table
    if rehash:
        (rh_obj, rh_rel), rh_row, new_probes = _rehash_table(
            [rh_obj, rh_rel], rh_row, key_tuple, vals, drop_zero_vals=False, layout=layout
        )
    return (rh_obj, rh_rel, rh_row), new_probes, new_row_ptr, new_payloads, garbage


def encode_ops(snapshot: GraphSnapshot, ops: Sequence[tuple[str, RelationTuple]]):
    """(encoded int32 [n, 5] (obj, rel, skind, sa, sb), is_insert bool
    [n], overlay): the ops under the base vocabulary and the names they
    add, which the delta.VocabOverlay carries with the grown objslot_ns
    and ns_has_config."""
    from .delta import SnapshotView, build_vocab_overlay

    overlay = build_vocab_overlay(snapshot, ops)
    view = SnapshotView(snapshot, overlay)
    enc = np.zeros((len(ops), 5), dtype=np.int32)
    is_insert = np.zeros(len(ops), dtype=bool)
    for i, (op, t) in enumerate(ops):
        enc[i, 0], enc[i, 1] = view.encode_node(t.namespace, t.object, t.relation)
        enc[i, 2], enc[i, 3], enc[i, 4] = view.encode_subject(t)
        is_insert[i] = op == "insert"
    return enc, is_insert, overlay


def _per_row(rows: np.ndarray, ins: np.ndarray, key, payload) -> dict:
    """(row key) -> {"ins": [payloads], "del": {payloads}} of deduplicated
    ops, in op order: a later op on the same payload overrides."""
    per_row: dict = {}
    for r, i in zip(rows.tolist(), ins.tolist()):
        ch = per_row.setdefault(key(r), {"ins": [], "del": set()})
        pay = payload(r)
        if i:
            ch["ins"].append(pay)
            ch["del"].discard(pay)
        else:
            ch["del"].add(pay)
            ch["ins"] = [t for t in ch["ins"] if t != pay]
    return per_row


def merge_ops_into_snapshot(snapshot: GraphSnapshot, ops: Sequence[tuple[str, RelationTuple]],
                            version: int):
    """(merged snapshot, enc_u [n, 5] int32, ins_u bool [n]): a new
    GraphSnapshot with `ops` folded in, and the deduplicated encoded ops
    the engine patches its expand and reverse mirrors with; (None, None,
    None) when a full rebuild is the better or only correct move. The
    input snapshot is never written."""
    n_ops = len(ops)
    if n_ops == 0 or n_ops > max(MIN_OPS_CAP, snapshot.n_tuples // MAX_OPS_FRACTION):
        return None, None, None
    try:
        enc, is_insert, overlay = encode_ops(snapshot, ops)
    except (KeyError, TypeError):
        return None, None, None  # an inconsistent op stream: rebuild from the store
    layout = snapshot.layout

    # the last op on each exact edge key wins, as in the delta overlay
    rev = np.arange(n_ops - 1, -1, -1)
    _, first = np.unique(enc[rev], axis=0, return_index=True)
    keep = rev[first]
    enc_u = enc[keep]
    ins_u = is_insert[keep]

    # direct-edge table: in-place upserts while it stays sparse, else a
    # rehash from its own integer arrays
    dh_cols = [np.array(snapshot.dh_obj), np.array(snapshot.dh_rel), np.array(snapshot.dh_skind),
               np.array(snapshot.dh_sa), np.array(snapshot.dh_sb)]
    dh_val = np.array(snapshot.dh_val)
    dh_keys = tuple(enc_u[:, i].copy() for i in range(5))
    dh_vals = ins_u.astype(np.int32)
    occupied = int(np.count_nonzero(snapshot.dh_obj != EMPTY))
    rehash = occupied + len(enc_u) > MAX_LOAD * len(dh_val)
    if not rehash:
        try:
            dh_probes = _hash_insert(dh_cols, dh_val, dh_keys, dh_vals, snapshot.dh_probes,
                                     layout)
        except MergeFallback:
            rehash = True
    if rehash:
        dh_cols, dh_val, dh_probes = _rehash_table(dh_cols, dh_val, dh_keys, dh_vals,
                                                   drop_zero_vals=True, layout=layout)

    # subject-set CSR: affected rows rewritten at the tail
    is_set = enc_u[:, 2] == 1
    per_row = _per_row(enc_u[is_set], ins_u[is_set], lambda r: (r[0], r[1]),
                       lambda r: (r[3], r[4]))
    if per_row:
        try:
            (rh_obj, rh_rel, rh_row), rh_probes, row_ptr, (e_obj, e_rel), garbage = patch_csr(
                (snapshot.rh_obj, snapshot.rh_rel, snapshot.rh_row), snapshot.rh_probes,
                snapshot.row_ptr, (snapshot.e_obj, snapshot.e_rel), per_row, layout,
            )
        except MergeFallback:
            return None, None, None
    else:
        rh_obj, rh_rel, rh_row = snapshot.rh_obj, snapshot.rh_rel, snapshot.rh_row
        rh_probes = snapshot.rh_probes
        row_ptr, e_obj, e_rel = snapshot.row_ptr, snapshot.e_obj, snapshot.e_rel
        garbage = 0

    total_garbage = snapshot.merge_garbage + garbage
    if total_garbage > max(GARBAGE_FLOOR, GARBAGE_FRACTION * len(e_obj)):
        return None, None, None

    # live-tuple count from the op counts: only the load gates need
    # exactness, and they measure occupancy directly
    n_tuples = snapshot.n_tuples + int(ins_u.sum()) - int((~ins_u).sum())
    merged = GraphSnapshot(
        ns_ids=vocab_merged(snapshot.ns_ids, overlay.ns_ids),
        rel_ids=vocab_merged(snapshot.rel_ids, overlay.rel_ids),
        obj_slots=vocab_merged(snapshot.obj_slots, overlay.obj_slots),
        subj_ids=vocab_merged(snapshot.subj_ids, overlay.subj_ids),
        n_config_rels=snapshot.n_config_rels,
        wildcard_rel=snapshot.wildcard_rel,
        layout=layout,
        objslot_ns=overlay.objslot_ns,
        ns_has_config=overlay.ns_has_config,
        dh_obj=dh_cols[0], dh_rel=dh_cols[1], dh_skind=dh_cols[2],
        dh_sa=dh_cols[3], dh_sb=dh_cols[4], dh_val=dh_val, dh_probes=dh_probes,
        rh_obj=rh_obj, rh_rel=rh_rel, rh_row=rh_row, rh_probes=rh_probes,
        row_ptr=row_ptr, e_obj=e_obj, e_rel=e_rel,
        instr_kind=snapshot.instr_kind, instr_rel=snapshot.instr_rel,
        instr_rel2=snapshot.instr_rel2, prog_flags=snapshot.prog_flags,
        K=snapshot.K,
        island_circuits=snapshot.island_circuits,
        version=version,
        n_tuples=max(n_tuples, 0),
        merge_garbage=total_garbage,
    )
    return merged, enc_u, ins_u

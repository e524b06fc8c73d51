"""Delta overlay, Check subset: the vocabulary view the engine encodes
queries through, and the fixed-shape overlay tables the check kernel
probes beside the compacted ones.

  - delta direct-edge table keyed (obj, rel, skind, sa, sb), value 1
    (insert) or 0 (delete tombstone), last op wins: the kernel's probe
    takes the overlay's answer over the compacted table's
  - dirty-row table keyed (obj, rel): a bitmask of rows whose edge list
    changed; a task expanding a check-dirty row sends its query to exact
    host replay
  - reverse-dirty table keyed (subject, reverse_subject_tag) for a
    subject whose direct edges changed and (subject slot, 0) for a
    subject slot whose reverse-edge row changed: a ListObjects walk that
    seeds from or visits such a key sends its query to host replay

The engine (torch_engine.py `_delta_refresh`) builds the overlay from
the store's change feed since its base snapshot, under every table
layout, bit for bit as the JAX package's; past DELTA_COMPACT_THRESHOLD
ops it merges them into a new base (engine/compact.py) instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..ketoapi import RelationTuple
from .snapshot import EMPTY, GraphSnapshot, _build_hash_table

# fixed overlay shapes: each op adds one dd entry and at most one dirty
# row (two reverse-dirty entries), at the builder's 0.25 load for
# DELTA_COMPACT_THRESHOLD ops
DELTA_CAPACITY = 8192
DIRTY_CAPACITY = 8192
RDIRTY_CAPACITY = 16384
DELTA_COMPACT_THRESHOLD = 2048
DELTA_PROBES = 8  # static probe depth of the overlay tables

DIRTY_FOR_EXPAND = 1
DIRTY_FOR_CHECK = 2


class DeltaOverflow(Exception):
    """Pending deltas exceed the fixed overlay capacity: compact."""


@dataclass
class VocabOverlay:
    """Vocabulary entries first seen in pending deltas, plus full copies
    of the vocab-dependent arrays."""

    ns_ids: dict[str, int]
    rel_ids: dict[str, int]
    obj_slots: dict[tuple[int, str], int]
    subj_ids: dict[str, int]
    objslot_ns: np.ndarray
    ns_has_config: np.ndarray


class SnapshotView:
    """Immutable (base snapshot, overlay) pair with the snapshot's
    query-encoding interface."""

    def __init__(self, snapshot: GraphSnapshot, overlay: Optional[VocabOverlay] = None):
        self.snapshot = snapshot
        self.overlay = overlay

    def _lookup(self, base: dict, extra_name: str, key):
        v = base.get(key)
        if v is None and self.overlay is not None:
            v = getattr(self.overlay, extra_name).get(key)
        return v

    def ns_id(self, name: str):
        return self._lookup(self.snapshot.ns_ids, "ns_ids", name)

    def rel_id(self, name: str):
        return self._lookup(self.snapshot.rel_ids, "rel_ids", name)

    def encode_node(self, namespace: str, obj: str, relation: str):
        ns = self.ns_id(namespace)
        if ns is None:
            return None
        slot = self._lookup(self.snapshot.obj_slots, "obj_slots", (ns, obj))
        rel = self.rel_id(relation)
        if slot is None or rel is None:
            return None
        return slot, rel

    def encode_subject(self, t: RelationTuple):
        if t.subject_set is not None:
            s = t.subject_set
            node = self.encode_node(s.namespace, s.object, s.relation)
            if node is None:
                return None
            return 1, node[0], node[1]
        sid = self._lookup(self.snapshot.subj_ids, "subj_ids", t.subject_id or "")
        if sid is None:
            return None
        return 0, sid, 0


def _fixed_capacity_table(keys, values, capacity: int, layout: str):
    """An overlay table of exactly `capacity` slots probed at most
    DELTA_PROBES deep; raises DeltaOverflow when the ops do not fit."""
    *cols, probes = _build_hash_table(
        keys, values, layout, min_capacity=capacity, boost_load=False
    )
    if cols[0].shape[0] != capacity or probes > DELTA_PROBES:
        raise DeltaOverflow
    return cols


def empty_delta_tables() -> dict[str, np.ndarray]:
    return {
        "dd_obj": np.full(DELTA_CAPACITY, EMPTY, np.int32),
        "dd_rel": np.full(DELTA_CAPACITY, EMPTY, np.int32),
        "dd_skind": np.full(DELTA_CAPACITY, EMPTY, np.int32),
        "dd_sa": np.full(DELTA_CAPACITY, EMPTY, np.int32),
        "dd_sb": np.full(DELTA_CAPACITY, EMPTY, np.int32),
        "dd_val": np.full(DELTA_CAPACITY, EMPTY, np.int32),
        "dirty_obj": np.full(DIRTY_CAPACITY, EMPTY, np.int32),
        "dirty_rel": np.full(DIRTY_CAPACITY, EMPTY, np.int32),
        "dirty_val": np.full(DIRTY_CAPACITY, EMPTY, np.int32),
        "rd_obj": np.full(RDIRTY_CAPACITY, EMPTY, np.int32),
        "rd_tag": np.full(RDIRTY_CAPACITY, EMPTY, np.int32),
        "rd_val": np.full(RDIRTY_CAPACITY, EMPTY, np.int32),
    }


def build_vocab_overlay(
    snapshot: GraphSnapshot, ops: Sequence[tuple[str, RelationTuple]]
) -> VocabOverlay:
    """Names first seen in the delta get ids after the base vocabulary;
    new relations are data-only (>= n_config_rels)."""
    from .snapshot import pad_headroom

    ns_new: dict[str, int] = {}
    rel_new: dict[str, int] = {}
    slot_new: dict[tuple[int, str], int] = {}
    subj_new: dict[str, int] = {}
    base = snapshot

    def ns_id(name: str) -> int:
        v = base.ns_ids.get(name)
        if v is None:
            v = ns_new.setdefault(name, len(base.ns_ids) + len(ns_new))
        return v

    def rel_id(name: str) -> None:
        if name not in base.rel_ids:
            rel_new.setdefault(name, len(base.rel_ids) + len(rel_new))

    def obj_slot(ns: int, obj: str) -> None:
        if (ns, obj) not in base.obj_slots:
            slot_new.setdefault((ns, obj), len(base.obj_slots) + len(slot_new))

    for _op, t in ops:
        obj_slot(ns_id(t.namespace), t.object)
        rel_id(t.relation)
        if t.subject_set is not None:
            s = t.subject_set
            obj_slot(ns_id(s.namespace), s.object)
            rel_id(s.relation)
        elif (t.subject_id or "") not in base.subj_ids:
            subj_new.setdefault(t.subject_id or "", len(base.subj_ids) + len(subj_new))

    objslot_ns = snapshot.objslot_ns
    ns_has_config = snapshot.ns_has_config
    if slot_new:
        total = len(base.obj_slots) + len(slot_new)
        objslot_ns = np.zeros(max(len(snapshot.objslot_ns), pad_headroom(total)), np.int32)
        objslot_ns[: len(snapshot.objslot_ns)] = snapshot.objslot_ns
        for (ns, _obj), slot in slot_new.items():
            objslot_ns[slot] = ns
    if ns_new:
        # namespaces first seen in tuples have no config by definition
        n_ns = len(base.ns_ids) + len(ns_new)
        ns_has_config = np.zeros(
            max(len(snapshot.ns_has_config), pad_headroom(n_ns, 64)), np.int32
        )
        ns_has_config[: len(snapshot.ns_has_config)] = snapshot.ns_has_config
    return VocabOverlay(
        ns_ids=ns_new, rel_ids=rel_new, obj_slots=slot_new, subj_ids=subj_new,
        objslot_ns=objslot_ns, ns_has_config=ns_has_config,
    )


def build_delta_tables(
    view: SnapshotView, ops: Sequence[tuple[str, RelationTuple]]
) -> dict[str, np.ndarray]:
    """Compile pending (op, tuple) pairs to the overlay tables under an
    overlay-aware view, in the snapshot's table layout."""
    from .snapshot import reverse_subject_tag

    if len(ops) > DELTA_COMPACT_THRESHOLD:
        raise DeltaOverflow
    layout = view.snapshot.layout
    last: dict[tuple[int, int, int, int, int], int] = {}
    dirty_ss: set[tuple[int, int]] = set()
    dirty_all: set[tuple[int, int]] = set()
    # a changed edge makes its subject's seed row stale and, for a
    # subject-set edge, the subject slot's reverse-edge row
    rdirty: set[tuple[int, int]] = set()
    for op, t in ops:
        obj, rel = view.encode_node(t.namespace, t.object, t.relation)
        skind, sa, sb = view.encode_subject(t)
        if skind == 1:
            dirty_ss.add((obj, rel))
            rdirty.add((sa, 0))
        dirty_all.add((obj, rel))
        rdirty.add((sa, int(reverse_subject_tag(skind, sb))))
        last[(obj, rel, skind, sa, sb)] = 1 if op == "insert" else 0

    tables = empty_delta_tables()
    if last:
        keys = np.array(list(last.keys()), dtype=np.int32).T
        vals = np.array(list(last.values()), dtype=np.int32)
        (
            tables["dd_obj"], tables["dd_rel"], tables["dd_skind"],
            tables["dd_sa"], tables["dd_sb"], tables["dd_val"],
        ) = _fixed_capacity_table(tuple(keys), vals, DELTA_CAPACITY, layout)
    if dirty_all:
        marks = {k: DIRTY_FOR_EXPAND for k in dirty_all}
        for k in dirty_ss:
            marks[k] |= DIRTY_FOR_CHECK
        keys = np.array(list(marks.keys()), dtype=np.int32).T
        vals = np.array(list(marks.values()), dtype=np.int32)
        tables["dirty_obj"], tables["dirty_rel"], tables["dirty_val"] = (
            _fixed_capacity_table(tuple(keys), vals, DIRTY_CAPACITY, layout)
        )
    if rdirty:
        keys = np.array(sorted(rdirty), dtype=np.int32).T
        vals = np.ones(len(rdirty), dtype=np.int32)
        tables["rd_obj"], tables["rd_tag"], tables["rd_val"] = _fixed_capacity_table(
            tuple(keys), vals, RDIRTY_CAPACITY, layout
        )
    return tables

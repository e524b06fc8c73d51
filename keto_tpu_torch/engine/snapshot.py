"""Graph snapshot compiler, Check subset: relation tuples + namespace
configs -> the host arrays the batched BFS check kernel runs over.

  - dictionary encoding: namespaces, relations, scoped objects
    ((ns, object) pairs -> dense int32 "object slots") and plain subject
    ids each get dense int32 vocabularies
  - direct-edge hash table: open addressing, double hashing, keyed
    (obj_slot, rel, skind, sa, sb), for O(1) existence probes
  - subject-set CSR: one row of subject-set edges per (obj_slot, rel),
    addressed through a second hash table
  - rewrite programs: each namespace relation's rewrite compiled to <= K
    flat instructions {COMPUTED(rel'), TTU(rel, rel')} run per task in the
    kernel. AND/NOT rewrites compile to islands (leaf sub-checks plus a
    postfix circuit combined on the host); oversized programs are flagged
    for exact host replay.

The probe-table layout is an explicit parameter: "bucketized" (probes
fill whole 256-byte bucket rows, one coalesced warp read on the GPU) or
"compact" (classic double hashing, one slot per bucket). The hash, the
probe sequence and the builder's winner rule are bit-identical to the JAX
package's, so both packages build the same tables from the same tuples.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..ketoapi import RelationTuple
from ..namespace import ast
from ..native import build_probe_table, sorted_unique_encode
from ..namespace.definitions import Namespace
from .definitions import WILDCARD_RELATION

EMPTY = np.int32(-1)

LAYOUTS = ("bucketized", "compact")

# rewrite instruction kinds
INSTR_NONE = 0
INSTR_COMPUTED = 1
INSTR_TTU = 2

# per-(ns, rel) program flags
FLAG_HOST_ONLY = 1  # rewrite exceeds the instruction/circuit caps
FLAG_CONFIG_MISSING = 2  # namespace declares relations but not this one
FLAG_ISLAND = 4  # rewrite has AND/NOT: island leaves + host circuit

# island circuit op codes (host-side combine, engine/islands.py)
CIRC_FALSE = "false"
CIRC_LEAF = "leaf"
CIRC_NOT = "not"
CIRC_AND = "and"
CIRC_OR = "or"

# circuit length cap: a rewrite compiling past this goes host-only
CIRCUIT_CAP = 48

_GOLDEN = np.uint32(0x9E3779B9)


def mix32(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32, vectorized over uint32."""
    x = np.asarray(x, dtype=np.uint32).copy()
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def hash_combine(*parts: np.ndarray) -> np.ndarray:
    h = np.zeros_like(np.asarray(parts[0], dtype=np.uint32)) + _GOLDEN
    for p in parts:
        h = mix32(h ^ np.asarray(p, dtype=np.uint32))
    return h


def check_layout(layout: str) -> str:
    if layout not in LAYOUTS:
        raise ValueError(f"table layout must be one of {LAYOUTS}, got {layout!r}")
    return layout


def slots_per_bucket(n_key_cols: int, layout: str) -> int:
    """Slots per open-addressing bucket. Bucketized: every bucket is one
    256-byte row, so 2-key pair tables (4-int entries) hold 16 slots and
    5-key edge tables (8-int entries) hold 8. Compact: 1 slot per bucket
    (classic double hashing)."""
    if check_layout(layout) == "compact":
        return 1
    return 16 if n_key_cols <= 2 else 8


def probe_slot(h1, h2, j, cap: int, spb: int):
    """Slot of probe number `j` for a key with hashes (h1, h2) in a
    power-of-two table of `cap` slots: probes fill the spb consecutive
    slots of bucket (h1 + (j // spb) * h2) before stepping to the next
    bucket. Builders and the kernel must agree on this sequence."""
    sh = np.uint32(spb.bit_length() - 1)  # log2(spb); spb is 1, 8 or 16
    bmask = np.uint32(cap // spb - 1)
    jb = np.asarray(j, dtype=np.uint32) >> sh
    js = np.asarray(j, dtype=np.uint32) & np.uint32(spb - 1)
    return ((h1 + jb * h2) & bmask) * np.uint32(spb) + js


def pad_headroom(n: int, quantum: int = 1024) -> int:
    """Length of a vocab-dependent array (objslot_ns, ns_has_config) for
    n entries: rounded up to a quantum with room for delta growth."""
    return ((n // quantum) + 2) * quantum


def hash_table_capacity(n: int, min_capacity: int = 64) -> int:
    """Power-of-two capacity at load factor <= 0.25 for n entries (floor
    64: the bucketized sequence needs at least one full bucket)."""
    cap = max(min_capacity, 64)
    while cap < 4 * n:
        cap *= 2
    return cap


def table_capacity(n: int, layout: str, min_capacity: int = 64) -> int:
    """Bucketized tables run half the 4n load, so that the probe limit
    (the max bucket occupancy) stays inside one bucket row; compact
    tables keep the 4n sizing."""
    cap = hash_table_capacity(n, min_capacity)
    if check_layout(layout) == "compact":
        return cap
    if cap < 8 * n:
        cap *= 2
    return cap


def _hash_table(keys, values, layout, min_capacity, boost_load, build) -> tuple[np.ndarray, ...]:
    """The capacity, the hashes and the grow-and-retry loop the native and
    the plain builders share; `build(h1, h2, keys, values, cap, empty, spb)`
    fills one table ((key columns, values, probe limit), a limit below 1
    when a key needs more than 64 rounds: the table doubles and builds
    again)."""
    n = len(values)
    cap = (
        table_capacity(n, layout, min_capacity)
        if boost_load
        else hash_table_capacity(n, min_capacity)
    )
    spb = slots_per_bucket(len(keys), layout)
    h1 = hash_combine(*keys)
    h2 = mix32(h1 ^ _GOLDEN) | np.uint32(1)  # odd stride, pow2 table
    while True:
        cols, vals, max_probes = build(h1, h2, keys, values, cap, int(EMPTY), spb)
        if max_probes >= 1:
            return (*cols, vals, max_probes)
        cap *= 2


def _build_hash_table(
    keys: tuple[np.ndarray, ...], values: np.ndarray, layout: str,
    min_capacity: int = 64, boost_load: bool = True,
) -> tuple[np.ndarray, ...]:
    """Open-addressing table built in probe rounds: per round, the lowest
    pending index wins each contended free slot and the losers advance
    one probe. Returns (key column arrays..., value array, probe_limit).
    Built by the native builder (keto_tpu_torch/native), which gives the
    numpy rounds' tables (_build_hash_table_plain) bit for bit."""
    return _hash_table(keys, values, layout, min_capacity, boost_load, build_probe_table)


def _build_hash_table_plain(
    keys: tuple[np.ndarray, ...], values: np.ndarray, layout: str,
    min_capacity: int = 64, boost_load: bool = True,
) -> tuple[np.ndarray, ...]:
    """The numpy rounds _build_hash_table's native builder stands for:
    the plain version the tests hold it to."""
    return _hash_table(keys, values, layout, min_capacity, boost_load, _probe_rounds)


def _probe_rounds(h1, h2, keys, values, cap, empty, spb):
    """One table of the numpy rounds, build_probe_table's signature."""
    n = len(values)
    table_keys = [np.full(cap, empty, dtype=np.int32) for _ in keys]
    table_vals = np.full(cap, empty, dtype=np.int32)
    pending = np.arange(n)
    probe = np.zeros(n, dtype=np.uint32)
    max_probes = 0
    while len(pending):
        max_probes += 1
        if max_probes > 64:
            return table_keys, table_vals, -1  # extremely clustered: grow and retry
        slots = probe_slot(h1[pending], h2[pending], probe[pending], cap, spb)
        if max_probes == 1:
            free = np.ones(len(pending), dtype=bool)
        else:
            free = table_vals[slots] == empty
        order = np.argsort(slots[free], kind="stable")
        free_idx = pending[free][order]
        free_slots = slots[free][order]
        if len(free_slots):
            first = np.concatenate(
                [[0], np.flatnonzero(free_slots[1:] != free_slots[:-1]) + 1]
            )
        else:
            first = np.array([], dtype=np.int64)
        uniq_slots = free_slots[first]
        winners = free_idx[first]
        table_vals[uniq_slots] = values[winners]
        for col, key in zip(table_keys, keys):
            col[uniq_slots] = key[winners]
        placed = np.zeros(n, dtype=bool)
        placed[winners] = True
        lost = pending[~placed[pending]]
        probe[lost] += 1
        pending = lost
    return table_keys, table_vals, max(max_probes, 1)


def encode_edge_arrays(tuples, ns_ids, rel_ids, obj_slots, subj_ids):
    """Encode tuples to (obj, rel, skind, sa, sb) int32 arrays under a
    vocabulary that already holds every name."""
    n_t = len(tuples)
    t_obj = np.zeros(n_t, dtype=np.int32)
    t_rel = np.zeros(n_t, dtype=np.int32)
    t_skind = np.zeros(n_t, dtype=np.int32)
    t_sa = np.zeros(n_t, dtype=np.int32)
    t_sb = np.zeros(n_t, dtype=np.int32)
    for i, t in enumerate(tuples):
        n = ns_ids[t.namespace]
        t_obj[i] = obj_slots[(n, t.object)]
        t_rel[i] = rel_ids[t.relation]
        if t.subject_set is not None:
            s = t.subject_set
            t_skind[i] = 1
            t_sa[i] = obj_slots[(ns_ids[s.namespace], s.object)]
            t_sb[i] = rel_ids[s.relation]
        else:
            t_sa[i] = subj_ids[t.subject_id or ""]
    return t_obj, t_rel, t_skind, t_sa, t_sb


def group_rows_csr(key_obj, key_rel, payloads, layout: str, min_capacity: int = 64):
    """Group edges by (obj, rel) into a CSR addressed through a row hash
    table, stable within a row. Returns (rh_obj, rh_rel, rh_row,
    rh_probes, row_ptr, sorted_payloads)."""
    n = len(key_obj)
    if n:
        order = np.lexsort((np.arange(n), key_rel, key_obj))
        key_obj, key_rel = key_obj[order], key_rel[order]
        payloads = tuple(p[order] for p in payloads)
        row_change = np.empty(n, dtype=bool)
        row_change[0] = True
        row_change[1:] = (key_obj[1:] != key_obj[:-1]) | (key_rel[1:] != key_rel[:-1])
        row_starts = np.flatnonzero(row_change)
        row_ptr = np.append(row_starts, n).astype(np.int32)
        rh_obj, rh_rel, rh_row, rh_probes = _build_hash_table(
            (key_obj[row_starts], key_rel[row_starts]),
            np.arange(len(row_starts), dtype=np.int32),
            layout, min_capacity=min_capacity,
        )
    else:
        cap = max(min_capacity, 64)
        row_ptr = np.zeros(1, dtype=np.int32)
        rh_obj = np.full(cap, EMPTY, np.int32)
        rh_rel = np.full(cap, EMPTY, np.int32)
        rh_row = np.full(cap, EMPTY, np.int32)
        rh_probes = 1
    return rh_obj, rh_rel, rh_row, rh_probes, row_ptr, payloads


def build_edge_tables(t_obj, t_rel, t_skind, t_sa, t_sb, layout: str) -> dict:
    """Direct-edge hash table + subject-set CSR from encoded edges.
    Wildcard-relation subject sets stay in the CSR (TTU traverses them;
    the kernel drops them from the expand-subject slot)."""
    n_t = len(t_obj)
    dh = _build_hash_table(
        (t_obj, t_rel, t_skind, t_sa, t_sb), np.ones(n_t, dtype=np.int32), layout
    )
    dh_obj, dh_rel, dh_skind, dh_sa, dh_sb, dh_val, dh_probes = dh
    is_set = t_skind == 1
    rh_obj, rh_rel, rh_row, rh_probes, row_ptr, (e_obj, e_rel) = group_rows_csr(
        t_obj[is_set], t_rel[is_set],
        (t_sa[is_set].astype(np.int32), t_sb[is_set].astype(np.int32)),
        layout,
    )
    return {
        "dh_obj": dh_obj, "dh_rel": dh_rel, "dh_skind": dh_skind,
        "dh_sa": dh_sa, "dh_sb": dh_sb, "dh_val": dh_val, "dh_probes": dh_probes,
        "rh_obj": rh_obj, "rh_rel": rh_rel, "rh_row": rh_row, "rh_probes": rh_probes,
        "row_ptr": row_ptr, "e_obj": e_obj, "e_rel": e_rel,
    }


# -- the columnar vocabularies ---------------------------------------------------

_SEP = "\x1f"


class ArrayMap:
    """A vocabulary as a sorted key array: the columnar builder's object
    slots and subject ids, where a dict of 1e7 entries would cost GBs and
    seconds of insertion. `get` is one searchsorted; without `values` an
    id is the key's sorted position. `encode` / `decode` adapt composite
    keys ((ns_id, obj) <-> "ns_id\\x1fobj"). The dict surface the engine
    reads: get, in, len, items.

    Keys are unicode (U) or UTF-8 bytes (S); the columnar builder stores
    S (a quarter of U's bytes, memcmp order), and UTF-8 byte order is
    code-point order, so both sort alike. The str <-> bytes adaptation
    happens here, at a lookup."""

    def __init__(self, sorted_keys: np.ndarray, encode=None, decode=None, values=None):
        self._keys = sorted_keys
        self._is_bytes = sorted_keys.dtype.kind == "S"
        # characters (U) or bytes (S) a key holds at most
        self._width = sorted_keys.dtype.itemsize // (1 if self._is_bytes else 4)
        self._values = values
        self._by_id: Optional[np.ndarray] = None  # id -> raw key, built lazily
        self._encode = encode or (lambda k: k)
        self._decode = decode or (lambda s: s)

    def keys_by_id_array(self) -> np.ndarray:
        """Raw keys ordered by id (one inverse permutation, cached)."""
        if self._by_id is None:
            if self._values is None:
                self._by_id = self._keys
            else:
                inv = np.empty(len(self._keys), dtype=np.int64)
                inv[np.asarray(self._values, dtype=np.int64)] = np.arange(
                    len(self._keys), dtype=np.int64)
                self._by_id = self._keys[inv]
        return self._by_id

    def _raw_to_str(self, raw) -> str:
        return bytes(raw).decode("utf-8") if self._is_bytes else str(raw)

    def key_by_id(self, i: int):
        """The decoded key of one id."""
        return self._decode(self._raw_to_str(self.keys_by_id_array()[i]))

    def get(self, key, default=None):
        k = self._encode(key)
        if self._is_bytes:
            k = k.encode("utf-8")
        # a key longer than the array's width is in no entry; searchsorted
        # would first widen the whole key array to its width
        if len(k) > self._width or len(self._keys) == 0:
            return default
        i = int(np.searchsorted(self._keys, k))
        if i < len(self._keys) and self._keys[i] == k:
            return int(self._values[i]) if self._values is not None else i
        return default

    def __contains__(self, key) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return len(self._keys)

    def items(self):
        for i, k in enumerate(self._keys):
            v = int(self._values[i]) if self._values is not None else i
            yield self._decode(self._raw_to_str(k)), v

    def merged_with(self, new_items: dict) -> "ArrayMap":
        """A new ArrayMap with `new_items` (decoded key -> id) inserted.
        Existing ids are kept, so the merged map carries an explicit value
        array (a sorted position is no longer an id): the incremental
        compaction's vocabulary (engine/compact.py)."""
        if not new_items:
            return self
        enc = [self._encode(k) for k in new_items]
        if self._is_bytes:
            new_keys = np.array([e.encode("utf-8") for e in enc], dtype="S")
        else:
            new_keys = np.array(enc, dtype="U")
        new_vals = np.fromiter(new_items.values(), dtype=np.int64, count=len(new_items))
        order = np.argsort(new_keys)
        new_keys, new_vals = new_keys[order], new_vals[order]
        base_keys = self._keys
        # np.insert truncates values longer than the array's itemsize:
        # widen first
        if new_keys.dtype.itemsize > base_keys.dtype.itemsize:
            base_keys = base_keys.astype(new_keys.dtype)
        else:
            new_keys = new_keys.astype(base_keys.dtype)
        base_vals = (np.arange(len(base_keys), dtype=np.int64) if self._values is None
                     else np.asarray(self._values, dtype=np.int64))
        pos = np.searchsorted(base_keys, new_keys)
        return ArrayMap(np.insert(base_keys, pos, new_keys), encode=self._encode,
                        decode=self._decode, values=np.insert(base_vals, pos, new_vals))


class _ArrayIdLookup:
    """id -> decoded key over an ArrayMap, without a reverse dict: at 1e7
    slots inverting into a Python dict costs GBs and minutes."""

    __slots__ = ("_amap",)

    def __init__(self, amap: ArrayMap):
        self._amap = amap

    def __getitem__(self, i):
        return self._amap.key_by_id(int(i))

    def get(self, i, default=None):
        i = int(i)
        return self._amap.key_by_id(i) if 0 <= i < len(self._amap) else default


def vocab_by_id(mapping):
    """id -> key of a vocabulary (a dict or an ArrayMap): indexable, with
    `get`. An ArrayMap answers from its key array, a dict is inverted."""
    if isinstance(mapping, ArrayMap):
        return _ArrayIdLookup(mapping)
    return {v: k for k, v in mapping.items()}


def vocab_merged(mapping, new_items: dict):
    """The vocabulary with `new_items` (key -> id) appended and the base's
    ids kept: a dict copies and updates, an ArrayMap merges them in sorted
    (ArrayMap.merged_with)."""
    if not new_items:
        return mapping
    if isinstance(mapping, ArrayMap):
        return mapping.merged_with(new_items)
    out = dict(mapping)
    out.update(new_items)
    return out


def _encode_obj_key(key) -> str:
    ns_id, obj = key
    return f"{ns_id}{_SEP}{obj}"


def _decode_obj_key(s: str):
    ns, _, obj = s.partition(_SEP)
    return (int(ns), obj)


def _compose_keys(ns_ids_arr: np.ndarray, objs: np.ndarray) -> np.ndarray:
    """Unicode "%d\\x1f%s" composite keys (an ns id holds no separator,
    so the first one delimits)."""
    return np.char.add(np.char.add(ns_ids_arr.astype("U11"), _SEP), objs.astype("U"))


def _compose_keys_bytes(ns_ids_arr: np.ndarray, objs: np.ndarray) -> np.ndarray:
    """The composite keys of _compose_keys as UTF-8 bytes (S), assembled
    by slice assignment into one uint8 buffer a distinct ns id (namespaces
    are few) in place of np.char.add's per-element passes."""
    n = len(objs)
    if n == 0:
        return np.array([], dtype="S1")
    obj_s = _encode_utf8(objs)
    ow = obj_s.dtype.itemsize
    ids = np.asarray(ns_ids_arr, dtype=np.int64)
    uniq = np.unique(ids)
    if len(uniq) > 256:  # many namespaces: one pass beats a slice a namespace
        return np.char.add(np.char.add(ids.astype("S11"), _SEP.encode()), obj_s)
    prefixes = {int(u): f"{int(u)}{_SEP}".encode() for u in uniq}
    total = max(len(p) for p in prefixes.values()) + ow
    buf = np.zeros((n, total), dtype=np.uint8)
    ob = np.ascontiguousarray(obj_s).view(np.uint8).reshape(n, ow)
    for u, p in prefixes.items():
        rows = np.flatnonzero(ids == u)
        pw = len(p)
        buf[rows, :pw] = np.frombuffer(p, dtype=np.uint8)
        buf[rows, pw: pw + ow] = ob[rows]
    return buf.view(f"S{total}").ravel()


def _encode_utf8(arr: np.ndarray) -> np.ndarray:
    """U -> S (UTF-8). An all-ASCII array narrows by one cast (a U array
    is UCS-4, and an ASCII code point is its UTF-8 byte); anything else
    goes through np.char.encode. Trailing NULs pad as np.char.encode's."""
    if arr.dtype.kind != "U":
        arr = arr.astype("U")
    n = len(arr)
    if n == 0:
        return np.array([], dtype="S1")
    w = arr.dtype.itemsize // 4
    cp = np.ascontiguousarray(arr).view(np.uint32).reshape(n, w)
    if cp.max(initial=0) < 128:
        return np.ascontiguousarray(cp.astype(np.uint8)).view(f"S{w}").ravel()
    return np.char.encode(arr, "utf-8")


def _queries_like(keys: np.ndarray, queries_u: np.ndarray) -> np.ndarray:
    """A U query array in the key array's dtype: numpy compares S with U
    elementwise False without an error, so a missed conversion would
    drop every row silently."""
    return _encode_utf8(queries_u) if keys.dtype.kind == "S" else queries_u


def _compose_keys_like(keys: np.ndarray, ns_ids_arr: np.ndarray, objs: np.ndarray) -> np.ndarray:
    """Composite queries in the key array's dtype."""
    if keys.dtype.kind == "S":
        return _compose_keys_bytes(ns_ids_arr, objs)
    return _compose_keys(ns_ids_arr, objs)


def _sorted_lookup(keys_sorted, vals_sorted, queries, default=-1):
    """queries -> values by binary search; vals_sorted None means the
    value is the sorted position (ArrayMap's columnar form)."""
    n = len(keys_sorted)
    if n == 0:
        return np.full(len(queries), default, dtype=np.int32)
    fits = True
    if queries.dtype.itemsize > keys_sorted.dtype.itemsize:
        # searchsorted would widen every key to the queries' width: cut
        # the queries to the keys' width instead, and let no query longer
        # than every key match
        width = keys_sorted.dtype.itemsize // (4 if keys_sorted.dtype.kind == "U" else 1)
        fits = np.char.str_len(queries) <= width
        queries = queries.astype(keys_sorted.dtype)
    idx = np.clip(np.searchsorted(keys_sorted, queries), 0, n - 1)
    ok = (keys_sorted[idx] == queries) & fits
    vals = idx if vals_sorted is None else vals_sorted[idx]
    return np.where(ok, vals, default).astype(np.int32)


@dataclass
class GraphSnapshot:
    """Immutable host mirror of one network's relation graph."""

    ns_ids: dict[str, int]
    rel_ids: dict[str, int]
    # the big vocabularies: dicts from build_snapshot, ArrayMaps from
    # build_snapshot_columnar (the same get / in / len / items)
    obj_slots: dict  # (ns_id, object) -> slot
    subj_ids: dict  # plain subject string -> id
    n_config_rels: int  # rel ids < this may have rewrite programs
    wildcard_rel: int  # rel id of "..."
    layout: str  # probe-table layout every table of this snapshot uses

    objslot_ns: np.ndarray  # obj_slot -> ns_id
    ns_has_config: np.ndarray  # ns_id -> 1 iff it declares relations

    dh_obj: np.ndarray
    dh_rel: np.ndarray
    dh_skind: np.ndarray
    dh_sa: np.ndarray
    dh_sb: np.ndarray
    dh_val: np.ndarray
    dh_probes: int

    rh_obj: np.ndarray
    rh_rel: np.ndarray
    rh_row: np.ndarray
    rh_probes: int

    row_ptr: np.ndarray  # [n_rows + 1]
    e_obj: np.ndarray  # [n_edges] subject-set object slot
    e_rel: np.ndarray  # [n_edges] subject-set relation id

    # rewrite programs, dense [n_ns * n_config_rels, K]; K is the effective
    # max program length (the kernel's expansion slot count is K + 1)
    instr_kind: np.ndarray
    instr_rel: np.ndarray
    instr_rel2: np.ndarray
    prog_flags: np.ndarray
    K: int

    # island programs: pid -> postfix circuit over leaf values
    island_circuits: dict = field(default_factory=dict)

    version: int = 0
    n_tuples: int = 0
    # CSR edges an incremental compaction left behind when it rewrote
    # their rows at the tail (engine/compact.py)
    merge_garbage: int = 0
    # _map_sorted_arrays of each vocabulary, built at the first vectorised
    # encode (the snapshot is immutable)
    _vocab_cache: dict = field(default_factory=dict, repr=False, compare=False)

    def device_arrays(self) -> dict[str, np.ndarray]:
        """The columnar arrays the kernel's packed tables are made from."""
        return {
            "objslot_ns": self.objslot_ns,
            "ns_has_config": self.ns_has_config,
            "dh_obj": self.dh_obj, "dh_rel": self.dh_rel,
            "dh_skind": self.dh_skind, "dh_sa": self.dh_sa,
            "dh_sb": self.dh_sb, "dh_val": self.dh_val,
            "rh_obj": self.rh_obj, "rh_rel": self.rh_rel, "rh_row": self.rh_row,
            "row_ptr": self.row_ptr, "e_obj": self.e_obj, "e_rel": self.e_rel,
            "instr_kind": self.instr_kind, "instr_rel": self.instr_rel,
            "instr_rel2": self.instr_rel2, "prog_flags": self.prog_flags,
        }


def _is_monotone(rw: ast.SubjectSetRewrite) -> bool:
    if rw.operation != ast.Operator.OR:
        return False
    for child in rw.children:
        if isinstance(child, ast.SubjectSetRewrite):
            if not _is_monotone(child):
                return False
        elif isinstance(child, ast.InvertResult):
            return False
        elif not isinstance(child, (ast.ComputedSubjectSet, ast.TupleToSubjectSet)):
            return False
    return True


def _compile_rewrite(rewrite, rel_ids: dict[str, int], K: int):
    """Compile a rewrite AST. Returns (instructions, circuit, flags):
    pure-union trees flatten to <= K inline instructions (circuit None);
    trees with AND/NOT become an island, whose instructions are its leaf
    sub-checks and whose circuit is a postfix program over the leaf bits
    (FLAG_ISLAND); trees past the caps are FLAG_HOST_ONLY."""
    if rewrite is None:
        return [], None, 0

    if _is_monotone(rewrite):
        instrs: list[tuple[int, int, int]] = []

        def walk(rw: ast.SubjectSetRewrite) -> None:
            for child in rw.children:
                if isinstance(child, ast.ComputedSubjectSet):
                    instrs.append((INSTR_COMPUTED, rel_ids[child.relation], 0))
                elif isinstance(child, ast.TupleToSubjectSet):
                    instrs.append((
                        INSTR_TTU,
                        rel_ids[child.relation],
                        rel_ids[child.computed_subject_set_relation],
                    ))
                else:
                    walk(child)

        walk(rewrite)
        if len(instrs) > K:
            return [], None, FLAG_HOST_ONLY
        return instrs, None, 0

    leaves: list[tuple[int, int, int]] = []
    leaf_index: dict[tuple[int, int, int], int] = {}
    ops: list[tuple] = []
    ok = True

    def leaf(key: tuple[int, int, int]) -> None:
        k = leaf_index.get(key)
        if k is None:
            k = len(leaves)
            leaf_index[key] = k
            leaves.append(key)
        ops.append((CIRC_LEAF, k))

    def emit(node) -> None:
        nonlocal ok
        if isinstance(node, ast.ComputedSubjectSet):
            leaf((INSTR_COMPUTED, rel_ids[node.relation], 0))
        elif isinstance(node, ast.TupleToSubjectSet):
            leaf((
                INSTR_TTU,
                rel_ids[node.relation],
                rel_ids[node.computed_subject_set_relation],
            ))
        elif isinstance(node, ast.InvertResult):
            emit(node.child)
            ops.append((CIRC_NOT,))
        elif isinstance(node, ast.SubjectSetRewrite):
            if not node.children:
                ops.append((CIRC_FALSE,))  # or([]) = and([]) = NotMember
                return
            combine = CIRC_AND if node.operation == ast.Operator.AND else CIRC_OR
            for i, child in enumerate(node.children):
                emit(child)
                if i:
                    ops.append((combine,))
        else:
            ok = False

    emit(rewrite)
    if not ok or len(leaves) > K or len(ops) > CIRCUIT_CAP:
        return [], None, FLAG_HOST_ONLY
    return leaves, tuple(ops), FLAG_ISLAND


def _walk_rewrite_relations(rw: ast.SubjectSetRewrite):
    """Yield (kind, relation, relation2) for every leaf of a rewrite."""
    for child in rw.children:
        if isinstance(child, ast.ComputedSubjectSet):
            yield ("computed", child.relation, "")
        elif isinstance(child, ast.TupleToSubjectSet):
            yield ("ttu", child.relation, child.computed_subject_set_relation)
        elif isinstance(child, ast.SubjectSetRewrite):
            yield from _walk_rewrite_relations(child)
        elif isinstance(child, ast.InvertResult):
            sub = child.child
            if isinstance(sub, ast.SubjectSetRewrite):
                yield from _walk_rewrite_relations(sub)
            elif isinstance(sub, ast.ComputedSubjectSet):
                yield ("computed", sub.relation, "")
            elif isinstance(sub, ast.TupleToSubjectSet):
                yield ("ttu", sub.relation, sub.computed_subject_set_relation)


# -- the transposed mirror of the list paths (engine/reverse_kernel.py) ---------
#
# ListObjects walks the graph backwards from a subject: a reverse-edge CSR
# of subject-set edges keyed by the subject slot, a reverse-seed CSR of
# all edges keyed by the full subject key, and each relation's rewrite
# inverted into entries keyed by the relation it pulls from.

# inverted-instruction kinds (rinstr_kind lanes)
RINSTR_NONE = 0
RINSTR_COMPUTED = 1  # pred (task obj, rel_p) at the same depth, ns-gated
RINSTR_TTU = 2  # pred (edge obj, rel_p) at depth - 1 when edge rel == rel_t
RINSTR_POISON = 3  # an island program pulls from this relation: host replay

# entries under one target relation past this collapse to one any-ns POISON
RINSTR_CAP = 16

# plain/set discriminator stride of reverse_subject_tag: a fixed constant,
# so builders, the delta's reverse-dirty entries and query encoding agree
# whatever the vocabulary's size
_REVERSE_TAG_STRIDE = 1 << 20


def reverse_subject_tag(skind, sb):
    """Second key column of the reverse-seed CSR: tells plain subject ids
    from subject-set slots that share an int. Tag 0 is reserved for the
    reverse-dirty table's row-level entries."""
    return (
        np.asarray(skind, dtype=np.int32) * np.int32(_REVERSE_TAG_STRIDE)
        + np.asarray(sb, dtype=np.int32)
        + np.int32(1)
    )


def build_reverse_tables(t_obj, t_rel, t_skind, t_sa, t_sb, layout: str) -> dict:
    """The transposed twin of build_edge_tables from the same encoded
    edges: the reverse-edge CSR (subject-set edges by subject slot) and
    the reverse-seed CSR (all edges by full subject key)."""
    is_set = np.asarray(t_skind) == 1
    rvh_obj, rvh_rel, rvh_row, rvh_probes, rv_row_ptr, (rv_pobj, rv_prel, rv_sb) = (
        group_rows_csr(
            t_sa[is_set].astype(np.int32),
            np.zeros(int(is_set.sum()), dtype=np.int32),
            (t_obj[is_set].astype(np.int32), t_rel[is_set].astype(np.int32),
             t_sb[is_set].astype(np.int32)),
            layout,
        )
    )
    tags = reverse_subject_tag(t_skind, t_sb)
    rsh_obj, rsh_tag, rsh_row, rsh_probes, rs_row_ptr, (rs_obj, rs_rel) = group_rows_csr(
        t_sa.astype(np.int32), tags, (t_obj.astype(np.int32), t_rel.astype(np.int32)), layout
    )
    return {
        "rvh_obj": rvh_obj, "rvh_rel": rvh_rel, "rvh_row": rvh_row,
        "rvh_probes": rvh_probes, "rv_row_ptr": rv_row_ptr,
        "rv_pobj": rv_pobj, "rv_prel": rv_prel, "rv_sb": rv_sb,
        "rsh_obj": rsh_obj, "rsh_tag": rsh_tag, "rsh_row": rsh_row,
        "rsh_probes": rsh_probes, "rs_row_ptr": rs_row_ptr,
        "rs_obj": rs_obj, "rs_rel": rs_rel,
    }


def _walk_rewrite_leaves(rw: ast.SubjectSetRewrite, has_not: bool = False):
    """Yield (kind, relation, relation2, under_not) for every leaf of a
    rewrite, AND/NOT islands included: the inverted table must see every
    leaf to know where a reverse walk enters a program."""
    for child in rw.children:
        if isinstance(child, ast.ComputedSubjectSet):
            yield ("computed", child.relation, "", has_not)
        elif isinstance(child, ast.TupleToSubjectSet):
            yield ("ttu", child.relation, child.computed_subject_set_relation, has_not)
        elif isinstance(child, ast.SubjectSetRewrite):
            yield from _walk_rewrite_leaves(child, has_not)
        elif isinstance(child, ast.InvertResult):
            sub = child.child
            if isinstance(sub, ast.SubjectSetRewrite):
                yield from _walk_rewrite_leaves(sub, True)
            elif isinstance(sub, ast.ComputedSubjectSet):
                yield ("computed", sub.relation, "", True)
            elif isinstance(sub, ast.TupleToSubjectSet):
                yield ("ttu", sub.relation, sub.computed_subject_set_relation, True)


def build_reverse_programs(namespaces, ns_ids: dict, rel_ids: dict, n_config_rels: int,
                           cap: int = RINSTR_CAP):
    """Invert every namespace relation's rewrite for the reverse walk.
    Returns (rinstr_kind, rinstr_relp, rinstr_relt, rinstr_ns), dense
    [max(n_config_rels, 1), RK] tables keyed by the target relation rel_c,
    RK, and host_all:

      - a monotone COMPUTED(rel_c) in (ns, rel_p) inverts to
        (COMPUTED, rel_p, 0, ns) and a TTU(rel_t, rel_c) to
        (TTU, rel_p, rel_t, ns)
      - an AND island's leaves invert to POISON entries (ns-gated for
        COMPUTED, any ns (-1) for TTU): a member of the island is a member
        of every leaf, so the walk reaches a leaf relation first
      - any NOT sets host_all: NOT members exist where no path exists,
        which a reachability walk cannot see
      - more than `cap` entries under one rel_c collapse to one any-ns
        POISON."""
    per_target: dict[int, list[tuple[int, int, int, int]]] = {}
    host_all = False
    for ns in namespaces:
        nsid = ns_ids[ns.name]
        for rel in ns.relations:
            rw = rel.subject_set_rewrite
            if rw is None:
                continue
            rel_p = rel_ids[rel.name]
            monotone = _is_monotone(rw)
            for kind, a, b, under_not in _walk_rewrite_leaves(rw):
                host_all |= under_not
                if kind == "computed":
                    rel_c, rel_t = rel_ids[a], 0
                    ekind = RINSTR_COMPUTED if monotone else RINSTR_POISON
                    ens = nsid
                else:
                    rel_c, rel_t = rel_ids[b], rel_ids[a]
                    ekind = RINSTR_TTU if monotone else RINSTR_POISON
                    ens = nsid if monotone else -1
                per_target.setdefault(rel_c, []).append((ekind, rel_p, rel_t, ens))
    for rel_c, entries in per_target.items():
        uniq = list(dict.fromkeys(entries))  # shared sub-rewrites repeat entries
        per_target[rel_c] = uniq if len(uniq) <= cap else [(RINSTR_POISON, 0, 0, -1)]
    RK = max([len(v) for v in per_target.values()] + [1])
    NR = max(n_config_rels, 1)
    cols = [np.zeros((NR, RK), dtype=np.int32) for _ in range(4)]
    for rel_c, entries in per_target.items():
        for k, entry in enumerate(entries):
            for col, v in zip(cols, entry):
                col[rel_c, k] = v
    return (*cols, RK, host_all)


def _register_config_vocab(namespaces, ns_id, rel_id) -> None:
    """Config relations first, so rewrite-capable rel ids are dense in
    [0, n_config_rels) and the program table stays small."""
    rel_id(WILDCARD_RELATION)
    for ns in namespaces:
        ns_id(ns.name)
        for rel in ns.relations:
            rel_id(rel.name)
            if rel.subject_set_rewrite is not None:
                for _kind, a, b in _walk_rewrite_relations(rel.subject_set_rewrite):
                    rel_id(a)
                    if b:
                        rel_id(b)


def _build_programs(namespaces, ns_ids, rel_ids, n_config_rels, n_ns, K):
    """Dense program tables of every namespace relation's rewrite."""
    NR = n_ns * max(n_config_rels, 1)
    compiled: dict[int, tuple] = {}
    missing_flags: list[int] = []
    for ns in namespaces:
        nsid = ns_ids[ns.name]
        if not ns.relations:
            continue
        declared = {rel.name for rel in ns.relations}
        # an undeclared relation visited in this namespace is an error
        for rel_name, rid in rel_ids.items():
            if rid < n_config_rels and rel_name not in declared:
                missing_flags.append(nsid * n_config_rels + rid)
        for rel in ns.relations:
            pidx = nsid * n_config_rels + rel_ids[rel.name]
            compiled[pidx] = _compile_rewrite(rel.subject_set_rewrite, rel_ids, K)

    K_eff = max([len(instrs) for instrs, _, _ in compiled.values()] + [1])
    instr_kind = np.zeros((NR, K_eff), dtype=np.int32)
    instr_rel = np.zeros((NR, K_eff), dtype=np.int32)
    instr_rel2 = np.zeros((NR, K_eff), dtype=np.int32)
    prog_flags = np.zeros(NR, dtype=np.int32)
    island_circuits: dict[int, tuple] = {}
    for pidx in missing_flags:
        prog_flags[pidx] |= FLAG_CONFIG_MISSING
    for pidx, (instrs, circuit, cflags) in compiled.items():
        prog_flags[pidx] |= cflags
        if circuit is not None:
            island_circuits[pidx] = circuit
        for k, (kind, a, b) in enumerate(instrs):
            instr_kind[pidx, k] = kind
            instr_rel[pidx, k] = a
            instr_rel2[pidx, k] = b
    return instr_kind, instr_rel, instr_rel2, prog_flags, K_eff, island_circuits


def build_snapshot(
    tuples: Sequence[RelationTuple],
    namespaces: Sequence[Namespace],
    *,
    layout: str,
    K: int = 8,
    version: int = 0,
) -> GraphSnapshot:
    ns_ids: dict[str, int] = {}
    rel_ids: dict[str, int] = {}
    obj_slots: dict[tuple[int, str], int] = {}
    subj_ids: dict[str, int] = {}

    def ns_id(name: str) -> int:
        return ns_ids.setdefault(name, len(ns_ids))

    def rel_id(name: str) -> int:
        return rel_ids.setdefault(name, len(rel_ids))

    _register_config_vocab(namespaces, ns_id, rel_id)
    n_config_rels = len(rel_ids)

    for t in tuples:
        n = ns_id(t.namespace)
        obj_slots.setdefault((n, t.object), len(obj_slots))
        rel_id(t.relation)
        if t.subject_set is not None:
            s = t.subject_set
            obj_slots.setdefault((ns_id(s.namespace), s.object), len(obj_slots))
            rel_id(s.relation)
        else:
            subj_ids.setdefault(t.subject_id or "", len(subj_ids))

    n_ns = max(len(ns_ids), 1)
    objslot_ns = np.zeros(pad_headroom(max(len(obj_slots), 1)), dtype=np.int32)
    if obj_slots:
        keys = np.fromiter((k[0] for k in obj_slots), dtype=np.int32, count=len(obj_slots))
        slots = np.fromiter(obj_slots.values(), dtype=np.int64, count=len(obj_slots))
        objslot_ns[slots] = keys
    ns_has_config = np.zeros(pad_headroom(n_ns, 64), dtype=np.int32)
    for ns in namespaces:
        if ns.relations:
            ns_has_config[ns_ids[ns.name]] = 1

    edges = encode_edge_arrays(tuples, ns_ids, rel_ids, obj_slots, subj_ids)
    tables = build_edge_tables(*edges, layout=layout)
    (
        instr_kind, instr_rel, instr_rel2, prog_flags, K_eff, island_circuits,
    ) = _build_programs(namespaces, ns_ids, rel_ids, n_config_rels, n_ns, K)

    return GraphSnapshot(
        ns_ids=ns_ids, rel_ids=rel_ids, obj_slots=obj_slots, subj_ids=subj_ids,
        n_config_rels=n_config_rels,
        wildcard_rel=rel_ids[WILDCARD_RELATION],
        layout=layout,
        objslot_ns=objslot_ns, ns_has_config=ns_has_config,
        dh_obj=tables["dh_obj"], dh_rel=tables["dh_rel"],
        dh_skind=tables["dh_skind"], dh_sa=tables["dh_sa"],
        dh_sb=tables["dh_sb"], dh_val=tables["dh_val"],
        dh_probes=tables["dh_probes"],
        rh_obj=tables["rh_obj"], rh_rel=tables["rh_rel"],
        rh_row=tables["rh_row"], rh_probes=tables["rh_probes"],
        row_ptr=tables["row_ptr"], e_obj=tables["e_obj"], e_rel=tables["e_rel"],
        instr_kind=instr_kind, instr_rel=instr_rel, instr_rel2=instr_rel2,
        prog_flags=prog_flags, K=K_eff, island_circuits=island_circuits,
        version=version, n_tuples=len(tuples),
    )


def columnar_encode(cols, namespaces: Sequence[Namespace], *, layout: str, K: int = 8,
                    version: int = 0) -> tuple[GraphSnapshot, tuple[np.ndarray, ...]]:
    """The columnar vocabulary build and edge encoding: every per-tuple
    step a numpy primitive or the native encoder, no Python loop over
    tuples. `cols` is a storage.columns.TupleColumns. Ids are sorted-unique
    ranks where build_snapshot gives insertion order (ids never leave the
    engine); the object slots and subject ids become ArrayMaps.

    Returns (a snapshot with empty edge tables, the encoded edges (t_obj,
    t_rel, t_skind, t_sa, t_sb)), as the JAX package's columnar_encode."""
    check_layout(layout)
    ns_ids: dict[str, int] = {}
    rel_ids: dict[str, int] = {}
    _register_config_vocab(
        namespaces,
        lambda name: ns_ids.setdefault(name, len(ns_ids)),
        lambda name: rel_ids.setdefault(name, len(rel_ids)),
    )
    n_config_rels = len(rel_ids)

    is_set = cols.skind == 1
    n_t = len(cols)

    # data namespaces and relations join the small dicts in sorted order,
    # every row factorised by one sorted-unique encode a name family
    def factorize(d: dict, own: np.ndarray, sub: np.ndarray):
        uniq, _, codes = sorted_unique_encode(_encode_utf8(np.concatenate([own, sub[is_set]])))
        for name in uniq:
            d.setdefault(name.decode("utf-8"), len(d))
        rank_to_id = np.array([d[name.decode("utf-8")] for name in uniq], dtype=np.int32)
        own_ids = rank_to_id[codes[: len(own)]]
        sub_ids = np.zeros(len(sub), dtype=np.int32)
        sub_ids[is_set] = rank_to_id[codes[len(own):]]
        return own_ids, sub_ids

    t_ns, s_ns = factorize(ns_ids, cols.ns, cols.sns)
    t_rel, s_rel = factorize(rel_ids, cols.rel, cols.srel)

    # object slots: the sorted-unique composite (ns_id, object) keys, in
    # UTF-8 bytes; a slot is its key's sorted position
    own_keys = _compose_keys_bytes(t_ns, cols.obj)
    set_keys = _compose_keys_bytes(s_ns[is_set], cols.sobj[is_set])
    all_keys = np.concatenate([own_keys, set_keys])
    all_ns = np.concatenate([t_ns, s_ns[is_set]])
    if len(all_keys):
        uniq_keys, first_idx, all_codes = sorted_unique_encode(all_keys)
    else:
        uniq_keys, first_idx, all_codes = (np.array([], dtype="S1"),
                                           np.array([], dtype=np.int64),
                                           np.array([], dtype=np.int32))
    obj_slots = ArrayMap(uniq_keys, encode=_encode_obj_key, decode=_decode_obj_key)
    t_obj = all_codes[: len(own_keys)]
    sa_set = all_codes[len(own_keys):]

    plain = ~is_set
    if plain.any():
        subj_keys, _, sa_plain = sorted_unique_encode(_encode_utf8(cols.sobj[plain]))
    else:
        subj_keys, sa_plain = np.array([], "S1"), np.array([], dtype=np.int32)
    subj_ids = ArrayMap(subj_keys)

    t_skind = cols.skind.astype(np.int32)
    t_sa = np.zeros(n_t, dtype=np.int32)
    t_sb = np.zeros(n_t, dtype=np.int32)
    t_sa[is_set] = sa_set
    t_sb[is_set] = s_rel[is_set]
    t_sa[plain] = sa_plain

    n_ns = max(len(ns_ids), 1)
    objslot_ns = np.zeros(pad_headroom(max(len(uniq_keys), 1)), dtype=np.int32)
    if len(uniq_keys):
        objslot_ns[: len(uniq_keys)] = all_ns[first_idx]
    ns_has_config = np.zeros(pad_headroom(n_ns, 64), dtype=np.int32)
    for ns in namespaces:
        if ns.relations:
            ns_has_config[ns_ids[ns.name]] = 1

    (
        instr_kind, instr_rel, instr_rel2, prog_flags, K_eff, island_circuits,
    ) = _build_programs(namespaces, ns_ids, rel_ids, n_config_rels, n_ns, K)
    z = np.zeros(0, dtype=np.int32)
    snap = _snapshot_with_tables(
        build_edge_tables(z, z, z, z, z, layout=layout),
        ns_ids=ns_ids, rel_ids=rel_ids, obj_slots=obj_slots, subj_ids=subj_ids,
        n_config_rels=n_config_rels, wildcard_rel=rel_ids[WILDCARD_RELATION], layout=layout,
        objslot_ns=objslot_ns, ns_has_config=ns_has_config,
        instr_kind=instr_kind, instr_rel=instr_rel, instr_rel2=instr_rel2,
        prog_flags=prog_flags, K=K_eff, island_circuits=island_circuits,
        version=version, n_tuples=n_t,
    )
    return snap, (t_obj, t_rel, t_skind, t_sa, t_sb)


_TABLE_KEYS = ("dh_obj", "dh_rel", "dh_skind", "dh_sa", "dh_sb", "dh_val", "dh_probes",
               "rh_obj", "rh_rel", "rh_row", "rh_probes", "row_ptr", "e_obj", "e_rel")


def _snapshot_with_tables(tables: dict, **fields) -> GraphSnapshot:
    return GraphSnapshot(**fields, **{k: tables[k] for k in _TABLE_KEYS})


def build_snapshot_columnar(cols, namespaces: Sequence[Namespace], *, layout: str, K: int = 8,
                            version: int = 0, split: Optional[dict] = None) -> GraphSnapshot:
    """build_snapshot from TupleColumns: the vectorised vocabulary build
    and encoding (columnar_encode), then one set of edge tables. `split`,
    when given, receives the seconds of each (encode_s, probe_tables_s)."""
    import dataclasses

    t0 = time.perf_counter()
    snap, edges = columnar_encode(cols, namespaces, layout=layout, K=K, version=version)
    t1 = time.perf_counter()
    tables = build_edge_tables(*edges, layout=layout)
    if split is not None:
        split.update(encode_s=t1 - t0, probe_tables_s=time.perf_counter() - t1)
    return dataclasses.replace(snap, **{k: tables[k] for k in _TABLE_KEYS})


def _map_sorted_arrays(mapping, composite: bool = False):
    """(sorted keys, values) of a vocabulary dict or ArrayMap for
    _sorted_lookup; `composite` writes (ns_id, object) dict keys in the
    ArrayMap's "ns\\x1fobj" form. An ArrayMap without values gives None
    (the value is the sorted position)."""
    if isinstance(mapping, ArrayMap):
        vals = None if mapping._values is None else np.asarray(mapping._values, dtype=np.int64)
        return mapping._keys, vals
    if composite:
        items = [(f"{ns}{_SEP}{obj}", v) for (ns, obj), v in mapping.items()]
    else:
        items = list(mapping.items())
    if not items:
        return np.array([], dtype="U1"), np.array([], dtype=np.int64)
    keys = np.array([k for k, _ in items], dtype="U")
    vals = np.array([v for _, v in items], dtype=np.int64)
    order = np.argsort(keys)
    return keys[order], vals[order]


def _vocab_arrays(snap: GraphSnapshot, name: str, mapping, composite=False):
    """_map_sorted_arrays of one vocabulary, cached on the snapshot."""
    cached = snap._vocab_cache.get(name)
    if cached is None:
        cached = _map_sorted_arrays(mapping, composite=composite)
        snap._vocab_cache[name] = cached
    return cached


def _lookup_name_columns(snap: GraphSnapshot, ns_a, obj_a, rel_a, is_set, sns_a, sobj_a, srel_a):
    """Base-vocabulary lookups over U name columns. An unknown namespace
    composes to "-1\\x1f...", which matches nothing. Returns (t_ns, t_rel,
    t_obj, s_ns, s_rel, s_slot, sid), int32, -1 where the base lacks it."""
    ns_keys, ns_vals = _vocab_arrays(snap, "ns", snap.ns_ids)
    rel_keys, rel_vals = _vocab_arrays(snap, "rel", snap.rel_ids)
    obj_keys, obj_vals = _vocab_arrays(snap, "obj", snap.obj_slots, True)
    subj_keys, subj_vals = _vocab_arrays(snap, "subj", snap.subj_ids)

    t_ns = _sorted_lookup(ns_keys, ns_vals, ns_a)
    t_rel = _sorted_lookup(rel_keys, rel_vals, rel_a)
    t_obj = _sorted_lookup(obj_keys, obj_vals, _compose_keys_like(obj_keys, t_ns, obj_a))
    s_ns = np.where(is_set, _sorted_lookup(ns_keys, ns_vals, sns_a), -1)
    s_rel = np.where(is_set, _sorted_lookup(rel_keys, rel_vals, srel_a), -1)
    s_slot = _sorted_lookup(obj_keys, obj_vals, _compose_keys_like(obj_keys, s_ns, sobj_a))
    sid = _sorted_lookup(subj_keys, subj_vals, _queries_like(subj_keys, sobj_a))
    return t_ns, t_rel, t_obj, s_ns, s_rel, s_slot, sid


def encode_edge_columns(cols, snapshot: GraphSnapshot):
    """(t_obj, t_rel, t_skind, t_sa, t_sb, keep) of TupleColumns under a
    snapshot's base vocabulary, vectorised. A row with a name the base
    does not know drops (keep False): a tuple written after the base rides
    the overlay, and its row is dirty, which sends the queries that reach
    it to the host oracle whatever the CSR holds."""
    is_set = np.asarray(cols.skind) == 1
    _, t_rel, t_obj, _, s_rel, s_slot, sa_plain = _lookup_name_columns(
        snapshot, cols.ns.astype("U"), cols.obj, cols.rel.astype("U"),
        is_set, cols.sns.astype("U"), cols.sobj, cols.srel.astype("U"),
    )
    t_skind = np.asarray(cols.skind, dtype=np.int32)
    t_sa = np.where(is_set, s_slot, sa_plain).astype(np.int32)
    t_sb = np.where(is_set, np.maximum(s_rel, 0), 0).astype(np.int32)
    subject_ok = np.where(is_set, (s_slot != -1) & (s_rel != -1), sa_plain != -1)
    keep = (t_obj != -1) & (t_rel != -1) & subject_ok
    return t_obj, t_rel, t_skind, t_sa, t_sb, keep


def _encode_nodes(view, ns_l, obj_l, rel_l, present):
    """(slot, rel, valid) of n (namespace, object, relation) nodes: the
    base lookups vectorised, then the overlay's small dicts for the nodes
    the base lacks."""
    snap = view.snapshot
    ns_keys, ns_vals = _vocab_arrays(snap, "ns", snap.ns_ids)
    rel_keys, rel_vals = _vocab_arrays(snap, "rel", snap.rel_ids)
    obj_keys, obj_vals = _vocab_arrays(snap, "obj", snap.obj_slots, True)
    t_ns = _sorted_lookup(ns_keys, ns_vals, np.asarray(ns_l, dtype="U"))
    t_rel = _sorted_lookup(rel_keys, rel_vals, np.asarray(rel_l, dtype="U"))
    t_obj = _sorted_lookup(obj_keys, obj_vals,
                           _compose_keys_like(obj_keys, t_ns, np.asarray(obj_l, dtype="U")))
    valid = present & (t_ns != -1) & (t_rel != -1) & (t_obj != -1)
    ov = view.overlay
    if ov is not None:
        for i in np.flatnonzero(present & ~valid):
            i = int(i)
            ns = int(t_ns[i])
            if ns == -1:
                ns = ov.ns_ids.get(ns_l[i], -1)
            rel = int(t_rel[i])
            if rel == -1:
                rel = ov.rel_ids.get(rel_l[i], -1)
            slot = int(t_obj[i])
            if slot == -1 and ns != -1:
                slot = ov.obj_slots.get((ns, obj_l[i]), -1)
            if ns != -1 and rel != -1 and slot != -1:
                t_obj[i], t_rel[i], valid[i] = slot, rel, True
    return t_obj, t_rel, valid


def encode_node_batch(view, triples, B: int):
    """(q_obj, q_rel, q_valid) of length B for (namespace, object,
    relation) triples (None leaves a row invalid), an expand batch's
    nodes: vectorised over an ArrayMap vocabulary, one node at a time
    over a dict."""
    n = len(triples)
    q_obj = np.zeros(B, dtype=np.int32)
    q_rel = np.zeros(B, dtype=np.int32)
    q_valid = np.zeros(B, dtype=bool)
    if not isinstance(view.snapshot.obj_slots, ArrayMap):
        for i, tr in enumerate(triples):
            node = None if tr is None else view.encode_node(*tr)
            if node is not None:
                q_obj[i], q_rel[i] = node
                q_valid[i] = True
        return q_obj, q_rel, q_valid
    ns_l, obj_l, rel_l = [""] * n, [""] * n, [""] * n
    present = np.zeros(n, dtype=bool)
    for i, tr in enumerate(triples):
        if tr is not None:
            ns_l[i], obj_l[i], rel_l[i] = tr
            present[i] = True
    t_obj, t_rel, valid = _encode_nodes(view, ns_l, obj_l, rel_l, present)
    q_obj[:n] = np.where(valid, t_obj, 0)
    q_rel[:n] = np.where(valid, t_rel, 0)
    q_valid[:n] = valid
    return q_obj, q_rel, q_valid


def encode_object_column(view, ns_id: int, objects: Sequence[str]):
    """(slots [n] int32, valid [n] bool) of candidate objects of one
    namespace, the BatchFilter shape: over an ArrayMap vocabulary one
    composite-key search for the column, over a dict one lookup an object;
    then the view's overlay for names first seen after the base snapshot."""
    snap = view.snapshot
    if isinstance(snap.obj_slots, ArrayMap):
        obj_keys, obj_vals = _vocab_arrays(snap, "obj", snap.obj_slots, True)
        slots = _sorted_lookup(obj_keys, obj_vals, _compose_keys_like(
            obj_keys, np.full(len(objects), ns_id, dtype=np.int32),
            np.asarray(objects, dtype="U"))).astype(np.int64)
    else:
        get = snap.obj_slots.get
        slots = np.fromiter((get((ns_id, o), -1) for o in objects), dtype=np.int64,
                            count=len(objects))
    valid = slots != -1
    ov = view.overlay
    if ov is not None and ov.obj_slots and not valid.all():
        for i in np.flatnonzero(~valid):
            slot = ov.obj_slots.get((ns_id, objects[int(i)]))
            if slot is not None:
                slots[i] = slot
                valid[i] = True
    return slots.astype(np.int32), valid


def encode_query_batch(view, tuples: Sequence[RelationTuple], B: int):
    """(q_obj, q_rel, q_skind, q_sa, q_sb, q_valid) arrays of length B.

    A query whose node (namespace, object, relation) is unknown stays
    invalid and is answered by exact host replay (a missing relation in a
    configured namespace must still raise). An unknown subject keeps the
    sentinel sa = -2: the walk still runs, so error flags surface, but no
    direct probe can hit. An ArrayMap-vocabulary snapshot encodes the
    batch vectorised (_encode_query_columns), a dict one query by query."""
    if isinstance(view.snapshot.obj_slots, ArrayMap):
        return _encode_query_columns(view, tuples, B)
    q_obj = np.zeros(B, dtype=np.int32)
    q_rel = np.zeros(B, dtype=np.int32)
    q_skind = np.zeros(B, dtype=np.int32)
    q_sa = np.full(B, -2, dtype=np.int32)
    q_sb = np.zeros(B, dtype=np.int32)
    q_valid = np.zeros(B, dtype=bool)
    for i, t in enumerate(tuples):
        node = view.encode_node(t.namespace, t.object, t.relation)
        if node is None:
            continue
        q_obj[i], q_rel[i] = node
        subject = view.encode_subject(t)
        if subject is not None:
            q_skind[i], q_sa[i], q_sb[i] = subject
        q_valid[i] = True
    return q_obj, q_rel, q_skind, q_sa, q_sb, q_valid


def _encode_query_columns(view, tuples: Sequence[RelationTuple], B: int):
    """encode_query_batch over an ArrayMap vocabulary: one composite-key
    search a column for the batch, then the overlay's small dicts for
    what the base lacks; the same arrays as the loop."""
    snap = view.snapshot
    n = len(tuples)
    ns_l, obj_l, rel_l = [""] * n, [""] * n, [""] * n
    sns_l, sobj_l, srel_l = [""] * n, [""] * n, [""] * n
    skind_l = np.zeros(n, dtype=np.int32)
    for i, t in enumerate(tuples):
        ns_l[i], obj_l[i], rel_l[i] = t.namespace, t.object, t.relation
        if t.subject_set is not None:
            skind_l[i] = 1
            sns_l[i] = t.subject_set.namespace
            sobj_l[i] = t.subject_set.object
            srel_l[i] = t.subject_set.relation
        else:
            sobj_l[i] = t.subject_id or ""
    is_set = skind_l == 1
    node_obj, node_rel, node_valid = _encode_nodes(view, ns_l, obj_l, rel_l,
                                                   np.ones(n, dtype=bool))
    ns_keys, ns_vals = _vocab_arrays(snap, "ns", snap.ns_ids)
    rel_keys, rel_vals = _vocab_arrays(snap, "rel", snap.rel_ids)
    obj_keys, obj_vals = _vocab_arrays(snap, "obj", snap.obj_slots, True)
    subj_keys, subj_vals = _vocab_arrays(snap, "subj", snap.subj_ids)
    sobj_arr = np.asarray(sobj_l, dtype="U")
    s_ns = np.where(is_set, _sorted_lookup(ns_keys, ns_vals, np.asarray(sns_l, "U")), -1)
    s_rel = np.where(is_set, _sorted_lookup(rel_keys, rel_vals, np.asarray(srel_l, "U")), -1)
    s_slot = _sorted_lookup(obj_keys, obj_vals, _compose_keys_like(obj_keys, s_ns, sobj_arr))
    sid = _sorted_lookup(subj_keys, subj_vals, _queries_like(subj_keys, sobj_arr))
    set_ok = is_set & (s_slot != -1) & (s_rel != -1)
    plain_ok = ~is_set & (sid != -1)

    q_obj = np.zeros(B, dtype=np.int32)
    q_rel = np.zeros(B, dtype=np.int32)
    q_skind = np.zeros(B, dtype=np.int32)
    q_sa = np.full(B, -2, dtype=np.int32)
    q_sb = np.zeros(B, dtype=np.int32)
    q_valid = np.zeros(B, dtype=bool)
    q_obj[:n] = np.where(node_valid, node_obj, 0)
    q_rel[:n] = np.where(node_valid, node_rel, 0)
    q_valid[:n] = node_valid
    q_skind[:n] = np.where(set_ok, 1, 0)
    q_sa[:n] = np.where(set_ok, s_slot, np.where(plain_ok, sid, -2))
    q_sb[:n] = np.where(set_ok, s_rel, 0)

    ov = view.overlay
    if ov is not None:
        # the subjects the base lacks, through the overlay's small dicts
        for i in np.flatnonzero(node_valid & ~(set_ok | plain_ok)):
            i = int(i)
            t = tuples[i]
            if t.subject_set is not None:
                s = t.subject_set
                sns = int(s_ns[i])
                if sns == -1:
                    sns = ov.ns_ids.get(s.namespace, -1)
                srl = int(s_rel[i])
                if srl == -1:
                    srl = ov.rel_ids.get(s.relation, -1)
                ssl = int(s_slot[i])
                if ssl == -1 and sns != -1:
                    ssl = ov.obj_slots.get((sns, s.object), -1)
                if sns != -1 and srl != -1 and ssl != -1:
                    q_skind[i], q_sa[i], q_sb[i] = 1, ssl, srl
            else:
                sv = ov.subj_ids.get(t.subject_id or "", -1)
                if sv != -1:
                    q_skind[i], q_sa[i], q_sb[i] = 0, sv, 0
    return q_obj, q_rel, q_skind, q_sa, q_sb, q_valid

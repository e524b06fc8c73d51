"""Columnar tuple store: numpy columns in place of one object a tuple.

The store of the scale tier (`dsn: "columnar"`): each network keeps its
tuples as seven numpy columns (storage/columns.py), about 100 bytes a
tuple, beside a small write buffer of RelationTuple objects, so that 1e7
tuples fit in a few GB of host memory and a bulk transformation (dedupe,
filter, the mirror's encode) is a numpy primitive or the native encoder.

The Manager surface and the write listeners of storage/memory.py, with
the JAX package's ColumnarStore semantics (keto_tpu/storage/columnar.py):
  - idempotent inserts per (nid, tuple), keyed by the tuple's identity
    key "ns\\x1fobj\\x1frel\\x1fskind\\x1fsns\\x1fsobj\\x1fsrel" (UTF-8 bytes)
  - keyset pagination in identity-key order with an N+1 probe; the filter
    runs over the columns, and only the page's rows become objects
  - a version a changed tuple and a bounded change log; `bulk_load`
    resets the log's floor, so `changes_since` answers None across it
    and the engine rebuilds its mirror

For the scale path:
  - bulk_load(cols, nid): a columnar append, deduplicated
  - all_tuple_columns(nid): the columns the columnar mirror builders read
"""

from __future__ import annotations

import base64
import threading
from collections import deque
from typing import Optional, Sequence

import numpy as np

from .. import faults as _faults
from ..errors import InvalidPageTokenError
from ..ketoapi import RelationQuery, RelationTuple
from .columns import TupleColumns, concat_columns
from .definitions import DEFAULT_NETWORK, DEFAULT_PAGE_SIZE, WriteHookMixin

CHANGE_LOG_CAP = 1 << 16
_SEP = "\x1f"
# the write buffer folds into the columns past this many tuples
_BUFFER_MERGE_THRESHOLD = 4096


def _identity_keys(cols: TupleColumns) -> np.ndarray:
    """Each row's identity key, "\\x1f".join of its seven fields (skind as
    "0" / "1"), as UTF-8 bytes (S): a quarter of U's bytes through every
    dedupe sort, and the same order (UTF-8 byte order is code-point
    order). Assembled by one masked flat scatter a column in place of
    np.char.add chains."""
    from ..engine.snapshot import _encode_utf8

    parts = [cols.ns, cols.obj, cols.rel, cols.skind.astype("U1"), cols.sns, cols.sobj, cols.srel]
    n = len(cols)
    if n == 0:
        return np.array([], dtype="S1")
    enc, lens = [], []
    for p in parts:
        b = _encode_utf8(np.asarray(p))
        w = b.dtype.itemsize
        m = np.ascontiguousarray(b).view(np.uint8).reshape(n, w)
        enc.append(m)
        # a name's byte length is the position of its last non-NUL byte
        # (numpy S pads with NULs; a name holds none)
        lens.append(np.max((m != 0) * np.arange(1, w + 1, dtype=np.int32), axis=1))
    row_len = np.sum(lens, axis=0) + (len(parts) - 1)
    total = int(row_len.max())
    out = np.zeros((n, total), dtype=np.uint8)
    flat = out.reshape(-1)
    base = np.arange(n, dtype=np.int64) * total
    off = np.zeros(n, dtype=np.int64)
    sep_b = _SEP.encode()[0]
    for k, (m, ln) in enumerate(zip(enc, lens)):
        j = np.arange(m.shape[1], dtype=np.int64)
        mask = j[None, :] < ln[:, None]
        dest = (base + off)[:, None] + j[None, :]
        flat[dest[mask]] = m[mask]
        off += ln
        if k < len(parts) - 1:
            flat[base + off] = sep_b
            off += 1
    return out.view(f"S{total}").ravel()


def _concat_s(parts: list[np.ndarray]) -> np.ndarray:
    """S arrays concatenated at the widest itemsize (numpy would truncate
    the wider array's entries otherwise)."""
    w = max(p.dtype.itemsize for p in parts)
    return np.concatenate([p.astype(f"S{w}") for p in parts])


def _encode_token(key: str) -> str:
    return "ck1." + base64.urlsafe_b64encode(key.encode()).decode()


def _decode_token(token: str) -> str:
    """A page token is "ck1." and the urlsafe base64 of the last row's
    identity key; anything else raises InvalidPageTokenError."""
    if not token:
        return ""
    if token.startswith("ck1."):
        try:
            # validate: a byte outside the alphabet must raise, not be
            # dropped (a corrupted cursor would restart at page 1)
            key = base64.b64decode(token[4:].encode(), altchars=b"-_", validate=True)
            if key:
                return key.decode()
        except ValueError:  # binascii.Error and UnicodeDecodeError
            pass
    raise InvalidPageTokenError(debug=f"invalid pagination token {token!r}")


def _tuple_identity(t: RelationTuple) -> str:
    if t.subject_set is not None:
        s = t.subject_set
        return _SEP.join((t.namespace, t.object, t.relation, "1", s.namespace, s.object,
                          s.relation))
    return _SEP.join((t.namespace, t.object, t.relation, "0", "", t.subject_id or "", ""))


class _ColumnarNetwork:
    """All tuples of one network id."""

    def __init__(self):
        self.base = TupleColumns.empty()
        self.base_keys = np.array([], dtype="S1")  # sorted identity keys
        self.base_ident = np.array([], dtype="S1")  # identity keys, row order
        self.base_order = np.array([], dtype=np.int64)  # sorted position -> row
        self.alive = np.array([], dtype=bool)
        self.buffer: list = []
        self.buffer_keys: dict[str, int] = {}  # identity -> buffer index
        # (namespace, object, relation) -> buffer indices: a read naming
        # all three scans its own bucket, not the whole buffer
        self.buffer_nodes: dict[tuple, list] = {}
        self.version = 0
        # (version, "insert" | "delete", tuple), oldest first
        self.log: deque = deque(maxlen=CHANGE_LOG_CAP)
        self.log_floor = 0  # versions <= the floor cannot be replayed

    def base_find(self, identity: str) -> Optional[int]:
        """The row of a live base tuple with this identity key."""
        ident_b = identity.encode("utf-8")
        # a key wider than the index's keys is in no row; searchsorted
        # would first widen every key to its width
        if len(ident_b) > self.base_keys.dtype.itemsize:
            return None
        i = int(np.searchsorted(self.base_keys, ident_b))
        if i < len(self.base_keys) and self.base_keys[i] == ident_b:
            row = int(self.base_order[i])
            if self.alive[row]:
                return row
        return None

    def append_rows(self, add: TupleColumns, add_keys: np.ndarray, add_order: np.ndarray) -> None:
        """The base becomes its live rows, then `add`. The sorted index is
        merged, not sorted again: the live rows' sorted keys (renumbered)
        and the added rows' (`add_order` sorts `add_keys`; no added key is
        a live row's) meet by one searchsorted and one insert, O(n) where
        a sort of every key would be O(n log n) string compares (the same
        index as the stable argsort gives: the keys are distinct)."""
        alive_idx = np.flatnonzero(self.alive)
        renum = np.cumsum(self.alive) - 1  # a live row's number after the fold
        live = self.alive[self.base_order]
        w = max(self.base_keys.dtype.itemsize, add_keys.dtype.itemsize)
        old_keys = self.base_keys[live].astype(f"S{w}")
        new_keys = add_keys[add_order].astype(f"S{w}")
        pos = np.searchsorted(old_keys, new_keys)
        self.base_keys = np.insert(old_keys, pos, new_keys)
        self.base_order = np.insert(renum[self.base_order[live]], pos, len(alive_idx) + add_order)
        self.base_ident = (_concat_s([self.base_ident[alive_idx], add_keys])
                           if len(self.base_ident) else add_keys)
        self.base = concat_columns([self.base.take(alive_idx), add])
        self.alive = np.ones(len(self.base), dtype=bool)

    def buffer_append(self, ident: str, t: RelationTuple) -> None:
        self.buffer_keys[ident] = len(self.buffer)
        self.buffer_nodes.setdefault((t.namespace, t.object, t.relation), []).append(
            len(self.buffer))
        self.buffer.append(t)

    def buffer_reset(self, tuples: list) -> None:
        """The buffer becomes `tuples`, its indices built anew."""
        self.buffer, self.buffer_keys, self.buffer_nodes = [], {}, {}
        for t in tuples:
            self.buffer_append(_tuple_identity(t), t)

    def buffered(self, q: RelationQuery):
        """The buffered tuples a query may match: its node's bucket when
        it names namespace, object and relation, else the whole buffer."""
        if q.namespace is not None and q.object is not None and q.relation is not None:
            return [self.buffer[i]
                    for i in self.buffer_nodes.get((q.namespace, q.object, q.relation), ())]
        return self.buffer

    def merge_buffer(self) -> None:
        """Fold the write buffer into the columns."""
        if not self.buffer:
            return
        add = TupleColumns.from_tuples(self.buffer)
        add_keys = _identity_keys(add)
        self.buffer_reset([])
        self.append_rows(add, add_keys, np.argsort(add_keys, kind="stable"))


class ColumnarStore(WriteHookMixin):
    """The Manager over columnar per-network stores. One RLock guards all
    state; listeners run after a write call releases it."""

    def __init__(self):
        self._lock = threading.RLock()
        self._networks: dict[str, _ColumnarNetwork] = {}
        self._write_listeners: list = []

    # read paths for unknown nids see this shared empty store, so request
    # tenant ids cannot grow self._networks
    _EMPTY = _ColumnarNetwork()

    def _net(self, nid: str) -> _ColumnarNetwork:
        net = self._networks.get(nid)
        if net is None:
            net = self._networks[nid] = _ColumnarNetwork()
        return net

    def _net_ro(self, nid: str) -> _ColumnarNetwork:
        return self._networks.get(nid, self._EMPTY)

    # -- the scale path ----------------------------------------------------------

    def bulk_load(self, cols: TupleColumns, nid: str = DEFAULT_NETWORK) -> None:
        """Append columns: deduplicated against themselves and the live
        base, one concatenation, one version, and the change log's floor
        reset (a bulk load is no delta: changes_since answers None across
        it, and the engine rebuilds its mirror)."""
        from ..native import unique_encode

        with self._lock:
            net = self._net(nid)
            net.merge_buffer()
            keys = _identity_keys(cols)
            _uniq, first, codes = unique_encode(keys)
            take = np.sort(first)
            cols = cols.take(take)
            keys = keys[take]
            ranks = codes[take]  # each kept row's rank among the sorted keys
            if len(net.base):
                idx = np.clip(np.searchsorted(net.base_keys, keys), 0,
                              max(len(net.base_keys) - 1, 0))
                dup = (net.base_keys[idx] == keys) if len(net.base_keys) \
                    else np.zeros(len(keys), dtype=bool)
                # a duplicate of a deleted row comes back: keep it
                dup &= net.alive[net.base_order[idx]]
                fresh = np.flatnonzero(~dup)
                cols = cols.take(fresh)
                keys = keys[fresh]
                ranks = ranks[fresh]
            if not len(cols):
                return
            # the kept rows in key order, from their ranks (no string sort)
            by_rank = np.full(len(first), -1, dtype=np.int64)
            by_rank[ranks] = np.arange(len(ranks))
            net.append_rows(cols, keys, by_rank[by_rank >= 0])
            net.version += 1
            net.log.clear()
            net.log_floor = net.version
        self._notify_write(nid, True)

    def all_tuple_columns(self, nid: str = DEFAULT_NETWORK) -> TupleColumns:
        """The network's live tuples as one set of columns (the write
        buffer folded in)."""
        with self._lock:
            net = self._net_ro(nid)
            if net is self._EMPTY:
                return TupleColumns.empty()
            net.merge_buffer()
            if net.alive.all():
                return net.base
            return net.base.take(np.flatnonzero(net.alive))

    # -- the Manager surface -----------------------------------------------------

    def version(self, nid: str = DEFAULT_NETWORK) -> int:
        with self._lock:
            return self._net_ro(nid).version

    def changes_since(self, version: int, nid: str = DEFAULT_NETWORK) -> Optional[list]:
        """The (op, tuple) pairs committed after `version`, in order, or
        None when the log no longer reaches back (or a bulk load lies
        between): the caller rebuilds from the columns."""
        triples = self.changelog_since(version, nid=nid)
        if triples is None:
            return None
        return [(op, t) for _v, op, t in triples]

    def changelog_since(self, version: int, nid: str = DEFAULT_NETWORK) -> Optional[list]:
        """The (version, op, tuple) triples committed after `version`, or
        None when the log cannot replay them."""
        with self._lock:
            net = self._net_ro(nid)
            if version < net.log_floor or (net.log and net.log[0][0] > version + 1):
                return None
            return [(v, op, t) for v, op, t in net.log if v > version]

    def write_relation_tuples(self, tuples: Sequence[RelationTuple],
                              nid: str = DEFAULT_NETWORK) -> None:
        with self._lock:
            changed = self._write_locked(tuples, nid)
        self._notify_write(nid, changed)

    def _write_locked(self, tuples: Sequence[RelationTuple], nid: str) -> bool:
        net = self._net(nid)
        changed = False
        for t in tuples:
            ident = _tuple_identity(t)
            if ident in net.buffer_keys or net.base_find(ident) is not None:
                continue  # idempotent insert
            net.buffer_append(ident, t)
            net.version += 1
            net.log.append((net.version, "insert", t))
            changed = True
        if len(net.buffer) >= _BUFFER_MERGE_THRESHOLD:
            net.merge_buffer()
        return changed

    def delete_relation_tuples(self, tuples: Sequence[RelationTuple],
                               nid: str = DEFAULT_NETWORK) -> None:
        with self._lock:
            changed = self._delete_locked(tuples, nid)
        self._notify_write(nid, changed)

    def _delete_locked(self, tuples: Sequence[RelationTuple], nid: str) -> bool:
        net = self._net(nid)
        changed = holes = False
        for t in tuples:
            ident = _tuple_identity(t)
            bi = net.buffer_keys.pop(ident, None)
            removed = False
            if bi is not None:
                net.buffer[bi] = None
                removed = holes = True
            row = net.base_find(ident)
            if row is not None:
                net.alive[row] = False
                removed = True
            if removed:
                net.version += 1
                net.log.append((net.version, "delete", t))
                changed = True
        if holes:
            net.buffer_reset([t for t in net.buffer if t is not None])
        return changed

    def transact_relation_tuples(self, insert: Sequence[RelationTuple],
                                 delete: Sequence[RelationTuple],
                                 nid: str = DEFAULT_NETWORK) -> None:
        """Inserts, then deletes, under one lock hold."""
        with self._lock:
            changed = self._write_locked(insert, nid)
            changed |= self._delete_locked(delete, nid)
        self._notify_write(nid, changed)

    def delete_all_relation_tuples(self, query: RelationQuery,
                                   nid: str = DEFAULT_NETWORK) -> None:
        changed = False
        with self._lock:
            net = self._net(nid)
            net.merge_buffer()
            for row in np.flatnonzero(self._query_mask(net, query) & net.alive):
                t = net.base.row(int(row))
                net.alive[row] = False
                net.version += 1
                net.log.append((net.version, "delete", t))
                changed = True
        self._notify_write(nid, changed)

    def relation_tuple_exists(self, t: RelationTuple, nid: str = DEFAULT_NETWORK) -> bool:
        with self._lock:
            net = self._net_ro(nid)
            ident = _tuple_identity(t)
            return ident in net.buffer_keys or net.base_find(ident) is not None

    def all_relation_tuples(self, nid: str = DEFAULT_NETWORK) -> list[RelationTuple]:
        return list(self.all_tuple_columns(nid).iter_tuples())

    # -- queries -----------------------------------------------------------------

    @staticmethod
    def _query_mask(net: _ColumnarNetwork, q: RelationQuery, rows=None) -> np.ndarray:
        """The query's matches among the base rows (all of them, or the
        `rows` given)."""
        def col(f):
            c = getattr(net.base, f)
            return c if rows is None else c[rows]

        mask = np.ones(len(net.base) if rows is None else len(rows), dtype=bool)
        if q.namespace is not None:
            mask &= col("ns") == q.namespace
        if q.object is not None:
            mask &= col("obj") == q.object
        if q.relation is not None:
            mask &= col("rel") == q.relation
        if q.subject_id is not None:
            mask &= (col("skind") == 0) & (col("sobj") == q.subject_id)
        if q.subject_set is not None:
            s = q.subject_set
            mask &= ((col("skind") == 1) & (col("sns") == s.namespace)
                     & (col("sobj") == s.object) & (col("srel") == s.relation))
        return mask

    @staticmethod
    def _sorted_matches(net: _ColumnarNetwork, q: RelationQuery):
        """(identity keys, rows) of the live base rows the query matches,
        in identity-key order. A query that names its namespace, object
        and relation reads only the range of sorted keys that start with
        "ns\x1fobj\x1frel\x1f" (the host oracle's reads: O(log n) and
        the range, not a pass over every row); the range is a superset of
        the matches (a name may hold the separator), so the exact mask
        runs on it. Any other query filters every row."""
        if q.namespace is not None and q.object is not None and q.relation is not None:
            prefix = _SEP.join((q.namespace, q.object, q.relation, "")).encode("utf-8")
            if len(prefix) > net.base_keys.dtype.itemsize:
                return net.base_keys[:0], net.base_order[:0]
            lo = int(np.searchsorted(net.base_keys, prefix, side="left"))
            hi = int(np.searchsorted(net.base_keys, prefix[:-1] + bytes([prefix[-1] + 1]),
                                     side="left"))
            rows = net.base_order[lo:hi]
            keep = ColumnarStore._query_mask(net, q, rows) & net.alive[rows]
            return net.base_keys[lo:hi][keep], rows[keep]
        sel = (ColumnarStore._query_mask(net, q) & net.alive)[net.base_order]
        return net.base_keys[sel], net.base_order[sel]

    def get_relation_tuples(
        self, query: RelationQuery, page_token: str = "",
        page_size: int = DEFAULT_PAGE_SIZE, nid: str = DEFAULT_NETWORK,
    ) -> tuple[list[RelationTuple], str]:
        """Keyset pagination in identity-key order: the filter and the
        order run over the columns (the sorted identity index), and only
        the page's rows become RelationTuple objects. This order is the
        store's everywhere: pages, the host oracle's reads and the
        columnar expand CSR's child order (expand_kernel.
        columnar_subject_order) agree."""
        _faults.inject("store_read")
        token_key = _decode_token(page_token)
        if page_size <= 0:
            page_size = DEFAULT_PAGE_SIZE
        with self._lock:
            net = self._net_ro(nid)
            if net is self._EMPTY:
                return [], ""
            if len(net.base):
                keys_sorted, rows_sorted = self._sorted_matches(net, query)
            else:
                keys_sorted = np.array([], dtype="S1")
                rows_sorted = np.array([], dtype=np.int64)
            start = (int(np.searchsorted(keys_sorted, token_key.encode("utf-8"), side="right"))
                     if token_key else 0)
            base_window = [
                (bytes(keys_sorted[i]).decode("utf-8"), None, int(rows_sorted[i]))
                for i in range(start, min(start + page_size + 1, len(rows_sorted)))
            ]
            buf_window = sorted(
                (k, t, -1) for t in net.buffered(query) for k in (_tuple_identity(t),)
                if query.matches(t) and k > token_key
            )
            merged = sorted(base_window + buf_window, key=lambda e: e[0])
            remaining = (len(keys_sorted) - start) + len(buf_window)
            page = merged[:page_size]
            out = [t if t is not None else net.base.row(r) for _, t, r in page]
        next_token = _encode_token(page[-1][0]) if page and remaining > page_size else ""
        return out, next_token

"""In-memory authoritative tuple store: the host source of truth the
device mirror is built from.

Semantics follow Keto's SQL persister: keyset pagination ordered by
shard id with an N+1 next-page probe, idempotent inserts, per-nid
isolation, and a per-nid version counter bumped by every write that
changed the store.

Every changed insert and delete is appended to a bounded per-nid change
log, tagged with the version its write call commits, in op order:
`changes_since` feeds the engine's delta overlay and incremental
compaction, and answers None once the log no longer reaches back.
Listeners added by `add_write_listener` run after each write call that
changed the store, outside the lock.

A single RLock guards all state; reads take it too.
"""

from __future__ import annotations

import bisect
import heapq
import threading
from collections import defaultdict, deque
from typing import Optional, Sequence

from .. import faults as _faults
from ..ketoapi import RelationQuery, RelationTuple
from .definitions import (
    DEFAULT_NETWORK,
    DEFAULT_PAGE_SIZE,
    WriteHookMixin,
    shard_id,
    validate_page_token,
)

# inserts per write call above which the sorted shard order is rebuilt by
# one merge instead of per-tuple bisect.insort (O(n) each): bulk loads of
# 1e6 tuples would otherwise spend minutes in list memmoves
_BULK_MERGE_MIN = 256

# ops the change log keeps per network
CHANGE_LOG_CAP = 1 << 16


class _NetworkStore:
    """All tuples of one network id."""

    __slots__ = ("by_shard", "order", "forward", "version", "log")

    def __init__(self):
        self.by_shard: dict[str, RelationTuple] = {}
        self.order: list[str] = []  # sorted shard ids (pagination order)
        # (ns, obj, rel) -> {shard ids}
        self.forward: dict[tuple[str, str, str], set[str]] = defaultdict(set)
        self.version: int = 0
        # (version, "insert" | "delete", tuple), oldest first
        self.log: deque[tuple[int, str, RelationTuple]] = deque(maxlen=CHANGE_LOG_CAP)


class MemoryManager(WriteHookMixin):
    def __init__(self):
        self._lock = threading.RLock()
        self._networks: dict[str, _NetworkStore] = defaultdict(_NetworkStore)
        self._write_listeners: list = []

    # read paths for unknown nids see this shared empty store, so request
    # tenant ids cannot grow self._networks
    _EMPTY = _NetworkStore()

    def _net_ro(self, nid: str) -> _NetworkStore:
        return self._networks.get(nid, self._EMPTY)

    # -- reads ---------------------------------------------------------------

    def get_relation_tuples(
        self,
        query: RelationQuery,
        page_token: str = "",
        page_size: int = DEFAULT_PAGE_SIZE,
        nid: str = DEFAULT_NETWORK,
    ) -> tuple[list[RelationTuple], str]:
        _faults.inject("store_read")
        token = validate_page_token(page_token)
        if page_size <= 0:
            page_size = DEFAULT_PAGE_SIZE
        with self._lock:
            net = self._net_ro(nid)
            if (
                query.namespace is not None
                and query.object is not None
                and query.relation is not None
            ):
                ordered = sorted(
                    net.forward.get(
                        (query.namespace, query.object, query.relation), ()
                    )
                )
            else:
                ordered = net.order
            i = bisect.bisect_right(ordered, token) if token else 0
            out: list[RelationTuple] = []
            next_token = ""
            last_sid = ""
            n = len(ordered)
            while i < n and len(out) < page_size:
                t = net.by_shard[ordered[i]]
                if query.matches(t):
                    out.append(t)
                    last_sid = ordered[i]
                i += 1
            # N+1 probe: is there any further match?
            while i < n:
                if query.matches(net.by_shard[ordered[i]]):
                    next_token = last_sid
                    break
                i += 1
            return out, next_token

    def relation_tuple_exists(
        self, t: RelationTuple, nid: str = DEFAULT_NETWORK
    ) -> bool:
        with self._lock:
            return shard_id(nid, t) in self._net_ro(nid).by_shard

    def all_relation_tuples(self, nid: str = DEFAULT_NETWORK) -> list[RelationTuple]:
        with self._lock:
            net = self._net_ro(nid)
            return [net.by_shard[sid] for sid in net.order]

    def version(self, nid: str = DEFAULT_NETWORK) -> int:
        with self._lock:
            return self._net_ro(nid).version

    def changes_since(
        self, version: int, nid: str = DEFAULT_NETWORK
    ) -> Optional[list[tuple[str, RelationTuple]]]:
        """The (op, tuple) pairs committed after `version`, in order, or
        None when the bounded log no longer reaches back that far (the
        caller then rebuilds from all_relation_tuples)."""
        triples = self.changelog_since(version, nid=nid)
        if triples is None:
            return None
        return [(op, t) for _v, op, t in triples]

    def changelog_since(
        self, version: int, nid: str = DEFAULT_NETWORK
    ) -> Optional[list[tuple[int, str, RelationTuple]]]:
        """The (version, op, tuple) triples committed after `version`, or
        None when the log cannot prove it holds all of them."""
        with self._lock:
            net = self._net_ro(nid)
            if version >= net.version:
                return []
            log = net.log
            # evicted entries all have v <= log[0][0]: the slice is whole
            # iff nothing was evicted or every evicted op predates `version`
            complete = len(log) < (log.maxlen or 0) or (bool(log) and version >= log[0][0])
            if not complete:
                return None
            return [(v, op, t) for v, op, t in log if v > version]

    # -- writes --------------------------------------------------------------

    def write_relation_tuples(
        self, tuples: Sequence[RelationTuple], nid: str = DEFAULT_NETWORK
    ) -> None:
        with self._lock:
            net = self._networks[nid]
            bulk = len(tuples) >= _BULK_MERGE_MIN
            new: list[str] = []
            for t in tuples:
                sid = self._insert(net, nid, t, sorted_order=not bulk)
                if sid is not None:
                    new.append(sid)
            if bulk and new:
                new.sort()
                net.order = list(heapq.merge(net.order, new))
            if new:  # no-op batches must not signal mirror staleness
                net.version += 1
        self._notify_write(nid, bool(new))

    def delete_relation_tuples(
        self, tuples: Sequence[RelationTuple], nid: str = DEFAULT_NETWORK
    ) -> None:
        with self._lock:
            net = self._networks[nid]
            changed = False
            for t in tuples:
                changed |= self._delete(net, nid, t)
            if changed:
                net.version += 1
        self._notify_write(nid, changed)

    def delete_all_relation_tuples(
        self, query: RelationQuery, nid: str = DEFAULT_NETWORK
    ) -> None:
        """Delete every tuple the query matches, in shard order."""
        with self._lock:
            net = self._networks[nid]
            doomed = [t for t in (net.by_shard[sid] for sid in net.order) if query.matches(t)]
            changed = False
            for t in doomed:
                changed |= self._delete(net, nid, t)
            if changed:
                net.version += 1
        self._notify_write(nid, changed)

    def transact_relation_tuples(
        self,
        insert: Sequence[RelationTuple],
        delete: Sequence[RelationTuple],
        nid: str = DEFAULT_NETWORK,
    ) -> None:
        """Inserts, then deletes, as one commit: one version."""
        with self._lock:
            net = self._networks[nid]
            changed = False
            for t in insert:
                changed |= self._insert(net, nid, t) is not None
            for t in delete:
                changed |= self._delete(net, nid, t)
            if changed:
                net.version += 1
        self._notify_write(nid, changed)

    # -- internals -----------------------------------------------------------

    def _insert(self, net: _NetworkStore, nid: str, t: RelationTuple,
                sorted_order: bool = True) -> Optional[str]:
        """Add one tuple and log it, tagged with the version the enclosing
        call commits: its shard id, or None for a tuple already there. A
        bulk write passes sorted_order=False and merges its shard ids into
        the order once."""
        sid = shard_id(nid, t)
        if sid in net.by_shard:
            return None  # idempotent
        net.by_shard[sid] = t
        net.forward[(t.namespace, t.object, t.relation)].add(sid)
        if sorted_order:
            bisect.insort(net.order, sid)
        net.log.append((net.version + 1, "insert", t))
        return sid

    def _delete(self, net: _NetworkStore, nid: str, t: RelationTuple) -> bool:
        sid = shard_id(nid, t)
        if sid not in net.by_shard:
            return False
        del net.by_shard[sid]
        idx = bisect.bisect_left(net.order, sid)
        if idx < len(net.order) and net.order[idx] == sid:
            net.order.pop(idx)
        key = (t.namespace, t.object, t.relation)
        fwd = net.forward.get(key)
        if fwd is not None:
            fwd.discard(sid)
            if not fwd:
                del net.forward[key]
        net.log.append((net.version + 1, "delete", t))
        return True

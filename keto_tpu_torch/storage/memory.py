"""In-memory authoritative tuple store: the host source of truth the
device mirror is built from.

Semantics follow Keto's SQL persister: keyset pagination ordered by
shard id with an N+1 next-page probe, idempotent inserts, per-nid
isolation, and a per-nid version counter bumped by every write that
changed the store (the engine rebuilds its mirror when it moves).

A single RLock guards all state; reads take it too.
"""

from __future__ import annotations

import bisect
import heapq
import threading
from collections import defaultdict
from typing import Sequence

from ..ketoapi import RelationQuery, RelationTuple
from .definitions import (
    DEFAULT_NETWORK,
    DEFAULT_PAGE_SIZE,
    shard_id,
    validate_page_token,
)

# inserts per write call above which the sorted shard order is rebuilt by
# one merge instead of per-tuple bisect.insort (O(n) each): bulk loads of
# 1e6 tuples would otherwise spend minutes in list memmoves
_BULK_MERGE_MIN = 256


class _NetworkStore:
    """All tuples of one network id."""

    __slots__ = ("by_shard", "order", "forward", "version")

    def __init__(self):
        self.by_shard: dict[str, RelationTuple] = {}
        self.order: list[str] = []  # sorted shard ids (pagination order)
        # (ns, obj, rel) -> {shard ids}
        self.forward: dict[tuple[str, str, str], set[str]] = defaultdict(set)
        self.version: int = 0


class MemoryManager:
    def __init__(self):
        self._lock = threading.RLock()
        self._networks: dict[str, _NetworkStore] = defaultdict(_NetworkStore)

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

    # -- writes --------------------------------------------------------------

    def write_relation_tuples(
        self, tuples: Sequence[RelationTuple], nid: str = DEFAULT_NETWORK
    ) -> None:
        with self._lock:
            net = self._networks[nid]
            bulk = len(tuples) >= _BULK_MERGE_MIN
            new: list[str] = []
            for t in tuples:
                sid = shard_id(nid, t)
                if sid in net.by_shard:
                    continue  # idempotent
                net.by_shard[sid] = t
                net.forward[(t.namespace, t.object, t.relation)].add(sid)
                if not bulk:
                    bisect.insort(net.order, sid)
                new.append(sid)
            if bulk and new:
                new.sort()
                net.order = list(heapq.merge(net.order, new))
            if new:  # no-op batches must not signal mirror staleness
                net.version += 1

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
        return True

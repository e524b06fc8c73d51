"""The serve-side check cache: Check verdicts, positive and negative,
kept at the store version they were computed at and served before the
batcher, so a hit skips the encode, the launch and the device.

A hit is as fresh as an uncached ride at the same snaptoken:

  - Every entry records the store version its answer is authoritative
    at. A device answer carries the evaluated state's `covered_version`
    (`check_batch_resolve_v`); an answer with no version (a host answer)
    is stored only when a re-read of the store version equals the
    request's enforce-time version, i.e. no write raced the evaluation.
  - A lookup names the request's enforce-time store version (the one its
    response snaptoken is minted from) and hits only an entry at exactly
    that version: a write moves the version and older entries stop
    hitting at once, whether or not any invalidation has run.
  - A namespace change alters answers without a version bump, so entries
    also carry the namespace manager's `config_generation`; a new
    generation flushes the cache.

Invalidation keeps memory down and is never needed for correctness: the
Watch hub's commit listener (the registry's `_push_invalidate`) calls
`notify_commit(nid)`, and a background thread reads the store's change
log since its last pass and deletes the entries a changed tuple can flip directly: the
entry of the changed node row (namespace, object, relation) and every
entry whose subject is the changed tuple's subject. Entries a change
flips only through an edge further up die to the version gate and age
out of the LRU.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Optional

from ..errors import StoreUnavailableError

DEFAULT_MAX_ENTRIES = 65536


def require_answer_floor(computed_v, version) -> None:
    """An answer pinned below the request's enforce-time version would go
    out under a snaptoken that overstates its freshness: the typed 503
    instead. The engine syncs to at least the enforce-time version before
    it evaluates, so only a store failing mid-request can cause it."""
    if computed_v is not None and version is not None and computed_v < version:
        raise StoreUnavailableError(
            f"store became unavailable mid-request: the answer is pinned to v{computed_v} "
            f"but the response snaptoken was minted at v{version}",
            breaker_open=True,
        )


def cached_check(registry, batcher, nid, t, max_depth, version, rt):
    """The serve path of one Check: the cache, else the batcher, then the
    verdict into the cache. Returns the CheckResult
    with any error still attached, for the transport to map."""
    cache = registry.check_cache()
    gen = None
    if cache is not None:
        res = cache.lookup(nid, t, max_depth, version)
        if res is not None:
            return res
        # captured before the evaluation, as the enforce-time version is:
        # a namespace change racing it then skips the store
        gen = cache.generation()
    res, computed_v = batcher.check_versioned(t, max_depth, nid=nid, rt=rt)
    require_answer_floor(computed_v, version)
    if cache is not None:
        cache.store(nid, t, max_depth, res, computed_v, version, gen=gen)
    return res


async def cached_check_async(registry, batcher, nid, t, max_depth, version, rt):
    """cached_check for the asyncio plane (api/aio_server.py): the same
    cache gate, the batcher's check awaited. The lookup and the store are
    one lock and a few dict operations, fine on the event loop."""
    cache = registry.check_cache()
    gen = None
    if cache is not None:
        res = cache.lookup(nid, t, max_depth, version)
        if res is not None:
            return res
        gen = cache.generation()
    res, computed_v = await batcher.check_versioned(t, max_depth, nid=nid, rt=rt)
    require_answer_floor(computed_v, version)
    if cache is not None:
        cache.store(nid, t, max_depth, res, computed_v, version, gen=gen)
    return res


class _Entry:
    __slots__ = ("result", "version", "expires")

    def __init__(self, result, version: int, expires: float):
        self.result = result
        self.version = version
        self.expires = expires


def _key_for(nid: str, t, max_depth: int) -> tuple:
    # the structured fields: the display string is not injective
    return (nid, t.namespace, t.object, t.relation, t.subject_id, t.subject_set, max_depth)


class CheckCache:
    """Versioned (nid, object, relation, subject, max_depth) -> verdict
    LRU with change-log invalidation. Thread-safe; a lookup is one lock
    and two dict operations. `counts` holds the hits, misses, stale
    entries met and entries invalidated."""

    # entries dropped a lock hold: a long invalidation pass must not
    # stall lookups for the length of a sweep
    _DROP_CHUNK = 256

    def __init__(self, manager, config, max_entries: int = DEFAULT_MAX_ENTRIES,
                 ttl_s: float = 0.0):
        self._manager = manager
        self._config = config
        self.max_entries = max(int(max_entries), 1)
        self.ttl_s = float(ttl_s or 0.0)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # the two key families a changed tuple can flip directly, and all
        # of a network's keys
        self._by_node: dict[tuple, set] = {}
        self._by_subject: dict[tuple, set] = {}
        self._by_nid: dict[str, set] = {}
        self._cfg_gen = None
        # the invalidation thread starts at the first commit
        self._inval_mu = threading.Lock()
        self._inval_event: Optional[threading.Event] = None
        self._inval_thread: Optional[threading.Thread] = None
        self._inval_versions: dict[str, int] = {}
        self._pending_nids: set[str] = set()
        self._closed = False
        self.counts = {"hit": 0, "miss": 0, "stale": 0, "invalidation": 0}

    # -- bookkeeping -----------------------------------------------------------

    def generation(self):
        """The namespace-config generation now: capture it before
        evaluating a miss and pass it to store()."""
        nm = self._config.namespace_manager()
        gen = getattr(nm, "config_generation", None)
        return gen if gen is not None else id(nm)

    def _check_generation_locked(self, gen) -> None:
        if gen != self._cfg_gen:
            self._entries.clear()
            self._by_node.clear()
            self._by_subject.clear()
            self._by_nid.clear()
            self._cfg_gen = gen

    # -- hot path --------------------------------------------------------------

    def lookup(self, nid: str, t, max_depth: int, version: int):
        """The cached CheckResult iff an entry for this query is
        authoritative at exactly `version`, the request's enforce-time
        store version; else None."""
        key = _key_for(nid, t, max_depth)
        gen = self.generation()
        with self._lock:
            self._check_generation_locked(gen)
            e = self._entries.get(key)
            if e is not None and self.ttl_s and time.monotonic() > e.expires:
                self._drop_locked(key)
                e = None
            if e is None:
                self.counts["miss"] += 1
                return None
            if e.version != version:
                if e.version < version:
                    # the store moved past it: dead
                    self._drop_locked(key)
                    self.counts["stale"] += 1
                else:
                    # newer than the request's version (a write and a
                    # store raced this lookup): no entry at that version
                    self.counts["miss"] += 1
                return None
            self._entries.move_to_end(key)
            self.counts["hit"] += 1
            return e.result

    def store(self, nid: str, t, max_depth: int, result, computed_version: Optional[int],
              enforce_version: int, gen=None) -> None:
        """Keep one evaluated verdict. `computed_version` is the version
        the engine pinned it to, or None: then it is kept only if the
        store has not moved since `enforce_version`. `gen` is the
        generation captured before the evaluation: a different one now
        means a namespace change raced it, and the verdict is not kept."""
        if result is None or getattr(result, "error", None) is not None:
            return
        version = computed_version
        if version is None:
            try:
                current = self._manager.version(nid=nid)
            except StoreUnavailableError:
                return
            if current != enforce_version:
                return
            version = enforce_version
        key = _key_for(nid, t, max_depth)
        current_gen = self.generation()
        if gen is not None and gen != current_gen:
            return
        expires = time.monotonic() + self.ttl_s if self.ttl_s else 0.0
        node_k = (nid, t.namespace, t.object, t.relation)
        subj_k = (nid, t.subject_id, t.subject_set)
        with self._lock:
            self._check_generation_locked(current_gen)
            old = self._entries.get(key)
            if old is not None:
                if old.version > version:
                    return  # never replace a fresher entry
                if old.version == version:
                    # singleflight riders store the same verdict again
                    self._entries.move_to_end(key)
                    return
            self._entries[key] = _Entry(result, version, expires)
            self._entries.move_to_end(key)
            self._by_node.setdefault(node_k, set()).add(key)
            self._by_subject.setdefault(subj_k, set()).add(key)
            self._by_nid.setdefault(nid, set()).add(key)
            while len(self._entries) > self.max_entries:
                evicted, _ = self._entries.popitem(last=False)
                self._unindex_locked(evicted)

    # -- entry removal (the caller holds self._lock) ---------------------------

    def _unindex_locked(self, key: tuple) -> None:
        nid, ns, obj, rel, sid, sset, _depth = key
        for index, k in ((self._by_node, (nid, ns, obj, rel)),
                         (self._by_subject, (nid, sid, sset)), (self._by_nid, nid)):
            s = index.get(k)
            if s is not None:
                s.discard(key)
                if not s:
                    del index[k]

    def _drop_locked(self, key: tuple) -> None:
        if self._entries.pop(key, None) is not None:
            self._unindex_locked(key)

    # -- invalidation ----------------------------------------------------------

    def notify_commit(self, nid: str) -> None:
        """Called by the Watch hub's commit listener on the writer's
        thread: it only flags the network and wakes the invalidation
        thread, so a burst of writes makes one pass."""
        if self._closed:
            return
        with self._inval_mu:
            if self._inval_event is None:
                self._inval_event = threading.Event()
                self._inval_thread = threading.Thread(
                    target=self._invalidate_loop, args=(self._inval_event,),
                    name="keto-torch-check-cache-invalidate", daemon=True)
                self._inval_thread.start()
            self._pending_nids.add(nid)
            ev = self._inval_event
        ev.set()

    def _invalidate_loop(self, ev: threading.Event) -> None:
        while True:
            ev.wait()
            if self._closed:
                return
            ev.clear()
            with self._inval_mu:
                nids, self._pending_nids = self._pending_nids, set()
            for nid in nids:
                try:
                    self._invalidate_nid(nid)
                except Exception:  # noqa: BLE001 - the thread never dies;
                    # the version gate carries correctness
                    logging.getLogger("keto_tpu_torch").debug(
                        "check-cache invalidation pass failed", exc_info=True)

    def _drop_chunked(self, keys, keep=None) -> int:
        """Drop `keys` a chunk a lock hold; `keep(entry)` spares an
        entry. Returns the number dropped."""
        removed = 0
        keys = list(keys)
        for i in range(0, len(keys), self._DROP_CHUNK):
            with self._lock:
                for key in keys[i : i + self._DROP_CHUNK]:
                    e = self._entries.get(key)
                    if e is None or (keep is not None and keep(e)):
                        continue
                    self._drop_locked(key)
                    removed += 1
        return removed

    def _invalidate_nid(self, nid: str) -> None:
        since = self._inval_versions.get(nid)
        current = self._manager.version(nid=nid)
        if since is None:
            # the network's first pass has no floor in the log: drop the
            # entries the store has moved past
            with self._lock:
                keys = list(self._by_nid.get(nid, ()))
            removed = self._drop_chunked(keys, keep=lambda e: e.version >= current)
        else:
            ops = self._manager.changelog_since(since, nid=nid)
            if ops is None:
                # the log no longer reaches back: drop the whole network
                with self._lock:
                    keys = list(self._by_nid.get(nid, ()))
                removed = self._drop_chunked(keys)
            else:
                doomed: set = set()
                ops = list(ops)
                for i in range(0, len(ops), self._DROP_CHUNK):
                    with self._lock:
                        for _v, _op, t in ops[i : i + self._DROP_CHUNK]:
                            doomed.update(self._by_node.get(
                                (nid, t.namespace, t.object, t.relation), ()))
                            doomed.update(self._by_subject.get(
                                (nid, t.subject_id, t.subject_set), ()))
                removed = self._drop_chunked(doomed)
        self._inval_versions[nid] = current
        if removed:
            with self._lock:
                self.counts["invalidation"] += removed

    # -- lifecycle -------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counts)
            out["entries"] = len(self._entries)
        total = out["hit"] + out["miss"] + out["stale"]
        out["hit_ratio"] = round(out["hit"] / total, 4) if total else 0.0
        return out

    def close(self) -> None:
        """End the invalidation thread."""
        self._closed = True
        with self._inval_mu:
            ev, thread = self._inval_event, self._inval_thread
        if ev is not None:
            ev.set()
        if thread is not None:
            thread.join(timeout=5)

"""Registry: the serving plane's composition root.

One object builds each service once, lazily, from the config and hands
it to everything above: the store (chosen by `dsn`: "memory", "columnar",
or a SQL DSN, `sqlite://<path>` or `sqlite://:memory:`, through the
strict router of storage/dialect.py), the Watch hub over it, the check engine
(`check.engine`: "torch", the device engine, or "host", the exact host
oracle alone), the namespace manager, the check cache, the device-path
circuit breaker, the serving counters, the closure maintainer, and the
readiness and drain flags the daemon flips.

The Watch hub (watch/hub.py, `watch.poll_interval`, `watch.buffer`,
`watch.heartbeat_s`) is built when the registry first hands out the
store, and is the store's write listener. Its commit listener
`_push_invalidate` pokes the built engine (`notify_write`: its refresh
thread folds the write into the mirror) and the check cache
(`notify_commit`: its invalidation pass); it never builds either. The
closure maintainer wakes on the same hub.

Not here yet: per-network engines (the tenancy plane's `nid_for` and its
LRU of `tenancy.max_networks` engines), the follower plane, and the store
health guard that the JAX package wraps a SQL store in (per-op timeouts,
a typed 503 from a wedged store). Asking for another network's engine
raises: one network's mirror never answers for another; a config that
sets `tenancy.header` or `follower.enabled` fails at construction.
"""

from __future__ import annotations

import threading
from typing import Optional

from . import __version__
from . import faults as _faults
from .config import Config, ConfigError
from .engine.reference import ReferenceEngine
from .ketoapi import RelationQuery, RelationTuple
from .resilience import CircuitBreaker, ServeCounters
from .storage.definitions import DEFAULT_NETWORK
from .storage.columnar import ColumnarStore
from .storage.memory import MemoryManager


class ReadyState:
    """A readiness flag with change notification: a watcher parks on
    `wait_change` instead of polling."""

    def __init__(self):
        self._cond = threading.Condition()
        self._flag = False
        self._gen = 0

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        with self._cond:
            if not self._flag:
                self._flag = True
                self._gen += 1
                self._cond.notify_all()

    def clear(self) -> None:
        with self._cond:
            if self._flag:
                self._flag = False
                self._gen += 1
                self._cond.notify_all()

    def state(self) -> tuple[bool, int]:
        with self._cond:
            return self._flag, self._gen

    def wait_change(self, gen: int, timeout: float) -> tuple[bool, int]:
        """Wait until the generation moves past `gen` (or the timeout);
        the current (flag, generation)."""
        with self._cond:
            if self._gen == gen:
                self._cond.wait(timeout)
            return self._flag, self._gen


class Registry:
    """Builds every service once. `device` is the engine's torch device
    (the card unless the caller asks for "cpu") and `layout` its table
    layout (engine/snapshot.py). `manager` hands the registry a store
    already loaded, in place of the one `dsn` names, and `engine` an
    engine already built (over `manager`, or its own store)."""

    def __init__(self, config: Optional[Config] = None, nid: str = DEFAULT_NETWORK, *,
                 device="cuda", layout: str = "bucketized", manager=None, engine=None):
        self.config = config or Config()
        # keys whose services are not ported: serving them with the
        # default network's store would answer, and write, for the wrong
        # tenant or the wrong role
        for key, module in (("tenancy.header", "ketoctx.py and Registry.nid_for"),
                            ("follower.enabled", "api/follower.py")):
            if self.config.get(key):
                raise ConfigError(f"{key} is set, but keto_tpu_torch has no {module} yet: "
                                  "it serves one network as a leader")
        self.nid = nid
        self.device = device
        self.layout = layout
        self.version = __version__
        self._lock = threading.RLock()
        self._manager = None
        self._given_manager = manager if manager is not None else getattr(engine, "manager",
                                                                          None)
        self._engine = engine
        self._check_cache = None
        self._check_cache_built = False
        self._watch_hub = None
        self._breaker = None
        self._counters = ServeCounters()
        self._closure_maintainer = None
        # the daemon sets these around serving: readiness, and the drain
        # window in which admit_check sheds new checks with a typed 429
        self.ready = ReadyState()
        self.draining = threading.Event()

    # -- storage --------------------------------------------------------------

    def relation_tuple_manager(self):
        with self._lock:
            if self._manager is None:
                self._manager = self._given_manager if self._given_manager is not None \
                    else self._open_store(self.config.dsn)
                # the hub is the store's write listener from the start, so
                # that every commit reaches the engine and the cache
                self.watch_hub()
            return self._manager

    def _open_store(self, dsn: str):
        if dsn == "memory":
            return MemoryManager()
        if dsn == "columnar":
            return ColumnarStore()
        # sqlite:// (and the server schemes, which raise
        # StoreDriverMissing) through the strict dialect router: an
        # unknown scheme or a bare typo ('Memory') raises, and a failing
        # connect or migration fails startup; nothing falls back to
        # another store
        from .storage.sqlite import SQLPersister

        return SQLPersister(dsn, legacy_namespaces=self.config.legacy_namespace_ids())

    # -- the Watch API --------------------------------------------------------

    def watch_hub(self):
        """The process's change-log hub (keto_tpu_torch/watch): the store's
        write listener, with `_push_invalidate` among its commit
        listeners. Heartbeats are opt-in (watch.heartbeat_s)."""
        with self._lock:
            # the store first: handing it out the first time builds the hub
            manager = self.relation_tuple_manager()
            if self._watch_hub is None:
                from .watch import WatchHub

                hb = self.config.get("watch.heartbeat_s")
                self._watch_hub = WatchHub(
                    manager,
                    poll_interval=float(self.config.get("watch.poll_interval", 0.25)),
                    buffer=int(self.config.get("watch.buffer", 256)),
                    heartbeat_s=float(hb) if hb is not None else None,
                )
                self._watch_hub.add_commit_listener(self._push_invalidate)
            return self._watch_hub

    def _push_invalidate(self, nid: str) -> None:
        """The hub's commit listener: pokes the built engine of `nid` and
        the check cache, building neither."""
        _faults.inject("cache_invalidation")
        with self._lock:
            engine = self._engine if nid == self.nid else None
            cache = self._check_cache
        if cache is not None:
            cache.notify_commit(nid)
        poke = getattr(engine, "notify_write", None)  # the host engine has no mirror
        if poke is not None:
            poke()

    # -- engines --------------------------------------------------------------

    def check_engine(self, nid: Optional[str] = None):
        """The check engine of the default network. Another network's
        raises ValueError until per-network engines exist."""
        if nid is not None and nid != self.nid:
            raise ValueError(
                f"network {nid!r}: only the default network {self.nid!r} is served")
        with self._lock:
            if self._engine is None:
                self._engine = self._build_engine()
            return self._engine

    def expand_engine(self, nid: Optional[str] = None):
        return self.check_engine(nid)

    def _build_engine(self):
        kind = self.config.get("check.engine", "torch")
        manager = self.relation_tuple_manager()
        # "tpu", the JAX package's name for its device engine, names the
        # port's, so that one config serves both
        if kind in ("torch", "tpu"):
            from .engine.torch_engine import TorchCheckEngine

            return TorchCheckEngine(
                manager, self.config, nid=self.nid, device=self.device, layout=self.layout,
                frontier_cap=int(self.config.get("check.frontier_cap", 1 << 14)),
            )
        if kind == "host":
            return _HostEngineFacade(ReferenceEngine(manager, self.config), self.nid)
        raise ValueError(f"unknown check.engine: {kind!r}")

    def built_engines(self) -> dict:
        """The engines that exist, by network id, building none."""
        with self._lock:
            return {self.nid: self._engine} if self._engine is not None else {}

    # -- serving services -----------------------------------------------------

    def check_cache(self):
        """The check cache (api/check_cache.py), or None when
        `check.cache.enabled` is false. Lock-free after the first call:
        the built flag is written last."""
        if self._check_cache_built:
            return self._check_cache
        with self._lock:
            if not self._check_cache_built:
                if bool(self.config.get("check.cache.enabled", True)):
                    from .api.check_cache import CheckCache

                    self._check_cache = CheckCache(
                        self.relation_tuple_manager(), self.config,
                        max_entries=int(self.config.get("check.cache.max_entries", 65536)),
                        ttl_s=float(self.config.get("check.cache.ttl_s", 0.0)),
                    )
                self._check_cache_built = True
            return self._check_cache

    def close_check_cache(self) -> None:
        """End the check cache's invalidation thread, if it was built."""
        with self._lock:
            cache = self._check_cache
        if cache is not None:
            cache.close()

    def circuit_breaker(self) -> CircuitBreaker:
        """The device path's circuit breaker, tuned by
        serve.check.breaker.{threshold,cooldown_s}."""
        with self._lock:
            if self._breaker is None:
                self._breaker = CircuitBreaker(
                    threshold=int(self.config.get("serve.check.breaker.threshold", 5)),
                    cooldown_s=float(self.config.get("serve.check.breaker.cooldown_s", 5.0)),
                )
            return self._breaker

    def counters(self) -> ServeCounters:
        """The serving plane's counters: the admission gate's and the
        daemon's batcher's."""
        return self._counters

    def closure_maintainer(self):
        """The closure index's maintainer (keto_tpu_torch/closure); the
        daemon starts it when closure.enabled."""
        with self._lock:
            if self._closure_maintainer is None:
                from .closure import ClosureMaintainer

                self._closure_maintainer = ClosureMaintainer(
                    self, poll_interval=float(self.config.get("watch.poll_interval", 0.25)))
            return self._closure_maintainer

    # -- namespaces -----------------------------------------------------------

    def namespace_manager(self):
        return self.config.namespace_manager()

    def validate_namespaces(self, *objs) -> None:
        """Every namespace a tuple, query or subject set names must be
        configured; raises NamespaceNotFoundError."""
        nm = self.namespace_manager()
        for o in objs:
            if o is None:
                continue
            names = []
            if isinstance(o, (RelationTuple, RelationQuery)):
                if o.namespace is not None:
                    names.append(o.namespace)
                if o.subject_set is not None:
                    names.append(o.subject_set.namespace)
            else:  # a SubjectSet
                names.append(o.namespace)
            for name in names:
                nm.get_namespace_by_name(name)


class _HostEngineFacade:
    """The host oracle behind the engine surface the serving plane uses
    (`check.engine: host`): no device, every answer exact."""

    def __init__(self, reference: ReferenceEngine, nid: str):
        self.reference = reference
        self.nid = nid
        self.manager = reference.manager
        self.config = reference.config
        self.closure_enabled = False
        self.stats = {"device_checks": 0, "host_checks": 0, "snapshot_builds": 0}
        self._mu = threading.Lock()

    def _count(self, key: str, n: int) -> None:
        with self._mu:
            self.stats[key] = self.stats.get(key, 0) + n

    def check_relation_tuple(self, r, max_depth: int = 0):
        return self.reference.check_relation_tuple(r, max_depth, self.nid)

    def check_batch(self, tuples, max_depth: int = 0):
        self._count("host_checks", len(tuples))
        return [self.check_relation_tuple(t, max_depth) for t in tuples]

    def expand(self, subject, max_depth: int = 0):
        return self.reference.expand(subject, max_depth, self.nid)

    def list_objects(self, namespace, relation, subject, max_depth: int = 0,
                     page_size: int = 100, page_token: str = ""):
        from .engine.definitions import paginate_names

        self._count("host_list_objects", 1)
        return paginate_names(
            self.reference.list_objects(namespace, relation, subject, max_depth, self.nid),
            page_size, page_token)

    def list_subjects(self, namespace, obj, relation, max_depth: int = 0,
                      page_size: int = 100, page_token: str = ""):
        from .engine.definitions import paginate_names

        self._count("host_list_subjects", 1)
        return paginate_names(
            self.reference.list_subjects(namespace, obj, relation, max_depth, self.nid),
            page_size, page_token)

    def filter_objects(self, namespace, relation, subject, objects, max_depth: int = 0,
                       deadline=None):
        verdicts = self.reference.filter_objects(namespace, relation, subject, objects,
                                                 max_depth, self.nid)
        return [o for o, ok in zip(objects, verdicts) if ok]

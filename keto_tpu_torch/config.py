"""Configuration of the Check path: a dotted-key view over a JSON config.

Reads the keys the JAX package's serve entry point reads for the read
and write routes: `namespaces` (an inline list of namespace dicts),
`limit.max_read_depth` (default 5, as Keto's embedx/config.schema.json),
`limit.page_size` (the list routes' default page, 100),
`serve.read.host` / `serve.read.port`, `serve.write.host` /
`serve.write.port` (the write routes' listener), `closure.enabled` (the Leopard
index routes checks and filters, default false), `closure.max_set_rows`
(the largest closure set a covered node may hold, 4096),
`closure.lag_budget_versions` (a check catches an index that lags the
mirror by at most this many store versions up inline, marking the
written nodes dirty, 64; past it the batch falls back to the BFS until
the maintainer catches up), `closure.powering` ("host", the default,
powers the index with numpy;
"device" on the engine's device, engine/closure_power.py; on the
1e6-tuple deep hierarchy of chip_smoke.py phase 9p "device" is no clear
gain, 11.3-15.4 s of powering against 12.2-14.4 s for "host" in the
same runs on an NVIDIA H100 80GB HBM3 at 700 W, since its host
preparation and R·D product outweigh the waves),
`filter.chunk_size` (candidates per filter evaluation, 4096) and
`filter.max_objects` (the largest candidate list a filter request may
carry, 65536).

The serving plane's keys, with the JAX package's defaults: `dsn` (the
store: "memory", the object store, or "columnar", the numpy-column store
of the scale tier, whose mirror builds by the columnar builders),
`check.engine` ("torch", the device engine, or "host", the exact host
oracle alone),
`check.pipeline_depth` (the batcher's resolve threads, 2),
`check.batch_window_ms` (how long the collector tops a batch up, 2.0),
`check.cache.enabled` (true), `check.cache.max_entries` (65536) and
`check.cache.ttl_s` (0: no expiry), and under `serve.check`:
`max_queue` (admitted checks past which a new one is refused with a
429; unset: no bound), `max_inflight` (launched but unresolved batches;
unset: twice the pipeline depth, at least 4), `device_timeout_ms` (the
launch watchdog; unset: off), `default_deadline_ms` and
`max_deadline_ms` (a request's deadline when it names none, and the cap
of any; unset: none), `breaker.threshold` (5) and `breaker.cooldown_s`
(5.0). The listeners' options, per kind ("read", "write"):
`serve.<kind>.grpc` ({host, port}: a direct gRPC listener beside the
muxed port; `serve.read.grpc.aio`, true: the read side's is the asyncio
plane; `serve.read.grpc.max_watchers`, 16: concurrent Health Watch
streams), `serve.<kind>.tls` ({cert_path, key_path}: TLS on the port and
its direct listener) and `serve.<kind>.cors` ({enabled, allowed_origins,
allowed_methods, allowed_headers}). Schema validation, namespace files
and OPL stay with the JAX package.
"""

from __future__ import annotations

import json
from typing import Any, Mapping, Optional

from .errors import KetoError
from .namespace.definitions import MemoryNamespaceManager, Namespace
from .storage.definitions import DEFAULT_PAGE_SIZE

DEFAULT_MAX_READ_DEPTH = 5
DEFAULT_READ_PORT = 4466
DEFAULT_WRITE_PORT = 4467
DEFAULT_FILTER_CHUNK_SIZE = 4096
DEFAULT_FILTER_MAX_OBJECTS = 65536


class ConfigError(KetoError):
    status = 500
    code = "internal_server_error"
    default_message = "invalid configuration"


class Config:
    def __init__(self, values: Optional[Mapping[str, Any]] = None):
        self._values: dict[str, Any] = dict(values or {})
        self._namespace_manager: Optional[MemoryNamespaceManager] = None

    @property
    def dsn(self) -> str:
        return str(self.get("dsn", "memory"))

    @classmethod
    def from_file(cls, path: str) -> "Config":
        if not path.endswith(".json"):
            raise ConfigError(f"config file must be JSON: {path}")
        with open(path, "rb") as f:
            return cls(json.load(f))

    def get(self, key: str, default: Any = None) -> Any:
        """Dotted-path lookup, e.g. 'limit.max_read_depth'."""
        cur: Any = self._values
        for part in key.split("."):
            if not isinstance(cur, Mapping) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def max_read_depth(self) -> int:
        return int(self.get("limit.max_read_depth", DEFAULT_MAX_READ_DEPTH))

    def page_size(self) -> int:
        return int(self.get("limit.page_size", DEFAULT_PAGE_SIZE))

    def closure_enabled(self) -> bool:
        return bool(self.get("closure.enabled", False))

    def filter_max_objects(self) -> int:
        return int(self.get("filter.max_objects", DEFAULT_FILTER_MAX_OBJECTS))

    def read_address(self) -> tuple[str, int]:
        return (
            str(self.get("serve.read.host", "0.0.0.0")),
            int(self.get("serve.read.port", DEFAULT_READ_PORT)),
        )

    def write_address(self) -> tuple[str, int]:
        return (
            str(self.get("serve.write.host", "0.0.0.0")),
            int(self.get("serve.write.port", DEFAULT_WRITE_PORT)),
        )

    def namespace_manager(self) -> MemoryNamespaceManager:
        if self._namespace_manager is None:
            raw = self.get("namespaces", [])
            if not isinstance(raw, list):
                raise ConfigError("`namespaces` must be an inline list")
            self._namespace_manager = MemoryNamespaceManager(
                Namespace.from_dict(d) if isinstance(d, Mapping) else d for d in raw
            )
        return self._namespace_manager

    def set_namespaces(self, namespaces: list[Namespace]) -> None:
        """Programmatic namespace injection (embedders and tests)."""
        self._namespace_manager = MemoryNamespaceManager(namespaces)

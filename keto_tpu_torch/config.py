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
allowed_methods, allowed_headers}). The Watch API's keys:
`watch.poll_interval` (how often a tail with no in-process writer reads
the store's change log, 0.25 s), `watch.buffer` (the events a
subscriber's ring holds before it overflows into a RESET, 256) and
`watch.heartbeat_s` (the in-band heartbeat period of the hub, unset:
none; of a gRPC stream's heartbeat frames and the SSE keep-alive
comments, 5.0).

`namespaces` takes, as the JAX package's config does:
  - an inline list of namespace dicts (name, id, relations);
  - a path, bare or `file://`-prefixed, to a `.yaml`/`.yml`, `.json` or
    `.toml` file of one namespace or a list of them, to a `.ts` file in
    the Ory Permission Language (opl/), or to a directory of such files,
    every `.ts` source there parsed as one document;
  - a dict `{location: <such a path>}`, as Keto >= 0.10 writes it.
A file source reloads when a file's mtime changes; a reload that fails to
parse keeps serving the previous set (`last_error` says why), and each
load that succeeds is a new `config_generation`. A source that fails at
startup raises ConfigError. A config file is `.yaml`/`.yml`, `.json` or
`.toml`; YAML needs PyYAML, imported only for a YAML file. Not ported:
the JSON-schema validation of a config.
"""

from __future__ import annotations

import json
import logging
import os
import tomllib
from typing import Any, Mapping, Optional

from .errors import KetoError, NamespaceNotFoundError
from .namespace.definitions import MemoryNamespaceManager, Namespace, next_config_generation
from .opl import parser as opl_parser
from .storage.definitions import DEFAULT_PAGE_SIZE

logger = logging.getLogger("keto_tpu_torch.config")

DEFAULT_MAX_READ_DEPTH = 5
DEFAULT_READ_PORT = 4466
DEFAULT_WRITE_PORT = 4467
DEFAULT_FILTER_CHUNK_SIZE = 4096
DEFAULT_FILTER_MAX_OBJECTS = 65536


class ConfigError(KetoError):
    status = 500
    code = "internal_server_error"
    default_message = "invalid configuration"


def _yaml_load(f, path: str):
    """One YAML document; PyYAML is imported here, so that a JSON or TOML
    config needs nothing more."""
    try:
        import yaml
    except ModuleNotFoundError:
        raise ConfigError(f"{path} is YAML, which needs PyYAML: it is not installed")
    return yaml.safe_load(f)


NAMESPACE_FILE_EXTENSIONS = ("yaml", "yml", "json", "toml", "ts")


class NamespaceFileManager:
    """The namespaces of a file or a directory of files, reloaded when a
    file's mtime changes; a reload that fails keeps the previous set and
    records why in `last_error`."""

    def __init__(self, location: str):
        self.location = location.removeprefix("file://")
        self._namespaces: dict[str, Namespace] = {}
        self._mtimes: dict[str, float] = {}
        self.last_error: Optional[Exception] = None
        self.config_generation = next_config_generation()
        self._load(initial=True)

    # -- loading --------------------------------------------------------------

    def _files(self) -> list[str]:
        loc = self.location
        if os.path.isdir(loc):
            return [os.path.join(loc, name) for name in sorted(os.listdir(loc))
                    if os.path.isfile(os.path.join(loc, name))
                    and name.rsplit(".", 1)[-1] in NAMESPACE_FILE_EXTENSIONS]
        return [loc]

    @staticmethod
    def parse_opl(source: str, origin: str) -> list[Namespace]:
        """The namespaces of an OPL source; `origin` names its files in
        the error."""
        namespaces, errs = opl_parser.parse(source)
        if errs:
            raise ConfigError(f"could not parse {origin}: " + "; ".join(e.msg for e in errs))
        return namespaces

    @classmethod
    def parse_file(cls, path: str) -> list[Namespace]:
        """The namespaces of one file, by its extension."""
        ext = path.rsplit(".", 1)[-1].lower()
        if ext == "ts":
            with open(path, "r") as f:
                return cls.parse_opl(f.read(), path)
        with open(path, "rb") as f:
            if ext in ("yaml", "yml"):
                raw = _yaml_load(f, path)
            elif ext == "json":
                raw = json.load(f)
            elif ext == "toml":
                raw = tomllib.load(f)
            else:
                raise ConfigError(f"unknown namespace file extension: {path}")
        if raw is None:
            return []
        if isinstance(raw, list):
            return [Namespace.from_dict(d) for d in raw]
        return [Namespace.from_dict(raw)]

    def _load(self, initial: bool = False) -> None:
        new: dict[str, Namespace] = {}
        mtimes: dict[str, float] = {}
        try:
            # a .ts file may name namespaces another declares: every OPL
            # source is parsed as one document, after the other formats
            opl_sources, opl_paths = [], []
            for path in self._files():
                mtimes[path] = os.stat(path).st_mtime
                if path.rsplit(".", 1)[-1].lower() == "ts":
                    opl_paths.append(path)
                    with open(path, "r") as f:
                        opl_sources.append(f.read())
                else:
                    for ns in self.parse_file(path):
                        new[ns.name] = ns
            if opl_sources:
                for ns in self.parse_opl("\n".join(opl_sources), ", ".join(opl_paths)):
                    new[ns.name] = ns
        except Exception as e:  # noqa: BLE001 - a bad reload must not end serving
            if initial:
                raise ConfigError(f"could not load namespaces: {e}")
            # keep serving the previous set; warn once for each new error
            if type(self.last_error) is not type(e) or str(self.last_error) != str(e):
                logger.warning("namespace reload failed, keeping previous set: %s", e)
            self.last_error = e
            return
        self._namespaces = new
        self._mtimes = mtimes
        self.last_error = None
        # a new set alters check answers without a store version bump
        self.config_generation = next_config_generation()

    def _maybe_reload(self) -> None:
        try:
            current = {p: os.stat(p).st_mtime for p in self._files()}
        except OSError:
            return
        if current != self._mtimes:
            self._load()

    # -- the namespace manager's surface ------------------------------------------

    def get_namespace_by_name(self, name: str) -> Namespace:
        self._maybe_reload()
        try:
            return self._namespaces[name]
        except KeyError:
            raise NamespaceNotFoundError(name)

    def namespaces(self) -> list[Namespace]:
        self._maybe_reload()
        return list(self._namespaces.values())


class Config:
    def __init__(self, values: Optional[Mapping[str, Any]] = None):
        self._values: dict[str, Any] = dict(values or {})
        self._namespace_manager = None

    @property
    def dsn(self) -> str:
        return str(self.get("dsn", "memory"))

    @classmethod
    def from_file(cls, path: str) -> "Config":
        """A `.yaml`/`.yml`, `.json` or `.toml` config file."""
        with open(path, "rb") as f:
            if path.endswith((".yaml", ".yml")):
                values = _yaml_load(f, path) or {}
            elif path.endswith(".json"):
                values = json.load(f)
            elif path.endswith(".toml"):
                values = tomllib.load(f)
            else:
                raise ConfigError(f"unknown config file extension: {path}")
        return cls(values)

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

    def namespace_manager(self):
        """The namespace manager of `namespaces`, built once: a
        NamespaceFileManager for a path or a {location} dict, a
        MemoryNamespaceManager for an inline list."""
        if self._namespace_manager is None:
            raw = self.get("namespaces", [])
            if isinstance(raw, str):
                self._namespace_manager = NamespaceFileManager(raw)
            elif isinstance(raw, Mapping) and "location" in raw:
                self._namespace_manager = NamespaceFileManager(raw["location"])
            elif isinstance(raw, list):
                self._namespace_manager = MemoryNamespaceManager(
                    Namespace.from_dict(d) if isinstance(d, Mapping) else d for d in raw)
            else:
                raise ConfigError("invalid `namespaces` config value")
        return self._namespace_manager

    def legacy_namespace_ids(self) -> Optional[dict]:
        """The deprecated numeric namespace id -> name map that the SQL
        store's strings-to-UUIDs data migration resolves legacy rows by
        (Keto's namespaceIDtoName); None when no configured namespace
        carries a numeric id."""
        legacy = {
            ns.id: ns.name
            for ns in self.namespace_manager().namespaces()
            if ns.id is not None
        }
        return legacy or None

    def set_namespaces(self, namespaces: list[Namespace]) -> None:
        """Programmatic namespace injection (embedders and tests)."""
        self._namespace_manager = MemoryNamespaceManager(namespaces)

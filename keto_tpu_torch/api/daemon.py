"""The serving daemon: the read and write REST listeners over a Registry,
the check batcher behind the read listener's single checks, and the
closure maintainer when `closure.enabled`.

`start()` builds the listeners on `serve.read.*` and `serve.write.*`
(port 0: a free one), starts the maintainer, then sets readiness. A
listener serves REST directly on its port: the JAX package's byte-sniffing
mux, which also serves gRPC on the same port, and its metrics listener
come later. `stop(grace)` drains in the JAX package's order: readiness
off and draining on (admit_check sheds new checks with a typed 429),
then up to `grace` seconds for every admitted check to be answered, then
the maintainer, the listeners, the batcher and the check cache's
invalidation thread, and the engine's refresh thread.
"""

from __future__ import annotations

import logging
import threading
import time

from ..errors import KetoError
from .batcher import CheckBatcher
from .rest_server import make_server, make_write_server

logger = logging.getLogger("keto_tpu_torch")


def make_batcher(registry) -> CheckBatcher:
    """The check batcher over `registry`'s engine, breaker and counters,
    sized by its config (check.pipeline_depth, check.batch_window_ms,
    serve.check.*)."""
    cfg = registry.config
    return CheckBatcher(
        registry.check_engine(),
        engine_resolver=registry.check_engine,
        pipeline_depth=int(cfg.get("check.pipeline_depth", 2)),
        window_s=float(cfg.get("check.batch_window_ms", 2.0)) / 1e3,
        max_inflight=cfg.get("serve.check.max_inflight"),
        max_queue=cfg.get("serve.check.max_queue"),
        device_timeout_ms=cfg.get("serve.check.device_timeout_ms"),
        breaker=registry.circuit_breaker(),
        counters=registry.counters(),
    )


class Daemon:
    def __init__(self, registry):
        self.registry = registry
        cfg = registry.config
        # the store first, before any listener or batcher: a bad dsn ends
        # here with one typed error
        try:
            registry.relation_tuple_manager().version(nid=registry.nid)
        except KetoError:
            raise
        except Exception as e:
            from ..config import ConfigError

            raise ConfigError(
                f"store DSN {cfg.dsn!r} failed its startup probe: {type(e).__name__}: {e}"
            ) from e
        self.read_addr = cfg.read_address()
        self.write_addr = cfg.write_address()
        self.batcher = make_batcher(registry)
        self._servers: dict = {}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        reg = self.registry
        self._servers["read"] = make_server(reg, *self.read_addr, batcher=self.batcher)
        self._servers["write"] = make_write_server(reg, *self.write_addr)
        for kind, srv in self._servers.items():
            threading.Thread(target=srv.serve_forever, name=f"keto-torch-rest-{kind}",
                             daemon=True).start()
        if bool(reg.config.get("closure.enabled", False)):
            reg.closure_maintainer().start()
        reg.draining.clear()
        reg.ready.set()
        logger.info("serving read=%s:%d write=%s:%d", self.read_addr[0], self.read_port,
                    self.write_addr[0], self.write_port)

    @property
    def read_port(self) -> int:
        return self._servers["read"].server_address[1]

    @property
    def write_port(self) -> int:
        return self._servers["write"].server_address[1]

    def stop(self, grace: float = 5.0) -> None:
        """Drain, then stop everything start() started: a check admitted
        before the drain is answered before its listener closes."""
        reg = self.registry
        reg.ready.clear()
        reg.draining.set()
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline and not self.batcher.idle():
            time.sleep(0.02)
        if reg._closure_maintainer is not None:
            reg._closure_maintainer.stop()
        for srv in self._servers.values():
            srv.shutdown()
            srv.server_close()
        self.batcher.close()
        reg.close_check_cache()
        for engine in reg.built_engines().values():
            stop = getattr(engine, "stop_push_refresh", None)
            if stop is not None:
                stop()

"""The serving daemon: the read and write ports over a Registry, each
serving gRPC and REST on one address, the check batcher behind the read
port's single checks, and the closure maintainer when `closure.enabled`.

A port is a PortMux: it peeks at every accepted connection for the
HTTP/2 client preface ("PRI * HTTP/2.0") and splices it to a loopback
gRPC server (api/grpc_server.py), or else hands the connection itself to
the port's REST server (api/rest_server.py, listening nowhere), as Keto
multiplexes both protocols on one port. The JAX package splices REST to
a loopback listener too; handing it over spares a REST request the
splice's two extra socket hops and the threads that pump them.
`serve.<kind>.grpc` ({host, port}) adds a second, direct gRPC listener
that skips the mux's splice. TLS, the asyncio plane and the metrics
listener come later.

`start()` builds the servers and the muxes on `serve.read.*` and
`serve.write.*` (port 0: a free one), starts the maintainer, then sets
readiness. `stop(grace)` drains: readiness off and draining on
(admit_check sheds new checks with a typed 429, RESOURCE_EXHAUSTED over
gRPC), then up to `grace` seconds for every admitted check to be
answered, then the maintainer, the muxes, the gRPC servers (read, then
write, each given `grace` for its calls), the REST servers, the batcher,
the check cache's invalidation thread and the engine's refresh thread.
"""

from __future__ import annotations

import logging
import selectors
import socket
import threading
import time

from ..errors import KetoError
from .batcher import CheckBatcher
from .grpc_server import build_grpc_server
from .rest_server import make_server, make_write_server

logger = logging.getLogger("keto_tpu_torch")

_H2_PREFACE = b"PRI * HTTP/2.0"
LOOPBACK = "127.0.0.1"


class PortMux:
    """One public port in front of a gRPC and a REST backend: an HTTP/2
    connection is spliced to the gRPC server at `grpc_addr`, its bytes
    pumped both ways until either side closes; any other is handed to
    `http_server.process_request`, as if that server had accepted it."""

    def __init__(self, host: str, port: int, grpc_addr, http_server):
        self.grpc_addr = grpc_addr
        self.http_server = http_server
        self._listener = socket.create_server((host, port), family=socket.AF_INET,
                                              backlog=128)
        self._listener.settimeout(0.5)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name=f"keto-torch-mux-{self.port}", daemon=True)

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)  # wakes the accept at once
        except OSError:
            pass
        self._listener.close()
        self._thread.join(timeout=5)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handshake, args=(conn, addr), daemon=True).start()

    def _handshake(self, conn: socket.socket, addr) -> None:
        try:
            head = self._peek_head(conn)
            if not head:
                conn.close()
                return
            conn.settimeout(None)
            if not head.startswith(_H2_PREFACE):
                # the peeked bytes are still unread: the server reads the
                # request from the start
                self.http_server.process_request(conn, addr)
                return
            backend = socket.create_connection(self.grpc_addr)
            # each relayed read goes on at once: Nagle would hold a small
            # frame back until the previous one is acknowledged
            for s in (conn, backend):
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._splice(conn, backend)
        except OSError:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _peek_head(conn: socket.socket, timeout_s: float = 10.0) -> bytes:
        """The connection's first bytes, left unread: as many as tell the
        HTTP/2 preface from anything else (a peek may return a first
        segment shorter than the preface, even with MSG_WAITALL). Empty
        when the client closes or sends nothing in `timeout_s`."""
        conn.settimeout(timeout_s)
        end = time.monotonic() + timeout_s
        try:
            while True:
                head = conn.recv(len(_H2_PREFACE), socket.MSG_PEEK | socket.MSG_WAITALL)
                if not head or len(head) >= len(_H2_PREFACE) or \
                        not _H2_PREFACE.startswith(head):
                    return head
                if time.monotonic() >= end:
                    return b""
                time.sleep(0.001)
        except socket.timeout:
            return b""

    @staticmethod
    def _splice(a: socket.socket, b: socket.socket) -> None:
        """Pump bytes both ways until both sides have closed."""
        sel = selectors.DefaultSelector()
        sel.register(a, selectors.EVENT_READ, b)
        sel.register(b, selectors.EVENT_READ, a)
        try:
            open_sides = 2
            while open_sides:
                for key, _ in sel.select(timeout=60):
                    src, dst = key.fileobj, key.data
                    try:
                        data = src.recv(65536)
                    except OSError:
                        data = b""
                    if not data:
                        sel.unregister(src)
                        open_sides -= 1
                        try:
                            dst.shutdown(socket.SHUT_WR)
                        except OSError:
                            pass
                        continue
                    try:
                        dst.sendall(data)
                    except OSError:
                        return
        finally:
            sel.close()
            for s in (a, b):
                try:
                    s.close()
                except OSError:
                    pass


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
        self.read_grpc_port = None
        self.write_grpc_port = None
        self._grpc: dict = {}
        self._rest: dict = {}
        self._muxes: dict = {}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        reg = self.registry
        for kind, addr in (("write", self.write_addr), ("read", self.read_addr)):
            write = kind == "write"
            server = build_grpc_server(reg, write=write, batcher=None if write else self.batcher)
            loop_port = server.add_insecure_port(f"{LOOPBACK}:0")
            setattr(self, f"{kind}_grpc_port", self._add_direct_grpc(kind, server))
            server.start()
            self._grpc[kind] = server
            rest = make_write_server(reg, LOOPBACK, 0, bind=False) if write else \
                make_server(reg, LOOPBACK, 0, batcher=self.batcher, bind=False)
            self._rest[kind] = rest
            self._muxes[kind] = PortMux(addr[0], addr[1], (LOOPBACK, loop_port), rest)
        for mux in self._muxes.values():
            mux.start()
        if bool(reg.config.get("closure.enabled", False)):
            reg.closure_maintainer().start()
        reg.draining.clear()
        reg.ready.set()
        logger.info("serving read=%s:%d write=%s:%d", self.read_addr[0], self.read_port,
                    self.write_addr[0], self.write_port)

    def _add_direct_grpc(self, kind: str, server):
        """Bind `server` on serve.<kind>.grpc as a second public port, not
        muxed; the bound port, or None when unconfigured."""
        g = self.registry.config.get(f"serve.{kind}.grpc")
        if not g:
            return None
        return server.add_insecure_port(f"{g.get('host', LOOPBACK)}:{g.get('port', 0)}")

    @property
    def read_port(self) -> int:
        return self._muxes["read"].port

    @property
    def write_port(self) -> int:
        return self._muxes["write"].port

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
        for mux in self._muxes.values():
            mux.stop()
        for kind in ("read", "write"):
            if kind in self._grpc:
                self._grpc[kind].stop(grace).wait(grace)
        for srv in self._rest.values():
            srv.server_close()
        self.batcher.close()
        reg.close_check_cache()
        for engine in reg.built_engines().values():
            stop = getattr(engine, "stop_push_refresh", None)
            if stop is not None:
                stop()

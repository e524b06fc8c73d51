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
that skips the mux's splice; with `serve.read.grpc.aio` the read side's
is the asyncio plane (api/aio_server.py), its own loop thread and batcher,
while the muxed port stays threaded.

`serve.<kind>.tls` ({cert_path, key_path}) puts TLS on that kind's port
and on its direct gRPC listener, the aio one included: the mux terminates
TLS on each accepted connection (a failed handshake closes that
connection alone), so both backends stay plaintext on loopback.
`serve.<kind>.cors` adds CORS to that kind's REST answers
(api/rest_server.py). A `pid_file` is written when the daemon starts and
removed when it stops cleanly, if it still holds this process's pid. The
metrics listener comes with the metrics.

`start()` builds the servers and the muxes on `serve.read.*` and
`serve.write.*` (port 0: a free one), starts the maintainer, then sets
readiness (the Watch hub runs from the first hand-out of the store, which
the constructor's probe makes). `stop(grace)` drains: readiness off and draining on
(admit_check sheds new checks with a typed 429, RESOURCE_EXHAUSTED over
gRPC), then up to `grace` seconds for every admitted check to be
answered, then the maintainer, the Watch hub (which closes every
subscription, so that no watch stream pins a listener), the muxes, the
aio listener, the gRPC
servers (read, then write, each given `grace` for its calls), the REST
servers, the batcher, the check cache's invalidation thread, the
engine's refresh thread, and last the pid file.
"""

from __future__ import annotations

import contextlib
import io
import logging
import os
import selectors
import socket
import ssl
import threading
import time

import grpc

from ..errors import KetoError
from .batcher import CheckBatcher
from .grpc_server import build_grpc_server
from .rest_server import make_server, make_write_server

logger = logging.getLogger("keto_tpu_torch")

_H2_PREFACE = b"PRI * HTTP/2.0"
LOOPBACK = "127.0.0.1"


class _Prefixed(io.RawIOBase):
    """A connection's read side with `head`, the bytes the mux already
    consumed, put back in front."""

    def __init__(self, head: bytes, raw):
        self._head = head
        self._raw = raw

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        if self._head:
            n = min(len(b), len(self._head))
            b[:n] = self._head[:n]
            self._head = self._head[n:]
            return n
        return self._raw.readinto(b)

    def close(self) -> None:
        if not self.closed:
            self._raw.close()
        super().close()


class _HandedOver:
    """A TLS connection handed to the REST server after the mux read its
    first bytes (a TLS socket cannot be peeked): its `makefile("rb")`
    yields those bytes first; everything else is the socket's."""

    def __init__(self, conn: ssl.SSLSocket, head: bytes):
        self._conn = conn
        self._head = head

    def makefile(self, mode="r", buffering=None, **kw):
        if "r" not in mode:
            return self._conn.makefile(mode, buffering, **kw)
        head, self._head = self._head, b""
        raw = _Prefixed(head, self._conn.makefile("rb", buffering=0))
        return io.BufferedReader(raw, buffering if buffering and buffering > 0
                                 else io.DEFAULT_BUFFER_SIZE)

    def __getattr__(self, name):
        return getattr(self._conn, name)


class PortMux:
    """One public port in front of a gRPC and a REST backend: an HTTP/2
    connection is spliced to the gRPC server at `grpc_addr`, its bytes
    pumped both ways until either side closes; any other is handed to
    `http_server.process_request`, as if that server had accepted it.
    With `ssl_context` the mux terminates TLS on each connection first
    and sniffs the decrypted stream."""

    def __init__(self, host: str, port: int, grpc_addr, http_server, ssl_context=None):
        self.grpc_addr = grpc_addr
        self.http_server = http_server
        self.ssl_context = ssl_context
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
            consumed = b""
            if self.ssl_context is not None:
                conn.settimeout(10.0)
                try:
                    conn = self.ssl_context.wrap_socket(conn, server_side=True)
                except (ssl.SSLError, OSError):
                    conn.close()
                    return
                head = consumed = self._read_head(conn)
            else:
                head = self._peek_head(conn)
            if not head:
                conn.close()
                return
            if not head.startswith(_H2_PREFACE):
                conn.settimeout(None)
                # the server reads the request from its first byte: still
                # unread on a plain socket, put back in front on a TLS one
                self.http_server.process_request(
                    _HandedOver(conn, consumed) if consumed else conn, addr)
                return
            backend = socket.create_connection(self.grpc_addr)
            # each relayed read goes on at once: Nagle would hold a small
            # frame back until the previous one is acknowledged
            for s in (conn, backend):
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if consumed:
                backend.sendall(consumed)
            # a TLS socket keeps a read timeout in the splice: a partial
            # record wakes the selector, then its read waits for the rest
            conn.settimeout(60.0 if self.ssl_context is not None else None)
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
    def _read_head(conn: ssl.SSLSocket) -> bytes:
        """_peek_head on a TLS connection, which cannot be peeked: the
        first decrypted bytes are read (as many as tell the preface from
        anything else, or all the TLS layer holds already) for the caller
        to replay. Empty when the client closes or stalls before a byte."""
        head = b""
        try:
            while len(head) < len(_H2_PREFACE) and _H2_PREFACE.startswith(head):
                chunk = conn.recv(len(_H2_PREFACE) - len(head))
                if not chunk:
                    break
                head += chunk
            # decrypted bytes the TLS layer holds wake no selector: take
            # them now, or the splice would wait for the client's next write
            while conn.pending():
                more = conn.recv(conn.pending())
                if not more:
                    break
                head += more
        except socket.timeout:
            pass
        return head

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
                        # a TLS socket's decrypted but unread bytes wake
                        # no selector: drain them with this read
                        pending = getattr(src, "pending", None)
                        while data and pending is not None and pending():
                            more = src.recv(65536)
                            if not more:
                                break
                            data += more
                    except socket.timeout:
                        continue  # a partial TLS record, not a close
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
                        # the read timeout must not govern a send to a slow
                        # but live client
                        prev = dst.gettimeout()
                        if prev:
                            dst.settimeout(None)
                        try:
                            dst.sendall(data)
                        finally:
                            if prev:
                                dst.settimeout(prev)
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
    def __init__(self, registry, pid_file: str | None = None):
        self.registry = registry
        # written by start(), removed by stop(): a pid file that outlives a
        # clean stop would point a supervisor at a recycled pid
        self.pid_file = pid_file
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
        self._aio_read = None
        self._grpc: dict = {}
        self._rest: dict = {}
        self._muxes: dict = {}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        reg = self.registry
        cfg = reg.config
        for kind, addr in (("write", self.write_addr), ("read", self.read_addr)):
            write = kind == "write"
            server = build_grpc_server(reg, write=write, batcher=None if write else self.batcher)
            loop_port = server.add_insecure_port(f"{LOOPBACK}:0")
            if not write and cfg.get("serve.read.grpc") and cfg.get("serve.read.grpc.aio"):
                # the direct read listener is the asyncio plane; the muxed
                # port stays on the threaded server
                from .aio_server import AioReadServer

                g = cfg.get("serve.read.grpc")
                self._aio_read = AioReadServer(
                    reg, g.get("host", LOOPBACK), int(g.get("port", 0)),
                    pipeline_depth=int(cfg.get("check.pipeline_depth", 2)),
                    window_s=float(cfg.get("check.batch_window_ms", 2.0)) / 1e3,
                    credentials=self._server_credentials("read"))
                self.read_grpc_port = self._aio_read.start()
            else:
                setattr(self, f"{kind}_grpc_port", self._add_direct_grpc(kind, server))
            server.start()
            self._grpc[kind] = server
            cors = cfg.get(f"serve.{kind}.cors")
            rest = make_write_server(reg, LOOPBACK, 0, bind=False, cors=cors) if write else \
                make_server(reg, LOOPBACK, 0, batcher=self.batcher, bind=False, cors=cors)
            self._rest[kind] = rest
            self._muxes[kind] = PortMux(addr[0], addr[1], (LOOPBACK, loop_port), rest,
                                        ssl_context=self._tls_context(kind))
        for mux in self._muxes.values():
            mux.start()
        if bool(cfg.get("closure.enabled", False)):
            reg.closure_maintainer().start()
        if self.pid_file:
            with open(self.pid_file, "w") as f:
                f.write(str(os.getpid()))
        reg.draining.clear()
        reg.ready.set()
        logger.info("serving read=%s:%d write=%s:%d", self.read_addr[0], self.read_port,
                    self.write_addr[0], self.write_port)

    def _tls_files(self, kind: str):
        """serve.<kind>.tls's (cert_path, key_path), or None when unset."""
        tls = self.registry.config.get(f"serve.{kind}.tls")
        if not tls or not tls.get("cert_path"):
            return None
        return tls["cert_path"], tls.get("key_path")

    def _tls_context(self, kind: str):
        """The server-side TLS context of serve.<kind>.tls (ALPN h2 for
        gRPC, http/1.1 for REST), or None when unset."""
        files = self._tls_files(kind)
        if files is None:
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.set_alpn_protocols(["h2", "http/1.1"])
        ctx.load_cert_chain(*files)
        return ctx

    def _server_credentials(self, kind: str):
        """gRPC server credentials of serve.<kind>.tls, or None when unset:
        a direct listener of a TLS deployment is never plaintext."""
        files = self._tls_files(kind)
        if files is None:
            return None
        cert_path, key_path = files
        with open(cert_path, "rb") as f:
            cert = f.read()
        with open(key_path or cert_path, "rb") as f:
            key = f.read()
        return grpc.ssl_server_credentials(((key, cert),))

    def _add_direct_grpc(self, kind: str, server):
        """Bind `server` on serve.<kind>.grpc as a second public port, not
        muxed, with serve.<kind>.tls's certificate when that is set; the
        bound port, or None when unconfigured."""
        g = self.registry.config.get(f"serve.{kind}.grpc")
        if not g:
            return None
        addr = f"{g.get('host', LOOPBACK)}:{g.get('port', 0)}"
        creds = self._server_credentials(kind)
        if creds is not None:
            return server.add_secure_port(addr, creds)
        return server.add_insecure_port(addr)

    @property
    def read_port(self) -> int:
        return self._muxes["read"].port

    @property
    def write_port(self) -> int:
        return self._muxes["write"].port

    def _idle(self) -> bool:
        aio = self._aio_read.batcher if self._aio_read is not None else None
        return self.batcher.idle() and (aio is None or aio.idle())

    def stop(self, grace: float = 5.0) -> None:
        """Drain, then stop everything start() started: a check admitted
        before the drain is answered before its listener closes."""
        reg = self.registry
        reg.ready.clear()
        reg.draining.set()
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline and not self._idle():
            time.sleep(0.02)
        # the maintainer before the hub: its subscriptions close with it
        if reg._closure_maintainer is not None:
            reg._closure_maintainer.stop()
        # then the hub, ending every watch stream before the listeners go
        if reg._watch_hub is not None:
            reg._watch_hub.stop()
        for mux in self._muxes.values():
            mux.stop()
        if self._aio_read is not None:
            self._aio_read.stop(grace)
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
        # last: while any part still drains, the pid is alive. Only this
        # process's own file goes: a supervisor may have started a
        # replacement onto the same path meanwhile
        if self.pid_file:
            with contextlib.suppress(OSError, ValueError):
                with open(self.pid_file) as f:
                    owner = int(f.read().strip() or 0)
                if owner == os.getpid():
                    os.unlink(self.pid_file)

"""Command line of keto_tpu_torch.

    python -m keto_tpu_torch serve --config cfg.json [--tuples tuples.txt] [--device cuda]

`serve` reads the JAX package's JSON config keys for the read and write
routes (`namespaces`, `limit.max_read_depth`, `limit.page_size`,
`serve.read.host` / `serve.read.port`, `serve.write.host` /
`serve.write.port`, `closure.*`, `filter.*`), loads the tuples of
`--tuples` (one "ns:obj#rel@subject" per line) into an in-memory store,
builds the device mirror (and, with `closure.enabled`, the closure
index, then starts the closure maintainer, closure/maintainer.py), and
serves the REST Check, Expand, ListObjects, ListSubjects and Filter
routes on the read listener and PUT, DELETE and PATCH
/admin/relation-tuples on the write listener until SIGINT or SIGTERM,
which stop the maintainer, then the listeners. The store's write
listener wakes the engine's refresh thread, which folds each write into
the mirror, and the maintainer, which marks the closure nodes it changes
and powers them again. It prints `serving read=<host>:<port>` and then
`serving write=<host>:<port>` once it accepts requests.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


class Services:
    """What `serve` runs: the engine, its closure maintainer (None unless
    `closure.enabled`) and the read and write listeners, each serving on
    a thread of its own."""

    def __init__(self, config, manager, device):
        from .api.rest_server import make_server, make_write_server
        from .closure import ClosureMaintainer, EngineRegistry
        from .engine.torch_engine import TorchCheckEngine

        engine = TorchCheckEngine(manager, config, device=device)
        engine.ensure_state()  # build and upload the mirror before serving
        self.engine = engine
        self.maintainer = None
        if config.closure_enabled():
            engine.closure_ensure_built()
            self.maintainer = ClosureMaintainer(EngineRegistry(manager, {engine.nid: engine}))
            self.maintainer.start()
        manager.add_write_listener(
            lambda nid: engine.notify_write() if nid == engine.nid else None)
        self.servers = [make_server(engine, *config.read_address()),
                        make_write_server(engine, *config.write_address())]
        for srv in self.servers:
            threading.Thread(target=srv.serve_forever, daemon=True).start()

    def addresses(self) -> list[tuple[str, int]]:
        """(host, port) of the read and the write listener."""
        return [srv.server_address[:2] for srv in self.servers]

    def stop(self) -> None:
        """The maintainer first, so that no pass runs against a closing
        server, then the listeners and the refresh thread."""
        if self.maintainer is not None:
            self.maintainer.stop()
        for srv in self.servers:
            srv.shutdown()
            srv.server_close()
        self.engine.stop_push_refresh()


def _serve(args) -> int:
    from .config import Config
    from .ketoapi import RelationTuple
    from .storage import MemoryManager

    config = Config.from_file(args.config)
    manager = MemoryManager()
    if args.tuples:
        with open(args.tuples, encoding="utf-8") as f:
            lines = [line.strip() for line in f]
        manager.write_relation_tuples(
            [RelationTuple.from_string(s) for s in lines if s and not s.startswith("#")]
        )
    services = Services(config, manager, args.device)
    stop = threading.Event()

    def _stop(*_):
        stop.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    (host, _), (w_host, _) = config.read_address(), config.write_address()
    (_, port), (_, w_port) = services.addresses()
    print(f"serving read={host}:{port}", flush=True)
    print(f"serving write={w_host}:{w_port}", flush=True)
    stop.wait()
    services.stop()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m keto_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve", help="serve the REST read and write routes")
    serve.add_argument("--config", required=True, help="JSON config file")
    serve.add_argument("--tuples", help="file of relation tuples, one per line")
    serve.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if args.command == "serve":
        return _serve(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())

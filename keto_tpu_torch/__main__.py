"""Command line of keto_tpu_torch.

    python -m keto_tpu_torch serve --config cfg.json [--tuples tuples.txt] [--device cuda]

`serve` reads the JAX package's JSON config keys for the read and write
routes (`namespaces`, `limit.max_read_depth`, `limit.page_size`,
`serve.read.host` / `serve.read.port`, `serve.write.host` /
`serve.write.port`, `closure.*`, `filter.*`), loads the tuples of
`--tuples` (one "ns:obj#rel@subject" per line) into an in-memory store,
builds the device mirror (and, with `closure.enabled`, the closure
index), and serves the REST Check, Expand, ListObjects, ListSubjects and
Filter routes on the read listener and PUT, DELETE and PATCH
/admin/relation-tuples on the write listener until SIGINT or SIGTERM.
The store's write listener wakes the engine's refresh thread, which folds
each write into the mirror. It prints `serving read=<host>:<port>` and
then `serving write=<host>:<port>` once it accepts requests.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def _serve(args) -> int:
    from .api.rest_server import make_server, make_write_server
    from .config import Config
    from .engine.torch_engine import TorchCheckEngine
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
    engine = TorchCheckEngine(manager, config, device=args.device)
    engine.ensure_state()  # build and upload the mirror before serving
    if config.closure_enabled():
        engine.closure_ensure_built()
    manager.add_write_listener(lambda nid: engine.notify_write() if nid == engine.nid else None)
    host, port = config.read_address()
    server = make_server(engine, host, port)
    w_host, w_port = config.write_address()
    write_server = make_write_server(engine, w_host, w_port)
    stop = threading.Event()

    def _stop(*_):
        stop.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    for srv in (server, write_server):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(f"serving read={host}:{server.server_address[1]}", flush=True)
    print(f"serving write={w_host}:{write_server.server_address[1]}", flush=True)
    stop.wait()
    for srv in (server, write_server):
        srv.shutdown()
        srv.server_close()
    engine.stop_push_refresh()
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

"""Command line of keto_tpu_torch.

    python -m keto_tpu_torch serve --config keto.yml [--tuples tuples.txt] [--device cuda]
                                   [--pid-file serve.pid]

`serve` reads a `.yaml`/`.yml` (Keto's own format; needs PyYAML),
`.json` or `.toml` config with the JAX package's keys for the read and
write routes (`namespaces`: an inline list, or a file or directory of
namespace files, `.ts` in the Ory Permission Language among them, as a
path or Keto's `{location: file:///...}`, reloaded when a file changes;
`dsn` ("memory", "columnar", or `sqlite://<path>`, a durable file that a
restart serves again), `limit.max_read_depth`, `limit.page_size`, `serve.read.host` /
`serve.read.port`, `serve.write.host` / `serve.write.port`,
`serve.<kind>.grpc` (a direct gRPC listener; with `"aio": true` the read
side's is the asyncio plane), `serve.<kind>.tls`, `serve.<kind>.cors`,
`check.*`, `serve.check.*`, `closure.*`, `filter.*`, `watch.*`;
config.py lists them), builds a Registry, loads the tuples of `--tuples`
(one "ns:obj#rel@subject" per line) into its store, builds the device
mirror (and, with `closure.enabled`, the closure index), and runs a
Daemon (api/daemon.py): on the read port the REST Check, Expand,
ListObjects, ListSubjects, Filter and Watch (SSE) routes and the gRPC
read services, the tuple WatchService among them, single checks
coalesced by the check batcher behind the check cache; on the write port
PUT, DELETE and PATCH /admin/relation-tuples and the gRPC WriteService;
each port answers REST and gRPC alike. With `closure.enabled` the
closure maintainer (closure/maintainer.py) runs too. SIGINT or SIGTERM
drains the daemon: readiness turns to 503 (NOT_SERVING) and new checks
are shed with a 429 (RESOURCE_EXHAUSTED) while admitted ones are
answered, then everything stops. It prints `serving read=<host>:<port>`
and then `serving write=<host>:<port>` once it accepts requests.
`--pid-file` names a file the daemon writes its pid to once it serves
and removes when it stops, if the pid there is still its own.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def _serve(args) -> int:
    from .api.daemon import Daemon
    from .config import Config
    from .ketoapi import RelationTuple
    from .registry import Registry

    config = Config.from_file(args.config)
    registry = Registry(config, device=args.device)
    if args.tuples:
        with open(args.tuples, encoding="utf-8") as f:
            lines = [line.strip() for line in f]
        registry.relation_tuple_manager().write_relation_tuples(
            [RelationTuple.from_string(s) for s in lines if s and not s.startswith("#")]
        )
    engine = registry.check_engine()
    if hasattr(engine, "ensure_state"):  # not the host engine
        engine.ensure_state()  # build and upload the mirror before serving
        if config.closure_enabled():
            engine.closure_ensure_built()
    daemon = Daemon(registry, pid_file=args.pid_file)
    stop = threading.Event()

    def _stop(*_):
        stop.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    daemon.start()
    print(f"serving read={daemon.read_addr[0]}:{daemon.read_port}", flush=True)
    print(f"serving write={daemon.write_addr[0]}:{daemon.write_port}", flush=True)
    stop.wait()
    daemon.stop()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m keto_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve", help="serve the read and write APIs, REST and gRPC")
    serve.add_argument("--config", required=True,
                       help="config file: .yaml/.yml, .json or .toml")
    serve.add_argument("--tuples", help="file of relation tuples, one per line")
    serve.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    serve.add_argument("--pid-file", default=None,
                       help="write the daemon's pid here once it serves; removed on a clean "
                            "stop if it still holds this pid")
    args = parser.parse_args(argv)
    if args.command == "serve":
        return _serve(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())

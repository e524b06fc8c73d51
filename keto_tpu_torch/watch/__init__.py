"""The Watch API: the store's change log as a stream (Zanzibar's Watch).

  WatchHub       the process's fan-out, tailing the store's change log
  Subscription   a resumable cursor: a bounded ring, RESET on overflow
  WatchEvent     one committed store version: its changes and snaptoken

Served as the gRPC `keto_tpu.watch.v1.WatchService` on the threaded and
the asyncio read planes, as SSE at `GET /relation-tuples/watch`, and read
by `ReadClient.watch()` (api/). The hub's commit listeners push every
write to the built engine's mirror refresh, the check cache's
invalidation and the closure maintainer (registry.py).
"""

from .hub import Subscription, WatchEvent, WatchHub

__all__ = ["Subscription", "WatchEvent", "WatchHub"]

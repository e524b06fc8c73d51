"""ClosureMaintainer: the Leopard index's freshness loop.

One background thread keeps every built engine's closure index
(engine/closure.py) current. Each pass calls the engine's
`closure_ensure_built()`: it powers the index when it needs it (first
use, a base snapshot swapped by a compaction or a rebuild, a dirty
overflow, a truncated change log), folds every write since into the
dirty marks by the store's change log, and powers the dirty nodes again
(`refresh_dirty`), off the request path. Then it drains the network's
Watch subscription (`_drain_events`): each event's changes mark dirty
nodes (`apply_changes`), and a RESET (an overflowed ring or a truncated
change log) marks the index stale, so that the next pass powers it
again. The Watch hub's commit listener wakes the loop at once; otherwise
it polls every `poll_interval` seconds.

Correctness never depends on this thread: every closure answer is gated
at submit on the index's synced version reaching the serving state's
covered version (engine/torch_engine.py `_closure_gate`), so a paused,
slow or dead maintainer costs deep checks their latency and nothing
else. `hold()` and `release()` force that lagging regime in tests.

The loop makes two registry calls (registry.py): `built_engines()`, the
engines by network id, and `watch_hub()`, whose commit listener wakes it
and whose subscriptions it drains. `stats` counts passes, rebuilds, the
tuple changes applied from events, and the RESETs.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

logger = logging.getLogger("keto_tpu_torch")

DEFAULT_POLL_INTERVAL = 0.25


class ClosureMaintainer:
    def __init__(self, registry, poll_interval: float = DEFAULT_POLL_INTERVAL):
        self.registry = registry
        self.poll_interval = max(float(poll_interval), 0.01)
        self._subs: dict[str, object] = {}
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._held = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()
        self._listener_registered = False
        self.stats = {"passes": 0, "events": 0, "rebuilds": 0, "resets": 0}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        with self._mu:
            if self._thread is not None:
                return
            self._stopped.clear()
            # a commit wakes the loop at once (a flag set on the writer's
            # thread). Registered once: the hub has no way to remove a
            # listener, and start/stop/start must not add a second
            if not self._listener_registered:
                self.registry.watch_hub().add_commit_listener(self._on_commit)
                self._listener_registered = True
            self._thread = threading.Thread(target=self._loop, name="keto-torch-closure-maintainer",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._mu:
            thread, self._thread = self._thread, None
        self._stopped.set()
        self._wake.set()
        if thread is not None:
            thread.join(timeout=5)
        for sub in self._subs.values():
            try:
                sub.close()
            except Exception:  # noqa: BLE001 - the teardown completes
                logger.debug("closure subscription close failed", exc_info=True)
        self._subs.clear()

    def hold(self) -> None:
        """Freeze maintenance: the index lags, and the fallbacks must stay
        correct meanwhile."""
        self._held.set()

    def release(self) -> None:
        self._held.clear()
        self._wake.set()

    def _on_commit(self, nid: str) -> None:
        self._wake.set()

    # -- the loop ---------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stopped.is_set():
            self._wake.wait(self.poll_interval)
            self._wake.clear()
            if self._stopped.is_set():
                return
            if self._held.is_set():
                continue
            try:
                self.step()
            except Exception:  # noqa: BLE001 - the loop never dies; the
                # version gate keeps answers correct and the next pass retries
                logger.debug("closure maintenance pass failed", exc_info=True)

    def step(self) -> int:
        """One pass over every built engine whose closure is enabled:
        power what needs it, then drain the watch events into the dirty
        marks. Returns the number of tuple changes applied; tests call it
        directly."""
        applied = 0
        self.stats["passes"] += 1
        for nid, engine in self.registry.built_engines().items():
            if not getattr(engine, "closure_enabled", False):
                continue
            idx = engine.closure_index()
            before = idx.stats["builds"]
            try:
                engine.closure_ensure_built()
            except Exception:  # noqa: BLE001 - one engine's failing
                # powering must not stop the others' maintenance
                logger.warning("closure build failed for nid=%s", nid, exc_info=True)
                continue
            if idx.stats["builds"] != before:
                self.stats["rebuilds"] += 1
            # after ensure: it advances the op encoder to the engine's
            # overlay, so an event applied here is one it can encode
            applied += self._drain_events(nid, idx)
        return applied

    def _drain_events(self, nid: str, idx) -> int:
        """Apply the pending events of `nid`'s subscription (opened live
        on the first call) to `idx`; a RESET marks it stale."""
        sub = self._subs.get(nid)
        if sub is None:
            try:
                sub = self.registry.watch_hub().subscribe(nid)
            except RuntimeError:
                return 0  # the hub is stopped: the daemon is shutting down
            self._subs[nid] = sub
        applied = 0
        while True:
            try:
                event = sub.get_nowait()
            except Exception:  # noqa: BLE001 - a failed resume only costs
                # the catch-up's work, which ensure_for does anyway
                break
            if event is None:
                break
            if event.is_reset:
                # the gap cannot be folded in: the next pass powers again
                idx.mark_stale()
                self.stats["resets"] += 1
                continue
            idx.apply_changes(event.changes, event.version)
            applied += len(event.changes)
        self.stats["events"] += applied
        return applied

"""TorchCheckEngine: batched Check on the device mirror, with exact host
replay for what the kernel flags.

A check batch is encoded against the current snapshot, padded to a
bucket size, and run as one check_kernel_packed launch; the packed result
is read back once. AND/NOT islands are combined on the host, and queries
the kernel flags (or whose vocabulary never reached the device) are
answered by the host oracle, memoised within the batch.

The mirror is rebuilt in full when the store version or the namespace
config changes; incremental overlay refresh is not part of this engine.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..config import Config
from ..ketoapi import RelationTuple
from ..storage.definitions import DEFAULT_NETWORK
from .definitions import RESULT_IS_MEMBER, RESULT_NOT_MEMBER, CheckResult, Membership
from .delta import SnapshotView
from .islands import combine_islands
from .kernel import (
    CAUSE_NAME_UNINDEXED,
    CAUSE_NAMES,
    check_kernel_packed,
    kernel_static_config,
    pack_queries,
    snapshot_tables,
    unpack_results,
)
from .reference import ReferenceEngine
from .snapshot import GraphSnapshot, build_snapshot, check_layout, encode_query_batch

_BUCKETS = (16, 64, 256, 1024, 4096, 16384)
# rewrite instructions per program; a rewrite that needs more compiles
# to a host-only program
REWRITE_INSTR_CAP = 8


def resolve_device(device) -> torch.device:
    """The engine's device. A CUDA device without a card is an error:
    nothing falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass
class _EngineState:
    snapshot: GraphSnapshot
    view: SnapshotView
    tables: dict
    covered_version: int
    config_fp: str


class TorchCheckEngine:
    def __init__(
        self,
        manager,
        config: Config,
        nid: str = DEFAULT_NETWORK,
        *,
        device="cuda",
        frontier_cap: int = 1 << 14,
        layout: str = "bucketized",
    ):
        self.device = resolve_device(device)
        self.manager = manager
        self.config = config
        self.nid = nid
        # the frontier holds at least one task per batched query
        self.frontier_cap = max(frontier_cap, _BUCKETS[0])
        self._allowed_buckets = [b for b in _BUCKETS if b <= self.frontier_cap]
        self.layout = check_layout(layout)
        self.reference = ReferenceEngine(manager, config)
        self._lock = threading.Lock()
        self._state: _EngineState | None = None
        self.stats = {
            "device_checks": 0,
            "host_checks": 0,
            "snapshot_builds": 0,
            "host_cause": {},
        }

    # -- mirror lifecycle ------------------------------------------------------

    def ensure_state(self) -> _EngineState:
        """The mirror of the store's current version under the current
        namespace config; rebuilt in full when either moved."""
        namespaces = self.config.namespace_manager().namespaces()
        config_fp = json.dumps([ns.to_dict() for ns in namespaces], sort_keys=True)
        with self._lock:
            version = self.manager.version(nid=self.nid)
            state = self._state
            if (
                state is None
                or state.covered_version != version
                or state.config_fp != config_fp
            ):
                tuples = self.manager.all_relation_tuples(nid=self.nid)
                snap = build_snapshot(
                    tuples, namespaces, layout=self.layout,
                    K=REWRITE_INSTR_CAP, version=version,
                )
                self._state = None  # release the old tables before uploading
                state = _EngineState(
                    snapshot=snap,
                    view=SnapshotView(snap),
                    tables=snapshot_tables(snap, self.device),
                    covered_version=version,
                    config_fp=config_fp,
                )
                self._state = state
                self.stats["snapshot_builds"] += 1
            return state

    def tables_nbytes(self) -> dict[str, int]:
        """Bytes of each device table of the current mirror."""
        state = self.ensure_state()
        return {k: v.numel() * v.element_size() for k, v in state.tables.items()}

    # -- check API --------------------------------------------------------------

    def check_relation_tuple(self, r: RelationTuple, max_depth: int = 0) -> CheckResult:
        """Single check with a proof tree: the host oracle answers it."""
        return self.reference.check_relation_tuple(r, max_depth, self.nid)

    def check_is_member(self, r: RelationTuple, max_depth: int = 0) -> bool:
        res = self.check_batch([r], max_depth)[0]
        if res.error is not None:
            raise res.error
        return res.membership == Membership.IS_MEMBER

    def check_batch(
        self, tuples: Sequence[RelationTuple], max_depth: int = 0
    ) -> list[CheckResult]:
        """Batched membership checks (no proof trees)."""
        return self.check_batch_resolve(self.check_batch_submit(tuples, max_depth))

    def check_batch_submit(self, tuples: Sequence[RelationTuple], max_depth: int = 0):
        """Run the device launch for one batch; returns a handle whose
        result vector stays on the device until check_batch_resolve."""
        n = len(tuples)
        if n == 0:
            return ("empty", None, None)
        state = self.ensure_state()
        global_max = self.config.max_read_depth()
        depth = max_depth if 0 < max_depth <= global_max else global_max
        B = next((b for b in self._allowed_buckets if b >= n), None)
        if B is None:
            # oversized batch: split along the largest allowed bucket
            step = self._allowed_buckets[-1]
            return (
                "multi",
                [self.check_batch_submit(tuples[i : i + step], max_depth)
                 for i in range(0, n, step)],
                None,
            )
        q_obj, q_rel, q_skind, q_sa, q_sb, q_valid = encode_query_batch(
            state.view, tuples, B
        )
        q_depth = np.full(B, depth, dtype=np.int32)
        # each launch's frontier scales with its bucket (step cost is
        # O(frontier)): 4x headroom over the seed tasks, at least 64
        launch_cap = min(self.frontier_cap, max(4 * B, 64))
        # islands: K leaf ctxs per instance, room for two per query
        island_cap = 2 * B if state.snapshot.island_circuits else 0
        cfg = kernel_static_config(
            state.snapshot, global_max, launch_cap, n_island_cap=island_cap,
            has_delta=False,
        )
        qpack = torch.from_numpy(
            pack_queries(q_obj, q_rel, q_depth, q_skind, q_sa, q_sb, q_valid)
        ).to(self.device)
        outputs = check_kernel_packed(state.tables, qpack, **cfg)
        meta = {
            "state": state, "tuples": tuples, "n": n, "B": B,
            "max_depth": max_depth, "q_valid": q_valid, "island_cap": cfg["n_island_cap"],
        }
        return ("batch", outputs, meta)

    def check_batch_resolve(self, handle) -> list[CheckResult]:
        return self.check_batch_resolve_v(handle)[0]

    def check_batch_resolve_v(self, handle):
        """(results, versions): versions[i] is the store version a device
        answer is authoritative at, None for host-replayed items (the
        replay reads the live store)."""
        kind, outputs, meta = handle
        if kind == "empty":
            return [], []
        if kind == "multi":
            results: list[CheckResult] = []
            versions: list = []
            for h in outputs:
                r, v = self.check_batch_resolve_v(h)
                results.extend(r)
                versions.extend(v)
            return results, versions
        return self._resolve(outputs, meta)

    def _resolve(self, outputs, meta):
        state = meta["state"]
        tuples = meta["tuples"]
        n, B, max_depth = meta["n"], meta["B"], meta["max_depth"]
        q_valid = meta["q_valid"]
        snap = state.snapshot
        # the batch's one device->host readback
        flat = outputs.cpu().numpy()
        ctx_hit, needs_host, isl_parent, isl_pid, n_isl, _stats = unpack_results(
            flat, B, meta["island_cap"], snap.K
        )
        ctx_hit = ctx_hit.copy()
        if n_isl:
            member = combine_islands(
                ctx_hit, isl_parent, isl_pid, n_isl, snap.island_circuits, B, snap.K
            )
        else:
            member = ctx_hit[:B]
        covered = state.covered_version

        if bool(q_valid[:n].all()) and not bool((needs_host[:n] > 0).any()):
            # every query answered on the device: the steady serving state
            self.stats["device_checks"] += n
            return (
                [RESULT_IS_MEMBER if m else RESULT_NOT_MEMBER for m in member[:n].tolist()],
                [covered] * n,
            )

        results: list[CheckResult] = []
        versions: list = []
        n_host = 0
        host_causes = self.stats["host_cause"]
        # identical replayed queries within one batch evaluate once
        replay_memo: dict[tuple, CheckResult] = {}
        for i, t in enumerate(tuples):
            if q_valid[i] and not needs_host[i]:
                results.append(RESULT_IS_MEMBER if member[i] else RESULT_NOT_MEMBER)
                versions.append(covered)
                continue
            n_host += 1
            cause = (
                CAUSE_NAMES.get(int(needs_host[i]), CAUSE_NAME_UNINDEXED)
                if q_valid[i]
                else CAUSE_NAME_UNINDEXED
            )
            host_causes[cause] = host_causes.get(cause, 0) + 1
            key = (t.namespace, t.object, t.relation, t.subject_id, t.subject_set, max_depth)
            res = replay_memo.get(key)
            if res is None:
                res = self.reference.check_relation_tuple(t, max_depth, self.nid)
                replay_memo[key] = res
            results.append(res)
            versions.append(None)
        self.stats["device_checks"] += n - n_host
        self.stats["host_checks"] += n_host
        return results, versions

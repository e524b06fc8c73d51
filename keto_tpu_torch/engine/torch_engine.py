"""TorchCheckEngine: batched Check and Expand on the device mirror, with
exact host replay for what the kernels flag.

A check batch is encoded against the current snapshot, padded to a
bucket size, and run as one check_kernel_packed launch; the packed result
is read back once. AND/NOT islands are combined on the host, and queries
the kernel flags (or whose vocabulary never reached the device) are
answered by the host oracle, memoised within the batch.

An expand batch runs as one expand_kernel_packed launch over the
full-edge CSR, built lazily beside the mirror; the host assembles each
tree from its slice of the packed pool. Subject ids, unknown vocabulary
and flagged queries are expanded by the host oracle.

A ListObjects batch runs as one list_objects_kernel_packed launch over
the transposed mirror, a ListSubjects batch as one
list_subjects_kernel_packed launch over the full-edge CSR; both are built
lazily beside the mirror. The host decodes, sorts and dedupes each
query's slice of the pool; flagged queries are answered by the host
oracle, and names the mirror does not know answer []. A NOT anywhere in
the config sends every ListObjects query to the oracle.

With `closure.enabled`, a check batch first rides one closure launch
over the Leopard index (engine/closure.py, built by closure_ensure_built,
never on the submit path): the queries it resolves are answered, the
rest go through the BFS kernel once and merge back in order. A
BatchFilter chunk runs four tiers in order: unknown names under a
monotone config are definitive non-members, the closure launch over the
candidate column, one shared-frontier walk (engine/filter_kernel.py) over
the leftovers, and the host oracle for whatever is still unresolved.

The mirror follows the store's change feed. A namespace-config change
rebuilds it in full. Otherwise the writes since its base snapshot fold
into the fixed-shape delta overlay (engine/delta.py): only the overlay
packs are uploaded, and every launch runs its overlay branch
(has_delta), where K1 takes the overlay's answer for an edge and a task
on a dirty row sends its query to the host oracle. Past the overlay's
capacity the writes merge into a new base (engine/compact.py), and the
retained expand and reverse mirrors are patched with the same ops; a
truncated change log or a failed merge gate rebuilds in full. A write
marks the closure nodes it may change dirty (a check catches a lagging
index up inline, within `closure.lag_budget_versions`), so only those
fall back; closure_ensure_built powers them again over the same base.
`notify_write`, wired to the Watch hub's commit listener (registry.py),
folds writes in on a background thread, off the request path.

A store that keeps columns (storage/columnar.py's ColumnarStore, `dsn:
"columnar"`) feeds the columnar builders: the snapshot, the full-edge CSR
and the transposed mirror are encoded from its numpy columns with no
RelationTuple object on the way, its object slots and subject ids become
ArrayMaps (sorted key arrays), and query batches over them encode
vectorised. Every probe table comes from the native builder
(keto_tpu_torch/native).

The engine is shared by the serving plane's threads: the batcher submits
on its launch thread and resolves on its pool threads (a closure batch's
resolve submits its leftovers from there), while Expand, the list routes
and Filter run on request threads. `_lock` guards the state swap and the
lazily built path tables, the closure index guards its own view, and
`_stats_mu` the counters. Every thread launches on PyTorch's current
stream, which is the device's default stream unless a caller sets
another, so the kernels' per-(device, stream) scratch (engine/cuda_ops.py)
sees one launch after another.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import faults as _faults
from ..config import DEFAULT_FILTER_CHUNK_SIZE, Config
from ..errors import DeadlineExceededError
from ..ketoapi import RelationTuple, Subject, SubjectSet, Tree
from ..storage.definitions import DEFAULT_NETWORK
from .definitions import (
    RESULT_IS_MEMBER,
    RESULT_NOT_MEMBER,
    CheckResult,
    Membership,
    paginate_names,
)
from .closure import CAUSE_LAG, DEFAULT_LAG_BUDGET, DEFAULT_MAX_SET_ROWS, ClosureIndex
from .closure_kernel import CL_CAUSE_NAMES, closure_kernel_packed, unpack_closure_results
from .compact import (
    GARBAGE_FLOOR,
    GARBAGE_FRACTION,
    MergeFallback,
    _per_row,
    merge_ops_into_snapshot,
    patch_csr,
)
from .delta import (
    DeltaOverflow,
    SnapshotView,
    build_delta_tables,
    build_vocab_overlay,
    empty_delta_tables,
)
from .expand_kernel import (
    ExpandDecoder,
    assemble_tree,
    build_full_csr,
    build_full_csr_columnar,
    decode_edge_buffer,
    expand_kernel_packed,
    expand_tables_from_numpy,
    pack_expand_queries,
    pack_expand_tables,
    unpack_expand_results,
)
from .filter_kernel import filter_kernel_packed, pack_filter_query, unpack_filter_results
from .islands import combine_islands
from .kernel import (
    CAUSE_NAME_UNINDEXED,
    CAUSE_NAMES,
    check_kernel_packed,
    kernel_static_config,
    pack_pair_table,
    pack_queries,
    refresh_delta_tables,
    snapshot_tables,
    tables_from_numpy,
    unpack_results,
)
from .reference import ReferenceEngine
from .reverse_kernel import (
    build_reverse_state,
    build_reverse_state_columnar,
    decode_pool_slice,
    list_objects_kernel_packed,
    list_subjects_kernel_packed,
    pack_list_objects_queries,
    pack_list_subjects_queries,
    pack_reverse_tables,
    pack_subjects_tables,
    reverse_tables_from_numpy,
    subjects_tables_from_numpy,
    unpack_list_results,
)
from .snapshot import (
    FLAG_HOST_ONLY,
    FLAG_ISLAND,
    GraphSnapshot,
    build_snapshot,
    build_snapshot_columnar,
    check_layout,
    encode_node_batch,
    encode_object_column,
    encode_query_batch,
    reverse_subject_tag,
)

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
    """One consistent mirror generation: a base snapshot, the overlay of
    the writes since its base version and their device tables. A write
    makes a new state; the lazily built path fields only go from None to
    a value, under the engine lock."""

    snapshot: GraphSnapshot
    view: SnapshotView
    tables: dict
    delta_np: dict  # the overlay's host tables (empty_delta_tables when clean)
    base_version: int  # the store version the base snapshot holds
    covered_version: int  # the store version base + overlay hold
    config_fp: str
    # False for a clean mirror: the launches skip the overlay's probes
    has_delta: bool = False
    # full-edge CSR of the expand path (host arrays and device tables),
    # built at the first expand or ListSubjects; the host arrays are kept
    # so that a compaction patches them
    expand_np: Optional[dict] = None
    expand_tables: Optional[dict] = None
    base_decoder: Optional[ExpandDecoder] = None  # the base snapshot's names
    decoder: Optional[ExpandDecoder] = None  # base_decoder with the overlay's
    # the transposed mirror of ListObjects and the tables of ListSubjects
    reverse_np: Optional[dict] = None
    reverse_tables: Optional[dict] = None
    subjects_tables: Optional[dict] = None


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
        self._stats_mu = threading.Lock()
        self.stats = {
            "device_checks": 0,
            "host_checks": 0,
            "snapshot_builds": 0,
            "incremental_merges": 0,
            "push_refreshes": 0,
            "host_cause": {},
            "device_expands": 0,
            "host_expands": 0,
            "device_list_objects": 0,
            "host_list_objects": 0,
            "device_list_subjects": 0,
            "host_list_subjects": 0,
            "closure_hits": 0,
            "closure_fallback": {},
            "filter_requests": 0,
            "filter_vocab": 0,
            "filter_closure": 0,
            "filter_frontier": 0,
            "filter_host": 0,
        }
        # seconds by stage of the last full mirror build: over columns
        # columns_s (the store's read), encode_s and probe_tables_s, over
        # tuple objects snapshot_s; then pack_upload_s
        self.last_build: dict = {}
        # an attribute, not re-read per batch, so that a caller can toggle
        # it between calls
        self.closure_enabled = config.closure_enabled()
        # exists whether or not closure_enabled routes checks through it
        self._closure = ClosureIndex(
            self.nid, self.device,
            max_set_rows=int(config.get("closure.max_set_rows", DEFAULT_MAX_SET_ROWS)),
            powering=str(config.get("closure.powering", "host")),
            lag_budget_versions=int(config.get("closure.lag_budget_versions",
                                               DEFAULT_LAG_BUDGET)),
        )
        # push refresh: a write listener sets the event, a thread folds
        # the writes in (notify_write)
        self._refresh_mu = threading.Lock()
        self._refresh_event: Optional[threading.Event] = None
        self._refresh_stopped = False

    # -- mirror lifecycle ------------------------------------------------------

    def ensure_state(self) -> _EngineState:
        """The mirror of the store's current version under the current
        namespace config: rebuilt in full on a config change; otherwise
        the writes since its base fold into the overlay, or into a
        compacted base past the overlay's capacity; rebuilt in full where
        neither applies (a truncated change log, a failed merge gate)."""
        namespaces = self.config.namespace_manager().namespaces()
        config_fp = json.dumps([ns.to_dict() for ns in namespaces], sort_keys=True)
        with self._lock:
            version = self.manager.version(nid=self.nid)
            state = self._state
            rebuild = state is None or state.config_fp != config_fp
            if not rebuild and state.covered_version != version:
                state = self._delta_refresh(state, version)
                rebuild = state is None
            if rebuild:
                state = self._rebuild(version, config_fp, namespaces)
            self._state = state
            return state

    def _columns(self):
        """The store's TupleColumns when it keeps columns (ColumnarStore),
        else None: a columnar store feeds the columnar builders, with no
        RelationTuple object on the build path."""
        columns_fn = getattr(self.manager, "all_tuple_columns", None)
        return None if columns_fn is None else columns_fn(nid=self.nid)

    def _rebuild(self, version: int, config_fp: str, namespaces) -> _EngineState:
        split: dict = {}
        t0 = time.perf_counter()
        cols = self._columns()
        if cols is not None:
            split["columns_s"] = time.perf_counter() - t0
            snap = build_snapshot_columnar(cols, namespaces, layout=self.layout,
                                           K=REWRITE_INSTR_CAP, version=version, split=split)
        else:
            snap = build_snapshot(self.manager.all_relation_tuples(nid=self.nid), namespaces,
                                  layout=self.layout, K=REWRITE_INSTR_CAP, version=version)
            split["snapshot_s"] = time.perf_counter() - t0
        del cols
        self._state = None  # release the old tables before uploading
        t1 = time.perf_counter()
        tables = snapshot_tables(snap, self.device)
        split["pack_upload_s"] = time.perf_counter() - t1
        self.last_build = split
        state = _EngineState(
            snapshot=snap,
            view=SnapshotView(snap),
            tables=tables,
            delta_np=empty_delta_tables(),
            base_version=version,
            covered_version=version,
            config_fp=config_fp,
        )
        self._count(snapshot_builds=1)
        return state

    def _delta_refresh(self, state: _EngineState, version: int) -> Optional[_EngineState]:
        """A new state with the writes since the base in its overlay, or a
        compacted one when they overflow it; None to rebuild in full."""
        ops = self.manager.changes_since(state.base_version, nid=self.nid)
        if ops is None:
            return None
        try:
            overlay = build_vocab_overlay(state.snapshot, ops)
            view = SnapshotView(state.snapshot, overlay)
            delta = build_delta_tables(view, ops)
        except DeltaOverflow:
            return self._incremental_compact(state, version, ops)
        # objslot_ns and ns_has_config are uploaded only when the overlay
        # grew them; within one base their growth only goes on
        grown = {k: getattr(overlay, k) for k in ("objslot_ns", "ns_has_config")
                 if getattr(overlay, k) is not getattr(state.snapshot, k)}
        tables = refresh_delta_tables(state.tables, delta, grown, self.device)
        new = _EngineState(
            snapshot=state.snapshot, view=view, tables=tables, delta_np=delta,
            base_version=state.base_version, covered_version=version,
            config_fp=state.config_fp, has_delta=True,
        )
        # the base's path tables ride along; only their dirty packs follow
        # the fresh overlay (one dirty_pack tensor serves every path)
        if state.expand_tables is not None:
            new.expand_np = state.expand_np
            new.expand_tables = {**state.expand_tables, "dirty_pack": tables["dirty_pack"]}
        if state.reverse_tables is not None:
            new.reverse_np = state.reverse_np
            new.reverse_tables = {**state.reverse_tables, "rd_pack": self._rd_pack(delta)}
        if state.subjects_tables is not None:
            new.subjects_tables = {**state.subjects_tables, "dirty_pack": tables["dirty_pack"]}
        if state.base_decoder is not None:
            new.base_decoder = state.base_decoder
            new.decoder = state.base_decoder.extended(overlay)
        return new

    def _rd_pack(self, delta: dict) -> torch.Tensor:
        packed = {"rd_pack": pack_pair_table(delta["rd_obj"], delta["rd_tag"], delta["rd_val"])}
        return tables_from_numpy(packed, self.device, ("rd_pack",))["rd_pack"]

    def _incremental_compact(self, state: _EngineState, version: int,
                             ops) -> Optional[_EngineState]:
        """The overlay overflowed: merge `ops` into a new base, touching
        only the slots and rows they affect (engine/compact.py), and patch
        the retained expand and reverse mirrors with the same ops; a
        mirror that cannot be patched is built again at its next use.
        None to rebuild in full."""
        merged, enc_u, ins_u = merge_ops_into_snapshot(state.snapshot, ops, version)
        if merged is None:
            return None
        delta = empty_delta_tables()
        new = _EngineState(
            snapshot=merged, view=SnapshotView(merged),
            tables=snapshot_tables(merged, self.device), delta_np=delta,
            base_version=version, covered_version=version, config_fp=state.config_fp,
        )
        expand_np = self._patched_expand_state(state, enc_u, ins_u)
        if expand_np is not None:
            new.expand_np = expand_np
            new.expand_tables = expand_tables_from_numpy(
                pack_expand_tables(expand_np, delta), self.device
            )
        reverse_np = self._patched_reverse_state(state, enc_u, ins_u)
        if reverse_np is not None:
            new.reverse_np = reverse_np
            new.reverse_tables = reverse_tables_from_numpy(
                pack_reverse_tables(reverse_np, merged, delta), self.device
            )
        if new.expand_np is not None or new.reverse_np is not None:
            new.base_decoder = new.decoder = ExpandDecoder(merged)
        # the ListSubjects tables are packed again from the patched full
        # CSR at their next use: a pack, not a build
        self._count(incremental_merges=1)
        return new

    @staticmethod
    def _patched_expand_state(state: _EngineState, enc_u, ins_u) -> Optional[dict]:
        """The retained full-edge CSR with the merged ops' rows rewritten,
        or None (no mirror retained, or garbage past its limit)."""
        src = state.expand_np
        if src is None:
            return None
        per_row = _per_row(enc_u, ins_u, lambda r: (r[0], r[1]), lambda r: (r[2], r[3], r[4]))
        (fh_obj, fh_rel, fh_row), fh_probes, f_row_ptr, payloads, garbage = patch_csr(
            (src["fh_obj"], src["fh_rel"], src["fh_row"]), src["fh_probes"], src["f_row_ptr"],
            (src["f_skind"], src["f_sa"], src["f_sb"]), per_row, state.snapshot.layout,
        )
        total_garbage = src["garbage"] + garbage
        if total_garbage > max(GARBAGE_FLOOR, GARBAGE_FRACTION * len(payloads[0])):
            return None
        return {
            "fh_obj": fh_obj, "fh_rel": fh_rel, "fh_row": fh_row, "fh_probes": fh_probes,
            "f_row_ptr": f_row_ptr, "f_skind": payloads[0], "f_sa": payloads[1],
            "f_sb": payloads[2], "garbage": total_garbage,
        }

    @staticmethod
    def _patched_reverse_state(state: _EngineState, enc_u, ins_u) -> Optional[dict]:
        """The retained transposed mirror patched with the merged ops: the
        reverse-edge rows (subject-set edges by subject slot) and the
        reverse-seed rows (every edge by its full subject key), by the
        same patch_csr; None (no mirror retained, or garbage past its
        limit) to build it again at its next use."""
        src = state.reverse_np
        if src is None:
            return None
        layout = state.snapshot.layout
        tags = reverse_subject_tag(enc_u[:, 2], enc_u[:, 4])
        rows = np.column_stack([enc_u, tags]).astype(np.int64)
        is_set = enc_u[:, 2] == 1
        per_rev = _per_row(rows[is_set], ins_u[is_set], lambda r: (r[3], 0),
                           lambda r: (r[0], r[1], r[4]))
        per_seed = _per_row(rows, ins_u, lambda r: (r[3], r[5]), lambda r: (r[0], r[1]))
        try:
            (rvh_obj, rvh_rel, rvh_row), rvh_probes, rv_row_ptr, (rv_pobj, rv_prel, rv_sb), \
                g_rev = patch_csr(
                    (src["rvh_obj"], src["rvh_rel"], src["rvh_row"]), src["rvh_probes"],
                    src["rv_row_ptr"], (src["rv_pobj"], src["rv_prel"], src["rv_sb"]),
                    per_rev, layout,
                )
            (rsh_obj, rsh_tag, rsh_row), rsh_probes, rs_row_ptr, (rs_obj, rs_rel), g_seed = \
                patch_csr(
                    (src["rsh_obj"], src["rsh_tag"], src["rsh_row"]), src["rsh_probes"],
                    src["rs_row_ptr"], (src["rs_obj"], src["rs_rel"]), per_seed, layout,
                )
        except MergeFallback:
            return None
        total_garbage = src["garbage"] + g_rev + g_seed
        if total_garbage > max(GARBAGE_FLOOR, GARBAGE_FRACTION * (len(rv_pobj) + len(rs_obj))):
            return None
        return {
            **src,
            "rvh_obj": rvh_obj, "rvh_rel": rvh_rel, "rvh_row": rvh_row,
            "rvh_probes": rvh_probes, "rv_row_ptr": rv_row_ptr,
            "rv_pobj": rv_pobj, "rv_prel": rv_prel, "rv_sb": rv_sb,
            "rsh_obj": rsh_obj, "rsh_tag": rsh_tag, "rsh_row": rsh_row,
            "rsh_probes": rsh_probes, "rs_row_ptr": rs_row_ptr,
            "rs_obj": rs_obj, "rs_rel": rs_rel,
            "garbage": total_garbage,
        }

    # -- push refresh ------------------------------------------------------------

    def notify_write(self) -> None:
        """Poked by the registry's commit listener on the Watch hub: wakes
        the refresh thread (started at the first call), which folds the
        writes into the mirror off the request path; a burst of writes
        coalesces into one refresh.
        ensure_state's own version check stays the backstop."""
        if self._refresh_stopped:
            return
        ev = self._refresh_event
        if ev is None:
            with self._refresh_mu:
                ev = self._refresh_event
                if ev is None:
                    ev = threading.Event()
                    thread = threading.Thread(target=self._push_refresh_loop, args=(ev,),
                                              name=f"keto-torch-push-refresh-{self.nid}",
                                              daemon=True)
                    self._refresh_event = ev
                    thread.start()
        ev.set()

    def stop_push_refresh(self) -> None:
        """End the refresh thread."""
        self._refresh_stopped = True
        ev = self._refresh_event
        if ev is not None:
            ev.set()

    def _push_refresh_loop(self, ev: threading.Event) -> None:
        while True:
            ev.wait()
            if self._refresh_stopped:
                return
            ev.clear()
            try:
                self.ensure_state()
                self._count(push_refreshes=1)
            except Exception:  # noqa: BLE001 - the refresh thread never dies;
                # the request path's ensure_state raises to its caller
                logging.getLogger("keto_tpu_torch").debug(
                    "push refresh of the mirror failed", exc_info=True
                )

    def ensure_expand_state(self) -> _EngineState:
        """The mirror with its full-edge CSR, built from the store at the
        mirror's covered version (retried if a write lands meanwhile)."""
        while True:
            state = self.ensure_state()
            with self._lock:
                if state.expand_tables is not None:
                    return state
                cols = self._columns()
                tuples = None if cols is not None else \
                    self.manager.all_relation_tuples(nid=self.nid)
                if self.manager.version(nid=self.nid) != state.covered_version:
                    continue
                csr = (build_full_csr_columnar(cols, state.snapshot) if cols is not None
                       else build_full_csr(tuples, state.snapshot, view=state.view))
                del cols, tuples
                state.expand_np = {**csr, "garbage": 0}
                self._ensure_decoder(state)
                # expand_tables is the readiness signal: set it last
                state.expand_tables = expand_tables_from_numpy(
                    pack_expand_tables(csr, state.delta_np), self.device
                )
                return state

    def ensure_reverse_state(self) -> _EngineState:
        """The mirror with its transposed twin (reverse-edge CSR,
        reverse-seed CSR, inverted programs), built from the store at the
        mirror's covered version (retried if a write lands meanwhile)."""
        while True:
            state = self.ensure_state()
            namespaces = self.config.namespace_manager().namespaces()
            with self._lock:
                if state.reverse_tables is not None:
                    return state
                cols = self._columns()
                tuples = None if cols is not None else \
                    self.manager.all_relation_tuples(nid=self.nid)
                if self.manager.version(nid=self.nid) != state.covered_version:
                    continue
                rnp = (build_reverse_state_columnar(cols, state.snapshot, namespaces)
                       if cols is not None
                       else build_reverse_state(tuples, state.snapshot, namespaces,
                                                view=state.view))
                del cols, tuples
                state.reverse_np = rnp
                self._ensure_decoder(state)
                # reverse_tables is the readiness signal: set it last
                state.reverse_tables = reverse_tables_from_numpy(
                    pack_reverse_tables(rnp, state.snapshot, state.delta_np), self.device
                )
                return state

    def ensure_subjects_state(self) -> _EngineState:
        """The mirror with the ListSubjects tables, packed from the expand
        state's host full-edge CSR (so built at the same covered version)."""
        state = self.ensure_expand_state()
        with self._lock:
            if state.subjects_tables is None:
                state.subjects_tables = subjects_tables_from_numpy(
                    pack_subjects_tables(state.expand_np, state.snapshot, state.delta_np),
                    self.device,
                )
        return state

    @staticmethod
    def _ensure_decoder(state: _EngineState) -> None:
        if state.base_decoder is None:
            state.base_decoder = ExpandDecoder(state.snapshot)
            state.decoder = state.base_decoder.extended(state.view.overlay)

    def tables_nbytes(self, path: str = "check") -> dict[str, int]:
        """Bytes of each device table of the current mirror on one path:
        "check", "expand", "reverse" (ListObjects), "subjects", or
        "closure" (the index's tables, empty before a build)."""
        if path == "closure":
            view, _cause = self.closure_index().view_for(self.ensure_state())
            tables = view.tables if view is not None else {}
            return {k: v.numel() * v.element_size() for k, v in tables.items()}
        ensure, attr = {
            "check": (self.ensure_state, "tables"),
            "expand": (self.ensure_expand_state, "expand_tables"),
            "reverse": (self.ensure_reverse_state, "reverse_tables"),
            "subjects": (self.ensure_subjects_state, "subjects_tables"),
        }[path]
        tables = getattr(ensure(), attr)
        return {k: v.numel() * v.element_size() for k, v in tables.items()}

    # -- Leopard closure index ---------------------------------------------------

    def closure_index(self) -> ClosureIndex:
        """The engine's closure index, empty until closure_ensure_built."""
        return self._closure

    def closure_ensure_built(self) -> bool:
        """Power the index for the current mirror unless it is built for
        its base, fold every write since into the dirty marks, then power
        the dirty nodes again (refresh_dirty, encoded through the mirror's
        overlay view). Returns readiness. The maintainer's per-pass entry
        point; never called on the submit path: powering there would
        stall a batch."""
        state = self.ensure_state()
        idx = self.closure_index()
        max_depth = self.config.max_read_depth()
        ready = idx.ensure_for(state, self.manager, max_depth)
        idx.refresh_dirty(self.manager, max_depth, view=state.view)
        return ready

    def _closure_gate(self, state):
        """(view, None) when the index serves this state, else (None,
        cause): the host-side cause every query of the batch counts under.
        A lagging index gets one inline catch-up (a change-log read and
        the ancestor marking) when its lag fits lag_budget_versions; past
        it the batch falls back and the maintainer catches up."""
        idx = self.closure_index()
        view, cause = idx.view_for(state)
        if cause == CAUSE_LAG and idx.lag_versions(state.covered_version) <= \
                idx.lag_budget_versions and idx.catch_up(self.manager, state.covered_version):
            view, cause = idx.view_for(state)
        return view, cause

    def _count_closure_fallback(self, cause: str, n: int) -> None:
        self._count(closure_fallback={cause: n})

    @staticmethod
    def _closure_launch(view, qpack: torch.Tensor) -> torch.Tensor:
        return closure_kernel_packed(view.tables, qpack, cc_probes=view.cc_probes,
                                     ch_probes=view.ch_probes, has_dirty=view.has_dirty,
                                     layout=view.layout)

    def _closure_read(self, outputs: torch.Tensor, B: int, n: int, counted=None):
        """(member, resolved) of the first n queries of one closure launch,
        after its one device->host readback. Each declined query of
        `counted` (default: all n) counts its cause as a closure fallback."""
        member, cause, _stats = unpack_closure_results(outputs.cpu().numpy(), B)
        member, cause = member[:n], cause[:n]
        resolved = cause == 0
        declined = ~resolved if counted is None else counted & ~resolved
        for code, count in zip(*np.unique(cause[declined], return_counts=True)):
            self._count_closure_fallback(CL_CAUSE_NAMES.get(int(code), "uncovered"), int(count))
        return member, resolved

    def _count(self, host_cause: Optional[dict] = None, closure_fallback: Optional[dict] = None,
               **counts: int) -> None:
        """Add to the counters in `stats` (and to its per-cause dicts), under
        one lock: the launch, resolve and request threads all count."""
        with self._stats_mu:
            for key, n in counts.items():
                self.stats[key] += n
            for name, per in (("host_cause", host_cause), ("closure_fallback", closure_fallback)):
                if per:
                    into = self.stats[name]
                    for cause, n in per.items():
                        into[cause] = into.get(cause, 0) + n

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

    def check_batch_submit(self, tuples: Sequence[RelationTuple], max_depth: int = 0,
                           allow_closure: bool = True):
        """Run the device launch for one batch; returns a handle whose
        result vector stays on the device until check_batch_resolve. With
        the closure enabled and serving this mirror, the launch is the
        closure probe; allow_closure=False is the resolve-time BFS ride of
        the queries it left unresolved."""
        n = len(tuples)
        if n == 0:
            return ("empty", None, None)
        # fault point (faults.py): a stall is a wedged launch, an error a
        # dying card, before any state build
        _faults.inject("device_launch")
        state = self.ensure_state()
        global_max = self.config.max_read_depth()
        depth = max_depth if 0 < max_depth <= global_max else global_max
        B = next((b for b in self._allowed_buckets if b >= n), None)
        if B is None:
            # oversized batch: split along the largest allowed bucket
            step = self._allowed_buckets[-1]
            return (
                "multi",
                [self.check_batch_submit(tuples[i : i + step], max_depth, allow_closure)
                 for i in range(0, n, step)],
                None,
            )
        q_obj, q_rel, q_skind, q_sa, q_sb, q_valid = encode_query_batch(
            state.view, tuples, B
        )
        q_depth = np.full(B, depth, dtype=np.int32)
        qpack = torch.from_numpy(
            pack_queries(q_obj, q_rel, q_depth, q_skind, q_sa, q_sb, q_valid)
        ).to(self.device)
        meta = {"state": state, "tuples": tuples, "n": n, "B": B, "max_depth": max_depth,
                "q_valid": q_valid}
        if allow_closure and self.closure_enabled:
            view, cause = self._closure_gate(state)
            if view is not None:
                return ("closure", self._closure_launch(view, qpack), meta)
            self._count_closure_fallback(cause, n)
        # each launch's frontier scales with its bucket (step cost is
        # O(frontier)): 4x headroom over the seed tasks, at least 64
        launch_cap = min(self.frontier_cap, max(4 * B, 64))
        # islands: K leaf ctxs per instance, room for two per query
        island_cap = 2 * B if state.snapshot.island_circuits else 0
        cfg = kernel_static_config(
            state.snapshot, global_max, launch_cap, n_island_cap=island_cap,
            has_delta=state.has_delta,
        )
        outputs = check_kernel_packed(state.tables, qpack, **cfg)
        meta["island_cap"] = cfg["n_island_cap"]
        return ("batch", outputs, meta)

    def check_batch_resolve(self, handle) -> list[CheckResult]:
        return self.check_batch_resolve_v(handle)[0]

    def check_batch_resolve_v(self, handle) -> tuple[list[CheckResult], list]:
        """(results, versions) of one submitted batch: versions[i] is the
        store version answer i is authoritative at, the evaluated state's
        covered_version for device answers and closure hits, None for a
        query replayed on the host oracle (it reads the live store). The
        check cache (api/check_cache.py) stores verdicts at these versions."""
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
        if kind == "closure":
            return self._resolve_closure(outputs, meta)
        return self._resolve(outputs, meta)

    def _resolve_closure(self, outputs, meta):
        """Answer the queries one closure launch resolved, at the mirror's
        covered version; the rest ride the BFS kernel once
        (allow_closure=False), with that sub-batch's versions, and merge
        back in request order."""
        tuples, n, B = meta["tuples"], meta["n"], meta["B"]
        member, resolved = self._closure_read(outputs, B, n)
        results = [RESULT_IS_MEMBER if m else RESULT_NOT_MEMBER for m in member.tolist()]
        versions: list = [meta["state"].covered_version] * n
        leftover = np.flatnonzero(~resolved).tolist()
        n_hits = n - len(leftover)
        self._count(closure_hits=n_hits, device_checks=n_hits)
        if leftover:
            sub = self.check_batch_submit([tuples[i] for i in leftover], meta["max_depth"],
                                          allow_closure=False)
            sub_res, sub_ver = self.check_batch_resolve_v(sub)
            for j, i in enumerate(leftover):
                results[i] = sub_res[j]
                versions[i] = sub_ver[j]
        return results, versions

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
        if _faults.get("batch_corrupt") is not None:
            # fault point (faults.py): every slot to the exact host replay,
            # the escape hatch of the capacity overflows
            _faults.inject("batch_corrupt")
            needs_host = np.maximum(needs_host, 1)
        if n_isl:
            member = combine_islands(
                ctx_hit, isl_parent, isl_pid, n_isl, snap.island_circuits, B, snap.K
            )
        else:
            member = ctx_hit[:B]

        covered = state.covered_version
        if bool(q_valid[:n].all()) and not bool((needs_host[:n] > 0).any()):
            # every query answered on the device: the steady serving state
            self._count(device_checks=n)
            return ([RESULT_IS_MEMBER if m else RESULT_NOT_MEMBER for m in member[:n].tolist()],
                    [covered] * n)

        results: list[CheckResult] = []
        versions: list = []
        n_host = 0
        host_causes: dict[str, int] = {}
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
        self._count(host_cause=host_causes, device_checks=n - n_host, host_checks=n_host)
        return results, versions

    # -- expand API -------------------------------------------------------------

    def expand(self, subject: Subject, max_depth: int = 0) -> Optional[Tree]:
        return self.expand_batch([subject], max_depth)[0]

    def expand_batch(
        self,
        subjects: Sequence[Subject],
        max_depth: int = 0,
        frontier_cap: int = 1024,
        edge_cap: int = 4096,
        pool_cap: int = 0,
    ) -> list[Optional[Tree]]:
        """Batched Expand: one device BFS gather and exact host assembly.
        `pool_cap` defaults to 32 edge records per bucketed query (at
        least 4096); a query whose edges do not fit the frontier, its
        buffer or the pool is expanded by the host oracle."""
        n = len(subjects)
        if n == 0:
            return []
        B = next((b for b in _BUCKETS if b >= n), None)
        if B is None:
            step = _BUCKETS[-1]
            out: list[Optional[Tree]] = []
            for i in range(0, n, step):
                out.extend(self.expand_batch(
                    subjects[i : i + step], max_depth, frontier_cap, edge_cap, pool_cap
                ))
            return out
        state = self.ensure_expand_state()
        global_max = self.config.max_read_depth()
        depth = max_depth if 0 < max_depth <= global_max else global_max
        q_obj, q_rel, q_valid = encode_node_batch(state.view, [
            (sub.namespace, sub.object, sub.relation) if isinstance(sub, SubjectSet)
            else None for sub in subjects], B)
        pool_cap = pool_cap or max(32 * B, 4096)
        qpack = torch.from_numpy(pack_expand_queries(q_obj, q_rel, depth, q_valid))
        flat = expand_kernel_packed(
            state.expand_tables, qpack.to(self.device), fh_probes=state.expand_np["fh_probes"],
            # the step budget follows the global depth cap, not the call's
            max_steps=global_max + 2, frontier_cap=max(frontier_cap, B),
            edge_cap=edge_cap, pool_cap=pool_cap, layout=state.snapshot.layout,
        )
        # the batch's one device->host readback
        offs, root, needs_host, pool_cols, _stats = unpack_expand_results(
            flat.cpu().numpy(), B, pool_cap
        )
        results: list[Optional[Tree]] = []
        n_host = 0
        for i, sub in enumerate(subjects):
            if not q_valid[i] or needs_host[i]:
                n_host += 1
                results.append(self.reference.expand(sub, max_depth, self.nid))
                continue
            adjacency = decode_edge_buffer(
                *pool_cols, int(offs[i + 1] - offs[i]), int(offs[i])
            )
            results.append(assemble_tree(
                sub, int(q_obj[i]), int(q_rel[i]), depth, adjacency, bool(root[i]),
                state.decoder,
            ))
        self._count(device_expands=n - n_host, host_expands=n_host)
        return results

    # -- ListObjects / ListSubjects ---------------------------------------------

    def list_objects_batch(
        self,
        queries: Sequence[tuple],
        max_depth: int = 0,
        frontier_cap: int = 4096,
        result_cap: int = 2048,
        pool_cap: int = 0,
    ) -> list[list[str]]:
        """Batched ListObjects: queries are (namespace, relation, subject)
        triples; each answer is the sorted list of objects of the
        namespace whose check for the subject is a member, as the host
        oracle's list_objects defines it. One reverse-BFS launch per
        bucketed batch; `pool_cap` defaults to 8 results per bucketed
        query (at least 4096)."""
        n = len(queries)
        if n == 0:
            return []
        state = self.ensure_reverse_state()
        rnp = state.reverse_np
        if rnp["host_all"]:
            # a NOT in the config: its members exist where no path exists,
            # which a reachability walk cannot see
            self._count_reverse("list_objects", 0, n, {"island_host": n})
            return [self.reference.list_objects(ns, rel, sub, max_depth, self.nid)
                    for ns, rel, sub in queries]
        B = next((b for b in _BUCKETS if b >= n), None)
        if B is None:
            step = _BUCKETS[-1]
            return [r for i in range(0, n, step) for r in self.list_objects_batch(
                queries[i : i + step], max_depth, frontier_cap, result_cap, pool_cap)]
        global_max = self.config.max_read_depth()
        depth = max_depth if 0 < max_depth <= global_max else global_max
        qpack, unknown = pack_list_objects_queries(state.view, queries, B, depth)
        snap = state.snapshot
        flat = list_objects_kernel_packed(
            state.reverse_tables, torch.from_numpy(qpack).to(self.device),
            rvh_probes=rnp["rvh_probes"], rsh_probes=rnp["rsh_probes"],
            max_steps=int(global_max + snap.n_config_rels + 4), wildcard_rel=snap.wildcard_rel,
            n_config_rels=max(snap.n_config_rels, 1), frontier_cap=max(frontier_cap, B),
            result_cap=result_cap, pool_cap=pool_cap or max(8 * B, 4096),
            has_delta=state.has_delta, layout=snap.layout,
        )
        # the batch's one device->host readback
        offs, needs, pool, _stats = unpack_list_results(flat.cpu().numpy(), B)
        slot_to_obj = state.decoder.slot_to_obj
        return self._resolve_reverse(
            "list_objects", queries, unknown, needs,
            lambda i: sorted(slot_to_obj[s][1]
                             for s in decode_pool_slice(pool, int(offs[i]), int(offs[i + 1]))),
            lambda qr: self.reference.list_objects(qr[0], qr[1], qr[2], max_depth, self.nid),
        )

    def list_subjects_batch(
        self,
        queries: Sequence[tuple],
        max_depth: int = 0,
        frontier_cap: int = 4096,
        result_cap: int = 2048,
        pool_cap: int = 0,
    ) -> list[list[str]]:
        """Batched ListSubjects: queries are (namespace, object, relation)
        triples; each answer is the sorted list of plain subject ids whose
        check is a member (the oracle's list_subjects). One forward-BFS
        launch per bucketed batch over the full-edge CSR and the rewrite
        instructions; the same host replay as list_objects_batch."""
        n = len(queries)
        if n == 0:
            return []
        B = next((b for b in _BUCKETS if b >= n), None)
        if B is None:
            step = _BUCKETS[-1]
            return [r for i in range(0, n, step) for r in self.list_subjects_batch(
                queries[i : i + step], max_depth, frontier_cap, result_cap, pool_cap)]
        state = self.ensure_subjects_state()
        global_max = self.config.max_read_depth()
        depth = max_depth if 0 < max_depth <= global_max else global_max
        qpack, unknown = pack_list_subjects_queries(state.view, queries, B, depth)
        snap = state.snapshot
        flat = list_subjects_kernel_packed(
            state.subjects_tables, torch.from_numpy(qpack).to(self.device),
            fsh_probes=state.expand_np["fh_probes"], max_steps=int(global_max + snap.n_config_rels + 4),
            wildcard_rel=snap.wildcard_rel, n_config_rels=max(snap.n_config_rels, 1),
            frontier_cap=max(frontier_cap, B), result_cap=result_cap,
            pool_cap=pool_cap or max(8 * B, 4096), has_delta=state.has_delta,
            layout=snap.layout,
        )
        # the batch's one device->host readback
        offs, needs, pool, _stats = unpack_list_results(flat.cpu().numpy(), B)
        name = state.decoder.subject_name
        return self._resolve_reverse(
            "list_subjects", queries, unknown, needs,
            lambda i: sorted(name(s)
                             for s in decode_pool_slice(pool, int(offs[i]), int(offs[i + 1]))),
            lambda qr: self.reference.list_subjects(qr[0], qr[1], qr[2], max_depth, self.nid),
        )

    def _count_reverse(self, leg: str, n_device: int, n_host: int, causes: dict) -> None:
        self._count(host_cause=causes, **{f"device_{leg}": n_device, f"host_{leg}": n_host})

    def _resolve_reverse(self, leg, queries, unknown, needs, decode_fn, host_fn):
        """Both list legs' answers: [] for names the mirror does not know,
        the host oracle for flagged queries, the decoded pool otherwise."""
        results: list[list[str]] = []
        n_host = 0
        causes: dict[str, int] = {}
        for i, qr in enumerate(queries):
            if i in unknown:
                results.append([])
            elif needs[i]:
                n_host += 1
                cause = CAUSE_NAMES.get(int(needs[i]), CAUSE_NAME_UNINDEXED)
                causes[cause] = causes.get(cause, 0) + 1
                results.append(host_fn(qr))
            else:
                results.append(decode_fn(i))
        self._count_reverse(leg, len(queries) - n_host, n_host, causes)
        return results

    def list_objects(self, namespace: str, relation: str, subject, max_depth: int = 0,
                     page_size: int = 100, page_token: str = "") -> tuple[list[str], str]:
        """One ListObjects query, paginated: (object names, next page
        token). Tokens are offsets into the sorted enumeration."""
        objs = self.list_objects_batch([(namespace, relation, subject)], max_depth)[0]
        return paginate_names(objs, page_size, page_token)

    def list_subjects(self, namespace: str, obj: str, relation: str, max_depth: int = 0,
                      page_size: int = 100, page_token: str = "") -> tuple[list[str], str]:
        """One ListSubjects query, paginated: (subject ids, next page token)."""
        subs = self.list_subjects_batch([(namespace, obj, relation)], max_depth)[0]
        return paginate_names(subs, page_size, page_token)

    # -- BatchFilter ----------------------------------------------------------------

    def filter_batch(
        self,
        namespace: str,
        relation: str,
        subject,
        objects: Sequence[str],
        max_depth: int = 0,
        frontier_cap: int = 4096,
        chunk_size: int = 0,
        deadline=None,
    ) -> list[bool]:
        """verdicts[i]: Check(namespace:objects[i]#relation@subject) is a
        member, for a column of candidates sharing one subject. Evaluated
        in chunks of `chunk_size` (0 reads filter.chunk_size, at most the
        largest bucket), each through the vocab, closure, frontier and
        host tiers. `deadline` (resilience.Deadline | None) is checked
        before every chunk: past it the call fails with the typed 504."""
        n = len(objects)
        if n == 0:
            return []
        self._count(filter_requests=1)
        chunk = int(chunk_size or self.config.get("filter.chunk_size", DEFAULT_FILTER_CHUNK_SIZE))
        chunk = max(1, min(chunk, _BUCKETS[-1]))
        out: list[bool] = []
        for i in range(0, n, chunk):
            if deadline is not None and deadline.expired():
                raise DeadlineExceededError(
                    f"filter deadline expired mid-evaluation ({i}/{n} candidates answered)")
            out.extend(self._filter_chunk(namespace, relation, subject,
                                          list(objects[i : i + chunk]), max_depth, frontier_cap))
        return out

    def filter_objects(self, namespace: str, relation: str, subject, objects: Sequence[str],
                       max_depth: int = 0, deadline=None) -> list[str]:
        """The candidates the subject can see, in request order, each
        occurrence of a duplicate answered on its own."""
        verdicts = self.filter_batch(namespace, relation, subject, objects, max_depth,
                                     deadline=deadline)
        return [o for o, ok in zip(objects, verdicts) if ok]

    def _count_filter(self, n_closure: int, n_frontier: int, n_host: int, causes: dict) -> None:
        self._count(host_cause=causes, filter_closure=n_closure, filter_frontier=n_frontier,
                    filter_host=n_host)

    def _filter_chunk(self, namespace, relation, subject, objects, max_depth,
                      frontier_cap) -> list[bool]:
        """One chunk through the tiers in order, each taking what the ones
        before it left unresolved."""
        n = len(objects)
        state = self.ensure_state()
        snap = state.snapshot
        global_max = self.config.max_read_depth()
        depth = max_depth if 0 < max_depth <= global_max else global_max

        # under a monotone config (no island, no host-only program) a
        # member needs an edge path, so a name the mirror does not know is
        # a definitive non-member; otherwise a NOT could make it one
        monotone = not bool(np.any(snap.prog_flags & (FLAG_HOST_ONLY | FLAG_ISLAND)))
        ns_id, rel_id = state.view.ns_id(namespace), state.view.rel_id(relation)
        proxy = RelationTuple(namespace=namespace, object="", relation=relation)
        if isinstance(subject, SubjectSet):
            proxy.subject_set = subject
        else:
            proxy.subject_id = subject
        sub = state.view.encode_subject(proxy)
        if ns_id is not None and rel_id is not None and sub is None and monotone:
            # no edge mentions the subject
            self._count(filter_vocab=n)
            return [False] * n
        if ns_id is None or rel_id is None or sub is None:
            verdicts = self.reference.filter_objects(namespace, relation, subject, objects,
                                                     max_depth, self.nid)
            self._count_filter(0, 0, n, {CAUSE_NAME_UNINDEXED: n})
            return verdicts
        skind, sa, sb = (int(x) for x in sub)
        c_obj, c_valid = encode_object_column(state.view, int(ns_id), objects)

        resolved = np.zeros(n, dtype=bool)
        value = np.zeros(n, dtype=bool)
        causes: dict[str, int] = {}
        n_closure = n_frontier = 0
        if monotone and not c_valid.all():
            resolved |= ~c_valid  # unknown candidates: value stays False
            self._count(filter_vocab=int((~c_valid).sum()))

        # 1. the closure tier: one launch over the candidate column
        if self.closure_enabled:
            view, cl_cause = self._closure_gate(state)
            if view is not None:
                B = next(b for b in _BUCKETS if b >= n)
                q_obj = np.zeros(B, dtype=np.int32)
                q_obj[:n] = c_obj
                q_valid = np.zeros(B, dtype=bool)
                q_valid[:n] = c_valid

                def col(v):
                    return np.full(B, v, dtype=np.int32)

                qpack = pack_queries(q_obj, col(rel_id), col(depth), col(skind), col(sa),
                                     col(sb), q_valid)
                outputs = self._closure_launch(view, torch.from_numpy(qpack).to(self.device))
                # unknown candidates are the vocab tier's, not fallbacks
                member, ok = self._closure_read(outputs, B, n, counted=c_valid)
                ok &= c_valid
                value |= member & ok
                resolved |= ok
                n_closure = int(ok.sum())
            else:
                self._count_closure_fallback(cl_cause, n)

        # 2. the frontier tier: one shared walk over the leftover column
        vp = np.flatnonzero(c_valid & ~resolved)
        if len(vp):
            rstate = self.ensure_reverse_state()
            rnp = rstate.reverse_np
            if rstate.snapshot is not snap:
                # a write compacted or rebuilt the mirror since the encode:
                # the slots no longer address these tables
                causes[CAUSE_NAME_UNINDEXED] = causes.get(CAUSE_NAME_UNINDEXED, 0) + len(vp)
            elif rnp["host_all"]:
                # a NOT in the config: its members exist where no path
                # exists, which a reachability walk cannot see
                causes["island_host"] = causes.get("island_host", 0) + len(vp)
            else:
                uniq = np.unique(c_obj[vp])
                C = next((b for b in _BUCKETS if b >= len(uniq)), _BUCKETS[-1])
                qc = pack_filter_query(sa, int(reverse_subject_tag(skind, sb)), rel_id, depth,
                                       uniq, C)
                flat = filter_kernel_packed(
                    rstate.reverse_tables, torch.from_numpy(qc).to(self.device),
                    rvh_probes=rnp["rvh_probes"], rsh_probes=rnp["rsh_probes"],
                    max_steps=int(global_max + snap.n_config_rels + 4),
                    wildcard_rel=snap.wildcard_rel, n_config_rels=max(snap.n_config_rels, 1),
                    frontier_cap=max(frontier_cap, 1024), has_delta=rstate.has_delta,
                    layout=snap.layout,
                )
                # the walk's one result readback
                hit, wcause, _stats = unpack_filter_results(flat.cpu().numpy(), C)
                if wcause == 0:
                    # a clean, complete walk: unmarked candidates are
                    # definitive non-members
                    value[vp] = hit[np.searchsorted(uniq, c_obj[vp])]
                    resolved[vp] = True
                    n_frontier = len(vp)
                else:
                    name = CAUSE_NAMES.get(wcause, CAUSE_NAME_UNINDEXED)
                    causes[name] = causes.get(name, 0) + len(vp)

        # 3. the host tier: exact replay of everything still unresolved
        host_idx = np.flatnonzero(~resolved)
        if len(host_idx):
            unindexed = len(host_idx) - sum(causes.values())
            if unindexed > 0:
                causes[CAUSE_NAME_UNINDEXED] = causes.get(CAUSE_NAME_UNINDEXED, 0) + unindexed
            value[host_idx] = self.reference.filter_objects(
                namespace, relation, subject, [objects[i] for i in host_idx.tolist()],
                max_depth, self.nid,
            )
        self._count_filter(n_closure, n_frontier, len(host_idx), causes)
        return value.tolist()

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

The mirror is rebuilt in full when the store version or the namespace
config changes; incremental overlay refresh is not part of this engine.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_FILTER_CHUNK_SIZE, Config
from ..ketoapi import RelationTuple, Subject, SubjectSet, Tree
from ..storage.definitions import DEFAULT_NETWORK
from .definitions import (
    RESULT_IS_MEMBER,
    RESULT_NOT_MEMBER,
    CheckResult,
    Membership,
    paginate_names,
)
from .closure import DEFAULT_MAX_SET_ROWS, ClosureIndex
from .closure_kernel import CL_CAUSE_NAMES, closure_kernel_packed, unpack_closure_results
from .delta import SnapshotView
from .expand_kernel import (
    ExpandDecoder,
    assemble_tree,
    build_full_csr,
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
    pack_queries,
    snapshot_tables,
    unpack_results,
)
from .reference import ReferenceEngine
from .reverse_kernel import (
    build_reverse_state,
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
    check_layout,
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
    snapshot: GraphSnapshot
    view: SnapshotView
    tables: dict
    covered_version: int
    config_fp: str
    # full-edge CSR of the expand path (host arrays and device tables),
    # built at the first expand or ListSubjects
    expand_np: Optional[dict] = None
    expand_tables: Optional[dict] = None
    decoder: Optional[ExpandDecoder] = None
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
        self.stats = {
            "device_checks": 0,
            "host_checks": 0,
            "snapshot_builds": 0,
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
        # an attribute, not re-read per batch, so that a caller can toggle
        # it between calls
        self.closure_enabled = config.closure_enabled()
        # exists whether or not closure_enabled routes checks through it
        self._closure = ClosureIndex(
            self.nid, self.device,
            max_set_rows=int(config.get("closure.max_set_rows", DEFAULT_MAX_SET_ROWS)),
            powering=str(config.get("closure.powering", "host")),
        )

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

    def ensure_expand_state(self) -> _EngineState:
        """The mirror with its full-edge CSR, built from the store at the
        mirror's covered version (retried if a write lands meanwhile)."""
        while True:
            state = self.ensure_state()
            with self._lock:
                if state.expand_tables is not None:
                    return state
                tuples = self.manager.all_relation_tuples(nid=self.nid)
                if self.manager.version(nid=self.nid) != state.covered_version:
                    continue
                csr = build_full_csr(tuples, state.snapshot, view=state.view)
                state.expand_np = csr
                state.decoder = state.decoder or ExpandDecoder(state.snapshot)
                # expand_tables is the readiness signal: set it last
                state.expand_tables = expand_tables_from_numpy(
                    pack_expand_tables(csr), self.device
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
                tuples = self.manager.all_relation_tuples(nid=self.nid)
                if self.manager.version(nid=self.nid) != state.covered_version:
                    continue
                rnp = build_reverse_state(tuples, state.snapshot, namespaces, view=state.view)
                state.reverse_np = rnp
                state.decoder = state.decoder or ExpandDecoder(state.snapshot)
                # reverse_tables is the readiness signal: set it last
                state.reverse_tables = reverse_tables_from_numpy(
                    pack_reverse_tables(rnp, state.snapshot), self.device
                )
                return state

    def ensure_subjects_state(self) -> _EngineState:
        """The mirror with the ListSubjects tables, packed from the expand
        state's host full-edge CSR (so built at the same covered version)."""
        state = self.ensure_expand_state()
        with self._lock:
            if state.subjects_tables is None:
                state.subjects_tables = subjects_tables_from_numpy(
                    pack_subjects_tables(state.expand_np, state.snapshot), self.device
                )
        return state

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
        it; returns readiness. Never called on the submit path: powering
        there would stall a batch."""
        state = self.ensure_state()
        return self.closure_index().ensure_for(state, self.config.max_read_depth())

    def _closure_gate(self, state):
        """(view, None) when the index serves this state, else (None,
        cause): the host-side cause every query of the batch counts under."""
        return self.closure_index().view_for(state)

    def _count_closure_fallback(self, cause: str, n: int) -> None:
        per = self.stats["closure_fallback"]
        per[cause] = per.get(cause, 0) + n

    @staticmethod
    def _closure_launch(view, qpack: torch.Tensor) -> torch.Tensor:
        # the port has no overlay, so no node is dirty: cd is never probed
        return closure_kernel_packed(view.tables, qpack, cc_probes=view.cc_probes,
                                     ch_probes=view.ch_probes, has_dirty=False,
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
            has_delta=False,
        )
        outputs = check_kernel_packed(state.tables, qpack, **cfg)
        meta["island_cap"] = cfg["n_island_cap"]
        return ("batch", outputs, meta)

    def check_batch_resolve(self, handle) -> list[CheckResult]:
        kind, outputs, meta = handle
        if kind == "empty":
            return []
        if kind == "multi":
            results: list[CheckResult] = []
            for h in outputs:
                results.extend(self.check_batch_resolve(h))
            return results
        if kind == "closure":
            return self._resolve_closure(outputs, meta)
        return self._resolve(outputs, meta)

    def _resolve_closure(self, outputs, meta):
        """Answer the queries one closure launch resolved, at the mirror's
        covered version; the rest ride the BFS kernel once
        (allow_closure=False) and merge back in request order."""
        tuples, n, B = meta["tuples"], meta["n"], meta["B"]
        member, resolved = self._closure_read(outputs, B, n)
        results = [RESULT_IS_MEMBER if m else RESULT_NOT_MEMBER for m in member.tolist()]
        leftover = np.flatnonzero(~resolved).tolist()
        n_hits = n - len(leftover)
        self.stats["closure_hits"] += n_hits
        self.stats["device_checks"] += n_hits
        if leftover:
            sub = self.check_batch_submit([tuples[i] for i in leftover], meta["max_depth"],
                                          allow_closure=False)
            for i, res in zip(leftover, self.check_batch_resolve(sub)):
                results[i] = res
        return results

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

        if bool(q_valid[:n].all()) and not bool((needs_host[:n] > 0).any()):
            # every query answered on the device: the steady serving state
            self.stats["device_checks"] += n
            return [RESULT_IS_MEMBER if m else RESULT_NOT_MEMBER for m in member[:n].tolist()]

        results: list[CheckResult] = []
        n_host = 0
        host_causes = self.stats["host_cause"]
        # identical replayed queries within one batch evaluate once
        replay_memo: dict[tuple, CheckResult] = {}
        for i, t in enumerate(tuples):
            if q_valid[i] and not needs_host[i]:
                results.append(RESULT_IS_MEMBER if member[i] else RESULT_NOT_MEMBER)
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
        self.stats["device_checks"] += n - n_host
        self.stats["host_checks"] += n_host
        return results

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
        q_obj = np.zeros(B, dtype=np.int32)
        q_rel = np.zeros(B, dtype=np.int32)
        q_valid = np.zeros(B, dtype=bool)
        for i, sub in enumerate(subjects):
            if isinstance(sub, SubjectSet):
                node = state.view.encode_node(sub.namespace, sub.object, sub.relation)
                if node is not None:
                    q_obj[i], q_rel[i] = node
                    q_valid[i] = True
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
        self.stats["device_expands"] += n - n_host
        self.stats["host_expands"] += n_host
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
            result_cap=result_cap, pool_cap=pool_cap or max(8 * B, 4096), has_delta=False,
            layout=snap.layout,
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
            pool_cap=pool_cap or max(8 * B, 4096), has_delta=False, layout=snap.layout,
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
        self.stats[f"device_{leg}"] += n_device
        self.stats[f"host_{leg}"] += n_host
        host_causes = self.stats["host_cause"]
        for cause, count in causes.items():
            host_causes[cause] = host_causes.get(cause, 0) + count

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
    ) -> list[bool]:
        """verdicts[i]: Check(namespace:objects[i]#relation@subject) is a
        member, for a column of candidates sharing one subject. Evaluated
        in chunks of `chunk_size` (0 reads filter.chunk_size, at most the
        largest bucket), each through the vocab, closure, frontier and
        host tiers."""
        n = len(objects)
        if n == 0:
            return []
        self.stats["filter_requests"] += 1
        chunk = int(chunk_size or self.config.get("filter.chunk_size", DEFAULT_FILTER_CHUNK_SIZE))
        chunk = max(1, min(chunk, _BUCKETS[-1]))
        out: list[bool] = []
        for i in range(0, n, chunk):
            out.extend(self._filter_chunk(namespace, relation, subject,
                                          list(objects[i : i + chunk]), max_depth, frontier_cap))
        return out

    def filter_objects(self, namespace: str, relation: str, subject, objects: Sequence[str],
                       max_depth: int = 0) -> list[str]:
        """The candidates the subject can see, in request order, each
        occurrence of a duplicate answered on its own."""
        verdicts = self.filter_batch(namespace, relation, subject, objects, max_depth)
        return [o for o, ok in zip(objects, verdicts) if ok]

    def _count_filter(self, n_closure: int, n_frontier: int, n_host: int, causes: dict) -> None:
        self.stats["filter_closure"] += n_closure
        self.stats["filter_frontier"] += n_frontier
        self.stats["filter_host"] += n_host
        host_causes = self.stats["host_cause"]
        for cause, count in causes.items():
            host_causes[cause] = host_causes.get(cause, 0) + count

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
            self.stats["filter_vocab"] += n
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
            self.stats["filter_vocab"] += int((~c_valid).sum())

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
                # a write rebuilt the mirror since the encode: the slots no
                # longer address these tables
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
                    frontier_cap=max(frontier_cap, 1024), has_delta=False, layout=snap.layout,
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

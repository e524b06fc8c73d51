"""Smoke run of keto_tpu_torch on one NVIDIA card: the quickest proof that
the port builds, agrees with itself and runs its main path on the GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

  1. card    — nvidia-smi's name and power limit
  2. build   — nvcc builds csrc/check_kernels.cu, csrc/expand_kernels.cu,
               csrc/list_kernels.cu, csrc/closure_filter_kernels.cu,
               csrc/closure_power_kernels.cu and csrc/microbench_kernels.cu
               from the checkout, one compiler per source, in parallel
  3. kernels — K1-K4 against their plain PyTorch versions on the card,
               on inputs captured from one real batch of phase 4's
               workload over its tables; exact equality, times, bounds;
               K2 at Check's step-2 launch, with its live share and
               distinct keys (the pair_probe row's shape; phases 7b, 8b
               and 10c add its other paths' launches under "at")
  4. check   — the main path: ~1e6 tuples (the benchmark's videos
               namespace, view = owner | parent->view, 6,600 folders x
               120 files) into the store, TorchCheckEngine(device="cuda"),
               batches of 4096 checks; zero host replays, every kernel's
               launch count advanced, 512 sampled verdicts equal the host
               oracle's; checks/s and p50 batch ms
  5. islands — an AND/NOT namespace batch against the host oracle
  6. serve   — `python -m keto_tpu_torch serve` on a free port: a 200, a
               403, a batch check, an expand tree, an expand 404, a
               list-objects and a list-subjects 200 and a list-objects 400,
               a check with a snaptoken ahead of the store (409) and a
               list-objects with a satisfied one
  7. expand  — (7a) data, (7b) X1 and X2 against their plain versions
               on inputs captured from one real expand batch, as phase 3,
               and X1 again on the same batch at a frontier cap of 32,768
               (the expand_emit row's "large" entry), and K2 at the
               batch's step-1 launch;
               then the Expand path: ~1e6 tuples of bench.py's RBAC shape (role
               member sets nesting earlier roles, docs with owner <
               editor < viewer rewrites; 13,000 roles x 410,000 docs),
               TorchCheckEngine.expand_batch over batches of 1024 role
               member sets; zero host expands, X1, X2, K2 and K4 launched,
               256 sampled trees equal the host oracle's; trees/s and p50
               batch ms
  8. list    — on phase 4's store and engine: (8a) the reverse and subjects
               states' build seconds and table bytes; (8b) L1-L4 against
               their plain versions on inputs captured from one real batch
               of each leg, as phase 3, and K4 on ListObjects' step-1
               launch at G = F = 2^20 (the dedupe_compact row's "large"
               entry), K2 at each of ListObjects' step launches and at
               ListSubjects' step-2 launch, and L4 at ListSubjects' launch
               (the list_pool_compact row's "at" entry); (8c) ListObjects,
               bench.py's batch of 256 users' `view` at depth 5 with caps
               scaled to the data: zero host replays, L1, L2, L4, K2 and
               K4 launched, 32 sampled answers equal to the generator's
               ownership maps, 4 of them held object by object against the
               host oracle's check; (8d) ListSubjects of 256 random files'
               `view`, the bench's caps: zero host replays, L1, L3, L4, K2
               and K4 launched, 64 sampled answers equal to the host
               oracle's list_subjects; lists/s, p50 batch ms, mean results
               per query and the launch + readback against host decode
               split
  9. closure — (9a) bench.py:1162's deep-1e6 topology (22,857 chains of
               20 parent hops, a tail owner each, 520,003 direct viewer
               grants; max read depth 24) into a second store, and the
               closure index built over it, powered on the card
               (closure.powering = "device"; the build's launches are the
               "closure_build" path: P1-P3 launched, nothing else): extract,
               power (host prep and waves), pack and upload seconds, covered
               nodes and entries (held to keto_tpu's 959,994 and 6,310,111)
               and table bytes; (9p) the host builder on the same graph,
               timed, equal to the device build array for array; a device
               build at max_set_rows 4 held to keto_tpu's 543,981 and
               645,912; (9q) P1-P3 against their plain versions on inputs
               captured from the widest wave of that build, as phase 3, and
               scatter_reduce's segment max as P1's yardstick; (9b) one closure
               batch captured for C1; (9) batches of 4096 chain-head checks
               with the closure on (one C1 launch, every query a hit) and
               off (the BFS) in alternating rounds, equal verdicts, 512
               sampled equal to the oracle; then one write: every check
               falls back (stale_snapshot), still correct, until the index
               is powered on the card again and the hits resume
 10. filter  — (10a) the frontier tier on phase 4's engine: 10,000
               candidates (bench.py:547's draws) for the owner of /d0, one
               shared walk; (10b) the closure tier on phase 9's engine:
               10,000 chain heads for a chain owner, one C1 launch; each
               with zero host replays, 200 sampled verdicts equal to the
               oracle and all equal to check_batch over the same pairs,
               objects/s; (10c) C1 and F1 against their plain versions,
               C1 also at the closure-tier filter's launch (the
               closure_probe row's "at" entry), each C1 launch with its
               valid and covered shares and the ch bytes it reads for
               queries its verdict leaves unresolved; torch.searchsorted
               on F1's inputs as its yardstick; K2 at the frontier walk's
               step-1 launch
 11. microbench — the TPU microbenchmarks' primitives (B8, B9): (11a)
               `python -m keto_tpu_torch.tools.microbench` and
               `... .tools.microbench_feasibility` as subprocesses, every
               line checked; (11b) both entry points again in process, the
               "microbench" launch path: M1-M10 launched; (11c) M1-M10
               against their plain versions on the tools' draws (the hash
               probe with planted keys, so both probe arms hit), exact,
               timed with bounds and PyTorch yardsticks; M3, M5 and M6
               also at F = 2^20 (the row's "large" entry), where M3's
               bin and own passes are logged as its parts

Before the last line it prints the kernel table as one JSON object
({"kernels": [...]}); the last line is {"ok": true, "device": {...}}.
A kernel's bound is the larger of its bytes over the H100 SXM's
3.35 TB/s and its 32-bit integer operations over the card's INT32 rate.
A kernel's "ms" is device time per call from the profiler; "wall_ms" is
the wrapper's time per call between CUDA events, host enqueue included.
"""

from __future__ import annotations

import gc
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# the kernels' hash/compare/select ops are 32-bit integer ops: 132 SMs x
# 64 INT32 lanes per SM (Hopper whitepaper) x the 1.98 GHz boost clock
OPS_INT32_PER_S = 132 * 64 * 1.98e9
HASH_OPS = 9  # one fmix32 round: 3 shifts, 3 xors, 2 multiplies, 1 combine xor
N_FOLDERS = 6600
FILES_PER_FOLDER = 120
N_USERS = 512
BATCH = 4096
MAX_DEPTH = 5
ROUNDS = 20
# expand phase: bench.py:374's RBAC shape, scaled from 64 roles x 2,000
# docs to ~1e6 tuples; its batch and cap formulas (bench.py:437, :448)
N_ROLES = 13000
N_DOCS = 410000
EXPAND_BATCH = 1024
EXPAND_DEPTH = 6
EXPAND_CAPS = dict(frontier_cap=max(1024, 4 * EXPAND_BATCH),
                   edge_cap=max(4096, 16 * EXPAND_BATCH))
# X1's "large" entry: a frontier whose 4 (2F + B) bytes the first X1, one
# block, could not hold in shared memory
EXPAND_LARGE_FRONTIER = 32768
# list phase: bench.py:473 bench_reverse's batch (bench.py:82) and depth.
# Its ListObjects caps (frontier 16384, results 2048, pool 64 B) were set
# for 64 folders; over 6,600 folders a user reaches ~1,950 objects (3,031
# at most in this batch, from the generator's draws) and one step expands
# ~805k slots, so the caps scale with the data. ListSubjects keeps the
# bench's own caps (1-2 subjects per file).
LIST_BATCH = 256
LIST_DEPTH = 5
LIST_ROUNDS = 10
LO_CAPS = dict(frontier_cap=1 << 20, result_cap=4096, pool_cap=LIST_BATCH * 4096)
LS_CAPS = dict(frontier_cap=max(16384, 4 * LIST_BATCH), result_cap=2048,
               pool_cap=64 * LIST_BATCH)
# closure phase: bench.py:1162 _powering_context(1_000_000) over
# bench.py:1092 _deep_columns: chains of 20 parent hops capped so the
# closure universe stays under 2^20 nodes, one tail owner a chain, and
# direct viewer grants on random chain nodes up to 1e6 tuples
DEEP_TUPLES = 1_000_000
DEEP_DEPTH = 20
DEEP_USERS = 128
DEEP_CHAINS = min(DEEP_TUPLES // (DEEP_DEPTH + 1), 960_000 // (2 * (DEEP_DEPTH + 1)))
DEEP_MAX_DEPTH = DEEP_DEPTH + 4
DEEP_ROUNDS = 10  # per arm, alternating
# covered nodes and entries keto_tpu's host powering gives on this
# topology (POWERING_AB_r19.json)
DEEP_CLOSURE = (959_994, 6_310_111)
# and at max_set_rows 4 (its build_sweep), the row-cap kill at this scale
DEEP_CAP_ROWS = 4
DEEP_CLOSURE_CAPPED = (543_981, 645_912)
# filter phase: bench.py:547 bench_filter's column of 10,000 candidates
FILTER_OBJECTS = 10_000
FILTER_ROUNDS = 5
FILTER_CHUNK = 16384
KERNEL_SOURCES = {
    "edge_probe": "keto_tpu_torch/csrc/check_kernels.cu",
    "pair_probe": "keto_tpu_torch/csrc/check_kernels.cu",
    "expand_gather": "keto_tpu_torch/csrc/check_kernels.cu",
    "dedupe_compact": "keto_tpu_torch/csrc/check_kernels.cu",
    "expand_emit": "keto_tpu_torch/csrc/expand_kernels.cu",
    "pool_compact": "keto_tpu_torch/csrc/expand_kernels.cu",
    "list_emit": "keto_tpu_torch/csrc/list_kernels.cu",
    "reverse_gather": "keto_tpu_torch/csrc/list_kernels.cu",
    "subjects_gather": "keto_tpu_torch/csrc/list_kernels.cu",
    "list_pool_compact": "keto_tpu_torch/csrc/list_kernels.cu",
    "closure_probe": "keto_tpu_torch/csrc/closure_filter_kernels.cu",
    "filter_mark": "keto_tpu_torch/csrc/closure_filter_kernels.cu",
    "power_step": "keto_tpu_torch/csrc/closure_power_kernels.cu",
    "power_account": "keto_tpu_torch/csrc/closure_power_kernels.cu",
    "power_poison": "keto_tpu_torch/csrc/closure_power_kernels.cu",
    **{name: "keto_tpu_torch/csrc/microbench_kernels.cu" for name in (
        "mb_probe", "mb_probe_smem", "mb_scatmax", "mb_scatmax_smem", "mb_pack_onepass",
        "mb_pack", "mb_hashprobe", "mb_add", "mb_row_gather", "mb_block_gather")},
}
REPLACES = {
    "edge_probe": "keto_tpu/engine/kernel.py:259",
    "pair_probe": "keto_tpu/engine/kernel.py:298",
    "expand_gather": "keto_tpu/engine/kernel.py:520",
    "dedupe_compact": "keto_tpu/engine/kernel.py:762",
    "expand_emit": "keto_tpu/engine/expand_kernel.py:157",
    "pool_compact": "keto_tpu/engine/expand_kernel.py:355",
    "list_emit": "keto_tpu/engine/reverse_kernel.py:250",
    "reverse_gather": "keto_tpu/engine/reverse_kernel.py:301",
    "subjects_gather": "keto_tpu/engine/reverse_kernel.py:649",
    "list_pool_compact": "keto_tpu/engine/reverse_kernel.py:565",
    "closure_probe": "keto_tpu/engine/closure_kernel.py:153",
    "filter_mark": "keto_tpu/engine/filter_kernel.py:185",
    "power_step": "keto_tpu/engine/closure_power.py:132",
    "power_account": "keto_tpu/engine/closure_power.py:132",
    "power_poison": "keto_tpu/engine/closure_power.py:132",
    "mb_probe": "tools/microbench_pallas.py:51",
    "mb_probe_smem": "tools/microbench_pallas.py:51",
    "mb_scatmax": "tools/microbench_pallas.py:94",
    "mb_scatmax_smem": "tools/microbench_pallas.py:94",
    "mb_pack_onepass": "tools/microbench_pallas.py:137",
    "mb_pack": "tools/microbench_pallas.py:137",
    "mb_hashprobe": "tools/microbench_pallas.py:181",
    "mb_add": "tools/microbench_pallas_feasibility.py:41",
    "mb_row_gather": "tools/microbench_pallas_feasibility.py:58",
    "mb_block_gather": "tools/microbench_pallas_feasibility.py:80",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


# -- workload ----------------------------------------------------------------


def videos_namespace():
    from keto_tpu_torch.namespace import Namespace

    return Namespace.from_dict({"name": "videos", "relations": [
        {"name": "owner"}, {"name": "parent"},
        {"name": "view", "rewrite": {"operator": "or", "children": [
            {"type": "computed_subject_set", "relation": "owner"},
            {"type": "tuple_to_subject_set", "relation": "parent",
             "computed_subject_set_relation": "view"},
        ]}},
    ]})


def build_dataset(n_folders: int, files_per_folder: int, seed: int = 1234):
    """Folders with owners, files with a parent link and (a quarter) an
    owner; queries are half folder owners viewing a nested file (hits)
    and half random users."""
    from keto_tpu_torch.ketoapi import RelationTuple, SubjectSet

    rng = random.Random(seed)
    tuples, owners = [], {}
    for d in range(n_folders):
        folder = f"/d{d}"
        owner = f"user{rng.randrange(N_USERS)}"
        owners[folder] = owner
        tuples.append(RelationTuple("videos", folder, "owner", subject_id=owner))
        parent = SubjectSet("videos", folder, "...")
        for f in range(files_per_folder):
            obj = f"{folder}/v{f}.mp4"
            tuples.append(RelationTuple("videos", obj, "parent", subject_set=parent))
            if rng.random() < 0.25:
                tuples.append(RelationTuple(
                    "videos", obj, "owner", subject_id=f"user{rng.randrange(N_USERS)}"
                ))
    queries = []
    for i in range(BATCH):
        d = rng.randrange(n_folders)
        obj = f"/d{d}/v{rng.randrange(files_per_folder)}.mp4"
        sub = owners[f"/d{d}"] if i % 2 == 0 else f"user{rng.randrange(N_USERS)}"
        queries.append(RelationTuple("videos", obj, "view", subject_id=sub))
    return tuples, queries


def rbac_namespaces():
    from keto_tpu_torch.namespace import Namespace

    def computed(rel):
        return {"operator": "or", "children": [{"type": "computed_subject_set", "relation": rel}]}

    return [
        Namespace.from_dict({"name": "role", "relations": [{"name": "member"}]}),
        Namespace.from_dict({"name": "doc", "relations": [
            {"name": "owner"},
            {"name": "editor", "rewrite": computed("owner")},
            {"name": "viewer", "rewrite": computed("editor")},
        ]}),
    ]


def build_rbac_dataset(n_roles: int, n_docs: int, seed: int = 7):
    """bench.py's config 3 in its own draw order: 4 direct members per
    role, each later role nests one earlier role with p = 0.5; one owner
    and one role-editor set per doc, a viewer with p = 0.3; then the
    expand batch of role member sets."""
    from keto_tpu_torch.ketoapi import RelationTuple, SubjectSet

    rng = random.Random(seed)
    tuples = []
    for r in range(n_roles):
        for _ in range(4):
            tuples.append(RelationTuple("role", f"r{r}", "member",
                                        subject_id=f"u{rng.randrange(N_USERS)}"))
        if r and rng.random() < 0.5:
            tuples.append(RelationTuple("role", f"r{r}", "member", subject_set=SubjectSet(
                "role", f"r{rng.randrange(r)}", "member")))
    for d in range(n_docs):
        tuples.append(RelationTuple("doc", f"d{d}", "owner",
                                    subject_id=f"u{rng.randrange(N_USERS)}"))
        tuples.append(RelationTuple("doc", f"d{d}", "editor", subject_set=SubjectSet(
            "role", f"r{rng.randrange(n_roles)}", "member")))
        if rng.random() < 0.3:
            tuples.append(RelationTuple("doc", f"d{d}", "viewer",
                                        subject_id=f"u{rng.randrange(N_USERS)}"))
    subjects = [SubjectSet("role", f"r{rng.randrange(n_roles)}", "member")
                for _ in range(EXPAND_BATCH)]
    return tuples, subjects


def tree_size(tree) -> int:
    return 0 if tree is None else 1 + sum(tree_size(c) for c in tree.children)


def normalize(tree):
    """Order-free form of a tree: the device lists a node's children in
    CSR row order, the host oracle in store order."""
    if tree is None:
        return None
    kids = sorted((normalize(c) for c in tree.children), key=repr)
    return (tree.type.value, str(tree.tuple) if tree.tuple else None, tuple(kids))


# -- kernels: capture, compare, time -------------------------------------------


class Recorder:
    """Wraps the cuda_ops wrappers during one batch and keeps a clone of
    the arguments of each kernel's call number `step` (or of `steps[name]`
    for that kernel; its last call, for a shorter walk), and of every call
    of the kernels named in `keep` (calls[name][i] is call i either way)."""

    def __init__(self, cuda_ops, step: int = 1, steps: dict | None = None,
                 keep: tuple[str, ...] = ()):
        self.cuda_ops = cuda_ops
        self.step = step
        self.steps = steps or {}
        self.keep = keep
        self.calls: dict = {}
        self.originals: dict = {}

    def __enter__(self):
        import torch

        def clone(x):
            if isinstance(x, tuple):
                return tuple(clone(y) for y in x)
            return x.clone() if isinstance(x, torch.Tensor) else x

        for name in self.cuda_ops.KERNELS:
            orig = getattr(self.cuda_ops, name)
            self.originals[name] = orig

            def wrapped(*args, _name=name, _orig=orig, **kw):
                seen = self.calls.setdefault(_name, [])
                if _name in self.keep or len(seen) <= self.steps.get(_name, self.step):
                    seen.append(([clone(a) for a in args], dict(kw)))
                return _orig(*args, **kw)

            setattr(self.cuda_ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self.originals.items():
            setattr(self.cuda_ops, name, orig)

    def args(self, name):
        step = self.steps.get(name, self.step)
        return self.calls[name][min(step, len(self.calls[name]) - 1)]


def wall_ms(fn, reps: int = 20) -> float:
    """Time per call between CUDA events around back-to-back calls: the
    host's enqueue of each call is included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# profile windows timed, and those whose record counts were not a whole
# number of launches a call
PROFILE_WINDOWS = {"timed": 0, "short": 0}
# the last timed window's parts: the profiler's kernel (or memset) key ->
# (records, launches a call, ms a call)
LAST_PARTS: dict = {}


def device_ms(fn, reps: int = 20, only: tuple[str, ...] | None = None) -> float:
    """Device time per call over `reps` calls: for every kernel the calls
    launched (or those whose name holds one of `only`), the profiler's
    mean self device time a launch times its launches a call. The
    profiler now and then misses some of a window's records (on the H100,
    18 or 19 of a kernel launched once a call, 20 times) or holds one
    more, so a kernel's launches a call are its record count over `reps`
    rounded to the nearest whole number, at least 1: a few lost or extra
    records neither scale the time nor drop a kernel. A window with no
    device time at all is taken again (CUPTI on the H100 now and then
    hands back empty windows, three in a row in one run); after five,
    the time between CUDA events stands in (host enqueue included, so
    never below the device time), but only without `only`: a filter that
    matches no kernel the profiler saw (a renamed kernel) raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen: set[str] = set()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.key_averages()
                  if evt.device_type == DeviceType.CUDA and evt.count]
        seen.update(evt.key for evt in events)
        picked = [evt for evt in events if only is None or any(o in evt.key for o in only)]
        parts = {}
        for evt in picked:
            per_call = max(1, round(evt.count / reps))
            parts[evt.key] = (evt.count, per_call,
                              evt.self_device_time_total / evt.count * per_call / 1e3)
        busy_ms = sum(ms for _, _, ms in parts.values())
        if busy_ms > 0:
            PROFILE_WINDOWS["timed"] += 1
            PROFILE_WINDOWS["short"] += any(evt.count % reps for evt in picked)
            LAST_PARTS.clear()
            LAST_PARTS.update(parts)
            return busy_ms
    if only is not None:
        raise AssertionError(f"no device time for {only}; the profiler saw {sorted(seen)}")
    log("  (the profiler saw no device time five times: CUDA-event time instead)")
    return wall_ms(fn, reps)


def kernel_name(key: str) -> str:
    """A profiler key's function name, without an anonymous namespace,
    return type and parameters: "void (anonymous namespace)::f<2>(int
    const*)" gives "f<2>"."""
    name = key.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").strip() or key


def max_abs_err(got, want) -> int:
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def pair_probe_case(args, kw, live, note):
    """K2's (name, kernel fn, plain fn, bytes, operations, compare fn,
    kernel functions) on captured inputs, and its launch's shape. K2
    returns a value for every (task, slot) of the [F, S] relation matrix,
    dead tasks and slots without an instruction included, so the least
    work for its function probes each distinct (obj, rel) key once (equal
    keys give equal answers) and reads each bucket row those keys address
    once (keys that hash into one bucket share its row): bytes count the
    [F] objects and [F, S] relations in, the distinct rows of spb 16-byte
    slots that the distinct keys' ceil(probes / spb) rows reach (at most
    the table's rows), and the [F, S, n_vals] values out.
    Operations count each distinct key's hashes and its compares. `live`
    is the frontier's liveness at that launch, which K2 does not read:
    the shape's live share."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import kernel as tk

    pack, obj, rels = args
    F, S = rels.shape
    keys = torch.unique((obj.to(torch.int64)[:, None] << 32) | (rels.to(torch.int64) & 0xFFFFFFFF))
    n_keys = int(keys.numel())
    spb = kw["spb"]
    pb = -(-kw["probes"] // spb)
    h1 = tk.hash_combine(keys >> 32, keys & 0xFFFFFFFF)
    h2 = tk.mix32(h1 ^ tk._GOLDEN) | 1
    nb = pack.shape[0] // spb
    jb = torch.arange(pb, dtype=torch.int64, device=pack.device)
    n_rows = int(torch.unique((h1[:, None] + jb * h2[:, None]) & (nb - 1)).numel())
    shape = {"note": note, "F": F, "S": S, "n_vals": kw["n_vals"], "probes": kw["probes"],
             "spb": spb, "distinct_keys": n_keys, "distinct_rows": n_rows, "table_rows": nb,
             "live_share": float(live.float().mean())}
    case = (
        "pair_probe",
        lambda: cuda_ops.pair_probe(*args, **kw),
        lambda: tk.pair_probe_plain(*args, **kw),
        F * 4 + F * S * 4 + F * S * kw["n_vals"] * 4 + n_rows * spb * 16,
        n_keys * (3 * HASH_OPS + pb * spb * 4),
        lambda: max_abs_err(cuda_ops.pair_probe(*args, **kw), tk.pair_probe_plain(*args, **kw)),
        ("pair_probe_", "Memset"),
    )
    return case, shape


def expect_probe(args, kw, pack, probes, what):
    """Raises unless a captured pair_probe call probed `pack` with
    `probes`: the launch the caller names it by position."""
    import torch

    got = args[0]
    if kw["probes"] != probes or got.shape != pack.shape or not torch.equal(got, pack):
        raise AssertionError(f"pair_probe's captured call is not {what}")
    return args, kw


def time_pair_probe(args, kw, live, note) -> dict:
    """K2 timed on one launch's captured inputs: a kernel row's keys and
    the launch's shape (pair_probe_case)."""
    case, shape = pair_probe_case(args, kw, live, note)
    row = time_kernel(*case)
    log(f"  K2 at {note}: {shape}")
    return {**{k: row[k] for k in LARGE_KEYS if k != "note"}, **shape}


def kernel_cases(rec):
    """(name, kernel fn, plain fn, bytes the function must move, 32-bit
    operations it does[, compare fn, kernel functions]) for each kernel on
    the captured inputs. Bytes
    count each input read once and each output written once. Probe rows
    and gathers count only what this step's data needs: bucket rows for
    the keys of tasks that are live with depth >= 1 (K1: the task's edge
    key), each distinct key's rows once for K2 (pair_probe_case), and for
    K3 the segments and sources of the candidates that land in the
    frontier."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import kernel as tk

    cases = []
    args, kw = rec.args("edge_probe")
    dh_pack, dd_pack, obj, rel, q, qsub, depth, live = args
    F = obj.shape[0]
    expand = live & (depth >= 1)
    n_probe = int(expand.sum())
    pb = -(-kw["dh_probes"] // kw["spb"])
    row_bytes = kw["spb"] * 32
    cases.append((
        "edge_probe",
        lambda: cuda_ops.edge_probe(*args, **kw),
        lambda: tk.edge_probe_plain(*args, **kw),
        F * (4 * 4 + 1 + 1) + n_probe * (16 + pb * row_bytes),
        n_probe * (6 * HASH_OPS + pb * kw["spb"] * 6),
        lambda: max_abs_err(cuda_ops.edge_probe(*args, **kw), tk.edge_probe_plain(*args, **kw)),
        ("edge_probe_staged_kernel", "Memset"),
    ))

    args2, kw2 = rec.args("pair_probe")
    if not torch.equal(args2[1], obj):
        raise AssertionError("pair_probe's capture is not from edge_probe's step")
    case2, shape2 = pair_probe_case(args2, kw2, live, "Check's step-2 launch")
    cases.append(case2)

    args3, kw3 = rec.args("expand_gather")
    counts, is_comp = args3[0], args3[4]
    F3, S3 = counts.shape
    c = counts.flatten().long()
    ends = c.cumsum(0)
    landed = (ends.clamp(max=F3) - (ends - c)).clamp(min=0)  # per segment
    n_out = int(landed.sum())
    n_edge_out = n_out - int((landed * (is_comp.flatten() != 0)).sum())

    def plain3():
        ch, over = tk.expand_gather_plain(*args3, **kw3)
        return (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid, over)

    def kernel3():
        return cuda_ops.expand_gather(*args3, **kw3)

    cases.append((
        "expand_gather",
        kernel3,
        plain3,
        # counts scanned whole; starts, slot_ctx, crel, is_comp and the
        # task's q, obj, depth gathered once per landed candidate; one
        # e_pack pair per edge candidate; six [F] columns and the causes out
        F3 * S3 * 4 + 7 * n_out * 4 + n_edge_out * 8
        + 5 * F3 * 4 + F3 + kw3["n_queries"] * 4,
        F3 * S3 * 3 + n_out * (2 * (F3 * S3).bit_length() + 20),
        lambda: max_abs_err(kernel3(), plain3()),
        None,
    ))

    name4, kernel4, plain4, bytes4, ops4 = dedupe_kernel_case(*rec.args("dedupe_compact"))
    cases.append((name4, kernel4, plain4, bytes4, ops4,
                  lambda: max_abs_err(kernel4(), plain4()), None))
    return cases, shape2


def dedupe_kernel_case(args, kw):
    """K4's (name, kernel fn, plain fn, bytes, operations) on captured
    inputs: the five columns and valid read once, the [F] frontier, n_new
    and the causes written once; per candidate two hashes and the keep
    test."""
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import kernel as tk

    G = args[0].shape[0]
    return (
        "dedupe_compact",
        lambda: cuda_ops.dedupe_compact(*args, **kw),
        lambda: tk.dedupe_compact_plain(tk.Expansion(*args), **kw),
        G * (5 * 4 + 1) + kw["F"] * 5 * 4 + 4 + kw["n_queries"] * 4,
        G * (2 * (3 * HASH_OPS + 10) + 3),
    )


def resetting(args, updated):
    """call(fn, kw): a call of fn on args that first copies the arguments
    at `updated` back to their values now, so that every timed call sees
    the captured state."""
    saved = {i: args[i].clone() for i in updated}

    def call(fn, kw):
        def run():
            for i, t in saved.items():
                args[i].copy_(t)
            return fn(*args, **kw)
        return run

    return call


def expand_emit_case(args1, kw1):
    """X1's (name, kernel fn, plain fn, bytes, operations, compare fn,
    kernel functions) on captured inputs. X1 updates its buffers in place,
    so every compared call works on its own clones; a timed call reuses one
    set, first copying eb_count and needs_host back (the kernel's time
    excludes the copies; the plain version's includes them), so it writes
    the same slots every time. Bytes count what the step's data needs: the
    gate columns of every task, the spans, parents and query counts of the
    tasks that emit, their emitted edges (three CSR columns read, five
    buffer columns written) and the [4F] candidate columns."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import expand_kernel as tek

    def cloned(args):
        return [tuple(x.clone() for x in a) if isinstance(a, tuple)
                else a.clone() if isinstance(a, torch.Tensor) else a for a in args]

    t_q, _obj, _rel, t_depth, live, row = args1[:6]
    F = t_q.shape[0]
    G = tek.EMIT_PER_TASK * F
    emitting = int((live & (t_depth >= 2) & (row >= 0)).sum())

    def run1(fn):
        a = cloned(args1)
        out = fn(*a, **kw1)
        return (*out, *a[11], a[12], a[13])  # outputs, then the buffers it updated

    n_emit = int(run1(tek.expand_emit_plain)[6])
    call = resetting(cloned(args1), (12, 13))
    return (
        "expand_emit",
        call(cuda_ops.expand_emit, kw1),
        call(tek.expand_emit_plain, kw1),
        F * (4 * 4 + 1) + emitting * (8 + 8 + 8) + n_emit * (12 + 20) + G * (4 * 4 + 1),
        F * 20 + G * (3 * max(F, 2).bit_length() + 20),
        lambda: max_abs_err(run1(cuda_ops.expand_emit), run1(tek.expand_emit_plain)),
        ("expand_emit_", "Memset"),
    )


def expand_kernel_cases(rec):
    """(name, kernel fn, plain fn, bytes, operations, compare fn[, kernel
    functions]) of X1 (step 1 of a real expand batch, expand_emit_case)
    and X2 (its one call): X2 reads B counts and flags and the used buffer
    rows and writes the whole packed vector; its operations are a query's
    clamp, scan and flags and a used row's source index (the EMPTY tail
    needs none)."""
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import expand_kernel as tek

    cases = [expand_emit_case(*rec.args("expand_emit"))]
    args2, kw2 = rec.args("pool_compact")
    eb_count2 = args2[1]
    B2, P = eb_count2.shape[0], kw2["pool_cap"]
    used = int(eb_count2.clamp(0, kw2["edge_cap"]).sum().clamp(max=P))
    cases.append((
        "pool_compact",
        lambda: cuda_ops.pool_compact(*args2, **kw2),
        lambda: tek.pool_compact_plain(*args2, **kw2),
        B2 * (4 + 2) + 32 + used * 5 * 4 + (3 * B2 + 1 + tek.N_LAUNCH_STATS + 5 * P) * 4,
        B2 * 6 + used * 4,
        lambda: max_abs_err(cuda_ops.pool_compact(*args2, **kw2),
                            tek.pool_compact_plain(*args2, **kw2)),
        ("pool_compact_kernel", "Memset"),
    ))
    return cases


def list_kernel_cases(rec_lo, rec_ls):
    """(name, kernel fn, plain fn, bytes, operations, compare fn[, kernel
    functions]) of L1 and L2 (ListObjects' emission at step 2 and
    expansion at step 1, its largest of each), L3 (ListSubjects' step 1)
    and L4 (ListObjects' one call). L1 updates its buffers in place, so
    every compared call works on its own clones; a timed call reuses one
    set, first copying res_count and needs_host back (the kernel's time
    excludes the copies; the plain version's includes them), so the
    emissions land at the same slots every time. Bytes count what the data
    needs: each task's columns, the instruction rows, edge rows and
    namespaces of the candidates that land, each output once."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import reverse_kernel as trk

    def cloned(args):
        return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]

    def landed_candidates(counts_fn, F):
        c = counts_fn().flatten().long()
        ends = c.cumsum(0)
        return int((ends.clamp(max=F) - (ends - c)).clamp(min=0).sum())

    cases = []
    args1, kw1 = rec_lo.args("list_emit")
    q, emit = args1[0], args1[1]
    N, B = q.shape[0], args1[4].shape[0]

    def run1(fn):
        a = cloned(args1)
        return (fn(*a, **kw1), a[3], a[4], a[5])

    n_emit = int(emit.sum())
    n_land = int(run1(trk.list_emit_plain)[0])
    call1 = resetting(cloned(args1), (4, 5))
    cases.append((
        "list_emit",
        call1(cuda_ops.list_emit, kw1),
        call1(trk.list_emit_plain, kw1),
        N * 5 + n_emit * 4 + n_land * 4 + B * 4 * 3,
        N * 3 + n_emit * 12,
        lambda: max_abs_err(run1(cuda_ops.list_emit), run1(trk.list_emit_plain)),
        ("list_emit_", "Memset"),
    ))

    args2, kw2 = rec_lo.args("reverse_gather")
    q, obj, rel, depth, live, ns_t, rstart, rlen, rinstr, rv_pack = args2[:10]
    F = q.shape[0]
    S = 1 + rinstr.shape[1] // 4
    ch, _cause = trk.reverse_gather_plain(*args2, **kw2)
    n_out = int(ch.valid.sum())
    cases.append((
        "reverse_gather",
        lambda: cuda_ops.reverse_gather(*args2, **kw2),
        lambda: trk.reverse_gather_plain(*args2, **kw2),
        F * (7 * 4 + 1) + rinstr.numel() * 4 + n_out * (16 + 4) + F * (4 * 4 + 1)
        + kw2["n_queries"] * 4,
        F * S * 8 + F * (2 * (F * S).bit_length() + 24),
        lambda: max_abs_err(cuda_ops.reverse_gather(*args2, **kw2),
                            (lambda c, x: (c.q, c.ctx, c.obj, c.rel, c.depth, c.valid, x))(
                                *trk.reverse_gather_plain(*args2, **kw2))),
        ("reverse_tile_kernel", "reverse_scan_kernel", "reverse_merge_kernel", "Memset"),
    ))

    args3, kw3 = rec_ls.args("subjects_gather")
    q3, spans, ik = args3[0], args3[4], args3[5]
    F3, K = ik.shape
    ch3, emit3, _v, _c = trk.subjects_gather_plain(*args3, **kw3)
    n_out3 = int((ch3.valid | emit3).sum())
    cases.append((
        "subjects_gather",
        lambda: cuda_ops.subjects_gather(*args3, **kw3),
        lambda: trk.subjects_gather_plain(*args3, **kw3),
        F3 * (3 * 4 + 1) + spans.numel() * 4 + ik.numel() * 12 + n_out3 * 16
        + F3 * (5 * 4 + 2) + kw3["n_queries"] * 4,
        F3 * (K + 1) * 8 + F3 * (2 * (F3 * (K + 1)).bit_length() + 24),
        lambda: max_abs_err(cuda_ops.subjects_gather(*args3, **kw3),
                            (lambda c, e, v, x: (c.q, c.ctx, c.obj, c.rel, c.depth, c.valid,
                                                 e, v, x))(
                                *trk.subjects_gather_plain(*args3, **kw3))),
        ("subjects_tile_kernel", "subjects_scan_kernel", "subjects_merge_kernel", "Memset"),
    ))

    cases.append(list_pool_case(*rec_lo.args("list_pool_compact")))
    return cases


def list_pool_case(args, kw):
    """L4's (name, kernel fn, plain fn, bytes, operations, compare fn,
    kernel functions) on one list leg's captured call: it reads B counts
    and causes and the used result rows and writes the whole packed
    vector; its operations are counted as X2's."""
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import reverse_kernel as trk

    res_count = args[1]
    B, P = res_count.shape[0], kw["pool_cap"]
    used = int(res_count.clamp(0, kw["result_cap"]).sum().clamp(max=P))
    return (
        "list_pool_compact",
        lambda: cuda_ops.list_pool_compact(*args, **kw),
        lambda: trk.list_pool_compact_plain(*args, **kw),
        B * 8 + 32 + used * 4 + (2 * B + 1 + 8 + P) * 4,
        B * 6 + used * 4,
        lambda: max_abs_err(cuda_ops.list_pool_compact(*args, **kw),
                            trk.list_pool_compact_plain(*args, **kw)),
        ("pool_compact_kernel", "Memset"),
    )


# -- phases ------------------------------------------------------------------------


# the keys of a kernel row's nested "large" entry: the same kernel timed
# again at a larger shape
LARGE_KEYS = ("note", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "wall_ms", "plain_wall_ms", "bytes", "ops")


def time_kernel(name, kernel, plain, nbytes, ops, compare, only=None,
                ops_per_s=OPS_INT32_PER_S) -> dict:
    """Compare, then time a kernel and its plain version; `only` names the
    CUDA functions and memsets of the kernel's entry point, where its call
    also resets inputs it updates. `ops` count at `ops_per_s`, the card's
    rate for their type (32-bit integer by default)."""
    err = compare()
    ms = device_ms(kernel, only=only)
    parts = "; ".join(f"{kernel_name(k)} {n} records, {c} a call, {t:.5f} ms"
                      for k, (n, c, t) in sorted(LAST_PARTS.items()))
    plain_ms = device_ms(plain)
    k_wall, p_wall = wall_ms(kernel), wall_ms(plain)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  {name}: max_abs_err {err}, device ms: kernel {ms:.5f}, plain {plain_ms:.5f}; "
        f"wall ms: kernel {k_wall:.5f}, plain {p_wall:.5f}; "
        f"bound {bound_ms:.6f} ms by {bound_by} ({nbytes} B, {ops} ops); parts: {parts}")
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version: {err}")
    return {
        "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
        "replaces": REPLACES[name], "launches": None, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "wall_ms": k_wall, "plain_wall_ms": p_wall,
        "bytes": nbytes, "ops": ops,
    }


def run_kernels(engine, queries):
    from keto_tpu_torch.engine import cuda_ops

    t0 = phase("3 kernels: K1-K4 against their plain versions, on a real check batch")
    with Recorder(cuda_ops, step=1) as rec:
        engine.check_batch(queries, MAX_DEPTH)
    cases, k2_shape = kernel_cases(rec)
    rows = [time_kernel(*case) for case in cases]
    k2 = next(row for row in rows if row["name"] == "pair_probe")
    k2.update(k2_shape)
    log(f"  K2 at {k2_shape['note']}: {k2_shape}")
    k2["at"] = {}
    log(f"  kernels phase {time.perf_counter() - t0:.1f} s")
    return rows


def run_expand_kernels(engine, subjects):
    from keto_tpu_torch.engine import cuda_ops

    t0 = phase("7b kernels: X1 and X2 against their plain versions, on a real expand batch; "
                f"X1 also at F = {EXPAND_LARGE_FRONTIER}; K2 at the step-1 launch")
    with Recorder(cuda_ops, step=1, keep=("pair_probe",)) as rec:
        engine.expand_batch(subjects, EXPAND_DEPTH, **EXPAND_CAPS)
    rows = [time_kernel(*case) for case in expand_kernel_cases(rec)]
    # pair_probe calls 0 and 1 probe the roots (fh, dirty); call 2 is step
    # 1's fh probe, on the frontier expand_emit's call 0 reads
    state = engine.ensure_expand_state()
    args2, kw2 = expect_probe(*rec.calls["pair_probe"][2], state.expand_tables["fh_pack"],
                              state.expand_np["fh_probes"], "Expand's step-1 fh probe")
    k2 = time_pair_probe(args2, kw2, rec.calls["expand_emit"][0][0][4],
                         "Expand's step-1 launch")
    with Recorder(cuda_ops, step=1) as rec_large:
        engine.expand_batch(subjects, EXPAND_DEPTH,
                            **{**EXPAND_CAPS, "frontier_cap": EXPAND_LARGE_FRONTIER})
    args, kw = rec_large.args("expand_emit")
    large = time_kernel(*expand_emit_case(args, kw))
    large["note"] = (f"step 1 of the same batch at frontier_cap {EXPAND_LARGE_FRONTIER}, "
                     f"F = {args[0].shape[0]}, B = {args[12].shape[0]}, E = {kw['edge_cap']}")
    rows[0]["large"] = {k: large[k] for k in LARGE_KEYS}
    log(f"  kernels phase {time.perf_counter() - t0:.1f} s")
    return rows, {"expand_step1": k2}


def run_check(engine, queries, manager, config):
    import torch
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine

    t0 = phase(f"4 check: batches of {BATCH} on the main path")
    cuda_ops.reset_launch_counts()
    before = dict(engine.stats)
    results = engine.check_batch(queries, MAX_DEPTH)  # the main path, once
    torch.cuda.synchronize()
    launches = dict(cuda_ops.launches)
    host = engine.stats["host_checks"] - before["host_checks"]
    if host:
        raise AssertionError(f"{host} host replays on the benchmark batch")
    # throughput: ROUNDS batches through submit/resolve, window of 8
    t1 = time.perf_counter()
    handles = []
    for _ in range(ROUNDS):
        handles.append(engine.check_batch_submit(queries, MAX_DEPTH))
        if len(handles) > 8:
            engine.check_batch_resolve(handles.pop(0))
    for h in handles:
        engine.check_batch_resolve(h)
    torch.cuda.synchronize()
    qps = ROUNDS * BATCH / (time.perf_counter() - t1)
    lat = []
    for _ in range(9):
        s = time.perf_counter()
        engine.check_batch(queries, MAX_DEPTH)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - s) * 1e3)
    if engine.stats["host_checks"] != before["host_checks"]:
        raise AssertionError("host replays during the timed rounds")
    missing = [k for k in cuda_ops.CHECK_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the check path: {missing}")
    # 512 sampled verdicts against the exact host oracle
    oracle = ReferenceEngine(manager, config)
    sample = random.Random(7).sample(range(len(queries)), min(512, len(queries)))
    bad = [i for i in sample
           if oracle.check_relation_tuple(queries[i], MAX_DEPTH).allowed != results[i].allowed]
    if bad:
        raise AssertionError(f"{len(bad)} of 512 sampled verdicts differ from the oracle")
    allowed = sum(r.allowed for r in results)
    log(f"  launches on the main path: {launches}")
    log(f"  verdicts: {allowed} allowed of {len(results)}; 512 sampled equal the oracle")
    log(f"  throughput {qps:.1f} checks/s ({ROUNDS} batches of {BATCH}); "
        f"p50 batch {statistics.median(lat):.2f} ms (min {min(lat):.2f}, max {max(lat):.2f})")
    log(f"  check phase {time.perf_counter() - t0:.1f} s")
    return launches, {"checks_per_s": qps, "p50_batch_ms": statistics.median(lat),
                      "batch_ms": lat, "allowed": allowed}


def device_profile(fn, label: str) -> dict:
    """Device busy time by kernel over two calls of `fn` from the
    profiler, and the idle share against the median unprofiled wall time
    of the same two calls (the profiler's per-op host cost would inflate
    the wall time it sees)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def two() -> float:
        s = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - s) * 1e3

    wall = statistics.median(two() for _ in range(5))
    # the profiler now and then reports no device time at all: try again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled = two()
        rows = sorted(
            ((evt.key, evt.self_device_time_total / 1e3, evt.count) for evt in prof.key_averages()
             if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0),
            key=lambda r: -r[1],
        )
        if rows:
            break
    # no device time three times over is "not measured", not an idle card
    busy = sum(r[1] for r in rows) if rows else None
    out = {f"wall_ms_2_{label}": wall, f"profiled_wall_ms_2_{label}": profiled,
           "device_busy_ms": busy, "idle_share": 1 - busy / wall if rows else None,
           "n_device_kernels": sum(r[2] for r in rows),
           "top": [{"name": k[:70], "ms": ms, "count": c} for k, ms, c in rows[:10]]}
    return out


def run_profile(engine, queries):
    """Where one batch's time goes: host stages (query encoding, the step
    loop with its kernels, the resolve readback) and, from the profiler,
    device time by kernel over two batches and the device's idle share."""
    import torch

    from keto_tpu_torch.engine.snapshot import encode_query_batch

    phase("4b profile: where one batch's time goes")
    state = engine.ensure_state()
    stages = {"encode_ms": [], "submit_ms": [], "resolve_ms": []}
    for _ in range(5):
        t0 = time.perf_counter()
        encode_query_batch(state.view, queries, BATCH)
        t1 = time.perf_counter()
        handle = engine.check_batch_submit(queries, MAX_DEPTH)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        engine.check_batch_resolve(handle)
        t3 = time.perf_counter()
        stages["encode_ms"].append((t1 - t0) * 1e3)
        stages["submit_ms"].append((t2 - t1) * 1e3)
        stages["resolve_ms"].append((t3 - t2) * 1e3)
    host = {k: statistics.median(v) for k, v in stages.items()}

    out = {"host_stages_ms": host,
           **device_profile(lambda: engine.check_batch(queries, MAX_DEPTH), "batches")}
    log("  profile " + json.dumps(out))
    return out


def run_islands():
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
    from keto_tpu_torch.ketoapi import RelationTuple
    from keto_tpu_torch.namespace import Namespace
    from keto_tpu_torch.storage import MemoryManager

    t0 = phase("5 islands: AND/NOT rewrites on the device against the host oracle")
    ns = Namespace.from_dict({"name": "acl", "relations": [
        {"name": "allow"}, {"name": "deny"}, {"name": "parent"},
        {"name": "access", "rewrite": {"operator": "and", "children": [
            {"type": "computed_subject_set", "relation": "allow"},
            {"type": "invert", "inverted": {"type": "computed_subject_set", "relation": "deny"}},
        ]}},
        {"name": "view", "rewrite": {"operator": "or", "children": [
            {"type": "computed_subject_set", "relation": "access"},
            {"type": "tuple_to_subject_set", "relation": "parent",
             "computed_subject_set_relation": "view"},
        ]}},
    ]})
    rng = random.Random(3)
    tuples = []
    for d in range(40):
        tuples.append(f"acl:doc{d}#parent@(acl:folder{d % 8}#...)")
        tuples.append(f"acl:doc{d}#allow@u{rng.randrange(12)}")
        if rng.random() < 0.3:
            tuples.append(f"acl:doc{d}#deny@u{rng.randrange(12)}")
    for f in range(8):
        tuples.append(f"acl:folder{f}#allow@u{rng.randrange(12)}")
        tuples.append(f"acl:folder{f}#deny@u{rng.randrange(12)}")
    queries = [RelationTuple.from_string(
        f"acl:doc{rng.randrange(40)}#{rng.choice(['view', 'access'])}@u{rng.randrange(12)}")
        for _ in range(200)]
    config = Config({"limit": {"max_read_depth": MAX_DEPTH}})
    config.set_namespaces([ns])
    manager = MemoryManager()
    manager.write_relation_tuples([RelationTuple.from_string(s) for s in tuples])
    engine = TorchCheckEngine(manager, config, device="cuda")
    got = engine.check_batch(queries)
    oracle = ReferenceEngine(manager, config)
    bad = [q for q, g in zip(queries, got)
           if g.allowed != oracle.check_relation_tuple(q).allowed]
    if bad:
        raise AssertionError(f"{len(bad)} island verdicts differ from the oracle: {bad[:3]}")
    if engine.stats["host_checks"]:
        raise AssertionError(f"{engine.stats['host_checks']} island queries went to the host")
    log(f"  {len(queries)} island checks equal the oracle "
        f"({sum(g.allowed for g in got)} allowed), all on the device "
        f"({time.perf_counter() - t0:.1f} s)")


def setup_expand():
    """The expand phase's store and engine, with its mirror and full-edge
    CSR built and uploaded."""
    import torch

    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
    from keto_tpu_torch.storage import MemoryManager

    phase(f"7a data: {N_ROLES} roles x {N_DOCS} docs into the store")
    t = time.perf_counter()
    tuples, subjects = build_rbac_dataset(N_ROLES, N_DOCS)
    config = Config({"limit": {"max_read_depth": EXPAND_DEPTH}})
    config.set_namespaces(rbac_namespaces())
    manager = MemoryManager()
    manager.write_relation_tuples(tuples)
    t_store = time.perf_counter() - t
    engine = TorchCheckEngine(manager, config, device="cuda")
    t = time.perf_counter()
    engine.ensure_state()
    torch.cuda.synchronize()
    t_mirror = time.perf_counter() - t
    t = time.perf_counter()
    state = engine.ensure_expand_state()
    torch.cuda.synchronize()
    t_csr = time.perf_counter() - t
    nbytes = engine.tables_nbytes("expand")
    info = {"tuples": len(tuples), "store_s": t_store, "mirror_s": t_mirror,
            "csr_build_upload_s": t_csr, "expand_table_bytes": sum(nbytes.values()),
            "fh_probes": state.expand_np["fh_probes"], "layout": state.snapshot.layout}
    log(f"  {len(tuples)} tuples: store {t_store:.1f} s, mirror {t_mirror:.1f} s, "
        f"full-edge CSR build + upload {t_csr:.1f} s, expand tables "
        f"{sum(nbytes.values()) / 1e6:.1f} MB: "
        + ", ".join(f"{k} {v / 1e6:.2f} MB" for k, v in sorted(nbytes.items())))
    return engine, manager, config, subjects, info


def run_expand(engine, manager, config, subjects, info):
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import torch_engine
    from keto_tpu_torch.engine.reference import ReferenceEngine

    t0 = phase(f"7 expand: batches of {EXPAND_BATCH} role member sets on the main path")
    cuda_ops.reset_launch_counts()
    before = dict(engine.stats)
    trees = engine.expand_batch(subjects, EXPAND_DEPTH, **EXPAND_CAPS)  # the main path, once
    torch.cuda.synchronize()
    launches = dict(cuda_ops.launches)
    host = engine.stats["host_expands"] - before["host_expands"]
    if host:
        raise AssertionError(f"{host} host expands on the benchmark batch")
    missing = [k for k in ("pair_probe", "dedupe_compact", *cuda_ops.EXPAND_KERNELS)
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the expand path: {missing}")
    if any(launches[k] for k in ("edge_probe", "expand_gather")):
        raise AssertionError(f"check-only kernels launched on the expand path: {launches}")

    # where a batch's time goes: the launch (step loop, kernels, readback)
    # against the host's encoding and tree assembly
    launch_ms: list = []
    orig = torch_engine.expand_kernel_packed

    def timed_launch(*a, **kw):
        s = time.perf_counter()
        out = orig(*a, **kw).cpu()
        launch_ms.append((time.perf_counter() - s) * 1e3)
        return out

    lat = []
    torch_engine.expand_kernel_packed = timed_launch
    try:
        t1 = time.perf_counter()
        for _ in range(ROUNDS):
            s = time.perf_counter()
            engine.expand_batch(subjects, EXPAND_DEPTH, **EXPAND_CAPS)
            lat.append((time.perf_counter() - s) * 1e3)
        wall = time.perf_counter() - t1
    finally:
        torch_engine.expand_kernel_packed = orig
    if engine.stats["host_expands"] != before["host_expands"]:
        raise AssertionError("host expands during the timed rounds")
    profile = device_profile(
        lambda: engine.expand_batch(subjects, EXPAND_DEPTH, **EXPAND_CAPS), "batches")

    oracle = ReferenceEngine(manager, config)
    sample = random.Random(11).sample(range(len(subjects)), 256)
    bad = [i for i in sample
           if normalize(trees[i]) != normalize(oracle.expand(subjects[i], EXPAND_DEPTH))]
    if bad:
        raise AssertionError(f"{len(bad)} of 256 sampled trees differ from the oracle")
    nodes = [tree_size(t) for t in trees]
    out = {
        "trees_per_s": ROUNDS * EXPAND_BATCH / wall,
        "p50_batch_ms": statistics.median(lat), "batch_ms": lat,
        "p50_launch_readback_ms": statistics.median(launch_ms),
        "mean_tree_nodes": sum(nodes) / len(nodes), "nil_trees": nodes.count(0),
        "launches": {k: v for k, v in launches.items() if v}, **info, "profile": profile,
    }
    log(f"  launches on the expand path: {launches}")
    log(f"  256 sampled trees equal the oracle; mean tree {out['mean_tree_nodes']:.2f} nodes")
    log(f"  throughput {out['trees_per_s']:.1f} trees/s ({ROUNDS} batches of {EXPAND_BATCH}); "
        f"p50 batch {out['p50_batch_ms']:.2f} ms (launch + readback "
        f"{out['p50_launch_readback_ms']:.2f} ms); idle share {profile['idle_share']}")
    log(f"  expand phase {time.perf_counter() - t0:.1f} s")
    return launches, out


def ownership(tuples):
    """The generator's ownership maps: user -> owned folders, user ->
    directly owned files, and the files of each folder."""
    folders_of, files_of, files_in = {}, {}, {}
    for t in tuples:
        if t.relation == "owner":
            obj = t.object
            target = files_of if "/v" in obj else folders_of
            target.setdefault(t.subject_id, []).append(obj)
        elif t.relation == "parent":
            files_in.setdefault(t.subject_set.object, []).append(t.object)
    return folders_of, files_of, files_in


def list_queries():
    """bench.py:489-507's draws: 256 users for ListObjects, then 256
    random files for ListSubjects."""
    rng = random.Random(11)
    lo = [("videos", "view", f"user{rng.randrange(N_USERS)}") for _ in range(LIST_BATCH)]
    ls = [("videos", f"/d{rng.randrange(N_FOLDERS)}/v{rng.randrange(FILES_PER_FOLDER)}.mp4",
           "view") for _ in range(LIST_BATCH)]
    return lo, ls


def setup_list(engine):
    import torch

    phase("8a list: the reverse and subjects states on phase 4's engine")
    out = {}
    for path, ensure in (("reverse", engine.ensure_reverse_state),
                         ("subjects", engine.ensure_subjects_state)):
        t = time.perf_counter()
        ensure()
        torch.cuda.synchronize()
        out[f"{path}_build_upload_s"] = time.perf_counter() - t
        nbytes = engine.tables_nbytes(path)
        out[f"{path}_table_bytes"] = sum(nbytes.values())
        log(f"  {path} state: build + upload {out[f'{path}_build_upload_s']:.1f} s, tables "
            f"{out[f'{path}_table_bytes'] / 1e6:.1f} MB: "
            + ", ".join(f"{k} {v / 1e6:.2f} MB" for k, v in sorted(nbytes.items())))
    rnp = engine.ensure_reverse_state().reverse_np
    out.update(RK=rnp["RK"], rvh_probes=rnp["rvh_probes"], rsh_probes=rnp["rsh_probes"])
    return out


def run_list_kernels(engine, lo_queries, ls_queries):
    """L1-L4's rows, K4 on ListObjects' step-1 launch (G = F = 2^20) as
    the dedupe_compact row's "large" entry, K2 at ListObjects' three
    step launches and at ListSubjects' step-2 launch, and L4 at
    ListSubjects' launch (its row's "at" entry)."""
    from keto_tpu_torch.engine import cuda_ops

    t0 = phase("8b kernels: L1-L4 and K4 at G = 2^20 against their plain versions, "
               "on real list batches; K2 at every ListObjects step and a ListSubjects step; "
               "L4 at ListSubjects' launch")
    with Recorder(cuda_ops, step=1, steps={"list_emit": 2},
                  keep=("pair_probe", "reverse_gather")) as rec_lo:
        engine.list_objects_batch(lo_queries, LIST_DEPTH, **LO_CAPS)
    with Recorder(cuda_ops, step=1) as rec_ls:
        engine.list_subjects_batch(ls_queries, LIST_DEPTH, **LS_CAPS)
    rows = [time_kernel(*case) for case in list_kernel_cases(rec_lo, rec_ls)]
    # ListObjects' pair_probe call 0 is the seed probe; call k the rvh span
    # probe of step k, on the frontier reverse_gather's call k - 1 reads
    rstate = engine.ensure_reverse_state()
    k2_at = {}
    for k in range(1, len(rec_lo.calls["pair_probe"])):
        args2, kw2 = expect_probe(*rec_lo.calls["pair_probe"][k],
                                  rstate.reverse_tables["rvh_pack"],
                                  rstate.reverse_np["rvh_probes"],
                                  f"ListObjects' step-{k} rvh span probe")
        k2_at[f"list_objects_step{k}"] = time_pair_probe(
            args2, kw2, rec_lo.calls["reverse_gather"][k - 1][0][4],
            f"ListObjects' step-{k} launch")
    sstate = engine.ensure_subjects_state()
    args2, kw2 = expect_probe(*rec_ls.args("pair_probe"), sstate.subjects_tables["fsh_pack"],
                              sstate.expand_np["fh_probes"], "ListSubjects' step-2 span probe")
    k2_at["list_subjects_step2"] = time_pair_probe(
        args2, kw2, rec_ls.args("subjects_gather")[0][3], "ListSubjects' step-2 launch")
    args4, kw4 = rec_lo.args("dedupe_compact")
    name, kernel, plain, nbytes, ops = dedupe_kernel_case(args4, kw4)
    large = time_kernel(name, kernel, plain, nbytes, ops,
                        lambda: max_abs_err(kernel(), plain()))
    large["note"] = f"ListObjects' step-1 launch, G = {args4[0].shape[0]}, F = {kw4['F']}"
    # L4's row is ListObjects' launch; its "at" entry ListSubjects' one
    args4, kw4 = rec_ls.args("list_pool_compact")
    l4_ls = time_kernel(*list_pool_case(args4, kw4))
    l4_ls["note"] = (f"ListSubjects' launch, B = {args4[1].shape[0]}, "
                     f"R = {kw4['result_cap']}, P = {kw4['pool_cap']}")
    next(row for row in rows if row["name"] == "list_pool_compact")["at"] = {
        "list_subjects": {k: l4_ls[k] for k in LARGE_KEYS}}
    log(f"  kernels phase {time.perf_counter() - t0:.1f} s")
    return rows, {k: large[k] for k in LARGE_KEYS}, k2_at


def run_list_leg(engine, leg, queries, caps, want_kernels, check):
    """One list leg's main path once, its launches, LIST_ROUNDS timed
    batches split into launch + readback and host decode, the device
    profile, and `check(results)`."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import torch_engine

    batch = getattr(engine, f"list_{leg}_batch")
    host_key = f"host_list_{leg}"
    cuda_ops.reset_launch_counts()
    before = engine.stats[host_key]
    results = batch(queries, LIST_DEPTH, **caps)  # the main path, once
    torch.cuda.synchronize()
    launches = dict(cuda_ops.launches)
    if engine.stats[host_key] != before:
        raise AssertionError(f"{engine.stats[host_key] - before} host replays on the {leg} batch")
    missing = [k for k in want_kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the list_{leg} path: {missing}")
    stray = [k for k in cuda_ops.KERNELS if k not in want_kernels and launches[k]]
    if stray:
        raise AssertionError(f"kernels of other paths launched on the list_{leg} path: {stray}")

    name = f"list_{leg}_kernel_packed"
    orig = getattr(torch_engine, name)
    launch_ms: list = []

    def timed_launch(*a, **kw):
        s = time.perf_counter()
        out = orig(*a, **kw).cpu()
        launch_ms.append((time.perf_counter() - s) * 1e3)
        return out

    lat = []
    setattr(torch_engine, name, timed_launch)
    try:
        t1 = time.perf_counter()
        for _ in range(LIST_ROUNDS):
            s = time.perf_counter()
            batch(queries, LIST_DEPTH, **caps)
            lat.append((time.perf_counter() - s) * 1e3)
        wall = time.perf_counter() - t1
    finally:
        setattr(torch_engine, name, orig)
    if engine.stats[host_key] != before:
        raise AssertionError(f"host replays during the timed {leg} rounds")
    profile = device_profile(lambda: batch(queries, LIST_DEPTH, **caps), "batches")
    check(results)
    sizes = [len(r) for r in results]
    p50_launch = statistics.median(launch_ms)
    out = {
        "lists_per_s": LIST_ROUNDS * len(queries) / wall,
        "p50_batch_ms": statistics.median(lat), "batch_ms": lat,
        "p50_launch_readback_ms": p50_launch,
        "p50_host_decode_ms": statistics.median(b - a for a, b in zip(launch_ms, lat)),
        "mean_results": sum(sizes) / len(sizes), "max_results": max(sizes),
        "launches": {k: v for k, v in launches.items() if v}, "profile": profile,
    }
    log(f"  launches on the list_{leg} path: {launches}")
    log(f"  throughput {out['lists_per_s']:.1f} lists/s ({LIST_ROUNDS} batches of {len(queries)}); "
        f"p50 batch {out['p50_batch_ms']:.2f} ms (launch + readback {p50_launch:.2f} ms, host "
        f"decode {out['p50_host_decode_ms']:.2f} ms); mean {out['mean_results']:.1f} results "
        f"per query (max {out['max_results']}); idle share {profile['idle_share']}")
    return launches, out


def run_list_objects(engine, manager, config, queries, owners):
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationTuple

    t0 = phase(f"8c list objects: batches of {len(queries)} users' view on the main path")
    folders_of, files_of, files_in = owners

    def expected(user):
        folders = folders_of.get(user, [])
        nested = [f for d in folders for f in files_in.get(d, [])]
        return sorted(set(folders) | set(nested) | set(files_of.get(user, [])))

    def check(results):
        rng = random.Random(13)
        sample = rng.sample(range(len(queries)), 32)
        bad = [i for i in sample if results[i] != expected(queries[i][2])]
        if bad:
            raise AssertionError(f"{len(bad)} of 32 sampled ListObjects answers differ from "
                                 "the ownership maps")
        # the oracle's own list_objects would check all ~800k objects per
        # query, minutes each: hold 16 returned and 16 other objects of 4
        # queries against its check instead
        oracle = ReferenceEngine(manager, config)
        all_folders = sorted(d for ds in folders_of.values() for d in ds)
        for i in sample[:4]:
            user = queries[i][2]
            got = set(results[i])
            near = rng.sample(all_folders, 64)
            near += [f for d in near for f in files_in.get(d, [])[:2]]
            others = sorted(o for o in set(near) if o not in got)
            picks = [(o, True) for o in rng.sample(sorted(got), 16)]
            picks += [(o, False) for o in rng.sample(others, 16)]
            for obj, want in picks:
                allowed = oracle.check_relation_tuple(
                    RelationTuple("videos", obj, "view", subject_id=user), LIST_DEPTH).allowed
                if allowed != want:
                    raise AssertionError(f"{user} {obj}: oracle says {allowed}, list says {want}")
        log("  32 sampled answers equal the ownership maps; 4 x 32 objects equal the oracle's "
            "check")

    launches, out = run_list_leg(
        engine, "objects", queries, LO_CAPS,
        ("pair_probe", "dedupe_compact", "list_emit", "reverse_gather", "list_pool_compact"),
        check)
    log(f"  list objects phase {time.perf_counter() - t0:.1f} s")
    return launches, out


def run_list_subjects(engine, manager, config, queries):
    from keto_tpu_torch.engine.reference import ReferenceEngine

    t0 = phase(f"8d list subjects: batches of {len(queries)} files' view on the main path")

    def check(results):
        oracle = ReferenceEngine(manager, config)
        sample = random.Random(17).sample(range(len(queries)), 64)
        bad = [i for i in sample if results[i] != oracle.list_subjects(*queries[i], LIST_DEPTH)]
        if bad:
            raise AssertionError(f"{len(bad)} of 64 sampled ListSubjects answers differ from "
                                 "the oracle's")
        log("  64 sampled answers equal the oracle's list_subjects")

    launches, out = run_list_leg(
        engine, "subjects", queries, LS_CAPS,
        ("pair_probe", "dedupe_compact", "list_emit", "subjects_gather", "list_pool_compact"),
        check)
    log(f"  list subjects phase {time.perf_counter() - t0:.1f} s")
    return launches, out


def deep_namespace():
    from keto_tpu_torch.namespace import Namespace

    return Namespace.from_dict({"name": "deep", "relations": [
        {"name": "owner"}, {"name": "parent"},
        {"name": "viewer", "rewrite": {"operator": "or", "children": [
            {"type": "computed_subject_set", "relation": "owner"},
            {"type": "tuple_to_subject_set", "relation": "parent",
             "computed_subject_set_relation": "viewer"},
        ]}},
    ]})


def build_deep_dataset(seed: int = 9):
    """bench.py:1092 _deep_columns' draws (numpy seed 9) as tuples: the
    tail owners, the parent chains, then the direct viewer grants; and a
    check batch as bench.py:818-822 (seed 6): chain heads' viewer, half
    the chain's owner and half a random user."""
    import numpy as np

    from keto_tpu_torch.ketoapi import RelationTuple, SubjectSet

    rng = np.random.default_rng(seed)
    n_chains, depth = DEEP_CHAINS, DEEP_DEPTH
    n_direct = DEEP_TUPLES - n_chains * (depth + 1)
    owners = [f"u{u}" for u in rng.integers(0, DEEP_USERS, n_chains).tolist()]
    tuples = [RelationTuple("deep", f"c{c}f{depth}", "owner", subject_id=owners[c])
              for c in range(n_chains)]
    tuples += [RelationTuple("deep", f"c{c}f{i}", "parent",
                             subject_set=SubjectSet("deep", f"c{c}f{i + 1}", "..."))
               for c in range(n_chains) for i in range(depth)]
    dc = rng.integers(0, n_chains, n_direct).tolist()
    dl = rng.integers(0, depth + 1, n_direct).tolist()
    du = rng.integers(0, DEEP_USERS, n_direct).tolist()
    tuples += [RelationTuple("deep", f"c{c}f{lv}", "viewer", subject_id=f"u{u}")
               for c, lv, u in zip(dc, dl, du)]
    qrng = random.Random(6)
    queries = []
    for i in range(BATCH):
        c = qrng.randrange(n_chains)
        sub = owners[c] if i % 2 == 0 else f"u{qrng.randrange(DEEP_USERS)}"
        queries.append(RelationTuple("deep", f"c{c}f0", "viewer", subject_id=sub))
    return tuples, owners, queries


def setup_closure():
    """Phase 9's store and engine, with the mirror and the closure index
    built and uploaded."""
    import torch

    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
    from keto_tpu_torch.storage import MemoryManager

    phase(f"9a data: {DEEP_CHAINS} chains of {DEEP_DEPTH} hops + direct grants into the store")
    t = time.perf_counter()
    tuples, owners, queries = build_deep_dataset()
    config = Config({"limit": {"max_read_depth": DEEP_MAX_DEPTH},
                     "closure": {"enabled": True, "powering": "device"}})
    config.set_namespaces([deep_namespace()])
    manager = MemoryManager()
    manager.write_relation_tuples(tuples)
    n_tuples = len(tuples)
    del tuples
    t_store = time.perf_counter() - t
    engine = TorchCheckEngine(manager, config, device="cuda")
    t = time.perf_counter()
    stored = engine.ensure_state().snapshot.n_tuples  # a repeated draw is stored once
    torch.cuda.synchronize()
    t_mirror = time.perf_counter() - t
    cuda_ops.reset_launch_counts()
    t = time.perf_counter()
    if not engine.closure_ensure_built():  # the closure_build path, once
        raise AssertionError("the closure index did not build over the deep store")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    launches = dict(cuda_ops.launches)
    missing = [k for k in cuda_ops.POWER_KERNELS if launches[k] == 0]
    stray = [k for k in cuda_ops.KERNELS if k not in cuda_ops.POWER_KERNELS and launches[k]]
    idx = engine.closure_index().describe()
    if missing or stray or idx["device_builds"] != 1 or idx["device_fallbacks"]:
        raise AssertionError(f"the build did not power on the card: launches {launches}, "
                             f"{idx['device_builds']} device builds, "
                             f"{idx['device_fallbacks']} fallbacks")
    nbytes = engine.tables_nbytes("closure")
    info = {"tuples": n_tuples, "stored_tuples": stored, "store_s": t_store,
            "mirror_s": t_mirror, "closure_build_s": t_build,
            **{k: idx[k] for k in ("covered_nodes", "entries", "universe", "extract_s",
                                   "power_s", "power_prep_s", "power_wave_s", "pack_s",
                                   "upload_s", "power_waves", "power_steps", "power_hbm")},
            "closure_table_bytes": sum(nbytes.values()),
            "closure_tables": nbytes,
            "build_launches": {k: v for k, v in launches.items() if v}}
    log(f"  {n_tuples} tuples drawn, {stored} stored: store {t_store:.1f} s, snapshot + upload "
        f"{t_mirror:.1f} s; closure "
        f"build {t_build:.1f} s (extract {idx['extract_s']:.1f}, power {idx['power_s']:.2f} on "
        f"the card: host prep {idx['power_prep_s']:.2f}, waves {idx['power_wave_s']:.2f}, "
        f"{idx['power_waves']} waves, {idx['power_steps']} steps; "
        f"pack {idx['pack_s']:.1f}, upload {idx['upload_s']:.2f}); universe {idx['universe']}, "
        f"covered nodes {idx['covered_nodes']}, entries {idx['entries']}; tables "
        f"{info['closure_table_bytes'] / 1e6:.1f} MB: "
        + ", ".join(f"{k} {v / 1e6:.2f} MB" for k, v in sorted(nbytes.items())))
    log(f"  launches on the closure_build path: {info['build_launches']}")
    if (idx["covered_nodes"], idx["entries"]) != DEEP_CLOSURE:
        raise AssertionError("the closure build differs from keto_tpu's on this topology")
    return engine, manager, config, owners, queries, launches, info


def run_powering(engine):
    """Phase 9p: the host builder against the index's device build on the
    same graph, then a device build at max_set_rows 4 whose widest wave's
    inputs are kept for P1-P3."""
    import numpy as np
    import torch

    from keto_tpu_torch.engine import closure as tcl
    from keto_tpu_torch.engine import closure_power as tcp

    t0 = phase("9p powering: the host builder against the device build; a row cap of "
               f"{DEEP_CAP_ROWS}")
    idx = engine.closure_index()
    desc = idx.describe()
    graph, snap, built = idx._graph, idx._snapshot, idx._build
    t = time.perf_counter()
    host = tcl.power_closure(graph, snap, DEEP_MAX_DEPTH, idx.max_set_rows, built.base_version)
    host_s = time.perf_counter() - t
    fields = ("covered_keys", "ent_obj", "ent_rel", "ent_skind", "ent_sa", "ent_sb", "ent_req")
    differ = [k for k in fields if getattr(host, k).dtype != getattr(built, k).dtype
              or not np.array_equal(getattr(host, k), getattr(built, k))]
    if differ or (host.n_nodes, host.vocab_fp, host.n_entries) != (
            built.n_nodes, built.vocab_fp, built.n_entries):
        raise AssertionError(f"the device build differs from the host's: {differ}")

    widest: dict = {}
    wave = tcp.closure_power_wave

    def keep_widest(*args, **kw):
        e_src, _e_dst, d_rows, _pois, R0, lvl0, _counts0 = args
        size = (e_src.shape[0] + 2 * R0.shape[0] + d_rows.shape[0]) * lvl0.shape[1]
        if size > widest.get("size", -1):
            widest.update(size=size, args=[a.clone() for a in args])
        return wave(*args, **kw)

    tcp.closure_power_wave = keep_widest
    try:
        t = time.perf_counter()
        capped, record = tcp.power_closure_device(graph, snap, DEEP_MAX_DEPTH, DEEP_CAP_ROWS,
                                                  built.base_version, device="cuda")
        torch.cuda.synchronize()
        capped_s = time.perf_counter() - t
    finally:
        tcp.closure_power_wave = wave
    if (len(capped.covered_keys), capped.n_entries) != DEEP_CLOSURE_CAPPED:
        raise AssertionError(f"the build at max_set_rows {DEEP_CAP_ROWS} gives "
                             f"{len(capped.covered_keys)} nodes, {capped.n_entries} entries")
    e_src, _e_dst, d_rows, _pois, R0, lvl0, _counts0 = widest["args"]
    info = {"host_power_s": host_s, "device_power_s": desc["power_s"],
            "device_prep_s": desc["power_prep_s"], "device_wave_s": desc["power_wave_s"],
            "waves": desc["power_waves"], "steps": desc["power_steps"],
            "capped": {"max_set_rows": DEEP_CAP_ROWS, "covered_nodes": len(capped.covered_keys),
                       "entries": capped.n_entries, "build_s": capped_s,
                       **{k: record[k] for k in ("waves", "steps", "lanes", "nodes", "edges",
                                                 "hbm", "device_hbm", "prep_s", "wave_s")}},
            "widest_wave": {"nodes": R0.shape[0], "edges": e_src.shape[0],
                            "d_rows": d_rows.shape[0], "lanes": lvl0.shape[1]}}
    log(f"  host power_closure {host_s:.2f} s against the device's {desc['power_s']:.2f} s (host "
        f"prep {desc['power_prep_s']:.2f}, waves {desc['power_wave_s']:.2f}; {desc['power_waves']} "
        f"waves, {desc['power_steps']} steps, {record['lanes']} lanes): the seven arrays equal, "
        f"{len(built.covered_keys)} nodes, {built.n_entries} entries")
    log(f"  max_set_rows {DEEP_CAP_ROWS}: {len(capped.covered_keys)} nodes, {capped.n_entries} "
        f"entries in {capped_s:.2f} s (prep {record['prep_s']:.2f}, waves "
        f"{record['wave_s']:.2f}; {record['waves']} waves, {record['steps']} steps); widest wave "
        f"{info['widest_wave']}")
    log(f"  powering phase {time.perf_counter() - t0:.1f} s")
    return widest["args"], idx.max_set_rows, info


def power_kernel_cases(wave_args, max_set_rows):
    """(name, kernel fn, plain fn, bytes, operations, compare fn, kernel
    functions) of P1 and P2 at step 1 of the widest wave and P3 at its end,
    and the yardstick of P1: scatter_reduce's segment max over keto_tpu's
    unpacked uint8 planes of the step's gathered rows (the unpack outside
    the timed call). Bytes count what the step's data needs: the edge
    sources and destinations, the F rows those edges gather (each
    once), R read only at the words the gathered OR set (fresh = acc & ~R
    is 0 elsewhere) and written where fresh lands, fresh written
    whole (the output), the counts fresh bits touch; P2 reads fresh once,
    writes F, and a level
    byte where a fresh bit lands on a direct row; P3 the mask, the seen rows
    of poisoned nodes and the summary. P1 and P2 update inputs in place,
    so every call works on clones, and a timed call first resets them
    (the kernel's time excludes the copies; the plain version's includes
    them)."""
    import torch

    from keto_tpu_torch.engine import closure_power as tcp
    from keto_tpu_torch.engine import cuda_ops

    with Recorder(cuda_ops, step=1) as rec:
        tcp.closure_power_wave(*wave_args, max_depth=DEEP_MAX_DEPTH, max_set_rows=max_set_rows)
    torch.cuda.synchronize()

    def compared(fn, args, kw, updated):
        def run(f):
            a = [x.clone() if i in updated else x for i, x in enumerate(args)]
            return (f(*a, **kw), *(a[i] for i in updated))
        return lambda: max_abs_err(run(fn[0]), run(fn[1]))

    cases = []
    args1, kw1 = rec.args("power_step")
    F, R, e_src, e_dst, counts, stats, status = args1
    N, W = F.shape
    S = 32 * W
    fresh = tcp.power_step_plain(*[a.clone() for a in args1])
    n_fresh_words = int((fresh != 0).sum())
    n_fresh_bits = int(tcp._popcount(fresh).sum())
    n_lanes = int((tcp._unpack(fresh).sum(0) > 0).sum())
    n_rows = int(torch.unique(e_src).numel())
    E = e_src.shape[0]
    # the (node, word) pairs the gathered OR sets: the words of R that
    # fresh = acc & ~R needs
    live = (F[e_src.long()] != 0).nonzero()
    n_acc_words = int(torch.unique(e_dst.long()[live[:, 0]] * W + live[:, 1]).numel())
    call1 = resetting(args1, (1, 4, 5))
    cases.append((
        "power_step",
        call1(cuda_ops.power_step, kw1),
        call1(tcp.power_step_plain, kw1),
        E * 8 + n_rows * W * 4 + n_acc_words * 4 + n_fresh_words * 4 + N * W * 4
        + n_lanes * 8 + 8 * 4 * 2 + 4,
        E * W * 3 + n_acc_words * 3 + n_fresh_bits * 3,
        compared((cuda_ops.power_step, tcp.power_step_plain), args1, kw1, (1, 4, 5)),
        ("power_step_gather_kernel", "power_step_walk_kernel"),
    ))

    args2, kw2 = rec.args("power_account")
    fresh2, lvl, counts2, d_rows, status2 = args2
    D = d_rows.shape[0]
    freshd = tcp._unpack(fresh2[d_rows.long()])
    n_lvl = int(((lvl < 0) & (freshd > 0)).sum())
    call2 = resetting(args2, (1, 4))
    cases.append((
        "power_account",
        call2(cuda_ops.power_account, kw2),
        call2(tcp.power_account_plain, kw2),
        N * W * 4 + S * 4 + D * 4 + n_lvl * 2 + N * W * 4 + 4,
        S * 2 + N * W * 3 + D * W * 2 + n_lvl * 3,
        compared((cuda_ops.power_account, tcp.power_account_plain), args2, kw2, (1, 4)),
        ("power_account_vec_kernel", "Memset"),
    ))

    args3, kw3 = rec.args("power_poison")
    R3, pois = args3[0], args3[1]
    n_pois = int((pois != 0).sum())
    cases.append((
        "power_poison",
        lambda: cuda_ops.power_poison(*args3, **kw3),
        lambda: tcp.power_poison_plain(*args3, **kw3),
        N + n_pois * W * 4 + S * 4 + 8 * 4 + (2 * S + 8) * 4,
        N + n_pois * W + (2 * S + 8) * 2,
        lambda: max_abs_err(cuda_ops.power_poison(*args3, **kw3),
                            tcp.power_poison_plain(*args3, **kw3)),
        ("power_poison_kernel",),
    ))

    planes = tcp._unpack(F[e_src.long()])
    index = e_dst.long()[:, None].expand_as(planes)
    base = torch.zeros(N, S, dtype=torch.uint8, device=F.device)
    return cases, (lambda: base.scatter_reduce(0, index, planes, "amax"))


def run_closure(engine, manager, config, queries):
    """Closure on and off (the BFS) on the same batch in alternating
    rounds, the main path's launches, the oracle, and a write that turns
    the index stale until it is built again."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationTuple

    t0 = phase(f"9 closure: batches of {BATCH} chain-head checks, closure on and off")
    engine.closure_enabled = False
    expected = [r.allowed for r in engine.check_batch(queries)]  # the BFS, warm
    engine.closure_enabled = True
    cuda_ops.reset_launch_counts()
    before = {k: engine.stats[k] for k in ("closure_hits", "host_checks")}
    fallbacks = dict(engine.stats["closure_fallback"])
    results = engine.check_batch(queries)  # the main path, once
    torch.cuda.synchronize()
    launches = dict(cuda_ops.launches)
    hits = engine.stats["closure_hits"] - before["closure_hits"]
    if launches["closure_probe"] != 1 or any(v for k, v in launches.items() if k != "closure_probe"):
        raise AssertionError(f"the closure batch did not ride one C1 launch alone: {launches}")
    if hits != len(queries) or engine.stats["closure_fallback"] != fallbacks \
            or engine.stats["host_checks"] != before["host_checks"]:
        raise AssertionError(f"{hits} closure hits of {len(queries)}; fallbacks "
                             f"{engine.stats['closure_fallback']}")
    if [r.allowed for r in results] != expected:
        raise AssertionError("closure verdicts differ from the BFS's")
    cuda_ops.reset_launch_counts()
    engine.closure_enabled = False
    engine.check_batch(queries)
    torch.cuda.synchronize()
    bfs_steps = cuda_ops.launches["edge_probe"]

    lat = {"on": [], "off": []}
    mismatches = 0
    for i in range(2 * DEEP_ROUNDS):
        arm = "on" if i % 2 else "off"
        engine.closure_enabled = arm == "on"
        s = time.perf_counter()
        got = engine.check_batch(queries)
        torch.cuda.synchronize()
        lat[arm].append((time.perf_counter() - s) * 1e3)
        mismatches += sum(r.allowed != w for r, w in zip(got, expected))
    if mismatches:
        raise AssertionError(f"{mismatches} verdicts differ between the arms")
    oracle = ReferenceEngine(manager, config)
    sample = random.Random(7).sample(range(len(queries)), min(512, len(queries)))
    bad = [i for i in sample if oracle.check_relation_tuple(queries[i]).allowed != expected[i]]
    if bad:
        raise AssertionError(f"{len(bad)} of 512 sampled verdicts differ from the oracle")
    engine.closure_enabled = False
    profile = device_profile(lambda: engine.check_batch(queries), "batches")
    engine.closure_enabled = True
    profile_on = device_profile(lambda: engine.check_batch(queries), "batches")

    # one write: the mirror rebuilds, the index no longer serves it, and
    # every check falls back to the BFS, still correct
    c = int(queries[0].object[1:].split("f")[0])
    fresh = RelationTuple("deep", f"c{c}f0", "viewer", subject_id="newbie")
    stale_batch = list(queries[:-1]) + [fresh]
    manager.write_relation_tuples([RelationTuple("deep", f"c{c}f{DEEP_DEPTH}", "owner",
                                                 subject_id="newbie")])
    t_w = time.perf_counter()
    stale = engine.stats["closure_fallback"].get("stale_snapshot", 0)
    got = engine.check_batch(stale_batch)
    t_stale = time.perf_counter() - t_w
    n_stale = engine.stats["closure_fallback"].get("stale_snapshot", 0) - stale
    want = expected[:-1] + [True]
    if n_stale != len(stale_batch) or [r.allowed for r in got] != want:
        raise AssertionError(f"after a write: {n_stale} stale fallbacks, verdicts "
                             f"{'equal' if [r.allowed for r in got] == want else 'differ'}")
    t_w = time.perf_counter()
    engine.closure_ensure_built()
    t_rebuild = time.perf_counter() - t_w
    rebuilt = engine.closure_index().describe()
    if rebuilt["device_builds"] != 2 or rebuilt["device_fallbacks"]:
        raise AssertionError(f"the rebuild was not powered on the card: {rebuilt['device_builds']} "
                             f"device builds, {rebuilt['device_fallbacks']} fallbacks")
    hits = engine.stats["closure_hits"]
    got = engine.check_batch(stale_batch)
    if engine.stats["closure_hits"] - hits != len(stale_batch) or \
            [r.allowed for r in got] != want:
        raise AssertionError("the rebuilt index did not resume the hits")

    out = {
        "on_checks_per_s": BATCH / (statistics.median(lat["on"]) / 1e3),
        "off_checks_per_s": BATCH / (statistics.median(lat["off"]) / 1e3),
        "on_p50_batch_ms": statistics.median(lat["on"]),
        "off_p50_batch_ms": statistics.median(lat["off"]),
        "batch_ms": lat, "off_steps_per_batch": bfs_steps,
        "allowed": sum(expected), "launches": {k: v for k, v in launches.items() if v},
        "stale_batch_s_incl_mirror_rebuild": t_stale, "closure_rebuild_s": t_rebuild,
        "rebuild_power": {k: rebuilt[k] for k in ("power_s", "power_prep_s", "power_wave_s")},
        "profile_off": profile, "profile_on": profile_on,
    }
    log(f"  launches on the closure path: {launches}; {len(queries)} closure hits, 0 fallbacks")
    log(f"  closure on {out['on_checks_per_s']:.1f} checks/s, p50 {out['on_p50_batch_ms']:.2f} ms "
        f"(idle share {profile_on['idle_share']}); off (BFS, {bfs_steps} steps) "
        f"{out['off_checks_per_s']:.1f} checks/s, p50 {out['off_p50_batch_ms']:.2f} ms "
        f"(idle share {profile['idle_share']}); {DEEP_ROUNDS} rounds each, alternating; "
        f"0 mismatches; 512 sampled equal the oracle; {sum(expected)} allowed")
    log(f"  a write: {n_stale} stale_snapshot fallbacks, verdicts correct ({t_stale:.1f} s with "
        f"the mirror rebuild); closure rebuilt in {t_rebuild:.1f} s (power on the card "
        f"{rebuilt['power_s']:.2f} s), hits resumed")
    log(f"  closure phase {time.perf_counter() - t0:.1f} s")
    return launches, out


def closure_case(args, kw, note):
    """C1's (name, kernel fn, plain fn, bytes, operations, compare fn,
    kernel functions) on one launch's captured inputs, and the launch's
    shape. Bytes count the query pack, the bucket rows the verdicts need
    (cc for valid queries, ch for covered and clean ones) and the output.
    The kernel also reads the ch rows of valid queries that are not
    covered and clean, as the JAX body probes every table and masks after:
    the shape gives their share and bytes, which the bound leaves out."""
    from keto_tpu_torch.engine import closure_kernel as tck
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.snapshot import slots_per_bucket

    qpack = args[3]
    B = qpack.shape[1]
    out = tck.closure_probe_plain(*args, **kw)
    n_valid = int((qpack[6] != 0).sum())
    n_cov = int((out[B : 2 * B] == 0).sum())
    s2, s5 = slots_per_bucket(2, kw["layout"]), slots_per_bucket(5, kw["layout"])
    pb2, pb5 = -(-kw["cc_probes"] // s2), -(-kw["ch_probes"] // s5)
    shape = {"note": note, "B": B, "has_dirty": kw["has_dirty"], "cc_probes": kw["cc_probes"],
             "ch_probes": kw["ch_probes"], "valid_share": n_valid / max(B, 1),
             "covered_share": n_cov / max(B, 1),
             "speculative_ch_bytes": (n_valid - n_cov) * pb5 * s5 * 32}
    case = (
        "closure_probe",
        lambda: cuda_ops.closure_probe(*args, **kw),
        lambda: tck.closure_probe_plain(*args, **kw),
        7 * B * 4 + n_valid * pb2 * s2 * 16 + n_cov * pb5 * s5 * 32 + (2 * B + 8) * 4,
        n_valid * (3 * HASH_OPS + pb2 * s2 * 4) + n_cov * (6 * HASH_OPS + pb5 * s5 * 6),
        lambda: max_abs_err(cuda_ops.closure_probe(*args, **kw), tck.closure_probe_plain(*args, **kw)),
        None,
    )
    return case, shape


def time_closure_probe(args, kw, note) -> dict:
    """C1 timed on one launch's captured inputs: a kernel row's keys and
    the launch's shape (closure_case)."""
    case, shape = closure_case(args, kw, note)
    row = time_kernel(*case)
    log(f"  C1 at {note}: {shape}")
    return {**{k: row[k] for k in LARGE_KEYS if k != "note"}, **shape}


def filter_mark_case(rec_f):
    """(name, kernel fn, plain fn, bytes, operations, compare fn, kernel
    functions) of F1 on step 1 of the videos filter walk, and
    torch.searchsorted on its inputs: bytes count the task columns, the
    candidate column once, the hit slots it sets, the status and the
    count. F1 updates hit and status in place, so every call works on its
    own clones."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import filter_kernel as tfk

    args2, _kw2 = rec_f.args("filter_mark")
    obj, rel, depth, live, cand, head = args2[:6]
    F, C = obj.shape[0], cand.shape[0]
    match = live & (rel == head[2]) & (depth >= 0)
    n_match = int(match.sum())
    # the hit mask is never read: F1 writes only the slots it finds
    pos = torch.searchsorted(cand, obj[match]).clamp(max=C - 1)
    n_slots = int(torch.unique(pos[cand[pos] == obj[match]]).numel())

    def run(fn):
        a = [x.clone() for x in args2]
        return (fn(*a).to(torch.int32), a[6], a[7])

    timed = [x.clone() for x in args2]
    case = (
        "filter_mark",
        lambda: cuda_ops.filter_mark(*timed),
        lambda: tfk.filter_mark_plain(*timed),
        F * 13 + 20 + C * 4 + n_slots * 4 + 16 + 4,
        F * 4 + n_match * (3 * (C.bit_length() + 1) + 4),
        lambda: max_abs_err(run(cuda_ops.filter_mark), run(tfk.filter_mark_plain)),
        ("filter_mark_staged_kernel", "Memset"),
    )
    return case, (lambda: torch.searchsorted(cand, obj))


def run_closure_kernels(engine, queries):
    from keto_tpu_torch.engine import cuda_ops

    t0 = phase("9b kernels: C1 against its plain version, on a real closure batch")
    engine.closure_enabled = True
    with Recorder(cuda_ops, step=0) as rec:
        engine.check_batch(queries)
    log(f"  kernels phase {time.perf_counter() - t0:.1f} s")
    return rec


def filter_candidates():
    rng = random.Random(77)
    return [f"/d{rng.randrange(N_FOLDERS)}/v{rng.randrange(FILES_PER_FOLDER)}.mp4"
            for _ in range(FILTER_OBJECTS)]


def run_filter_leg(engine, manager, config, subject, objects, namespace, relation, tier,
                   want_kernels):
    """One filter leg's main path once, its launches and tiers, the
    oracle on 200 sampled candidates, check_batch over the same pairs, and
    FILTER_ROUNDS timed calls."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.engine.snapshot import encode_object_column
    from keto_tpu_torch.ketoapi import RelationTuple

    keys = ("filter_vocab", "filter_closure", "filter_frontier", "filter_host")
    before = {k: engine.stats[k] for k in keys}
    cuda_ops.reset_launch_counts()
    verdicts = engine.filter_batch(namespace, relation, subject, objects,
                                   chunk_size=FILTER_CHUNK)  # the main path, once
    torch.cuda.synchronize()
    launches = dict(cuda_ops.launches)
    tiers = {k: engine.stats[k] - before[k] for k in keys}
    if tiers["filter_host"] or tiers[tier] + tiers["filter_vocab"] != len(objects):
        raise AssertionError(f"filter tiers {tiers} over {len(objects)} candidates")
    missing = [k for k in want_kernels if launches[k] == 0]
    stray = [k for k in cuda_ops.KERNELS if k not in want_kernels and launches[k]]
    if missing or stray:
        raise AssertionError(f"filter launches {launches}: missing {missing}, stray {stray}")
    oracle = ReferenceEngine(manager, config)
    sample = random.Random(78).sample(range(len(objects)), 200)
    want = oracle.filter_objects(namespace, relation, subject, [objects[i] for i in sample])
    if [verdicts[i] for i in sample] != want:
        raise AssertionError("sampled filter verdicts differ from the oracle")
    pairs = [RelationTuple(namespace, o, relation, subject_id=subject) for o in objects]
    t = time.perf_counter()
    checks = engine.check_batch(pairs)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t
    if [r.allowed for r in checks] != verdicts:
        raise AssertionError("filter verdicts differ from check_batch over the same pairs")
    lat = []
    for _ in range(FILTER_ROUNDS):
        s = time.perf_counter()
        engine.filter_batch(namespace, relation, subject, objects, chunk_size=FILTER_CHUNK)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - s)
    wall = sum(lat)
    profile = device_profile(lambda: engine.filter_batch(namespace, relation, subject, objects,
                                                         chunk_size=FILTER_CHUNK), "filters")
    view = engine.ensure_state().view
    t = time.perf_counter()
    encode_object_column(view, view.ns_id(namespace), objects)
    encode_ms = (time.perf_counter() - t) * 1e3
    return launches, {
        "profile": profile, "encode_ms": encode_ms,
        "objects_per_s": FILTER_ROUNDS * len(objects) / wall,
        "us_per_object": wall / (FILTER_ROUNDS * len(objects)) * 1e6,
        "p50_filter_ms": statistics.median(lat) * 1e3,
        "check_batch_us_per_object": check_s / len(objects) * 1e6,
        "allowed": sum(verdicts), "tiers": tiers,
        "launches": {k: v for k, v in launches.items() if v},
    }


def run_filter(v_engine, v_manager, v_config, v_subject, d_engine, d_manager, d_config,
               d_subject):
    from keto_tpu_torch.engine import cuda_ops

    t0 = phase(f"10 filter: {FILTER_OBJECTS} candidates, one subject")
    objects = filter_candidates()
    v_engine.closure_enabled = False
    with Recorder(cuda_ops, step=1) as rec_f:
        v_engine.filter_batch("videos", "view", v_subject, objects, chunk_size=FILTER_CHUNK)
    f_launches, frontier = run_filter_leg(
        v_engine, v_manager, v_config, v_subject, objects, "videos", "view", "filter_frontier",
        ("filter_mark", "pair_probe", "reverse_gather", "dedupe_compact"))
    frontier["steps_per_walk"] = f_launches["filter_mark"]
    log(f"  (a) frontier tier, videos-1e6, subject {v_subject}: launches {f_launches}; tiers "
        f"{frontier['tiers']}; {frontier['allowed']} allowed; {frontier['objects_per_s']:.1f} "
        f"objects/s, {frontier['us_per_object']:.3f} us/object (check_batch "
        f"{frontier['check_batch_us_per_object']:.3f} us/object); "
        f"{frontier['steps_per_walk']} steps a walk; candidate encoding "
        f"{frontier['encode_ms']:.2f} ms; idle share {frontier['profile']['idle_share']}")

    chain_rng = random.Random(79)
    heads = [f"c{chain_rng.randrange(DEEP_CHAINS)}f0" for _ in range(FILTER_OBJECTS)]
    d_engine.closure_enabled = True
    with Recorder(cuda_ops, step=0) as rec_fc:
        d_engine.filter_batch("deep", "viewer", d_subject, heads, chunk_size=FILTER_CHUNK)
    c_launches, closure = run_filter_leg(
        d_engine, d_manager, d_config, d_subject, heads, "deep", "viewer", "filter_closure",
        ("closure_probe",))
    if c_launches["closure_probe"] != 1:
        raise AssertionError(f"the closure tier took {c_launches['closure_probe']} C1 launches")
    log(f"  (b) closure tier, deep-1e6, subject {d_subject}: launches {c_launches}; tiers "
        f"{closure['tiers']}; {closure['allowed']} allowed; {closure['objects_per_s']:.1f} "
        f"objects/s, {closure['us_per_object']:.3f} us/object (check_batch "
        f"{closure['check_batch_us_per_object']:.3f} us/object); candidate encoding "
        f"{closure['encode_ms']:.2f} ms; idle share {closure['profile']['idle_share']}")
    log(f"  filter phase {time.perf_counter() - t0:.1f} s")
    return f_launches, rec_f, rec_fc, {"frontier": frontier, "closure": closure}


def run_serve():
    import urllib.error
    import urllib.parse
    import urllib.request

    from keto_tpu_torch.engine.snaptoken import encode_snaptoken

    t0 = phase("6 serve: python -m keto_tpu_torch serve on a free port")
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ns = {"name": "videos", "relations": [
            {"name": "owner"}, {"name": "parent"},
            {"name": "view", "rewrite": {"operator": "or", "children": [
                {"type": "computed_subject_set", "relation": "owner"},
                {"type": "tuple_to_subject_set", "relation": "parent",
                 "computed_subject_set_relation": "view"}]}}]}
        cfg = {"namespaces": [ns], "serve": {"read": {"host": "127.0.0.1", "port": 0}}}
        with open(os.path.join(tmp, "cfg.json"), "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(tmp, "tuples.txt"), "w") as f:
            f.write("videos:/cats#owner@cat lady\n"
                    "videos:/cats/1.mp4#parent@(videos:/cats#...)\n"
                    "videos:/cats/2.mp4#owner@john\n")
        proc = subprocess.Popen(
            [sys.executable, "-m", "keto_tpu_torch", "serve", "--config",
             os.path.join(tmp, "cfg.json"), "--tuples", os.path.join(tmp, "tuples.txt")],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": repo},
        )
        try:
            line = proc.stdout.readline()
            if not line.startswith("serving read="):
                raise AssertionError(f"serve did not start: {line!r} {proc.stderr.read()}")
            base = "http://" + line.split("=", 1)[1].strip()

            def get(params, route="/relation-tuples/check"):
                url = base + route + "?" + urllib.parse.urlencode(params)
                try:
                    with urllib.request.urlopen(url, timeout=60) as r:
                        return r.status, json.loads(r.read())
                except urllib.error.HTTPError as e:
                    return e.code, json.loads(e.read())

            q = {"namespace": "videos", "object": "/cats/1.mp4", "relation": "view"}
            allowed = get({**q, "subject_id": "cat lady"})
            denied = get({**q, "subject_id": "john"})
            req = urllib.request.Request(
                base + "/relation-tuples/check/batch", method="POST",
                data=json.dumps({"tuples": [
                    {**q, "subject_id": "cat lady"},
                    {"namespace": "videos", "object": "/cats/2.mp4", "relation": "view",
                     "subject_id": "john"},
                    {**q, "subject_id": "nobody"},
                ]}).encode(),
            )
            with urllib.request.urlopen(req, timeout=60) as r:
                batch = json.loads(r.read())
            tree = get({"namespace": "videos", "object": "/cats/1.mp4", "relation": "parent"},
                       "/relation-tuples/expand")
            nil = get({"namespace": "videos", "object": "/cats/9.mp4", "relation": "view"},
                      "/relation-tuples/expand")
            objects = get({"namespace": "videos", "relation": "view", "subject_id": "cat lady"},
                          "/relation-tuples/list-objects")
            subjects = get({"namespace": "videos", "object": "/cats/1.mp4", "relation": "view"},
                           "/relation-tuples/list-subjects")
            no_rel = get({"namespace": "videos", "subject_id": "cat lady"},
                         "/relation-tuples/list-objects")
            ahead = get({**q, "subject_id": "cat lady",
                         "snaptoken": encode_snaptoken(99, "default")})
            pinned = get({"namespace": "videos", "relation": "view", "subject_id": "cat lady",
                          "snaptoken": encode_snaptoken(1, "default")},
                         "/relation-tuples/list-objects")
            log(f"  GET allowed -> {allowed}, GET denied -> {denied}, batch -> {batch}, "
                f"expand -> {tree}, expand nil -> {nil}, list-objects -> {objects}, "
                f"list-subjects -> {subjects}, list-objects without relation -> {no_rel}, "
                f"check ahead of the store -> {ahead}, list-objects at v1 -> {pinned}")
            if allowed != (200, {"allowed": True}) or denied != (403, {"allowed": False}):
                raise AssertionError("single checks answered wrongly")
            if [r["allowed"] for r in batch["results"]] != [True, True, False]:
                raise AssertionError("batch check answered wrongly")

            def node(obj, rel):
                return {"namespace": "", "object": "", "relation": "",
                        "subject_set": {"namespace": "videos", "object": obj, "relation": rel}}

            want = (200, {"type": "union", "tuple": node("/cats/1.mp4", "parent"),
                          "children": [{"type": "leaf", "tuple": node("/cats", "...")}]})
            if tree != want:
                raise AssertionError(f"expand answered wrongly: {tree}, want {want}")
            if nil[0] != 404 or nil[1]["error"]["message"] != "no relation tuples found":
                raise AssertionError(f"expand of a nil tree answered wrongly: {nil}")
            if objects != (200, {"objects": ["/cats", "/cats/1.mp4"], "next_page_token": ""}):
                raise AssertionError(f"list-objects answered wrongly: {objects}")
            if subjects != (200, {"subject_ids": ["cat lady"], "next_page_token": ""}):
                raise AssertionError(f"list-subjects answered wrongly: {subjects}")
            if no_rel[0] != 400:
                raise AssertionError(f"list-objects without a relation answered {no_rel}")
            if ahead[0] != 409 or ahead[1]["error"]["status"] != "conflict":
                raise AssertionError(f"a token ahead of the store answered {ahead}")
            if pinned != objects:
                raise AssertionError(f"list-objects at a satisfied token answered {pinned}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()
            proc.stderr.close()
    log(f"  serve phase {time.perf_counter() - t0:.1f} s")


def run_microbench():
    """Phase 11: the tools as subprocesses, then in process (the
    "microbench" launch path), then M1-M10 against their plain versions,
    timed. Returns (launches, kernel rows, the tools' lines)."""
    import contextlib
    import io

    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.tools import microbench as mb
    from keto_tpu_torch.tools import microbench_feasibility as mf

    t0 = phase("11a microbench: both tools as subprocesses")
    repo = os.path.dirname(os.path.abspath(__file__))
    card = torch.cuda.get_device_name(0)
    ops_names = ["probe", "probe_smem", "scatmax", "scatmax_smem", "pack_onepass", "pack",
                 "hashprobe"] + [f"{op}_F{mb.F_LARGE}" for op in ("scatmax", "pack_onepass",
                                                                 "pack")]
    ops_names += ["torch_gather", "torch_scatter_max", "torch_masked_select",
                  f"torch_scatter_max_F{mb.F_LARGE}", f"torch_masked_select_F{mb.F_LARGE}",
                  "device"]

    def check_bench(lines):
        if [line["op"] for line in lines] != ops_names:
            raise AssertionError(f"microbench printed {[line['op'] for line in lines]}")
        for line in lines[:-1]:
            if not (line["ms"] > 0 and line["bound_ms"] > 0):
                raise AssertionError(f"microbench line {line}")
        if card not in lines[-1]["note"]:
            raise AssertionError(f"microbench ran on {lines[-1]['note']}")

    def check_feasibility(lines):
        if len(lines) != 4 or card not in lines[0]["device"] or not all(
                line["ok"] is True for line in lines[1:]):
            raise AssertionError(f"microbench_feasibility printed {lines}")

    tools = {}
    for module, argv, check in (("microbench", ["--n", "20"], check_bench),
                                ("microbench_feasibility", [], check_feasibility)):
        proc = subprocess.run([sys.executable, "-m", f"keto_tpu_torch.tools.{module}", *argv],
                              cwd=repo, capture_output=True, text=True, timeout=300,
                              env={**os.environ, "PYTHONPATH": repo})
        if proc.returncode != 0:
            raise AssertionError(f"{module} exited {proc.returncode}: {proc.stderr[-2000:]}")
        lines = [json.loads(line) for line in proc.stdout.splitlines()]
        check(lines)
        tools[module] = lines
        for line in lines:
            log(f"  {module}: {json.dumps(line)}")

    phase("11b microbench: both entry points in process, the microbench launch path")
    buf = io.StringIO()
    cuda_ops.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        mb.main(["--n", "3"])
        mf.main([])
    torch.cuda.synchronize()
    launches = dict(cuda_ops.launches)
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    check_bench(lines[:len(ops_names)])
    check_feasibility(lines[len(ops_names):])
    log("  launches: " + ", ".join(f"{k} {launches[k]}" for k in cuda_ops.MICROBENCH_KERNELS))
    missing = [k for k in cuda_ops.MICROBENCH_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the microbench path did not launch {missing}")

    phase("11c kernels: M1-M10 against their plain versions")
    inp = mb.make_inputs(mb.F_TOOL, mb.CAP_TOOL)
    inp["keys"] = mb.plant_keys(inp["keys"], inp["qk"], mb.F_TOOL // 4)
    cases = mb.ops(inp, "cuda", large=mb.make_inputs(mb.F_LARGE, mb.CAP_TOOL)) + mf.ops("cuda")
    rows, by_kernel = [], {}
    for o in cases:
        row = time_kernel(o.kernel, o.run, o.plain, o.nbytes, o.ops,
                          lambda o=o: max_abs_err(o.run(), o.plain()), ops_per_s=o.ops_per_s)
        row["library_ms"] = device_ms(o.library) if o.library is not None else None
        row["note"] = o.note
        log(f"  {o.op}: library {row['library_ms']} ms")
        if o.kernel in by_kernel:
            by_kernel[o.kernel]["large"] = {k: row[k] for k in LARGE_KEYS}
        else:
            by_kernel[o.kernel] = row
            rows.append(row)
    log(f"  microbench phase {time.perf_counter() - t0:.1f} s")
    return launches, rows, tools


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device is available: chip_smoke.py needs an NVIDIA card")
        return 1
    t_start = phase("1 card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
    from keto_tpu_torch.storage import MemoryManager

    phase("2 build: one nvcc per source, in parallel, then one link")
    path = cuda_ops.build(force=True)
    cuda_ops.library()
    log(f"  built {os.path.relpath(path)} in {cuda_ops.build_info['seconds']:.1f} s")

    phase(f"4a data: {N_FOLDERS} folders x {FILES_PER_FOLDER} files into the store")
    t = time.perf_counter()
    tuples, queries = build_dataset(N_FOLDERS, FILES_PER_FOLDER)
    config = Config({"limit": {"max_read_depth": MAX_DEPTH}})
    config.set_namespaces([videos_namespace()])
    manager = MemoryManager()
    manager.write_relation_tuples(tuples)
    t_store = time.perf_counter() - t
    engine = TorchCheckEngine(manager, config, device="cuda", frontier_cap=2 * BATCH)
    t = time.perf_counter()
    state = engine.ensure_state()
    torch.cuda.synchronize()
    t_mirror = time.perf_counter() - t
    nbytes = engine.tables_nbytes()
    snap = state.snapshot
    log(f"  {len(tuples)} tuples: store {t_store:.1f} s, snapshot + upload {t_mirror:.1f} s "
        f"({snap.layout}, dh_probes {snap.dh_probes}, rh_probes {snap.rh_probes}, K {snap.K})")
    log(f"  device tables {sum(nbytes.values()) / 1e6:.1f} MB: "
        + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in sorted(nbytes.items())))
    owners = ownership(tuples)
    del tuples

    rows = run_kernels(engine, queries)
    launches, check = run_check(engine, queries, manager, config)
    profile = run_profile(engine, queries)
    run_islands()
    run_serve()
    # the expand phase's store joins only now, so the check phases run in
    # the same process state as before the expand slice existed
    x_engine, x_manager, x_config, subjects, x_info = setup_expand()
    # both stores' ~2M tuple objects stay for the rest of the run: move
    # them out of the collector's scans, as a server does after loading,
    # so a full collection does not land inside a timed batch
    gc.collect()
    gc.freeze()
    x_rows, k2_at = run_expand_kernels(x_engine, subjects)
    rows += x_rows
    next(row for row in rows if row["name"] == "pair_probe")["at"].update(k2_at)
    x_launches, expand = run_expand(x_engine, x_manager, x_config, subjects, x_info)
    # the list phases run on phase 4's store and engine
    lo_queries, ls_queries = list_queries()
    l_info = setup_list(engine)
    list_rows, dedupe_large, k2_at = run_list_kernels(engine, lo_queries, ls_queries)
    next(row for row in rows if row["name"] == "dedupe_compact")["large"] = dedupe_large
    next(row for row in rows if row["name"] == "pair_probe")["at"].update(k2_at)
    rows += list_rows
    lo_launches, list_objects = run_list_objects(engine, manager, config, lo_queries, owners)
    ls_launches, list_subjects = run_list_subjects(engine, manager, config, ls_queries)
    # the closure phase's deep store joins now; the filter phase runs on
    # phase 4's engine (reverse state from phase 8) and on phase 9's
    d_engine, d_manager, d_config, d_owners, d_queries, b_launches, d_info = setup_closure()
    gc.collect()
    gc.freeze()
    wave_args, wave_rows, powering = run_powering(d_engine)
    phase("9q kernels: P1-P3 against their plain versions, on the widest wave")
    p_cases, segment_max = power_kernel_cases(wave_args, wave_rows)
    for case in p_cases:
        rows.append(time_kernel(*case))
    rows[-3]["library_ms"] = device_ms(segment_max)
    log(f"  scatter_reduce amax over P1's unpacked planes: {rows[-3]['library_ms']:.5f} ms")
    del wave_args, p_cases, segment_max
    rec_c = run_closure_kernels(d_engine, d_queries)
    c_launches, closure = run_closure(d_engine, d_manager, d_config, d_queries)
    folders_of = owners[0]
    v_subject = next(u for u, ds in folders_of.items() if "/d0" in ds)
    f_launches, rec_f, rec_fc, filt = run_filter(engine, manager, config, v_subject, d_engine,
                                                 d_manager, d_config, d_owners[0])
    f1_case, searchsorted = filter_mark_case(rec_f)
    phase("10c kernels: C1 and F1 against their plain versions; C1 at the closure-tier "
          "filter's launch, K2 at the filter walk's step-1 launch")
    case, shape = closure_case(*rec_c.args("closure_probe"), "a closure batch of deep-1e6")
    rows.append({**time_kernel(*case), **{k: v for k, v in shape.items() if k != "note"}})
    log(f"  C1 at a closure batch: {shape}")
    rows[-1]["at"] = {"filter_closure": time_closure_probe(
        *rec_fc.args("closure_probe"), "the closure-tier filter's launch")}
    rows.append(time_kernel(*f1_case))
    rows[-1]["library_ms"] = device_ms(searchsorted)
    log(f"  torch.searchsorted on F1's (cand, obj): {rows[-1]['library_ms']:.5f} ms")
    # the walk's pair_probe call 0 is the seed probe, call 1 step 1's rvh
    # span probe, on the frontier reverse_gather's call 0 reads
    rstate = engine.ensure_reverse_state()
    args2, kw2 = expect_probe(*rec_f.args("pair_probe"), rstate.reverse_tables["rvh_pack"],
                              rstate.reverse_np["rvh_probes"], "the filter walk's step-1 span probe")
    next(row for row in rows if row["name"] == "pair_probe")["at"]["filter_step1"] = \
        time_pair_probe(args2, kw2, rec_f.calls["reverse_gather"][0][0][4],
                        "the filter walk's step-1 launch")
    m_launches, m_rows, tools = run_microbench()
    rows += m_rows
    by_path = {"check": launches, "expand": x_launches, "list_objects": lo_launches,
               "list_subjects": ls_launches, "closure_build": b_launches, "closure": c_launches,
               "filter": f_launches, "microbench": m_launches}
    # each kernel's count on its own path: check for K1-K4, expand for X1
    # and X2, ListObjects for L1, L2 and L4, ListSubjects for L3, closure
    # for C1, filter for F1, closure_build for P1-P3, microbench for
    # M1-M10; K2, K4, L1, L2 and L4 run on several
    own = {name: "expand" for name in cuda_ops.EXPAND_KERNELS}
    own.update({name: "closure_build" for name in cuda_ops.POWER_KERNELS})
    own.update({name: "microbench" for name in cuda_ops.MICROBENCH_KERNELS})
    own.update(list_emit="list_objects", reverse_gather="list_objects",
               list_pool_compact="list_objects", subjects_gather="list_subjects",
               closure_probe="closure", filter_mark="filter")
    if sorted(row["name"] for row in rows) != sorted(cuda_ops.KERNELS):
        raise AssertionError(f"the kernel table lists {[row['name'] for row in rows]}")
    for row in rows:
        row["launches"] = by_path[own.get(row["name"], "check")][row["name"]]
        row["launches_by_path"] = {path: counts[row["name"]] for path, counts in by_path.items()}

    log(json.dumps({"check": {**check, "card": smi, "tuples": snap.n_tuples,
                              "device_table_bytes": sum(nbytes.values()),
                              "profile": profile}}))
    log(json.dumps({"expand": {**expand, "card": smi}}))
    log(json.dumps({"list": {**l_info, "card": smi, "list_objects": list_objects,
                             "list_subjects": list_subjects,
                             "caps": {"list_objects": LO_CAPS, "list_subjects": LS_CAPS}}}))
    log(json.dumps({"closure": {**d_info, **closure, "powering": powering, "card": smi}}))
    log(json.dumps({"filter": {**filt, "card": smi}}))
    log(json.dumps({"microbench": {**tools, "card": smi}}))
    log(f"profile windows whose records were not whole launches: {PROFILE_WINDOWS['short']} of "
        f"{PROFILE_WINDOWS['timed']}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)

"""Smoke run of keto_tpu_torch on one NVIDIA card: the quickest proof that
the port builds, agrees with itself and runs its main path on the GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

  1. card    — nvidia-smi's name and power limit
  2. build   — nvcc builds csrc/check_kernels.cu from the checkout
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card, on inputs captured from one real batch of phase 4's
               workload over its tables; exact equality, times, bounds
  4. check   — the main path: ~1e6 tuples (the benchmark's videos
               namespace, view = owner | parent->view, 6,600 folders x
               120 files) into the store, TorchCheckEngine(device="cuda"),
               batches of 4096 checks; zero host replays, every kernel's
               launch count advanced, 512 sampled verdicts equal the host
               oracle's; checks/s and p50 batch ms
  5. islands — an AND/NOT namespace batch against the host oracle
  6. serve   — `python -m keto_tpu_torch serve` on a free port: a 200, a
               403 and a batch check

Before the last line it prints the kernel table as one JSON object
({"kernels": [...]}); the last line is {"ok": true, "device": {...}}.
A kernel's bound is the larger of its bytes over the H100 SXM's
3.35 TB/s and its 32-bit integer operations over the card's INT32 rate.
A kernel's "ms" is device time per call from the profiler; "wall_ms" is
the wrapper's time per call between CUDA events, host enqueue included.
"""

from __future__ import annotations

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
KERNEL_SOURCE = "keto_tpu_torch/csrc/check_kernels.cu"
REPLACES = {
    "edge_probe": "keto_tpu/engine/kernel.py:259",
    "pair_probe": "keto_tpu/engine/kernel.py:298",
    "expand_gather": "keto_tpu/engine/kernel.py:520",
    "dedupe_compact": "keto_tpu/engine/kernel.py:762",
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


# -- kernels: capture, compare, time -------------------------------------------


class Recorder:
    """Wraps the cuda_ops wrappers during one batch and keeps a clone of
    the arguments of each kernel's call at BFS step `step` (or its last
    call, for a shorter walk)."""

    def __init__(self, cuda_ops, step: int = 1):
        self.cuda_ops = cuda_ops
        self.step = step
        self.calls: dict = {}
        self.originals: dict = {}

    def __enter__(self):
        import torch

        def clone(x):
            return x.clone() if isinstance(x, torch.Tensor) else x

        for name in self.cuda_ops.KERNELS:
            orig = getattr(self.cuda_ops, name)
            self.originals[name] = orig

            def wrapped(*args, _name=name, _orig=orig, **kw):
                seen = self.calls.setdefault(_name, [])
                if len(seen) <= self.step:
                    seen.append(([clone(a) for a in args], dict(kw)))
                return _orig(*args, **kw)

            setattr(self.cuda_ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self.originals.items():
            setattr(self.cuda_ops, name, orig)

    def args(self, name):
        return self.calls[name][min(self.step, len(self.calls[name]) - 1)]


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call: the profiler's self device time of every
    kernel the calls launched, over `reps` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(evt.self_device_time_total for evt in prof.key_averages()
                  if evt.device_type == DeviceType.CUDA)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    return busy_us / 1e3 / reps


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


def kernel_cases(rec, snap, tables):
    """(name, kernel fn, plain fn, bytes the function must move, 32-bit
    operations it does) for each kernel on the captured inputs. Bytes
    count each input read once and each output written once. Probe rows
    and gathers count only what this step's data needs: bucket rows for
    the keys of tasks that are live with depth >= 1 (K1: the task's edge
    key; K2: slot 0 and its TTU slots; computed slots and dead tasks need
    no span), and for K3 the segments and sources of the candidates that
    land in the frontier."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import kernel as tk
    from keto_tpu_torch.engine.snapshot import INSTR_NONE, INSTR_TTU

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
    ))

    args2, kw2 = rec.args("pair_probe")
    pack, pobj, rels = args2
    Fp, S = rels.shape
    if not torch.equal(pobj, obj):
        raise AssertionError("pair_probe's capture is not from edge_probe's step")
    _ns, has_prog, pid, _flags = tk.program_lookup(
        tables, obj, rel, live, n_config_rels=max(snap.n_config_rels, 1))
    ipack = tables["instr_pack"][pid.long()].reshape(F, snap.K, 4)
    ik = torch.where(has_prog[:, None], ipack[..., 0], INSTR_NONE)
    n_keys = n_probe + int(((ik == INSTR_TTU) & expand[:, None]).sum())
    pb2 = -(-kw2["probes"] // kw2["spb"])
    cases.append((
        "pair_probe",
        lambda: cuda_ops.pair_probe(*args2, **kw2),
        lambda: tk.pair_probe_plain(*args2, **kw2),
        Fp * 4 + Fp * S * 4 + Fp * S * kw2["n_vals"] * 4 + n_keys * pb2 * kw2["spb"] * 16,
        n_keys * (3 * HASH_OPS + pb2 * kw2["spb"] * 4),
    ))

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

    cases.append((
        "expand_gather",
        lambda: cuda_ops.expand_gather(*args3, **kw3),
        plain3,
        # counts scanned whole; starts, slot_ctx, crel, is_comp and the
        # task's q, obj, depth gathered once per landed candidate; one
        # e_pack pair per edge candidate; six [F] columns and the causes out
        F3 * S3 * 4 + 7 * n_out * 4 + n_edge_out * 8
        + 5 * F3 * 4 + F3 + kw3["n_queries"] * 4,
        F3 * S3 * 3 + n_out * (2 * (F3 * S3).bit_length() + 20),
    ))

    args4, kw4 = rec.args("dedupe_compact")
    G = args4[0].shape[0]

    def plain4():
        return tk.dedupe_compact_plain(tk.Expansion(*args4), **kw4)

    cases.append((
        "dedupe_compact",
        lambda: cuda_ops.dedupe_compact(*args4, **kw4),
        plain4,
        G * (5 * 4 + 1) + kw4["F"] * 5 * 4 + 4 + kw4["n_queries"] * 4,
        G * (2 * (3 * HASH_OPS + 10) + 3),
    ))
    return cases


# -- phases ------------------------------------------------------------------------


def run_kernels(engine, queries):
    from keto_tpu_torch.engine import cuda_ops

    t0 = phase("3 kernels: each CUDA kernel against its plain version, on a real batch")
    with Recorder(cuda_ops, step=1) as rec:
        engine.check_batch(queries, MAX_DEPTH)
    rows = []
    state = engine.ensure_state()
    for name, kernel, plain, nbytes, ops in kernel_cases(rec, state.snapshot, state.tables):
        err = max_abs_err(kernel(), plain())
        ms, plain_ms = device_ms(kernel), device_ms(plain)
        k_wall, p_wall = wall_ms(kernel), wall_ms(plain)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / OPS_INT32_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"  {name}: max_abs_err {err}, device ms: kernel {ms:.5f}, plain {plain_ms:.5f}; "
            f"wall ms: kernel {k_wall:.5f}, plain {p_wall:.5f}; "
            f"bound {bound_ms:.6f} ms by {bound_by} ({nbytes} B, {ops} ops)")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version: {err}")
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "wall_ms": k_wall, "plain_wall_ms": p_wall,
            "bytes": nbytes, "ops": ops,
        })
    log(f"  kernels phase {time.perf_counter() - t0:.1f} s")
    return rows


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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
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


def run_profile(engine, queries):
    """Where one batch's time goes: host stages (query encoding, the step
    loop with its kernels, the resolve readback) and, from the profiler,
    device time by kernel over two batches and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    def two_batches() -> float:
        s = time.perf_counter()
        for _ in range(2):
            engine.check_batch(queries, MAX_DEPTH)
        torch.cuda.synchronize()
        return (time.perf_counter() - s) * 1e3

    # the idle share divides the profiled busy time by an unprofiled wall
    # time of the same two batches: the profiler's per-op host cost would
    # inflate the wall time it sees
    wall_ms = statistics.median(two_batches() for _ in range(5))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = two_batches()
    rows = [
        (evt.key, evt.self_device_time_total / 1e3, evt.count)
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    out = {"host_stages_ms": host, "wall_ms_2_batches": wall_ms,
           "profiled_wall_ms_2_batches": profiled_wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / wall_ms, "n_device_kernels": sum(r[2] for r in rows),
           "top": [{"name": k[:70], "ms": ms, "count": c} for k, ms, c in rows[:10]]}
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


def run_serve():
    import urllib.error
    import urllib.parse
    import urllib.request

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

            def get(params):
                url = base + "/relation-tuples/check?" + urllib.parse.urlencode(params)
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
            log(f"  GET allowed -> {allowed}, GET denied -> {denied}, batch -> {batch}")
            if allowed != (200, {"allowed": True}) or denied != (403, {"allowed": False}):
                raise AssertionError("single checks answered wrongly")
            if [r["allowed"] for r in batch["results"]] != [True, True, False]:
                raise AssertionError("batch check answered wrongly")
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

    phase("2 build")
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
    del tuples

    rows = run_kernels(engine, queries)
    launches, check = run_check(engine, queries, manager, config)
    for row in rows:
        row["launches"] = launches[row["name"]]
    profile = run_profile(engine, queries)
    run_islands()
    run_serve()

    log(json.dumps({"check": {**check, "card": smi, "tuples": snap.n_tuples,
                              "device_table_bytes": sum(nbytes.values()),
                              "profile": profile}}))
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

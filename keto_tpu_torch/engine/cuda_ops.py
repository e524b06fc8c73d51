"""Loader and wrappers of the CUDA kernels (csrc/*.cu).

The first call builds every CUDA source with nvcc, one compiler process
per source, all started together, and links the objects into one shared
library with a plain C interface under keto_tpu_torch/_build/ (named by
the content hash of every source, so an edited source rebuilds); ctypes
binds it. Nothing is built or loaded at import time.

Each wrapper checks device, type, shape and contiguity, allocates the
outputs, launches on PyTorch's current stream without synchronising,
raises if the launch reported an error, and adds one to its entry in
`launches`. Scratch buffers a wrapper allocates may be dropped when it
returns: PyTorch's caching allocator hands their memory out again only in
stream order, after the launch. The wrappers take CUDA tensors only; the
plain versions for CPU tensors live beside the dispatchers in
engine/kernel.py, engine/expand_kernel.py, engine/reverse_kernel.py,
engine/closure_kernel.py, engine/filter_kernel.py,
engine/closure_power.py and tools/microbench.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(
    _PKG / "csrc" / name
    for name in ("check_kernels.cu", "expand_kernels.cu", "list_kernels.cu",
                 "closure_filter_kernels.cu", "closure_power_kernels.cu",
                 "microbench_kernels.cu")
)
# headers the sources include: part of the library's content hash
HEADERS = tuple(_PKG / "csrc" / name
                for name in ("probe.cuh", "scan.cuh", "reduce.cuh", "keyed_rank.cuh",
                             "pool.cuh", "lookback.cuh"))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

CHECK_KERNELS = ("edge_probe", "pair_probe", "expand_gather", "dedupe_compact")
EXPAND_KERNELS = ("expand_emit", "pool_compact")
LIST_KERNELS = ("list_emit", "reverse_gather", "subjects_gather", "list_pool_compact")
CLOSURE_KERNELS = ("closure_probe",)
FILTER_KERNELS = ("filter_mark",)
POWER_KERNELS = ("power_step", "power_account", "power_poison")
# M1-M10: the primitives of the TPU microbenchmarks (tools/microbench.py)
MICROBENCH_KERNELS = ("mb_probe", "mb_probe_smem", "mb_scatmax", "mb_scatmax_smem",
                      "mb_pack_onepass", "mb_pack", "mb_hashprobe", "mb_add", "mb_row_gather",
                      "mb_block_gather")
KERNELS = (CHECK_KERNELS + EXPAND_KERNELS + LIST_KERNELS + CLOSURE_KERNELS + FILTER_KERNELS
           + POWER_KERNELS + MICROBENCH_KERNELS)
launches = {name: 0 for name in KERNELS}
# the largest dynamic shared memory one block may take on Hopper, less
# the kernels' static shared memory
MAX_DYNAMIC_SMEM = 232448 - 1024
# the most tiles K3's and K4's multi-block scans cut their input into
# (csrc/scan.cuh kMaxTiles): the size of their tile-sum scratch
SCAN_MAX_TILES = 1024
# P1-P3 index in 32 bits: N * W, E * W and the level plane's D * 32 W must
# stay below this, as must K2's F * S. The wrappers refuse a call that
# reaches it, and the wave plan (closure_power.power_closure_device) a
# wave that would.
INDEX_LIMIT = 2**31

_lib = None
_lock = threading.Lock()
_launches_mu = threading.Lock()
build_info: dict = {}
# the scratch words of csrc/reduce.cuh's last-block sums, one pair per
# (device, stream): see grid_scratch
_grid_scratch: dict = {}
# P1's and P3's accumulator and P1's lists, one pair per (device,
# stream): see power_scratch
_power_scratch: dict = {}
# M5's look-back scratch and the epoch of its last call, one pair per
# (device, stream): see onepass_scratch
_onepass_scratch: dict = {}
# M6's capacity in inputs, per device index: see pack_capacity
_pack_capacity: dict = {}
# the epochs a look-back status word carries (csrc/lookback.cuh): after
# the last, the next call zeroes the words and starts again at 1
ONEPASS_EPOCHS = (1 << 30) - 1


def reset_launch_counts() -> None:
    for name in KERNELS:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libketo_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the kernels unless this source set's library exists (or
    `force`). Returns its path; `build_info` records the seconds and the
    compiler output."""
    out = library_path()
    if out.exists() and not force:
        build_info.setdefault("seconds", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [(src.name, log) for src, p, log in zip(SOURCES, procs, logs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n}:\n{log}" for n, log in failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0,
                      log="".join(logs) + proc.stderr + proc.stdout)
    return out


_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "keto_edge_probe": [_VP, _LL, _VP, _LL, _I, _I, _I, _I, _VP, _VP, _VP, _VP, _VP,
                        _VP, _VP, _I, _VP],
    "keto_pair_probe": [_VP, _LL, _I, _I, _VP, _VP, _I, _I, _I, _VP, _VP],
    "keto_expand_gather": [_VP] * 9 + [_I] * 5 + [_VP] * 11,
    "keto_dedupe_compact": [_VP] * 6 + [_I] * 5 + [_VP] * 11,
    "keto_expand_emit_scratch": [_I, _I],
    "keto_expand_emit": [_VP] * 8 + [_I] + [_VP] * 3 + [_I] * 4 + [_VP] * 15,
    "keto_pool_scratch": [_I],
    "keto_pool_compact": [_VP] * 9 + [_I] * 3 + [_VP] * 3,
    "keto_list_emit_scratch": [_I, _I],
    "keto_list_emit": [_VP] * 3 + [_I] * 3 + [_VP] * 7,
    "keto_gather_scratch": [_I],
    "keto_reverse_gather": [_VP] * 9 + [_I] + [_VP] + [_I] + [_VP] + [_I] * 5 + [_VP] * 8,
    "keto_subjects_gather": [_VP] * 8 + [_I] + [_VP] + [_I] * 4 + [_VP] * 10,
    "keto_list_pool_compact": [_VP] * 4 + [_I] * 3 + [_VP] * 3,
    "keto_closure_probe": [_VP, _LL, _I, _VP, _LL, _I, _I, _I, _VP, _LL, _I, _I, _VP, _I, _VP,
                           _VP, _VP],
    "keto_filter_mark": [_VP] * 4 + [_I, _VP, _I] + [_VP] * 6,
    "keto_power_step_scratch": [_I] * 3,
    "keto_power_step": [_VP] * 4 + [_I] * 3 + [_VP] * 7,
    "keto_power_account": [_VP] * 4 + [_I] * 5 + [_VP] * 4,
    "keto_power_poison": [_VP] * 4 + [_I] * 2 + [_VP] * 4,
    "keto_mb_probe": [_VP, _VP, _I, _VP, _VP],
    "keto_mb_probe_smem": [_VP, _I, _VP, _I, _VP, _VP],
    "keto_mb_scatmax_scratch": [_I, _I],
    "keto_mb_scatmax": [_VP, _VP, _I, _VP, _I, _VP, _VP],
    "keto_mb_scatmax_smem_capacity": [],
    "keto_mb_scatmax_smem": [_VP, _VP, _I, _VP, _I, _VP],
    "keto_mb_pack_tiles": [_I],
    "keto_mb_pack_onepass": [_VP, _VP, _I, _VP, _VP, _VP, _I, _VP],
    "keto_mb_pack_capacity": [],
    "keto_mb_pack": [_VP, _VP, _I, _VP, _VP, _VP, _VP],
    "keto_mb_hashprobe": [_VP, _VP, _I, _VP, _I, _VP, _VP],
    "keto_mb_add": [_VP, _VP, _I, _VP, _VP],
    "keto_mb_row_gather": [_VP, _I, _VP, _I, _VP, _VP],
    "keto_mb_block_gather": [_VP, _I, _VP, _I, _VP, _VP],
}


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name in ("keto_expand_emit_scratch", "keto_list_emit_scratch",
                         "keto_gather_scratch", "keto_power_step_scratch",
                         "keto_pool_scratch", "keto_mb_scatmax_scratch",
                         "keto_mb_pack_capacity"):
                getattr(lib, name).restype = ctypes.c_longlong
            lib.keto_error_string.argtypes = [ctypes.c_int]
            lib.keto_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {lib.keto_error_string(rc).decode()}")
    # the serving plane launches from several threads at once
    with _launches_mu:
        launches[name] += 1


def _p(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def grid_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The two 64-bit scratch words of csrc/reduce.cuh's last-block sums
    (F1's, P2's and L1's grid sums and P3's ticket in the first, C1's two
    counts one in each) on `device` for launches on `stream`
    (a cuda_stream handle): zeroed once here, and left at zero by every
    launch that uses them. Launches on one stream run one after the
    other, so they may share them; another stream gets its own, so no two
    launches in flight do."""
    key = (device.index, stream)
    t = _grid_scratch.get(key)
    if t is None:
        with _lock:
            t = _grid_scratch.get(key)
            if t is None:
                t = _grid_scratch[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return t


def power_scratch(device: torch.device, stream: int, acc_words: int = 0,
                  list_ints: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """P1's and P3's scratch on `device` for launches on `stream`: an int32
    accumulator of at least acc_words words (P1's [N, W], P3's W), zeroed
    when it is allocated and left at zero by every launch (P1's walk and
    P3's last block return each word they read to zero), and P1's int32
    lists of at least list_ints ints, written before they are read, so
    never reset. Each grows to the largest call it has served. As for
    grid_scratch, launches on one stream may share them and another stream
    gets its own."""
    key = (device.index, stream)
    got = _power_scratch.get(key)
    if got is None or got[0].numel() < acc_words or got[1].numel() < list_ints:
        with _lock:
            acc, lists = _power_scratch.get(key) or (None, None)
            if acc is None or acc.numel() < acc_words:
                acc = torch.zeros(acc_words, dtype=torch.int32, device=device)
            if lists is None or lists.numel() < list_ints:
                lists = torch.empty(list_ints, dtype=torch.int32, device=device)
            got = _power_scratch[key] = (acc, lists)
    return got


def _require(name: str, dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expects CUDA tensors, got one on {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expects {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def _require_pack(name: str, pack: torch.Tensor, width: int, spb: int) -> None:
    _require(name, torch.int32, pack)
    if pack.dim() != 2 or pack.shape[1] != width or pack.shape[0] % spb:
        raise ValueError(f"{name}: expects a [cap, {width}] table with cap % {spb} == 0")
    if pack.data_ptr() % 16:
        raise ValueError(f"{name}: table must be 16-byte aligned")


def edge_probe(dh_pack, dd_pack, obj, rel, q, qsub, depth, live, *,
               dh_probes: int, spb: int, has_delta: bool) -> torch.Tensor:
    """K1: hit[F] (bool) of the direct-edge probe, overlay and liveness fused."""
    from .delta import DELTA_PROBES

    name = "edge_probe"
    _require_pack(name, dh_pack, 8, spb)
    if has_delta:
        _require_pack(name, dd_pack, 8, spb)
    _require(name, torch.int32, obj, rel, q, qsub, depth)
    _require(name, torch.bool, live)
    F = obj.shape[0]
    if qsub.dim() != 2 or qsub.shape[1] != 4 or qsub.data_ptr() % 16:
        raise ValueError(f"{name}: qsub must be an aligned [B, 4] int32 tensor")
    hit = torch.empty(F, dtype=torch.bool, device=obj.device)
    lib = library()
    rc = lib.keto_edge_probe(
        _p(dh_pack), dh_pack.shape[0], _p(dd_pack) if has_delta else None,
        dd_pack.shape[0] if has_delta else 0, spb, dh_probes, DELTA_PROBES,
        int(has_delta), _p(obj), _p(rel), _p(q), _p(qsub), _p(depth), _p(live),
        _p(hit), F, _stream(),
    )
    _check(lib, rc, name)
    return hit


def pair_probe(pack, obj, rels, *, probes: int, spb: int, n_vals: int) -> torch.Tensor:
    """K2: [F, S, n_vals] value lanes of the (obj, rel) probe, for every
    (task, slot); equal keys of a warp share one probe."""
    name = "pair_probe"
    _require_pack(name, pack, 4, spb)
    _require(name, torch.int32, obj, rels)
    if n_vals not in (1, 2):
        raise ValueError(f"{name}: n_vals must be 1 or 2")
    if spb & (spb - 1):
        raise ValueError(f"{name}: slots per bucket must be a power of two, got {spb}")
    F, S = rels.shape
    if F * S >= INDEX_LIMIT:
        raise ValueError(f"{name}: F * S must stay below 2^31, got {F * S}")
    out = torch.empty(F, S, n_vals, dtype=torch.int32, device=obj.device)
    lib = library()
    rc = lib.keto_pair_probe(
        _p(pack), pack.shape[0], spb, probes, _p(obj), _p(rels), F, S, n_vals,
        _p(out), _stream(),
    )
    _check(lib, rc, name)
    return out


def expand_gather(counts, starts, slot_ctx, crel, is_comp, q, obj, depth, e_pack, *,
                  wildcard_rel: int, n_queries: int):
    """K3: the candidate columns (q, ctx, obj, rel, depth, valid) in scan
    order, and the per-query frontier-overflow causes."""
    name = "expand_gather"
    _require(name, torch.int32, counts, starts, slot_ctx, crel, is_comp, q, obj, depth, e_pack)
    F, S = counts.shape
    for t in (starts, slot_ctx, crel, is_comp):
        if t.shape != counts.shape:
            raise ValueError(f"{name}: per-slot inputs must all be [F, S]")
    dev = counts.device
    offsets = torch.empty(F * S, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(SCAN_MAX_TILES, dtype=torch.int32, device=dev)
    overflow = torch.empty(n_queries, dtype=torch.int32, device=dev)
    cols = [torch.empty(F, dtype=torch.int32, device=dev) for _ in range(5)]
    valid = torch.empty(F, dtype=torch.bool, device=dev)
    lib = library()
    rc = lib.keto_expand_gather(
        _p(counts), _p(starts), _p(slot_ctx), _p(crel), _p(is_comp), _p(q), _p(obj),
        _p(depth), _p(e_pack), e_pack.shape[0], F, S, n_queries, wildcard_rel,
        _p(offsets), _p(total), _p(tile_sums), _p(overflow), *(_p(c) for c in cols),
        _p(valid), _stream(),
    )
    _check(lib, rc, name)
    return (*cols, valid, overflow)


def dedupe_compact(q, ctx, obj, rel, depth, valid, *, F: int, n_queries: int):
    """K4: (q, ctx, obj, rel, depth) of the next [F] frontier, n_new
    (0-d), and the per-query frontier-overflow causes."""
    from .kernel import dedupe_bits, dedupe_capacity

    name = "dedupe_compact"
    _require(name, torch.int32, q, ctx, obj, rel, depth)
    _require(name, torch.bool, valid)
    G = q.shape[0]
    idx_bits = dedupe_bits(G)
    cap = dedupe_capacity(G)
    dev = q.device
    winner = torch.empty(cap, dtype=torch.int32, device=dev)
    keep = torch.empty(G, dtype=torch.uint8, device=dev)
    tile_counts = torch.empty(SCAN_MAX_TILES, dtype=torch.int32, device=dev)
    overflow = torch.empty(n_queries, dtype=torch.int32, device=dev)
    cols = [torch.empty(F, dtype=torch.int32, device=dev) for _ in range(5)]
    n_new = torch.empty(1, dtype=torch.int32, device=dev)
    lib = library()
    rc = lib.keto_dedupe_compact(
        _p(q), _p(ctx), _p(obj), _p(rel), _p(depth), _p(valid), G, F, n_queries, cap,
        idx_bits, _p(winner), _p(keep), _p(tile_counts), _p(overflow),
        *(_p(c) for c in cols), _p(n_new), _stream(),
    )
    _check(lib, rc, name)
    return (*cols, n_new.reshape(()), overflow)


def expand_emit(t_q, t_obj, t_rel, t_depth, live, row, dirty, f_row_ptr, f_skind, f_sa, f_sb,
                eb, eb_count, needs_host, *, edge_cap: int):
    """X1: one expand step's emission. Updates the five [B*E] buffers,
    eb_count and needs_host in place; returns the [4F] child candidates
    (q, ctx, obj, rel, depth, valid), ctx being q, and the step's
    emitted-edge count (0-d)."""
    from .expand_kernel import EMIT_PER_TASK

    name = "expand_emit"
    _require(name, torch.int32, t_q, t_obj, t_rel, t_depth, row, dirty, f_row_ptr, f_skind,
             f_sa, f_sb, eb_count, *eb)
    _require(name, torch.bool, live, needs_host)
    F, B, E = t_q.shape[0], eb_count.shape[0], edge_cap
    if any(t.shape != (F,) for t in (t_obj, t_rel, t_depth, live, row, dirty)):
        raise ValueError(f"{name}: task columns must all be [F]")
    if len(eb) != 5 or any(c.shape != (B * E,) for c in eb) or needs_host.shape != (B,):
        raise ValueError(f"{name}: expects five [B * edge_cap] buffers and [B] flags")
    if not (f_skind.shape == f_sa.shape == f_sb.shape) or f_row_ptr.dim() != 1:
        raise ValueError(f"{name}: malformed CSR columns")
    if F == 0 or B == 0:
        raise ValueError(f"{name}: expects a frontier and queries, got F = {F}, B = {B}")
    G = EMIT_PER_TASK * F
    dev = t_q.device
    lib = library()
    scratch = torch.empty(lib.keto_expand_emit_scratch(F, B), dtype=torch.int32, device=dev)
    emitted = torch.empty(1, dtype=torch.int32, device=dev)
    c_q, c_obj, c_rel, c_depth = (torch.empty(G, dtype=torch.int32, device=dev) for _ in range(4))
    c_valid = torch.empty(G, dtype=torch.bool, device=dev)
    rc = lib.keto_expand_emit(
        _p(t_q), _p(t_obj), _p(t_rel), _p(t_depth), _p(live), _p(row), _p(dirty),
        _p(f_row_ptr), f_row_ptr.shape[0] - 1, _p(f_skind), _p(f_sa), _p(f_sb),
        f_skind.shape[0], F, B, E, *(_p(c) for c in eb), _p(eb_count), _p(needs_host),
        _p(scratch), _p(emitted), _p(c_q), _p(c_obj), _p(c_rel), _p(c_depth), _p(c_valid),
        _stream(),
    )
    _check(lib, rc, name)
    return c_q, c_q, c_obj, c_rel, c_depth, c_valid, emitted.reshape(())


def _pool_scratch(lib, B: int, dev) -> torch.Tensor | None:
    """L4's and X2's scratch: tile sums for a batch of more queries than
    one block's shared memory holds, else none."""
    n = lib.keto_pool_scratch(B)
    return torch.empty(n, dtype=torch.int32, device=dev) if n else None


def pool_compact(eb, eb_count, root, needs_host, stats, *, edge_cap: int, pool_cap: int):
    """X2: the packed expand result [offsets(B+1) | root(B) | needs_host(B)
    | stats | pool(pool_cap * 5)] from the edge buffers."""
    from .kernel import N_LAUNCH_STATS

    name = "pool_compact"
    _require(name, torch.int32, eb_count, stats, *eb)
    _require(name, torch.bool, root, needs_host)
    B, E = eb_count.shape[0], edge_cap
    if len(eb) != 5 or any(c.shape != (B * E,) for c in eb):
        raise ValueError(f"{name}: expects five [B * edge_cap] buffers")
    if B == 0 or root.shape != (B,) or needs_host.shape != (B,):
        raise ValueError(f"{name}: expects [B] root and needs_host flags, B > 0")
    if stats.shape != (N_LAUNCH_STATS,):
        raise ValueError(f"{name}: expects [{N_LAUNCH_STATS}] stats")
    dev = eb_count.device
    out = torch.empty(3 * B + 1 + N_LAUNCH_STATS + 5 * pool_cap, dtype=torch.int32, device=dev)
    lib = library()
    rc = lib.keto_pool_compact(
        *(_p(c) for c in eb), _p(eb_count), _p(root), _p(needs_host), _p(stats), B, E,
        pool_cap, _p(_pool_scratch(lib, B, dev)), _p(out), _stream(),
    )
    _check(lib, rc, name)
    return out


def list_emit(q, emit, value, res, res_count, needs_host, *, result_cap: int):
    """L1: bump-allocate one result slot per emitting entry, in entry
    order within each query, and write the values that land. Updates
    res, res_count and needs_host in place; returns the landed count
    (0-d). The queries of emitting entries must lie in [0, B)."""
    name = "list_emit"
    _require(name, torch.int32, q, value, res, res_count, needs_host)
    _require(name, torch.bool, emit)
    N, B, R = q.shape[0], res_count.shape[0], result_cap
    if emit.shape != (N,) or value.shape != (N,):
        raise ValueError(f"{name}: q, emit and value must all be [N]")
    if res.shape != (B * R,) or needs_host.shape != (B,):
        raise ValueError(f"{name}: expects a [B * result_cap] buffer and [B] causes")
    if N == 0 or B == 0:
        raise ValueError(f"{name}: expects entries and queries, got N = {N}, B = {B}")
    lib = library()
    dev = q.device
    stream = _stream()
    table = torch.empty(lib.keto_list_emit_scratch(N, B), dtype=torch.int32, device=dev)
    landed = torch.empty(1, dtype=torch.int32, device=dev)
    rc = lib.keto_list_emit(
        _p(q), _p(emit), _p(value), N, B, R, _p(res), _p(res_count), _p(needs_host),
        _p(table), _p(landed), _p(grid_scratch(dev, stream)), stream,
    )
    _check(lib, rc, name)
    return landed.reshape(())


def _aligned(name: str, t: torch.Tensor, width: int) -> None:
    if t.dim() != 2 or t.shape[1] % width or t.data_ptr() % (4 * width):
        raise ValueError(f"{name}: a table of {width}-int rows must be aligned to them")


def reverse_gather(q, obj, rel, depth, live, ns_t, rstart, rlen, rinstr_pack, rv_pack,
                   objslot_ns, *, wildcard_rel: int, n_config_rels: int, n_queries: int):
    """L2: ListObjects' predecessor candidates (q, ctx, obj, rel, depth,
    valid), ctx being q, in scan order, and the per-query causes
    (frontier overflow, POISON)."""
    name = "reverse_gather"
    _require(name, torch.int32, q, obj, rel, depth, ns_t, rstart, rlen, rinstr_pack, rv_pack,
             objslot_ns)
    _require(name, torch.bool, live)
    F = q.shape[0]
    if any(t.shape != (F,) for t in (obj, rel, depth, live, ns_t, rstart, rlen)):
        raise ValueError(f"{name}: task columns must all be [F]")
    _aligned(name, rinstr_pack, 4)
    _aligned(name, rv_pack, 4)
    if rinstr_pack.shape[0] < max(n_config_rels, 1) or rv_pack.shape[1] != 4:
        raise ValueError(f"{name}: malformed rinstr_pack or rv_pack")
    RK = rinstr_pack.shape[1] // 4
    dev = q.device
    lib = library()
    scratch = torch.empty(lib.keto_gather_scratch(F), dtype=torch.int32, device=dev)
    cause = torch.empty(n_queries, dtype=torch.int32, device=dev)
    cols = [torch.empty(F, dtype=torch.int32, device=dev) for _ in range(4)]
    valid = torch.empty(F, dtype=torch.bool, device=dev)
    rc = lib.keto_reverse_gather(
        _p(q), _p(obj), _p(rel), _p(depth), _p(live), _p(ns_t), _p(rstart), _p(rlen),
        _p(rinstr_pack), RK, _p(rv_pack), rv_pack.shape[0], _p(objslot_ns),
        objslot_ns.shape[0], F, n_queries, wildcard_rel, n_config_rels, _p(scratch),
        _p(cause), *(_p(c) for c in cols), _p(valid), _stream(),
    )
    _check(lib, rc, name)
    return cols[0], cols[0], cols[1], cols[2], cols[3], valid, cause


def subjects_gather(q, obj, depth, live, spans, ik, ir, ir2, fe_pack, *, wildcard_rel: int,
                    n_queries: int):
    """L3: ListSubjects' candidates (q, ctx, obj, rel, depth, valid), ctx
    being q, in scan order, the result mask and value of each, and the
    per-query frontier-overflow causes."""
    name = "subjects_gather"
    _require(name, torch.int32, q, obj, depth, spans, ik, ir, ir2, fe_pack)
    _require(name, torch.bool, live)
    F, K = ik.shape
    if any(t.shape != (F,) for t in (q, obj, depth, live)) or ir.shape != ik.shape \
            or ir2.shape != ik.shape or spans.shape != (F, K + 1, 2):
        raise ValueError(f"{name}: expects [F] tasks, [F, K] lanes and [F, K + 1, 2] spans")
    if spans.data_ptr() % 8:
        raise ValueError(f"{name}: spans must be 8-byte aligned")
    _aligned(name, fe_pack, 4)
    dev = q.device
    lib = library()
    scratch = torch.empty(lib.keto_gather_scratch(F), dtype=torch.int32, device=dev)
    cause = torch.empty(n_queries, dtype=torch.int32, device=dev)
    cols = [torch.empty(F, dtype=torch.int32, device=dev) for _ in range(4)]
    valid, emit = (torch.empty(F, dtype=torch.bool, device=dev) for _ in range(2))
    value = torch.empty(F, dtype=torch.int32, device=dev)
    rc = lib.keto_subjects_gather(
        _p(q), _p(obj), _p(depth), _p(live), _p(spans), _p(ik), _p(ir), _p(ir2), K,
        _p(fe_pack), fe_pack.shape[0], F, n_queries, wildcard_rel, _p(scratch), _p(cause),
        *(_p(c) for c in cols), _p(valid), _p(emit), _p(value), _stream(),
    )
    _check(lib, rc, name)
    return cols[0], cols[0], cols[1], cols[2], cols[3], valid, emit, value, cause


def list_pool_compact(res, res_count, needs_host, stats, *, result_cap: int, pool_cap: int):
    """L4: the packed list result [offsets(B+1) | needs_host(B) | stats |
    pool(pool_cap)] from the result buffer."""
    from .kernel import N_LAUNCH_STATS

    name = "list_pool_compact"
    _require(name, torch.int32, res, res_count, needs_host, stats)
    B, R = res_count.shape[0], result_cap
    if B == 0 or res.shape != (B * R,) or needs_host.shape != (B,):
        raise ValueError(f"{name}: expects a [B * result_cap] buffer and [B] causes, B > 0")
    if stats.shape != (N_LAUNCH_STATS,):
        raise ValueError(f"{name}: expects [{N_LAUNCH_STATS}] stats")
    dev = res.device
    out = torch.empty(2 * B + 1 + N_LAUNCH_STATS + pool_cap, dtype=torch.int32, device=dev)
    lib = library()
    rc = lib.keto_list_pool_compact(
        _p(res), _p(res_count), _p(needs_host), _p(stats), B, R, pool_cap,
        _p(_pool_scratch(lib, B, dev)), _p(out), _stream(),
    )
    _check(lib, rc, name)
    return out


def closure_probe(cc_pack, ch_pack, cd_pack, qpack, *, cc_probes: int, ch_probes: int,
                  has_dirty: bool, layout: str) -> torch.Tensor:
    """C1: the closure verdicts of a [7, B] query pack, [member(B) |
    cause(B) | stats(8)] int32, in one launch that writes every slot of
    the result. cd_pack is read only when has_dirty."""
    from .delta import DELTA_PROBES
    from .kernel import N_LAUNCH_STATS
    from .snapshot import slots_per_bucket

    name = "closure_probe"
    spb_pair, spb_edge = slots_per_bucket(2, layout), slots_per_bucket(5, layout)
    _require_pack(name, cc_pack, 4, spb_pair)
    _require_pack(name, ch_pack, 8, spb_edge)
    if has_dirty:
        _require_pack(name, cd_pack, 4, spb_pair)
    _require(name, torch.int32, qpack)
    if qpack.dim() != 2 or qpack.shape[0] != 7:
        raise ValueError(f"{name}: expects a [7, B] query pack")
    B = qpack.shape[1]
    out = torch.empty(2 * B + N_LAUNCH_STATS, dtype=torch.int32, device=qpack.device)
    lib = library()
    stream = _stream()
    rc = lib.keto_closure_probe(
        _p(cc_pack), cc_pack.shape[0], cc_probes, _p(cd_pack) if has_dirty else None,
        cd_pack.shape[0] if has_dirty else 0, DELTA_PROBES, int(has_dirty), spb_pair,
        _p(ch_pack), ch_pack.shape[0], ch_probes, spb_edge, _p(qpack), B, _p(out),
        _p(grid_scratch(qpack.device, stream)), stream,
    )
    _check(lib, rc, name)
    return out


def filter_mark(obj, rel, depth, live, cand, head, hit, status) -> torch.Tensor:
    """F1: one filter step's candidate intersection. Tasks that are live,
    of the query's relation (head[2]) and at depth >= 0 set the hit slot
    of their object in the sorted column `cand`; hit and the running count
    of hit slots, status[2], update in place. Returns the matching tasks'
    count (0-d)."""
    name = "filter_mark"
    _require(name, torch.int32, obj, rel, depth, cand, head, hit, status)
    _require(name, torch.bool, live)
    F, C = obj.shape[0], cand.shape[0]
    if any(t.shape != (F,) for t in (rel, depth, live)):
        raise ValueError(f"{name}: task columns must all be [F]")
    if C == 0 or hit.shape != (C,) or head.shape[0] < 3 or status.shape[0] < 3:
        raise ValueError(f"{name}: expects a [C > 0] column and hit mask, head and status")
    marks = torch.empty(1, dtype=torch.int32, device=obj.device)
    lib = library()
    stream = _stream()
    rc = lib.keto_filter_mark(
        _p(obj), _p(rel), _p(depth), _p(live), F, _p(cand), C, _p(head), _p(hit), _p(status),
        _p(marks), _p(grid_scratch(obj.device, stream)), stream,
    )
    _check(lib, rc, name)
    return marks.reshape(())


def _require_words(name: str, *mats: torch.Tensor) -> tuple[int, int]:
    """(N, W) of [N, W] int32 bit matrices of one shape, W a power of two
    (a row's lane group is min(W, 32) threads of one warp)."""
    _require(name, torch.int32, *mats)
    N, W = mats[0].shape
    if any(m.shape != (N, W) for m in mats) or W < 1 or W & (W - 1):
        raise ValueError(f"{name}: expects [N, W] bit matrices, W a power of two")
    return N, W


def _require_32bit(name: str, *sizes: int) -> None:
    if any(n >= INDEX_LIMIT for n in sizes):
        raise ValueError(f"{name}: {max(sizes)} words overflow its 32-bit indices")


def power_step(F, R, e_src, e_dst, counts, stats, status) -> torch.Tensor:
    """P1: one powering step over the edges (e_src, e_dst), node indices
    below N; returns fresh [N, W]. Updates R, counts and stats in place;
    status[0] is the popcount of F before the step. The kernels index in
    32 bits and read F 16 bytes at a time: N * W and E * W must stay below
    2^31, and F (when W >= 4) be 16-byte aligned."""
    from .kernel import N_LAUNCH_STATS

    name = "power_step"
    N, W = _require_words(name, F, R)
    _require(name, torch.int32, e_src, e_dst, counts, stats, status)
    E = e_src.shape[0]
    if e_src.dim() != 1 or e_dst.shape != (E,) or counts.shape != (32 * W,):
        raise ValueError(f"{name}: expects [E] sources and destinations and [32 W] counts")
    if stats.shape != (N_LAUNCH_STATS,) or status.numel() < 1:
        raise ValueError(f"{name}: expects [{N_LAUNCH_STATS}] stats and a status")
    _require_32bit(name, N * W, E * W)
    if W >= 4 and F.data_ptr() % 16:
        raise ValueError(f"{name}: F must be 16-byte aligned")
    fresh = torch.empty_like(F)
    lib = library()
    stream = _stream()
    acc, lists = power_scratch(F.device, stream, N * W, lib.keto_power_step_scratch(E, N, W))
    rc = lib.keto_power_step(_p(F), _p(R), _p(e_src), _p(e_dst), E, N, W, _p(acc), _p(lists),
                             _p(fresh), _p(counts), _p(stats), _p(status), stream)
    _check(lib, rc, name)
    return fresh


def power_account(fresh, lvl, counts, d_rows, status, *, level: int,
                  max_set_rows: int) -> torch.Tensor:
    """P2: the next frontier F = fresh & ~kill; lvl and status[0] (F's
    popcount) update in place. The kernel indexes in 32 bits and moves 16
    bytes at a time: N * W and the level plane's D * 32 W bytes must stay
    below 2^31, fresh (when W >= 4) and lvl be 16-byte aligned."""
    name = "power_account"
    N, W = _require_words(name, fresh)
    _require(name, torch.int32, counts, d_rows, status)
    _require(name, torch.int8, lvl)
    D = d_rows.shape[0]
    if lvl.shape != (D, 32 * W) or counts.shape != (32 * W,) or status.numel() < 1:
        raise ValueError(f"{name}: expects a [D, 32 W] level plane, [32 W] counts and a status")
    _require_32bit(name, N * W, D * 32 * W)
    if lvl.data_ptr() % 16 or (W >= 4 and fresh.data_ptr() % 16):
        raise ValueError(f"{name}: fresh and lvl must be 16-byte aligned")
    F = torch.empty_like(fresh)
    lib = library()
    stream = _stream()
    rc = lib.keto_power_account(_p(fresh), _p(lvl), _p(counts), _p(d_rows), N, D, W, level,
                                max_set_rows, _p(F), _p(status),
                                _p(grid_scratch(fresh.device, stream)), stream)
    _check(lib, rc, name)
    return F


def power_poison(R, pois_mask, counts, stats) -> torch.Tensor:
    """P3: the wave's summary [counts(S) | poison(S) | stats(8)] int32. The
    kernel reads the mask 16 bytes at a time and holds W words in shared
    memory: pois_mask must be 16-byte aligned, W at most 256 (8,192
    lanes) and N * W below 2^31."""
    from .kernel import N_LAUNCH_STATS

    name = "power_poison"
    N, W = _require_words(name, R)
    _require(name, torch.uint8, pois_mask)
    _require(name, torch.int32, counts, stats)
    S = 32 * W
    if pois_mask.shape != (N,) or counts.shape != (S,) or stats.shape != (N_LAUNCH_STATS,):
        raise ValueError(f"{name}: expects an [N] mask, [32 W] counts and "
                         f"[{N_LAUNCH_STATS}] stats")
    if W > 256:
        raise ValueError(f"{name}: expects at most 256 words a row, got {W}")
    _require_32bit(name, N * W)
    if pois_mask.data_ptr() % 16:
        raise ValueError(f"{name}: pois_mask must be 16-byte aligned")
    dev = R.device
    out = torch.empty(2 * S + N_LAUNCH_STATS, dtype=torch.int32, device=dev)
    lib = library()
    stream = _stream()
    pw, _lists = power_scratch(dev, stream, W)
    rc = lib.keto_power_poison(_p(R), _p(pois_mask), _p(counts), _p(stats), N, W, _p(pw),
                               _p(grid_scratch(dev, stream)), _p(out), stream)
    _check(lib, rc, name)
    return out


# -- M1-M10: the microbenchmark primitives (tools/microbench.py) -------------


def _require_aligned(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors read 16 bytes at a time must be 16-byte aligned")


def _require_smem(name: str, nbytes: int) -> None:
    if nbytes > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: {nbytes} bytes do not fit one block's shared memory")


def mb_probe(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """M1: out[i] = tab[idx[i]] over the flat tensors; out has idx's
    shape. Indices must lie in [0, tab.numel())."""
    name = "mb_probe"
    _require(name, torch.int32, tab, idx)
    out = torch.empty_like(idx)
    lib = library()
    _check(lib, lib.keto_mb_probe(_p(tab), _p(idx), idx.numel(), _p(out), _stream()), name)
    return out


def mb_probe_smem(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """M2: M1 from a copy of the table in each block's shared memory,
    half staged by one TMA bulk copy, half by the threads' loads. The
    table must be 16-byte aligned, a multiple of 4 ints and fit one
    block's shared memory (ValueError otherwise, before any launch)."""
    name = "mb_probe_smem"
    _require(name, torch.int32, tab, idx)
    _require_aligned(name, tab)
    cap = tab.numel()
    if cap % 4:
        raise ValueError(f"{name}: the table's size must be a multiple of 4")
    _require_smem(name, 4 * cap)
    out = torch.empty_like(idx)
    lib = library()
    rc = lib.keto_mb_probe_smem(_p(tab), cap, _p(idx), idx.numel(), _p(out), _stream())
    _check(lib, rc, name)
    return out


def _scatmax_out(b: torch.Tensor, n_out: int) -> torch.Tensor:
    return torch.empty((n_out, *b.shape[1:]), dtype=torch.int32, device=b.device)


def mb_scatmax(b: torch.Tensor, p: torch.Tensor, *, n_out: int) -> torch.Tensor:
    """M3: zeros(n_out) then out[b[i]] = max(out[b[i]], p[i]); out is
    [n_out, *b.shape[1:]]. Buckets must lie in [0, n_out). From the
    library's binned size on, a bin pass into scratch and an own pass, no
    memset; below it, a memset and global atomics."""
    name = "mb_scatmax"
    _require(name, torch.int32, b, p)
    if p.shape != b.shape:
        raise ValueError(f"{name}: buckets and priorities must have one shape")
    out = _scatmax_out(b, n_out)
    lib = library()
    F = b.numel()
    n = lib.keto_mb_scatmax_scratch(F, n_out)
    scratch = torch.empty(n, dtype=torch.int32, device=b.device) if n else None
    rc = lib.keto_mb_scatmax(_p(b), _p(p), F, _p(out), n_out, _p(scratch), _stream())
    _check(lib, rc, name)
    return out


def mb_scatmax_smem(b: torch.Tensor, p: torch.Tensor, *, n_out: int) -> torch.Tensor:
    """M4: M3 on one thread-block cluster, the output spread over its
    blocks' shared memory; at most keto_mb_scatmax_smem_capacity() buckets
    (ValueError past it, before any launch)."""
    name = "mb_scatmax_smem"
    _require(name, torch.int32, b, p)
    if p.shape != b.shape:
        raise ValueError(f"{name}: buckets and priorities must have one shape")
    lib = library()
    cap = lib.keto_mb_scatmax_smem_capacity()
    if n_out > cap:
        raise ValueError(f"{name}: {n_out} buckets do not fit one cluster's shared memory "
                         f"({cap} buckets)")
    out = _scatmax_out(b, n_out)
    rc = lib.keto_mb_scatmax_smem(_p(b), _p(p), b.numel(), _p(out), n_out, _stream())
    _check(lib, rc, name)
    return out


def _pack_args(name: str, keep: torch.Tensor, vals: torch.Tensor):
    _require(name, torch.int32, keep, vals)
    _require_aligned(name, keep, vals)
    if keep.shape != vals.shape:
        raise ValueError(f"{name}: keep and vals must have one shape")
    out = torch.empty_like(vals)
    n = torch.empty((1, 1), dtype=torch.int32, device=vals.device)
    return out, n


def onepass_scratch(device: torch.device, stream: int, tiles: int) -> tuple[torch.Tensor, int]:
    """M5's scratch on `device` for launches on `stream`, and the epoch of
    this call: an int64 ticket counter, then a status word for each of at
    least `tiles` tiles, zeroed when allocated. Every launch leaves the
    counter at 0; the status words keep what each call wrote, tagged with
    its epoch (1 to ONEPASS_EPOCHS, one more each call), so a later call
    never reads them as its own; when the epoch wraps to 1 the words are
    zeroed again. It grows to the largest call it has served. As for
    grid_scratch, launches on one stream may share it and another stream
    gets its own."""
    key = (device.index, stream)
    with _lock:
        buf, epoch = _onepass_scratch.get(key, (None, 0))
        if buf is None or buf.numel() < 1 + tiles:
            buf = torch.zeros(1 + tiles, dtype=torch.int64, device=device)
        elif epoch == ONEPASS_EPOCHS:
            buf[1:].zero_()
        epoch = epoch % ONEPASS_EPOCHS + 1
        _onepass_scratch[key] = (buf, epoch)
    return buf, epoch


def mb_pack_onepass(keep: torch.Tensor, vals: torch.Tensor):
    """M5: (out, n): vals[keep != 0] in input order, zeros past the count
    n ([1, 1]); one launch, its tiles chained by a decoupled look-back."""
    name = "mb_pack_onepass"
    out, n = _pack_args(name, keep, vals)
    lib = library()
    F = vals.numel()
    stream = _stream()
    scratch, epoch = onepass_scratch(vals.device, stream, lib.keto_mb_pack_tiles(F))
    rc = lib.keto_mb_pack_onepass(_p(keep), _p(vals), F, _p(out), _p(n), _p(scratch), epoch,
                                  stream)
    _check(lib, rc, name)
    return out, n


def pack_capacity(device: torch.device) -> int:
    """The most inputs one M6 launch takes on `device`: every tile's block
    resident at once (its grid-wide barrier needs them all running).
    Asked of the card once per device."""
    cap = _pack_capacity.get(device.index)
    if cap is None:
        lib = library()
        with torch.cuda.device(device):
            cap = lib.keto_mb_pack_capacity()
        if cap < 0:
            raise RuntimeError(f"mb_pack: CUDA error {-cap}: "
                               f"{lib.keto_error_string(-cap).decode()}")
        _pack_capacity[device.index] = cap
    return cap


def mb_pack(keep: torch.Tensor, vals: torch.Tensor):
    """M6: M5's function in one cooperative launch that keeps nothing from
    one call to the next: each tile's count, a grid-wide barrier, then
    each tile's survivors from the counts before it. At most
    pack_capacity() inputs (ValueError past it, before any launch)."""
    name = "mb_pack"
    out, n = _pack_args(name, keep, vals)
    F = vals.numel()
    cap = pack_capacity(vals.device)
    if F > cap:
        raise ValueError(f"{name}: {F} inputs are more than one cooperative launch holds ({cap})")
    lib = library()
    counts = torch.empty(lib.keto_mb_pack_tiles(F), dtype=torch.int32, device=vals.device)
    rc = lib.keto_mb_pack(_p(keep), _p(vals), F, _p(counts), _p(out), _p(n), _stream())
    _check(lib, rc, name)
    return out, n


def mb_hashprobe(keys: torch.Tensor, kvals: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """M7: the two-probe double-hash lookup of q in (keys, kvals), whose
    size is a power of two: the value, or -1."""
    name = "mb_hashprobe"
    _require(name, torch.int32, keys, kvals, q)
    cap = keys.numel()
    if kvals.numel() != cap or cap < 1 or cap & (cap - 1):
        raise ValueError(f"{name}: keys and values must be one power-of-two size")
    out = torch.empty_like(q)
    lib = library()
    rc = lib.keto_mb_hashprobe(_p(keys), _p(kvals), cap, _p(q), q.numel(), _p(out), _stream())
    _check(lib, rc, name)
    return out


def mb_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """M8: x + y, float32."""
    name = "mb_add"
    _require(name, torch.float32, x, y)
    if x.shape != y.shape:
        raise ValueError(f"{name}: x and y must have one shape")
    out = torch.empty_like(x)
    lib = library()
    _check(lib, lib.keto_mb_add(_p(x), _p(y), x.numel(), _p(out), _stream()), name)
    return out


def _require_rows(name: str, tab: torch.Tensor) -> int:
    _require_aligned(name, tab)
    if tab.dim() != 2 or tab.shape[1] % 4:
        raise ValueError(f"{name}: expects an [R, C] table, C a multiple of 4")
    return tab.shape[1]


def mb_row_gather(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """M9: out[i, :] = tab[idx[i], :]. Indices must lie in [0, R)."""
    name = "mb_row_gather"
    _require(name, torch.int32, idx, tab)
    C = _require_rows(name, tab)
    n = idx.numel()
    out = torch.empty((n, C), dtype=torch.int32, device=tab.device)
    lib = library()
    _check(lib, lib.keto_mb_row_gather(_p(idx), n, _p(tab), C, _p(out), _stream()), name)
    return out


def mb_block_gather(bidx: torch.Tensor, tab: torch.Tensor, *, block_rows: int) -> torch.Tensor:
    """M10: the [block_rows, C] blocks bidx[i] of tab, stacked into
    [len(bidx) * block_rows, C]. Block indices must lie in
    [0, R / block_rows)."""
    name = "mb_block_gather"
    _require(name, torch.int32, bidx, tab)
    C = _require_rows(name, tab)
    if block_rows < 1 or tab.shape[0] % block_rows:
        raise ValueError(f"{name}: the table's rows must be whole blocks of {block_rows}")
    nb = bidx.numel()
    out = torch.empty((nb * block_rows, C), dtype=torch.int32, device=tab.device)
    lib = library()
    rc = lib.keto_mb_block_gather(_p(bidx), nb, _p(tab), block_rows * C, _p(out), _stream())
    _check(lib, rc, name)
    return out

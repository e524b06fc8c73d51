"""The check kernel's irregular primitives, timed alone on the card.

The hand-written CUDA counterparts (csrc/microbench_kernels.cu, M1-M7) of
the TPU prototypes in tools/microbench_pallas.py, each beside its plain
PyTorch version, at that file's sizes (F = 16384 updates or queries,
CAP = 32768 table slots) and, for the scatter-max and the compactions,
also at F = 2^20:

  probe       out[i] = tab[idx[i]]                     M1 global, M2 shared
  scatmax     out = 0; out[b[i]] = max(out[b[i]], p[i])  M3 binned, M4 one cluster
  pack        out[:n] = vals[keep != 0] in order, 0 past n  M5 look-back, M6 grid barrier
  hashprobe   two-probe double-hash lookup             M7

    python -m keto_tpu_torch.tools.microbench [--device cpu] [--n 50]

prints one JSON line per op, {"op", "ms", "bound_ms", "note"}: the time
per call over `n` calls (between CUDA events on the card, host enqueue
included), and the least time the card could take (bytes over the H100
SXM's memory rate, or operations over its rate for their type, whichever
is larger); then the torch_* lines, one PyTorch call computing the same
function, as yardsticks; then a "device" line. On the CPU the plain
versions run, and the times are the CPU's.

The inputs are `make_inputs`'s: the TPU tool's draws from
numpy.random.default_rng(seed) in its order, so both get the same arrays.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..engine import cuda_ops
from ..engine.torch_engine import resolve_device

F_TOOL, CAP_TOOL = 16384, 32768
F_LARGE = 1 << 20  # ListObjects' frontier G, where K4 compacts today
# the H100 SXM's peaks (NVIDIA data sheet; Hopper white paper for INT32:
# 132 SMs x 64 lanes x the 1.98 GHz boost clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 67e12
SECTOR = 32  # bytes of one DRAM sector, the least a scattered read moves
H1_MUL, H2_MUL = 2654435761, 40503


def make_inputs(F: int, CAP: int, seed: int = 0) -> dict:
    """tools/microbench_pallas.py's arrays, drawn in its order."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, hi, n in (("tab", 1 << 20, CAP), ("idx", CAP, F), ("buck", 2 * F, F),
                        ("prio", 1 << 30, F), ("keep", 2, F), ("vals", 1 << 20, F),
                        ("keys", 1 << 26, CAP), ("kvals", 1 << 20, CAP), ("qk", 1 << 26, F)):
        out[name] = rng.integers(0, hi, (n, 1), dtype=np.int32)
    return out


def hash_slots(q: torch.Tensor, cap: int):
    """(h1, the second slot (h1 + h2) & (cap - 1)) of each query, int64;
    both products modulo 2^32, of which the mask keeps the low bits."""
    k = q.reshape(-1).to(torch.int64)
    mask = cap - 1
    h1 = (k * H1_MUL) & mask
    h2 = ((k * H2_MUL) | 1) & mask
    return h1, (h1 + h2) & mask


def plant_keys(keys: np.ndarray, q: np.ndarray, n: int) -> np.ndarray:
    """A copy of keys where the first n queries sit at their first slot
    and the next n at their second (their first slot holding another
    key), skipping slots already taken: so that a probe exercises both
    arms."""
    keys = keys.copy()
    flat, cap = keys.reshape(-1), keys.size
    h1, h2 = (s.numpy() for s in hash_slots(torch.from_numpy(q), cap))
    taken: set = set()
    for i in range(min(2 * n, q.size)):
        k = int(q.reshape(-1)[i])
        a, b = int(h1[i]), int(h2[i])
        if i < n and a not in taken:
            flat[a] = k
            taken.add(a)
        elif i >= n and a != b and not {a, b} & taken:
            flat[a], flat[b] = k ^ 1, k
            taken.update((a, b))
    return keys


# -- plain versions -----------------------------------------------------------


def probe_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tab.reshape(-1)[idx.reshape(-1).long()].reshape(idx.shape)


def scatmax_plain(b: torch.Tensor, p: torch.Tensor, *, n_out: int) -> torch.Tensor:
    out = torch.zeros(n_out, dtype=torch.int32, device=b.device)
    out.scatter_reduce_(0, b.reshape(-1).long(), p.reshape(-1), "amax")
    return out.reshape((n_out, *b.shape[1:]))


def pack_plain(keep: torch.Tensor, vals: torch.Tensor):
    sel = vals.reshape(-1)[keep.reshape(-1) != 0]
    out = torch.zeros(vals.numel(), dtype=torch.int32, device=vals.device)
    out[: sel.numel()] = sel
    n = torch.full((1, 1), sel.numel(), dtype=torch.int32, device=vals.device)
    return out.reshape(vals.shape), n


def hashprobe_plain(keys: torch.Tensor, kvals: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    h1, h2 = hash_slots(q, keys.numel())
    k, kf = q.reshape(-1), keys.reshape(-1)
    hit0 = kf[h1] == k
    slot = torch.where(hit0, h1, h2)
    hit = hit0 | (kf[h2] == k)
    out = torch.where(hit, kvals.reshape(-1)[slot], torch.full_like(k, -1))
    return out.reshape(q.shape)


# -- dispatchers: the plain version for CPU tensors, the kernel otherwise -----


def probe(tab, idx):
    return probe_plain(tab, idx) if idx.device.type == "cpu" else cuda_ops.mb_probe(tab, idx)


def probe_smem(tab, idx):
    if idx.device.type == "cpu":
        return probe_plain(tab, idx)
    return cuda_ops.mb_probe_smem(tab, idx)


def scatmax(b, p, *, n_out: int):
    if b.device.type == "cpu":
        return scatmax_plain(b, p, n_out=n_out)
    return cuda_ops.mb_scatmax(b, p, n_out=n_out)


def scatmax_smem(b, p, *, n_out: int):
    if b.device.type == "cpu":
        return scatmax_plain(b, p, n_out=n_out)
    return cuda_ops.mb_scatmax_smem(b, p, n_out=n_out)


def pack_onepass(keep, vals):
    if vals.device.type == "cpu":
        return pack_plain(keep, vals)
    return cuda_ops.mb_pack_onepass(keep, vals)


def pack(keep, vals):
    return pack_plain(keep, vals) if vals.device.type == "cpu" else cuda_ops.mb_pack(keep, vals)


def hashprobe(keys, kvals, q):
    if q.device.type == "cpu":
        return hashprobe_plain(keys, kvals, q)
    return cuda_ops.mb_hashprobe(keys, kvals, q)


# -- ops: what main() and the card's smoke time -------------------------------


@dataclass(frozen=True)
class Op:
    """One timed op: `run` calls the dispatcher (the kernel on the card),
    `plain` the plain version, `library` one PyTorch call computing the
    same function (None where there is none), on the same inputs.
    `nbytes` and `ops` are what the function must move and compute on
    these inputs, `ops` at `ops_per_s`."""

    op: str
    kernel: str
    run: Callable
    plain: Callable
    library: Callable | None
    nbytes: int
    ops: int
    note: str
    ops_per_s: float = INT32_OPS_PER_S

    @property
    def bound_ms(self) -> float:
        return max(self.nbytes / HBM_BYTES_PER_S, self.ops / self.ops_per_s) * 1e3

    @property
    def bound_by(self) -> str:
        return "bytes" if self.nbytes / HBM_BYTES_PER_S >= self.ops / self.ops_per_s \
            else "operations"


def _sectors(*slots: torch.Tensor) -> int:
    """Distinct 32-byte sectors of an int32 array at these slots."""
    return int(torch.unique(torch.cat([s.reshape(-1) for s in slots]) // (SECTOR // 4)).numel())


def _tensors(inp: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in inp.items()}


def ops(inp: dict, device, *, large: dict | None = None) -> list[Op]:
    """M1-M7 on `inp` (make_inputs's arrays), and M3, M5 and M6 on
    `large` where given (ops named with an `_F<size>` suffix), each on
    `device`."""
    t = _tensors(inp, device)
    F, CAP = t["idx"].numel(), t["tab"].numel()
    size = f"F={F} CAP={CAP}"
    idx_cpu = torch.from_numpy(inp["idx"]).long()
    probe_bytes = 8 * F + SECTOR * _sectors(idx_cpu)
    out = [
        Op("probe", "mb_probe", lambda: probe(t["tab"], t["idx"]),
           lambda: probe_plain(t["tab"], t["idx"]),
           lambda: t["tab"].reshape(-1)[t["idx"].reshape(-1)], probe_bytes, F,
           f"M1 global memory, {size}"),
        Op("probe_smem", "mb_probe_smem", lambda: probe_smem(t["tab"], t["idx"]),
           lambda: probe_plain(t["tab"], t["idx"]),
           lambda: t["tab"].reshape(-1)[t["idx"].reshape(-1)], probe_bytes, F,
           f"M2 table staged in each block's shared memory, half by a TMA bulk copy, "
           f"{size}"),
    ]
    out += _scatmax_pack_ops(t, "", size)
    keys, q = torch.from_numpy(inp["keys"]), torch.from_numpy(inp["qk"])
    h1, h2 = hash_slots(q, CAP)
    hit0 = keys.reshape(-1)[h1] == q.reshape(-1)
    hit = hit0 | (keys.reshape(-1)[h2] == q.reshape(-1))
    slot = torch.where(hit0, h1, h2)[hit]
    hp_bytes = 8 * F + SECTOR * (_sectors(h1, h2[~hit0]) + (_sectors(slot) if slot.numel() else 0))
    out.append(Op("hashprobe", "mb_hashprobe", lambda: hashprobe(t["keys"], t["kvals"], t["qk"]),
                  lambda: hashprobe_plain(t["keys"], t["kvals"], t["qk"]), None, hp_bytes,
                  12 * F, f"M7 two probes, {size}, {int(hit.sum())} hits"))
    if large is not None:
        tl = _tensors({k: large[k] for k in ("buck", "prio", "keep", "vals")}, device)
        n = tl["buck"].numel()
        out += [o for o in _scatmax_pack_ops(tl, f"_F{n}", f"F={n}")
                if o.kernel != "mb_scatmax_smem"]
    return out


def _scatmax_pack_ops(t: dict, suffix: str, size: str) -> list[Op]:
    b, p, keep, vals = t["buck"], t["prio"], t["keep"], t["vals"]
    F = b.numel()
    n_out = 2 * F

    def library_scatmax():
        return torch.zeros(n_out, dtype=torch.int32, device=b.device).scatter_reduce_(
            0, b.reshape(-1).long(), p.reshape(-1), "amax")

    def library_pack():
        return torch.masked_select(vals, keep != 0)

    scat_bytes, pack_bytes = 8 * F + 4 * n_out, 12 * F + 4
    return [
        Op("scatmax" + suffix, "mb_scatmax", lambda: scatmax(b, p, n_out=n_out),
           lambda: scatmax_plain(b, p, n_out=n_out), library_scatmax, scat_bytes, F,
           f"M3 a memset and global atomicMax below 2^20 updates, bin then own from there, "
           f"{size}"),
        Op("scatmax_smem" + suffix, "mb_scatmax_smem", lambda: scatmax_smem(b, p, n_out=n_out),
           lambda: scatmax_plain(b, p, n_out=n_out), library_scatmax, scat_bytes, F,
           f"M4 one cluster, the output in its blocks' shared memory, {size}"),
        Op("pack_onepass" + suffix, "mb_pack_onepass", lambda: pack_onepass(keep, vals),
           lambda: pack_plain(keep, vals), library_pack, pack_bytes, 2 * F,
           f"M5 one pass, decoupled look-back, {size}"),
        Op("pack" + suffix, "mb_pack", lambda: pack(keep, vals),
           lambda: pack_plain(keep, vals), library_pack, pack_bytes, 2 * F,
           f"M6 one cooperative launch, tile counts, a grid barrier, {size}"),
    ]


def timed_ms(fn: Callable, n: int, device: torch.device) -> float:
    """Time per call over n calls after one warm-up call: between CUDA
    events on the card, by the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_note(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} x {torch.cuda.device_count()}"
    return "cpu: the plain versions"


def rec(**line) -> None:
    print(json.dumps(line), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m keto_tpu_torch.tools.microbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=50, help="timed calls per op")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    timed = ops(make_inputs(F_TOOL, CAP_TOOL), device, large=make_inputs(F_LARGE, CAP_TOOL))
    for o in timed:
        rec(op=o.op, ms=timed_ms(o.run, args.n, device), bound_ms=o.bound_ms, note=o.note)
    yardsticks = {"probe": "torch_gather", "scatmax": "torch_scatter_max",
                  "pack": "torch_masked_select"}
    for o in timed:
        base, sep, size = o.op.partition("_F")
        if base in yardsticks:
            rec(op=yardsticks[base] + sep + size, ms=timed_ms(o.library, args.n, device),
                bound_ms=o.bound_ms, note=o.note[o.note.index("F="):])
    rec(op="device", ms=0.0, bound_ms=0.0, note=device_note(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time K3 `expand_gather` and K4 `dedupe_compact` of one or more
checkouts of keto_tpu_torch on one NVIDIA card, in turns, on the same
inputs.

    python tools/scan_ab_torch.py --roots _checkout/parent . . _checkout/parent

Each root runs in a process of its own, which imports keto_tpu_torch from
that root (so its kernels build from the root's csrc/ into the root's
_build/), makes the inputs from a seed at the shapes of chip_smoke.py's
cells, holds each kernel to its plain version (max_abs_err must be 0) and
times it: device ms per call from torch.profiler, every kernel and memset
of the call, its mean time a launch times its launches a call, and those
parts by name. The inputs
are drawn, not captured: chip_smoke.py times the kernels on real batches.
One JSON line per root, after a line with the card's name and power limit.
Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPS = 50
# name: (kernel, G or F, F, S or n_queries); the cells of chip_smoke.py
# (PERF.md §4): Check's frontier of 8,192 (S = K + 1 = 3 for its videos
# namespace) and 4,096 queries, Expand's 4F candidates, ListSubjects' and
# the filter walk's frontiers of 16,384, ListObjects' of 2^20
CASES = {
    "k3_check": ("expand_gather", 8192, 8192, 3),
    "k4_check": ("dedupe_compact", 8192, 8192, 4096),
    "k4_expand": ("dedupe_compact", 16384, 4096, 1024),
    "k4_list_subjects": ("dedupe_compact", 16384, 16384, 256),
    "k4_filter": ("dedupe_compact", 16384, 16384, 1),
    "k4_list_objects": ("dedupe_compact", 1 << 20, 1 << 20, 256),
}


def inputs(name: str, dev):
    """(args, kwargs) of the case's wrapper, drawn from seed 0: K3 a
    quarter of the slots non-empty (the total stays under F, as on a batch
    that needs no host replay); K4 narrow keys (duplicates and bucket
    collisions) with 80% valid."""
    import numpy as np
    import torch

    kernel, n, F, m = CASES[name]
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    if kernel == "expand_gather":
        S, B, n_edges = m, 4096, 1 << 20
        counts = (rng.random((F, S)) < 0.23) * rng.integers(1, 2, (F, S))
        e_pack = np.stack([rng.integers(0, 1 << 20, n_edges), rng.integers(0, 6, n_edges)], 1)
        args = (t(counts), t(rng.integers(0, n_edges - 2, (F, S))), t(rng.integers(0, B, (F, S))),
                t(rng.integers(0, 6, (F, S))), t(rng.integers(0, 2, (F, S))),
                t(rng.integers(0, B, F)), t(rng.integers(0, 1 << 20, F)),
                t(rng.integers(0, 6, F)), t(e_pack))
        return args, dict(wildcard_rel=5, n_queries=B)
    G, B = n, m
    q = rng.integers(0, B, G)
    cols = (t(q), t(q), t(rng.integers(0, max(G // 64, 40), G)), t(rng.integers(0, 3, G)),
            t(rng.integers(-1, 6, G)))
    valid = torch.from_numpy(rng.random(G) < 0.8).to(dev)
    return (*cols, valid), dict(F=F, n_queries=B)


def device_ms(fn, reps: int = REPS) -> tuple[float, dict]:
    """Device ms per call, and its parts by kernel (or memset) name."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        parts: dict = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count:
                m = re.search(r"(\w+)\(", e.key)
                name = m.group(1) if m else e.key
                us = e.self_device_time_total / e.count * -(-e.count // reps)
                parts[name] = parts.get(name, 0.0) + us / 1e3
        if parts and sum(parts.values()) > 0:
            return sum(parts.values()), parts
    raise RuntimeError("the profiler saw no device time")


def worker(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import kernel as tk

    cuda_ops.library()
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    for name, (kernel, *_shape) in CASES.items():
        args, kw = inputs(name, torch.device("cuda"))
        run = lambda: getattr(cuda_ops, kernel)(*args, **kw)  # noqa: E731
        if kernel == "expand_gather":
            ch, over = tk.expand_gather_plain(*args, **kw)
            want = (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid, over)
        else:
            want = tk.dedupe_compact_plain(tk.Expansion(*args), **kw)
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
                  for g, w in zip(run(), want))
        if err:
            raise AssertionError(f"{root} {name}: max_abs_err {err}")
        out[name], out[f"{name}_parts"] = device_ms(run)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available: the kernels need an NVIDIA card", file=sys.stderr)
        return 1
    if a.worker:
        print(json.dumps(worker(a.worker)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    rc = 0
    for root in a.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                              capture_output=True, text=True, timeout=600)
        print(proc.stdout.strip() or json.dumps({"root": root, "rc": proc.returncode,
                                                 "stderr": proc.stderr[-2000:]}), flush=True)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Time K3 `expand_gather`, K4 `dedupe_compact`, F1 `filter_mark` and P2
`power_account` of one or more checkouts of keto_tpu_torch on one NVIDIA
card, in turns, on the same inputs.

    python tools/scan_ab_torch.py --roots _checkout/parent . . _checkout/parent

Each root runs in a process of its own, which imports keto_tpu_torch from
that root (so its kernels build from the root's csrc/ into the root's
_build/), makes the inputs from a seed at the shapes of chip_smoke.py's
cells, holds each kernel to its plain version (max_abs_err must be 0) and
times it: device ms per call from torch.profiler, every kernel and memset
of the call, its mean time a launch times its launches a call, and those
parts by name. F1 and P2 update inputs in place: each side of the
comparison works on its own clones, F1 is timed on one set of clones
call after call (as chip_smoke.py times it), and each timed P2 call first
copies its level plane and status back (the copies are reported among the
parts, not in the kernel's time). The inputs are drawn, not captured:
chip_smoke.py times the kernels on real batches.
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
# name: (kernel, *shape); the cells of chip_smoke.py (PERF.md §4). K3 and
# K4: (G or F, F, S or n_queries): Check's frontier of 8,192 (S = K + 1 =
# 3 for its videos namespace) and 4,096 queries, Expand's 4F candidates,
# ListSubjects' and the filter walk's frontiers of 16,384, ListObjects' of
# 2^20. F1: (F tasks, C slots, candidates): filter_batch's frontier of
# 4,096 against the 16,384-slot bucket of bench_filter's 10,000
# candidates. P2: (N nodes, lanes, D direct rows): the widest wave of
# the max_set_rows-4 deep-1e6 build (32,768 nodes, 2,048 lanes, so W =
# 64, and 16,384 direct rows), with a step's fresh bits as sparse as on
# that wave (p2_wave) and one word in eight non-zero (p2_dense: the level
# pass's heavy case).
CASES = {
    "k3_check": ("expand_gather", 8192, 8192, 3),
    "k4_check": ("dedupe_compact", 8192, 8192, 4096),
    "k4_expand": ("dedupe_compact", 16384, 4096, 1024),
    "k4_list_subjects": ("dedupe_compact", 16384, 16384, 256),
    "k4_filter": ("dedupe_compact", 16384, 16384, 1),
    "k4_list_objects": ("dedupe_compact", 1 << 20, 1 << 20, 256),
    "f1_filter": ("filter_mark", 4096, 16384, 10000),
    "p2_wave": ("power_account", 32768, 2048, 16384),
    "p2_dense": ("power_account", 32768, 2048, 16384),
}
# the arguments F1 and P2 update in place
UPDATED = {"filter_mark": (6, 7), "power_account": (1, 4)}


def inputs(name: str, dev):
    """(args, kwargs) of the case's wrapper, drawn from seed 0: K3 a
    quarter of the slots non-empty (the total stays under F, as on a batch
    that needs no host replay); K4 narrow keys (duplicates and bucket
    collisions) with 80% valid; F1 a sorted column padded as the walk pads
    it, objects that hit it a quarter of the time, 90% live; P2 reach
    counts of 0-8 against a row cap of 4, so about half the sources are
    killed, and two fresh bits a source at random nodes (as a chain
    advances a node a step; p2_wave) or one fresh word in eight non-zero
    (p2_dense)."""
    import numpy as np
    import torch

    kernel, n, F, m = CASES[name]
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    if kernel == "filter_mark":
        from keto_tpu_torch.engine.filter_kernel import CAND_PAD

        C, n_cand = F, m
        cand = np.full(C, CAND_PAD, np.int32)
        cand[:n_cand] = np.sort(rng.choice(4 * n_cand, n_cand, replace=False))
        live = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        return (t(rng.integers(0, 4 * n_cand, n)), t(rng.integers(0, 3, n)),
                t(rng.integers(-1, 3, n)), live, t(cand), t([0, 0, 1, 0, n_cand]),
                t(np.zeros(C)), t([n, 0, 0, n_cand])), {}
    if kernel == "power_account":
        N, S, D = n, F, m
        W = S // 32
        if name == "p2_dense":
            fresh = rng.integers(0, 1 << 32, (N, W), dtype=np.uint64)
            fresh &= rng.integers(0, 1 << 32, (N, W), dtype=np.uint64)  # sparse bits
            fresh[rng.random((N, W)) >= 0.125] = 0
        else:
            fresh = np.zeros((N, W), np.uint64)
            lane = np.repeat(np.arange(S), 2)
            np.bitwise_or.at(fresh, (rng.integers(0, N, 2 * S), lane // 32),
                             np.uint64(1) << (lane % 32).astype(np.uint64))
        lvl = np.where(rng.random((D, S)) < 0.9, -1, rng.integers(0, 3, (D, S))).astype(np.int8)
        args = (t(fresh.astype(np.uint32).view(np.int32)), torch.from_numpy(lvl).to(dev),
                t(rng.integers(0, 9, S)), t(np.sort(rng.choice(N, D, replace=False))), t([0]))
        return args, dict(level=2, max_set_rows=4)

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
        fn = getattr(cuda_ops, kernel)
        run = lambda: fn(*args, **kw)  # noqa: E731
        if kernel in UPDATED:
            got, want, run = in_place(kernel, fn, args, kw)
        elif kernel == "expand_gather":
            got = run()
            ch, over = tk.expand_gather_plain(*args, **kw)
            want = (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid, over)
        else:
            got, want = run(), tk.dedupe_compact_plain(tk.Expansion(*args), **kw)
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        if err:
            raise AssertionError(f"{root} {name}: max_abs_err {err}")
        _total, parts = device_ms(run)
        out[name] = sum(ms for part, ms in parts.items() if not part.startswith("Memcpy"))
        out[f"{name}_parts"] = parts
    return out


def in_place(kernel: str, fn, args, kw):
    """F1's or P2's outputs and updated inputs from its plain version and
    from the kernel, each on its own clones, and the call to time."""
    import torch

    from keto_tpu_torch.engine import closure_power as tcp
    from keto_tpu_torch.engine import filter_kernel as tfk

    plain = tfk.filter_mark_plain if kernel == "filter_mark" else tcp.power_account_plain
    updated = UPDATED[kernel]

    def side(f):
        a = [x.clone() if i in updated else x for i, x in enumerate(args)]
        return (f(*a, **kw), *(a[i] for i in updated))

    got, want = side(fn), side(plain)
    timed = [x.clone() if i in updated else x for i, x in enumerate(args)]
    if kernel == "filter_mark":
        return got, want, lambda: fn(*timed, **kw)

    def reset_and_run():
        for i in updated:
            timed[i].copy_(args[i])
        return fn(*timed, **kw)

    return got, want, reset_and_run


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

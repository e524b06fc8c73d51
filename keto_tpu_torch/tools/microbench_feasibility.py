"""Three probes of what a hand-written kernel does on the card, at the
sizes of the TPU's feasibility probes (tools/microbench_pallas_feasibility.py):

1. a basic kernel builds and runs: M8, an [8, 128] float32 add;
2. a vector gather of table rows by an index vector, which the TPU does
   not lower inside a kernel: M9, a row gather, supported on Hopper;
3. a gather of (8, 128) blocks by block index, the TPU's supported
   alternative (scalar prefetch): M10, one CTA per block index.

    python -m keto_tpu_torch.tools.microbench_feasibility [--device cpu]

prints a "device" line, then one JSON line per probe as the TPU tool
does. "compile_s" is the seconds nvcc took to build the kernel library in
this process (0.0 when it was built already, or on the CPU, where the
plain versions run).
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..engine import cuda_ops
from ..engine.torch_engine import resolve_device
from .microbench import FP32_OPS_PER_S, Op, device_note, rec

BLOCK = (8, 128)
IDX = [3, 7, 0, 200, 12, 9, 1, 255]
BIDX = [3, 7, 0, 30, 12]


# -- plain versions and dispatchers --------------------------------------------


def add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y


def row_gather_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    return tab[idx.long()]


def block_gather_plain(bidx: torch.Tensor, tab: torch.Tensor, *,
                       block_rows: int) -> torch.Tensor:
    blocks = tab.reshape(tab.shape[0] // block_rows, block_rows, tab.shape[1])
    return blocks[bidx.long()].reshape(-1, tab.shape[1])


def add(x, y):
    return add_plain(x, y) if x.device.type == "cpu" else cuda_ops.mb_add(x, y)


def row_gather(idx, tab):
    if tab.device.type == "cpu":
        return row_gather_plain(idx, tab)
    return cuda_ops.mb_row_gather(idx, tab)


def block_gather(bidx, tab, *, block_rows: int):
    if tab.device.type == "cpu":
        return block_gather_plain(bidx, tab, block_rows=block_rows)
    return cuda_ops.mb_block_gather(bidx, tab, block_rows=block_rows)


def make_inputs(device) -> dict:
    """The TPU tool's constants."""
    x = torch.arange(BLOCK[0] * BLOCK[1], dtype=torch.float32, device=device).reshape(BLOCK)
    return {
        "x": x, "y": torch.ones_like(x),
        "tab": torch.arange(256 * 128, dtype=torch.int32, device=device).reshape(256, 128),
        "idx": torch.tensor(IDX, dtype=torch.int32, device=device),
        "bidx": torch.tensor(BIDX, dtype=torch.int32, device=device),
    }


def ops(device) -> list[Op]:
    """M8-M10 on the tool's constants."""
    t = make_inputs(device)
    x, y, tab, idx, bidx = t["x"], t["y"], t["tab"], t["idx"], t["bidx"]
    C, R = tab.shape[1], BLOCK[0]
    blocks = tab.reshape(tab.shape[0] // R, R, C)
    return [
        Op("basic_kernel", "mb_add", lambda: add(x, y), lambda: add_plain(x, y),
           lambda: torch.add(x, y), 12 * x.numel(), x.numel(), "M8 [8, 128] float32 add",
           ops_per_s=FP32_OPS_PER_S),
        Op("vector_int_indexing", "mb_row_gather", lambda: row_gather(idx, tab),
           lambda: row_gather_plain(idx, tab), lambda: torch.index_select(tab, 0, idx),
           4 * len(IDX) + 2 * 4 * len(IDX) * C, 0, "M9 row gather of [256, 128] by 8 indices"),
        Op("scalar_prefetch_block_gather", "mb_block_gather",
           lambda: block_gather(bidx, tab, block_rows=R),
           lambda: block_gather_plain(bidx, tab, block_rows=R),
           lambda: torch.index_select(blocks, 0, bidx), 4 * len(BIDX) + 2 * 4 * len(BIDX) * R * C,
           0, "M10 gather of (8, 128) blocks by 5 block indices"),
    ]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m keto_tpu_torch.tools.microbench_feasibility",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rec(device=device_note(device))
    t = make_inputs(device)
    out = add(t["x"], t["y"])
    rec(probe="basic_kernel", ok=bool(torch.equal(out, t["x"] + 1.0)),
        compile_s=cuda_ops.build_info.get("seconds", 0.0) if device.type == "cuda" else 0.0)
    got = row_gather(t["idx"], t["tab"])
    rec(probe="vector_int_indexing", ok=bool(torch.equal(got, t["tab"][t["idx"].long()])),
        note="a row gather by an index vector is a kernel on Hopper (M9)")
    got = block_gather(t["bidx"], t["tab"], block_rows=BLOCK[0])
    want = t["tab"].reshape(32, *BLOCK)[t["bidx"].long()].reshape(-1, BLOCK[1])
    rec(probe="scalar_prefetch_block_gather", ok=bool(torch.equal(got, want)), block=list(BLOCK))
    return 0


if __name__ == "__main__":
    sys.exit(main())

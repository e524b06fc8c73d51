"""The Leopard closure probe: a whole batch of checks in one launch, C1
`closure_probe` (csrc/closure_filter_kernels.cu), beside its plain
PyTorch version.

The runtime half of the closure index (engine/closure.py). Where the BFS
check kernel pays one step per nesting level, this answers a batch in
one step whatever the chain depth. Per query (obj, rel, depth, skind, sa,
sb, valid) of the [7, B] pack the check kernel also takes:
  1. the `cc` coverage probe: is the node proven closure-complete?
  2. the `cd` dirty probe (only with has_dirty): has a write since the
     powering possibly perturbed the node's closure?
  3. the `ch` membership probe, keyed like the direct-edge table
     (obj, rel, skind, sa, sb), whose value is the entry's least
     required depth; member = the row matched and 1 <= req <= depth.
A query that is invalid, uncovered or dirty is left unresolved with its
cause code, and the engine sends it to the BFS kernel. A resolved
verdict is final: a covered, clean node's closure set is complete.

The result is the JAX kernel's one int32 vector [member(B) | cause(B) |
stats(8)], the stats being one step's launch counters. The plain version
computes it bit for bit; the dispatcher takes it only for CPU tensors
and launches C1 for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_ops
from .delta import DELTA_PROBES
from .kernel import (
    N_LAUNCH_STATS,
    _edge_key_probe_plain,
    pair_probe_plain,
    tables_from_numpy,
    update_launch_stats,
)
from .snapshot import slots_per_bucket

# kernel-side fallback causes (a launch happened, these queries stay
# unresolved); the host-side causes are in engine/closure.py
CL_CAUSE_OK = 0
CL_CAUSE_UNCOVERED = 1  # node not covered (poison, row cap, outside the universe)
CL_CAUSE_DIRTY = 2  # node possibly perturbed by a write since the powering
CL_CAUSE_INVALID = 3  # the query's vocabulary never encoded

CL_CAUSE_NAMES = {
    CL_CAUSE_UNCOVERED: "uncovered",
    CL_CAUSE_DIRTY: "dirty",
    CL_CAUSE_INVALID: "unindexed",
}

CLOSURE_TABLE_KEYS = ("cc_pack", "ch_pack", "cd_pack")


def closure_tables_from_numpy(packed: dict, device) -> dict[str, torch.Tensor]:
    """Packed closure tables (closure.pack_closure_tables, plus a cd_pack
    for has_dirty launches, or the JAX package's read back as numpy) ->
    int32 tensors."""
    return tables_from_numpy(packed, device, CLOSURE_TABLE_KEYS)


def closure_probe_plain(cc_pack, ch_pack, cd_pack, qpack, *, cc_probes: int, ch_probes: int,
                        has_dirty: bool, layout: str) -> torch.Tensor:
    """The closure verdicts of a [7, B] query pack: [member(B) | cause(B)
    | stats(8)] int32. `cd_pack` is read only when has_dirty."""
    B = qpack.shape[1]
    obj, rel, depth, skind, sa, sb = (qpack[i] for i in range(6))
    valid = qpack[6] != 0
    rels = rel[:, None]
    spb_pair, spb_edge = slots_per_bucket(2, layout), slots_per_bucket(5, layout)
    covered = pair_probe_plain(cc_pack, obj, rels, probes=cc_probes, spb=spb_pair,
                               n_vals=1)[:, 0, 0] == 1
    if has_dirty:
        dval = pair_probe_plain(cd_pack, obj, rels, probes=DELTA_PROBES, spb=spb_pair,
                                n_vals=1)[:, 0, 0]
        dirty = dval.clamp(min=0) == 1
    else:
        dirty = torch.zeros(B, dtype=torch.bool, device=qpack.device)
    z = torch.zeros_like(obj)
    key = torch.stack([obj, rel, skind, sa, sb, z, z, z], dim=-1)
    found, req = _edge_key_probe_plain(ch_pack, key, ch_probes, spb_edge)
    resolved = valid & covered & ~dirty
    member = resolved & found & (req >= 1) & (req <= depth)
    cause = torch.where(
        ~valid, CL_CAUSE_INVALID,
        torch.where(~covered, CL_CAUSE_UNCOVERED,
                    torch.where(dirty, CL_CAUSE_DIRTY, CL_CAUSE_OK)),
    ).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=qpack.device)
    stats = update_launch_stats(
        torch.zeros(N_LAUNCH_STATS, dtype=torch.int32, device=qpack.device), zero + B,
        valid.sum(), member.sum(), zero, zero,
    )
    return torch.cat([member.to(torch.int32), cause, stats]).to(torch.int32)


def closure_probe(cc_pack, ch_pack, cd_pack, qpack, *, cc_probes: int, ch_probes: int,
                  has_dirty: bool, layout: str) -> torch.Tensor:
    fn = closure_probe_plain if qpack.device.type == "cpu" else cuda_ops.closure_probe
    return fn(cc_pack, ch_pack, cd_pack, qpack, cc_probes=cc_probes, ch_probes=ch_probes,
              has_dirty=has_dirty, layout=layout)


def closure_kernel_packed(
    tables: dict,
    qpack: torch.Tensor,
    *,
    cc_probes: int,
    ch_probes: int,
    has_dirty: bool,
    layout: str,
) -> torch.Tensor:
    """One closure launch over the [7, B] query pack (obj, rel, depth,
    skind, sa, sb, valid), the check kernel's; the result is one int32
    vector [member(B) | cause(B) | stats(N_LAUNCH_STATS)]."""
    qpack = qpack.to(torch.int32).contiguous()
    return closure_probe(
        tables["cc_pack"], tables["ch_pack"], tables.get("cd_pack"), qpack,
        cc_probes=cc_probes, ch_probes=ch_probes, has_dirty=has_dirty, layout=layout,
    )


def unpack_closure_results(flat: np.ndarray, B: int):
    """(member[B] bool, cause[B] int32, stats[N_LAUNCH_STATS]) of one
    closure result vector."""
    return (flat[:B].astype(bool), flat[B : 2 * B],
            flat[2 * B : 2 * B + N_LAUNCH_STATS])


def estimate_closure_gather_bytes(B: int, cc_probes: int, ch_probes: int,
                                  has_dirty: bool, layout: str = "bucketized") -> int:
    """Bytes one closure launch gathers: each probe chain reads
    ceil(probes / spb) bucket rows per query (256 B each when bucketized,
    one slot when compact)."""
    def rows(probes: int, n_keys: int, width: int) -> int:
        spb = slots_per_bucket(n_keys, layout)
        return -(-int(probes) // spb) * spb * width * 4

    b = B * rows(cc_probes, 2, 4) + B * rows(ch_probes, 5, 8)
    if has_dirty:
        b += B * rows(DELTA_PROBES, 2, 4)
    return b

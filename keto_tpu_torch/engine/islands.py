"""Island combine: host-side evaluation of AND/NOT rewrite circuits.

The kernel evaluates every island leaf (a computed/TTU sub-check under an
AND/NOT rewrite) as a full BFS exploration that accumulates hits in its
own ctx slot. What remains is boolean algebra over those leaf bits.
Two-valued logic is exact for check verdicts: Keto's or/and collapse
Unknown to NotMember.

Islands are allocated in BFS step order, so a nested island always has a
higher index than its parent: walking indices in reverse resolves inner
islands first.
"""

from __future__ import annotations

import numpy as np

from .snapshot import CIRC_AND, CIRC_FALSE, CIRC_LEAF, CIRC_NOT, CIRC_OR


def eval_circuit(ops: tuple, leaves: np.ndarray) -> bool:
    """Evaluate one postfix boolean circuit over the island's leaf bits."""
    stack: list[bool] = []
    for op in ops:
        code = op[0]
        if code == CIRC_LEAF:
            stack.append(bool(leaves[op[1]]))
        elif code == CIRC_FALSE:
            stack.append(False)
        elif code == CIRC_NOT:
            stack[-1] = not stack[-1]
        elif code == CIRC_AND:
            b = stack.pop()
            stack[-1] = stack[-1] and b
        elif code == CIRC_OR:
            b = stack.pop()
            stack[-1] = stack[-1] or b
        else:
            raise ValueError(f"unknown circuit op {code!r}")
    return stack[-1]


def combine_islands(
    ctx_hit: np.ndarray,
    isl_parent: np.ndarray,
    isl_pid: np.ndarray,
    n_isl: int,
    circuits: dict,
    n_queries: int,
    K: int,
) -> np.ndarray:
    """Resolve all island instances inner-first; returns the per-query
    verdicts ctx_hit[:B] (mutates the ctx_hit passed in)."""
    for i in range(n_isl - 1, -1, -1):
        base = n_queries + i * K
        if eval_circuit(circuits[int(isl_pid[i])], ctx_hit[base : base + K]):
            ctx_hit[int(isl_parent[i])] = True
    return ctx_hit[:n_queries]

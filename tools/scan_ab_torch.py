"""Time K1 `edge_probe`, K2 `pair_probe`, K3 `expand_gather`, K4
`dedupe_compact`, F1 `filter_mark`, P1 `power_step`, P2 `power_account`,
P3 `power_poison`, L1 `list_emit`, L2 `reverse_gather`, L3
`subjects_gather`, L4 `list_pool_compact`, X1 `expand_emit` and X2
`pool_compact` of one or more checkouts of
keto_tpu_torch on one NVIDIA card, in turns, on the same inputs; and the
card's dependent round trip (`chase`).

    python tools/scan_ab_torch.py --roots _checkout/parent . . _checkout/parent
    python tools/scan_ab_torch.py --cases l1_list_objects x1_expand --roots . _checkout/parent
    python tools/scan_ab_torch.py --cases p1_wave p1_dense p3_wave p3_all --roots . _checkout/parent
    python tools/scan_ab_torch.py --cases l2_list_objects l2_filter k1_check k1_delta \
        k1_compact chase --roots _checkout/parent . . _checkout/parent
    python tools/scan_ab_torch.py --cases l3_list_subjects k2_check k2_expand \
        k2_list_objects k2_distinct k2_compact chase --roots _checkout/parent . . _checkout/parent
    python tools/scan_ab_torch.py --cases l4_list_objects l4_list_subjects l4_overflow \
        l4_wide x2_expand chase --roots _checkout/parent . . _checkout/parent

Each root runs in a process of its own, which imports keto_tpu_torch from
that root (so its kernels build from the root's csrc/ into the root's
_build/), makes the inputs from a seed at the shapes of chip_smoke.py's
cells, holds each kernel to its plain version (max_abs_err must be 0) and
times it: device ms per call from torch.profiler, every kernel and memset
of the call (a P3 call of an older checkout is two kernels and a
memset), its mean time a launch times its launches a call, and those
parts by name; and wall ms per call (`<case>_wall`), between CUDA events
around back-to-back calls (the least of 21 windows), the wrapper's
host work and any copies back included. F1, P1, P2, L1 and X1 update
inputs in place: each side of the comparison works on its own clones, F1
is timed on one set of clones call after call (as chip_smoke.py times
it), and each timed P1, P2, L1 or X1 call first copies back what the next
call would otherwise see changed (P1's R, counts and stats, P2's level
plane and status, L1's result counts and causes, X1's edge counts and
flags; the copies are reported among the parts, not in the kernel's
time; L1's and X1's buffers are written at the same slots every call).
The inputs are drawn, not captured: chip_smoke.py times the kernels on
real batches.
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
# pass's heavy case). P1: (N nodes, lanes, E edges) of the same wave
# (32,768 edges, the tail padding at the dummy node), on a step-1
# frontier as sparse as the wave's, one bit a source (p1_wave), and on one
# word of F in eight non-zero (p1_dense). P3: (N nodes, lanes, poisoned
# nodes) of the same wave, three nodes poisoned (p3_wave) or every node
# (p3_all). L1: (N entries, B queries, R result cap):
# ListObjects' step-2 launch (the 2^20 frontier cap, 256 queries, 4,096
# results a query) and ListSubjects' (16,384, 256, 2,048). X1: (F tasks,
# B queries, E edge cap): Expand's step-1 launch (4,096, 1,024, 16,384),
# and a one-subject Expand (TorchCheckEngine.expand): the engine's
# smallest bucket of 16 queries, one of them live, at expand_batch's
# default caps (frontier 1,024, edge cap 4,096), so every live task of a
# round has one query. L2: (F tasks, B queries, RK inverted entries a
# relation): ListObjects' step shape (the 2^20 frontier cap, 256 queries,
# the videos namespace's one inverted entry a relation) and the filter
# walk's (16,384 tasks, one query). K1: (F tasks, table slots, probes):
# Check's frontier of 8,192 on a 2^21-slot table (64 MB, past the 50 MB
# L2, as the videos-1e6 table is) of one bucket row a probe sequence
# (bucketized, k1_check), with the overlay (k1_delta), and under the
# compact layout at 12 probes (two rounds of 16 lanes, k1_compact).
# L3: (F tasks, B queries, K instruction lanes): ListSubjects' step shape
# (its frontier of 16,384, 256 queries, the videos namespace's two lanes).
# K2: (F tasks, S slots a task, probes): Check's step-2 launch (8,192
# tasks, S = K + 1 = 3, both value lanes, k2_check), every key distinct at
# that shape (k2_distinct), and under the compact layout at 12 probes
# (k2_compact); Expand's step launch (4,096 tasks, one slot, one value
# lane, k2_expand); ListObjects' step launch (the 2^20 frontier cap, one
# slot of relation 0, both lanes, k2_list_objects); all on a 2^22-slot
# table (64 MB, past the 50 MB L2) of one bucket row a probe sequence
# under the bucketized layout.
# L4: (B queries, R result cap, P pool cap): ListObjects' launch (256
# queries, 4,096 results a query, a pool of 2^20), ListSubjects' (256,
# 2,048, 16,384), ListObjects' counts into a pool of 2^18, below their
# total (l4_overflow), and the engine's largest batch, 16,384 queries, at
# ListSubjects' pool of 64 a query (l4_wide). X2: (B queries, E edge cap,
# P pool rows): Expand's launch (1,024, 16,384, 32,768).
# chase: one thread following a random cycle of (lines of 128 B, L2
# lines, steps a call): a dependent round trip to DRAM and to L2, and an empty
# kernel on K1's grid at k1_check's shape: K1's latency floor is that
# launch and three trips, K2's that launch and two.
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
    "p1_wave": ("power_step", 32768, 2048, 32768),
    "p1_dense": ("power_step", 32768, 2048, 32768),
    "p3_wave": ("power_poison", 32768, 2048, 3),
    "p3_all": ("power_poison", 32768, 2048, 32768),
    "l1_list_objects": ("list_emit", 1 << 20, 256, 4096),
    "l1_list_subjects": ("list_emit", 16384, 256, 2048),
    "x1_expand": ("expand_emit", 4096, 1024, 16384),
    "x1_one_subject": ("expand_emit", 1024, 16, 4096),
    "l2_list_objects": ("reverse_gather", 1 << 20, 256, 1),
    "l2_filter": ("reverse_gather", 16384, 1, 1),
    "k1_check": ("edge_probe", 8192, 1 << 21, 8),
    "k1_delta": ("edge_probe", 8192, 1 << 21, 8),
    "k1_compact": ("edge_probe", 8192, 1 << 21, 12),
    "l3_list_subjects": ("subjects_gather", 16384, 256, 2),
    "k2_check": ("pair_probe", 8192, 3, 16),
    "k2_distinct": ("pair_probe", 8192, 3, 16),
    "k2_compact": ("pair_probe", 8192, 3, 12),
    "k2_expand": ("pair_probe", 4096, 1, 16),
    "k2_list_objects": ("pair_probe", 1 << 20, 1, 16),
    "l4_list_objects": ("list_pool_compact", 256, 4096, 1 << 20),
    "l4_list_subjects": ("list_pool_compact", 256, 2048, 16384),
    "l4_overflow": ("list_pool_compact", 256, 4096, 1 << 18),
    "l4_wide": ("list_pool_compact", 16384, 64, 64 * 16384),
    "x2_expand": ("pool_compact", 1024, 16384, 32768),
    "chase": ("chase", 1 << 21, 1 << 12, 4096),
}
# the arguments each kernel updates in place, and those a timed call
# first copies back
UPDATED = {"filter_mark": (6, 7), "power_step": (1, 4, 5), "power_account": (1, 4),
           "list_emit": (3, 4, 5), "expand_emit": (11, 12, 13)}
RESET = {"power_step": (1, 4, 5), "power_account": (1, 4), "list_emit": (4, 5),
         "expand_emit": (12, 13)}


def inputs(name: str, dev):
    """(args, kwargs) of the case's wrapper, drawn from seed 0: K3 a
    quarter of the slots non-empty (the total stays under F, as on a batch
    that needs no host replay); K4 narrow keys (duplicates and bucket
    collisions) with 80% valid; F1 a sorted column padded as the walk pads
    it, objects that hit it a quarter of the time, 90% live; P2 reach
    counts of 0-8 against a row cap of 4, so about half the sources are
    killed, and two fresh bits a source at random nodes (as a chain
    advances a node a step; p2_wave) or one fresh word in eight non-zero
    (p2_dense); P1 24,000 nodes below the dummy, 20,000 edges from
    distinct sources (as on chains, each node one out-edge) to random
    destinations, sorted by destination, the rest padding at the dummy,
    and R = F as at a wave's first step: F one bit for each of 2,045
    sources at distinct nodes (p1_wave) or one word in eight non-zero
    (p1_dense); P3 a seen matrix with one word in eight non-zero and
    three random nodes poisoned (p3_wave) or all (p3_all); L1 a frontier
    whose first 60% are live, grouped by query (K4 keeps task order), two
    in three of them emitting, the padding tail not, into result counts a
    few slots deep; X1 half the frontier live,
    grouped by query (all on query 0 in x1_one_subject), at depths 1-6, on
    rows of 0-16 edges, into edge counts a few slots deep (rows land, and
    the step emits most of its 4F budget); L2 the first 9.7% of the
    frontier live, grouped by query, each with a reverse-edge row of a
    geometric length (mean 4, at most 120) at a random start, over the
    videos namespace's rewrite (COMPUTED into one relation, TTU into
    another), as on ListObjects' step-1 launch on videos-1e6 (101,538 live
    tasks of 2^20, 402,600 row edges, the longest 120); L3 the first 6%
    of the frontier live (a ListSubjects step's few hundred tasks), grouped
    by query, at depths 1-5, with spans of 0-3 edges and the videos
    namespace's lanes (COMPUTED, then TTU) on the tasks of the rewritten
    relation; K1 random keys on a random table (every probed row is read
    and compared, hit or not), 90% live; K2 a live head and a zero-filled
    tail (k2_inputs); L4 counts drawn around ListObjects' ~1,950 used
    results a query (one in 16 at R, one in 32 past it, one in 32
    negative), 0-3 a query at ListSubjects' shape, 0-40 at l4_wide's,
    causes mostly 0; X2 counts of 0-30 a query (about half Expand's pool
    used), one root and one host flag in ten."""
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

    if kernel == "power_step":
        N, S, E = n, F, m
        W, n_sub, n_edges = S // 32, 24_000, 20_000
        src = rng.choice(n_sub, n_edges, replace=False)
        dst = rng.integers(0, n_sub, n_edges)
        order = np.argsort(dst, kind="stable")
        e_src, e_dst = np.full(E, n_sub), np.full(E, n_sub)
        e_src[:n_edges], e_dst[:n_edges] = src[order], dst[order]
        if name == "p1_dense":
            f = rng.integers(0, 1 << 32, (N, W), dtype=np.uint64)
            f &= rng.integers(0, 1 << 32, (N, W), dtype=np.uint64)
            f[rng.random((N, W)) >= 0.125] = 0
            f[n_sub:] = 0
        else:
            f = np.zeros((N, W), np.uint64)
            lane = np.arange(S - 3)
            f[rng.choice(n_sub, S - 3, replace=False), lane // 32] = (
                np.uint64(1) << (lane % 32).astype(np.uint64))
        F_ = t(f.astype(np.uint32).view(np.int32))
        counts = np.zeros(S)
        counts[:S - 3] = 1
        return (F_, F_.clone(), t(e_src), t(e_dst), t(counts), t(np.zeros(8)),
                t([int(np.unpackbits(f.astype(np.uint32).view(np.uint8)).sum())])), {}
    if kernel == "power_poison":
        N, S, n_pois = n, F, m
        W = S // 32
        r = rng.integers(0, 1 << 32, (N, W), dtype=np.uint64)
        r[rng.random((N, W)) >= 0.125] = 0
        pois = np.zeros(N, np.uint8)
        pois[rng.choice(N, n_pois, replace=False)] = 1
        return (t(r.astype(np.uint32).view(np.int32)), torch.from_numpy(pois).to(dev),
                t(rng.integers(0, 9, S)), t(rng.integers(0, 1000, 8))), {}

    if kernel == "list_emit":
        N, B, R = n, F, m
        n_live = int(0.6 * N)
        q = np.zeros(N, np.int64)
        q[:n_live] = np.sort(rng.integers(0, B, n_live))
        emit = torch.from_numpy((rng.random(N) < 2 / 3) & (np.arange(N) < n_live)).to(dev)
        return (t(q), emit, t(rng.integers(0, 1 << 20, N)), t(np.full(B * R, -1)),
                t(rng.integers(0, R // 8, B)), t(np.zeros(B))), dict(result_cap=R)
    if kernel == "expand_emit":
        F, B, E = n, F, m
        n_rows = 5000
        row_ptr = np.concatenate([[0], np.cumsum(rng.integers(0, 17, n_rows))])
        n_edges = int(row_ptr[-1])
        q = np.zeros(F, np.int64)
        q[:F // 2] = np.sort(rng.integers(0, 1 if name == "x1_one_subject" else B, F // 2))
        live = torch.from_numpy(np.arange(F) < F // 2).to(dev)
        eb = tuple(t(np.full(B * E, -1)) for _ in range(5))
        return (t(q), t(rng.integers(0, 1 << 20, F)), t(rng.integers(0, 6, F)),
                t(rng.integers(1, 7, F)), live, t(rng.integers(-1, n_rows, F)),
                t(np.full(F, -1)), t(row_ptr), t(rng.integers(0, 2, n_edges)),
                t(rng.integers(0, 1 << 20, n_edges)), t(rng.integers(0, 6, n_edges)), eb,
                t(rng.integers(0, E // 16, B)),
                torch.zeros(B, dtype=torch.bool, device=dev)), dict(edge_cap=E)
    if kernel == "expand_gather":
        S, B, n_edges = m, 4096, 1 << 20
        counts = (rng.random((F, S)) < 0.23) * rng.integers(1, 2, (F, S))
        e_pack = np.stack([rng.integers(0, 1 << 20, n_edges), rng.integers(0, 6, n_edges)], 1)
        args = (t(counts), t(rng.integers(0, n_edges - 2, (F, S))), t(rng.integers(0, B, (F, S))),
                t(rng.integers(0, 6, (F, S))), t(rng.integers(0, 2, (F, S))),
                t(rng.integers(0, B, F)), t(rng.integers(0, 1 << 20, F)),
                t(rng.integers(0, 6, F)), t(e_pack))
        return args, dict(wildcard_rel=5, n_queries=B)
    if kernel == "reverse_gather":
        from keto_tpu_torch.engine.reverse_kernel import RINSTR_COMPUTED, RINSTR_TTU

        B, RK, ncr, n_obj, n_red = F, m, 4, 1 << 20, 792_000
        live = np.arange(n) < int(0.097 * n)
        q = np.zeros(n, np.int64)
        q[live] = np.sort(rng.integers(0, B, int(live.sum())))
        rel = rng.integers(1, ncr, n)
        rlen = np.where(live, np.minimum(rng.geometric(0.25, n), 120), 0)
        rstart = np.where(rlen > 0, rng.integers(0, n_red - 120, n), -1)
        rinstr = np.zeros((ncr, 4 * RK), np.int64)
        rinstr[1, :4] = (RINSTR_COMPUTED, 3, 0, 0)
        rinstr[3, :4] = (RINSTR_TTU, 3, 1, 0)
        rv = np.stack([rng.integers(0, n_obj, n_red), rng.integers(0, ncr, n_red),
                       rng.integers(0, ncr, n_red), np.zeros(n_red, np.int64)], 1)
        return (t(q), t(rng.integers(0, n_obj, n)), t(rel), t(rng.integers(1, 6, n)),
                torch.from_numpy(live).to(dev), t(np.zeros(n)), t(rstart), t(rlen), t(rinstr),
                t(rv), t(np.zeros(n_obj))), dict(wildcard_rel=0, n_config_rels=ncr,
                                                 n_queries=B)
    if kernel == "pair_probe":
        return k2_inputs(name, dev)
    if kernel == "list_pool_compact":
        B, R, P = n, F, m
        if name in ("l4_list_objects", "l4_overflow"):
            counts = rng.normal(1950, 600, B).astype(np.int64)
            pick = rng.random(B)
            counts = np.where(pick < 1 / 16, R, counts)
            counts = np.where((pick >= 1 / 16) & (pick < 3 / 32), R + rng.integers(1, 99, B),
                              counts)
            counts = np.where((pick >= 3 / 32) & (pick < 1 / 8), -rng.integers(1, 9, B), counts)
        else:
            counts = rng.integers(0, 4 if name == "l4_list_subjects" else 41, B)
        needs = np.where(rng.random(B) < 0.05, rng.integers(1, 9, B), 0)
        return (t(rng.integers(-1, 1 << 20, B * R)), t(counts), t(needs),
                t(rng.integers(0, 1000, 8))), dict(result_cap=R, pool_cap=P)
    if kernel == "pool_compact":
        B, E, P = n, F, m
        eb = tuple(t(rng.integers(-1, 1 << 20, B * E)) for _ in range(5))
        flags = [torch.from_numpy(rng.random(B) < 0.1).to(dev) for _ in range(2)]
        return (eb, t(rng.integers(0, 31, B)), *flags, t(rng.integers(0, 1000, 8))), dict(
            edge_cap=E, pool_cap=P)
    if kernel == "subjects_gather":
        from keto_tpu_torch.engine.snapshot import INSTR_COMPUTED, INSTR_TTU

        F, B, K, n_edges = n, F, m, 1 << 20
        live = np.arange(F) < int(0.06 * F)
        q = np.zeros(F, np.int64)
        q[live] = np.sort(rng.integers(0, B, int(live.sum())))
        rel = np.where(live, rng.integers(1, 4, F), 0)
        lanes = np.where(rel[:, None] == 3, [[INSTR_COMPUTED, INSTR_TTU]], 0)
        start = np.where(live[:, None], rng.integers(-1, n_edges - 4, (F, K + 1)), -1)
        spans = np.stack([start, np.where(start < 0, -1, start + rng.integers(0, 4, (F, K + 1)))],
                         -1)
        fe = np.stack([rng.integers(0, 2, n_edges), rng.integers(0, 1 << 20, n_edges),
                       rng.integers(0, 4, n_edges), np.zeros(n_edges, np.int64)], 1)
        return (t(q), t(np.where(live, rng.integers(0, 1 << 20, F), 0)),
                t(np.where(live, rng.integers(1, 6, F), 0)), torch.from_numpy(live).to(dev),
                t(spans), t(lanes), t(np.where(lanes > 0, 2, 0)), t(np.where(lanes > 0, 3, 0)),
                t(fe)), dict(wildcard_rel=0, n_queries=B)
    if kernel == "edge_probe":
        slots, probes = F, m
        spb = 1 if name == "k1_compact" else 8
        has_delta = name == "k1_delta"
        pack = t(rng.integers(0, 1 << 16, (slots, 8))).reshape(slots, 8)
        dd = t(rng.integers(0, 1 << 16, (8192, 8))).reshape(8192, 8) if has_delta else None
        B = 4096
        qsub = t(np.stack([rng.integers(0, 2, B), rng.integers(0, 1 << 16, B),
                           rng.integers(0, 8, B), np.zeros(B)], 1)).reshape(B, 4)
        return (pack, dd, t(rng.integers(0, 1 << 16, n)), t(rng.integers(0, 8, n)),
                t(rng.integers(0, B, n)), qsub, t(rng.integers(0, 7, n)),
                torch.from_numpy(rng.random(n) < 0.9).to(dev)), dict(
                    dh_probes=probes, spb=spb, has_delta=has_delta)
    G, B = n, m
    q = rng.integers(0, B, G)
    cols = (t(q), t(q), t(rng.integers(0, max(G // 64, 40), G)), t(rng.integers(0, 3, G)),
            t(rng.integers(-1, 6, G)))
    valid = torch.from_numpy(rng.random(G) < 0.8).to(dev)
    return (*cols, valid), dict(F=F, n_queries=B)


def k2_inputs(name: str, dev):
    """K2's drawn (args, kwargs): a table of random entries in which half
    the live keys are planted in the first row of their probe sequence
    (hits and misses, every probed row read and compared either way), and
    a frontier whose live head is followed by the tail K4 leaves, zeros.
    k2_check and k2_compact: 60% of the tasks live, a task's slots its
    relation (one of three) and two instruction lanes, zero where the
    relation has no program (so a task repeats the key (obj, 0)); objects
    from 2^20, so a warp's keys are nearly all distinct; k2_distinct: every
    task live and every (task, slot) key distinct; k2_expand: half the
    tasks live, one slot, one value lane; k2_list_objects: the measured
    9.7% live (see inputs' L2), one slot of relation 0."""
    import numpy as np
    import torch

    from keto_tpu_torch.engine import kernel as tk

    _kernel, F, S, probes = CASES[name]
    rng = np.random.default_rng(1)
    spb = 1 if name == "k2_compact" else 16
    cap = 1 << 22
    n_live = {"k2_distinct": F, "k2_expand": F // 2,
              "k2_list_objects": int(0.097 * F)}.get(name, int(0.6 * F))
    obj = np.zeros(F, np.int64)
    rels = np.zeros((F, S), np.int64)
    if name == "k2_distinct":
        obj[:] = rng.permutation(1 << 20)[:F]
        rels[:] = np.arange(1, S + 1)
    else:
        obj[:n_live] = rng.integers(1, 1 << 20, n_live)
        if name != "k2_list_objects":
            rel = rng.integers(1, 4, n_live)
            rels[:n_live, 0] = rel
            if S > 1:
                rels[:n_live, 1:] = np.where(rel[:, None] == 3, [[1, 2]], 0)[:, : S - 1]
    pack = np.stack([rng.integers(1, 1 << 20, cap), rng.integers(1, 8, cap),
                     rng.integers(0, 1 << 24, cap), rng.integers(0, 1 << 24, cap)], 1)
    ko, kr = np.broadcast_to(obj[:, None], rels.shape)[:n_live], rels[:n_live]
    plant = rng.random(ko.shape) < 0.5
    h1 = tk.hash_combine(torch.from_numpy(ko[plant]), torch.from_numpy(kr[plant])).numpy()
    slot = (h1 & (cap // spb - 1)) * spb + rng.integers(0, spb, h1.shape[0])
    pack[slot, 0], pack[slot, 1] = ko[plant], kr[plant]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    n_vals = 1 if name == "k2_expand" else 2
    return (t(pack), t(obj), t(rels)), dict(probes=probes, spb=spb, n_vals=n_vals)


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


def wall_ms(fn, reps: int = REPS, windows: int = 21) -> float:
    """Ms per call between CUDA events around `reps` back-to-back calls,
    the least of `windows` windows: the host's enqueue of each call is
    included, and the host's cores are shared, so a stall only ever adds
    to a window (medians of five windows spread over 2x on one checkout)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return min(times)


def worker(root: str, cases: list[str]) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from keto_tpu_torch.engine import closure_power as tcp
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import expand_kernel as tek
    from keto_tpu_torch.engine import kernel as tk
    from keto_tpu_torch.engine import reverse_kernel as trk

    cuda_ops.library()
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    for name in cases:
        kernel = CASES[name][0]
        if kernel == "chase":
            out.update(chase(cuda_ops))
            continue
        args, kw = inputs(name, torch.device("cuda"))
        fn = getattr(cuda_ops, kernel)
        run = lambda: fn(*args, **kw)  # noqa: E731
        if kernel in UPDATED:
            got, want, run = in_place(kernel, fn, args, kw)
        elif kernel == "power_poison":
            got, want = (run(),), (tcp.power_poison_plain(*args),)
        elif kernel == "reverse_gather":
            got = run()
            ch, cause = trk.reverse_gather_plain(*args, **kw)
            want = (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid, cause)
        elif kernel == "edge_probe":
            got, want = (run(),), (tk.edge_probe_plain(*args, **kw),)
        elif kernel == "pair_probe":
            got, want = (run(),), (tk.pair_probe_plain(*args, **kw),)
        elif kernel == "subjects_gather":
            got = run()
            ch, emit, value, cause = trk.subjects_gather_plain(*args, **kw)
            want = (ch.q, ch.ctx, ch.obj, ch.rel, ch.depth, ch.valid, emit, value, cause)
        elif kernel == "list_pool_compact":
            got, want = (run(),), (trk.list_pool_compact_plain(*args, **kw),)
        elif kernel == "pool_compact":
            got, want = (run(),), (tek.pool_compact_plain(*args, **kw),)
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
        out[f"{name}_wall"] = wall_ms(run)
    return out


CHASE_SOURCE = r"""
#include <cuda_runtime.h>

__global__ void chase_kernel(const unsigned* __restrict__ next, int steps, int cg,
                             unsigned* __restrict__ out) {
  unsigned x = *out;  // where the last call stopped: no line is visited twice
  for (int s = 0; s < steps; ++s) x = cg ? __ldcg(next + x) : next[x];
  *out = x;
}

__global__ void empty_kernel() {}

extern "C" int chase(const unsigned* next, int steps, int cg, unsigned* out, void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, cg, out);
  return (int)cudaGetLastError();
}

extern "C" int empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def chase(cuda_ops) -> dict:
    """The dependent round trips of one thread: a random cycle over
    `lines` 128-byte lines (DRAM: 256 MB, past L2; each call goes on where
    the last stopped, so no line is read twice) or `l2_lines` (512 KB,
    the whole cycle read by the warm-up call, then in L2 and read past
    L1), `steps` steps a call, device ms a step; and an empty kernel on
    K1's grid at k1_check's shape (8,192 tasks of 16 threads). The two
    kernels are built from CHASE_SOURCE into the root's _build/: they
    probe the card and are no kernels of the port."""
    import ctypes

    import numpy as np
    import torch

    _kernel, lines, l2_lines, steps = CASES["chase"]
    so = cuda_ops.BUILD_DIR / "chase.so"
    if not so.exists():
        src = cuda_ops.BUILD_DIR / "chase.cu"
        cuda_ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(CHASE_SOURCE)
        subprocess.run([cuda_ops._nvcc(), *cuda_ops.NVCC_FLAGS, "-shared", "-o", str(so),
                        str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p]
    lib.empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rng = np.random.default_rng(0)
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = {}
    for label, n, cg in (("dram", lines, 0), ("l2", l2_lines, 1)):
        out.zero_()
        perm = rng.permutation(n)
        nxt = np.zeros(n * 32, np.uint32)
        nxt[perm * 32] = np.roll(perm, -1) * 32  # one cycle through every line, from 0
        buf = torch.from_numpy(nxt.view(np.int32)).cuda()
        stream = torch.cuda.current_stream().cuda_stream

        def run(buf=buf, cg=cg, stream=stream):
            if lib.chase(buf.data_ptr(), steps, cg, out.data_ptr(), stream):
                raise RuntimeError("chase launch failed")

        ms, _parts = device_ms(run, reps=5)
        got[f"chase_{label}_ms"] = ms / steps
    blocks = -(-8192 * 16 // 256)

    def run_empty():
        if lib.empty(blocks, 256, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("empty launch failed")

    got["chase_launch_ms"], _parts = device_ms(run_empty)
    got["k1_floor_ms"] = got["chase_launch_ms"] + 3 * got["chase_dram_ms"]
    got["k2_floor_ms"] = got["chase_launch_ms"] + 2 * got["chase_dram_ms"]
    return got


def in_place(kernel: str, fn, args, kw):
    """F1's, P1's, P2's, L1's or X1's outputs and updated inputs from its plain
    version and from the kernel, each on its own clones (as flat lists of
    tensors), and the call to time."""
    from keto_tpu_torch.engine import closure_power as tcp
    from keto_tpu_torch.engine import expand_kernel as tek
    from keto_tpu_torch.engine import filter_kernel as tfk
    from keto_tpu_torch.engine import reverse_kernel as trk

    plain = {"filter_mark": tfk.filter_mark_plain, "power_step": tcp.power_step_plain,
             "power_account": tcp.power_account_plain, "list_emit": trk.list_emit_plain,
             "expand_emit": tek.expand_emit_plain}[kernel]
    updated = UPDATED[kernel]

    def clone(x):
        return tuple(y.clone() for y in x) if isinstance(x, tuple) else x.clone()

    def flat(x):
        return [y for z in x for y in flat(z)] if isinstance(x, (tuple, list)) else [x]

    def side(f):
        a = [clone(x) if i in updated else x for i, x in enumerate(args)]
        return flat([f(*a, **kw), *(a[i] for i in updated)])

    got, want = side(fn), side(plain)
    timed = [clone(x) if i in updated else x for i, x in enumerate(args)]
    if kernel not in RESET:
        return got, want, lambda: fn(*timed, **kw)

    def reset_and_run():
        for i in RESET[kernel]:
            timed[i].copy_(args[i])
        return fn(*timed, **kw)

    return got, want, reset_and_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--cases", nargs="+", choices=sorted(CASES), default=list(CASES))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available: the kernels need an NVIDIA card", file=sys.stderr)
        return 1
    if a.worker:
        print(json.dumps(worker(a.worker, a.cases)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    rc = 0
    for root in a.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                               "--cases", *a.cases],
                              capture_output=True, text=True, timeout=600)
        print(proc.stdout.strip() or json.dumps({"root": root, "rc": proc.returncode,
                                                 "stderr": proc.stderr[-2000:]}), flush=True)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

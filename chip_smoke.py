"""Smoke run of keto_tpu_torch on one NVIDIA card: the quickest proof that
the port builds, agrees with itself and runs its main path on the GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

  1. card    — nvidia-smi's name and power limit; torch's, grpc's and
               protobuf's versions, and PyYAML's (or its absence: phase
               13's config is then JSON)
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
 4w. write   — (run after phase 10, with 8w, 10w and 9w, so that every
               phase before measures the stores as loaded) the write path
               on phase 4's engine: (a) one write of 64
               inserts and 64 deletes folds into the delta overlay (timed);
               the next batch of 4096 checks runs every launch with
               has_delta (the "check_write" launch path: K1-K4 launched),
               its only host replays are dirty_row replays (counted), 512
               sampled verdicts equal the oracle's, and K1-K4 are held to
               their plain versions on inputs captured from it (the
               edge_probe and pair_probe rows' "write" entries, and
               pair_probe's "write_dirty" at the step-1 dirty-row probe);
               (b) one write of 4,096 ops overflows the overlay and
               compacts the mirror (incremental_merges + 1, no snapshot
               build), timed against phase 4a's full build, and the next
               batch runs on the new base with zero host replays
  5. islands — an AND/NOT namespace batch against the host oracle
  6. serve   — `python -m keto_tpu_torch serve` (a Registry and a Daemon)
               on free ports: a 200, a
               403, a batch check, an expand tree, an expand 404, a
               list-objects and a list-subjects 200 and a list-objects 400,
               a check with a snaptoken ahead of the store (409) and a
               list-objects with a satisfied one; then a PUT, a PATCH and a
               DELETE on the write listener, each seen by a check that
               carries the token it returned; GET /version and GET
               /relation-tuples a tuple a page, all on the default serve
               keys; then over gRPC on the same ports (each port answers
               REST and gRPC through its mux) a Transact on the write
               port, Check (allowed and denied at its token), BatchCheck,
               Expand, ListObjects, ListSubjects, Filter,
               ListRelationTuples a tuple a page, Version and Health on
               both ports, each equal to the REST route's answer on the
               same port and to the host oracle's; serve exits 0 on
               SIGTERM; then a second serve with a 500 ms batch window, a
               gRPC Health Watch stream open on it, and SIGTERM while a
               check waits in that window: /health/ready answers 503, a
               new check 429 (draining) and a gRPC Check
               RESOURCE_EXHAUSTED with the same message and a
               `retry-after` of 1, the admitted check 200, the stream
               SERVING then NOT_SERVING, and serve exits 0
 6b. serve under load — a Registry over phase 4's store (dsn memory) and a
               Daemon with the default serve keys on free ports; 32
               closed-loop REST clients (bench.py:72-73's SERVE_THREADS and
               SERVE_SECONDS) in a process of their own for 8 s, single
               checks drawn by phase 4's law without repeat (cache misses),
               then 2 s over 256 hot checks (cache hits, singleflight):
               checks/s, per-request p50/p95/p99 ms, batches and mean batch
               size, coalesced riders, cache hits and misses, device and
               host checks; zero errors, host checks, failed batches,
               sheds and breaker transitions, 512 sampled verdicts of the
               miss leg and every verdict of the hot leg (cache hits and
               coalesced riders included) equal to the oracle, K1-K4
               launched on the "serve" launch path; the REST requests
               pass through the read port's mux
 6c. gRPC under load — on 6b's Registry and Daemon, through the read
               port's mux, clients in a process of their own that imports
               grpc and protobuf and nothing of torch: (a) 32 closed-loop
               clients, one channel each, of single CheckService/Check
               RPCs for 8 s, drawn without repeat and apart from 6b's
               draws (cache misses), then the same on the read port's
               direct gRPC listener (no splice) for 8 s; (b) the same
               clients over 256 new hot
               checks for 2 s; (c) bench.py:74-79's batch leg, 4 clients
               of BatchCheck RPCs of 2,048 draws without repeat for 8 s;
               (d) one Expand, ListObjects, ListSubjects and Filter
               (10,000 candidates) RPC, the states they read built first:
               checks/s, per-RPC p50/p95/p99 ms, for (a) and (b) the
               batcher's mean batch; zero errors, sheds, failed batches,
               deadline drops, host checks and breaker moves; every
               verdict of (a)-(c) equal to the ground truth of the
               generator's ownership maps, 512 sampled of (a) (all of
               them, when fewer) and of (c) and every one of (b) equal to
               the oracle; each of (d) equal to
               the engine's own answer called directly and to the ground
               truth or the oracle; K1-K4 launched on the "grpc" ((a) and
               (b)) and "grpc_batch" ((c)) launch paths, (d)'s launches on
               "grpc_reads"
 6d. asyncio read plane — on phase 4's store and engine, a second Registry
               and Daemon with `serve.read.grpc.aio`: 6c(a)'s 32 clients of
               single Check RPCs for 8 s on its aio listener (one loop
               thread, AioCheckBatcher), then 8 s on 6b's threaded direct
               listener, draws without repeat and apart from 6b's and 6c's:
               checks/s, p50/p95/p99 ms, batches and mean batch, K1-K4
               launches of each leg (the "grpc_aio" and "grpc_direct"
               launch paths); zero errors, sheds, failed batches, deadline
               drops, host checks, cache hits and breaker moves, every
               verdict equal to the ground truth and 512 sampled to the
               oracle; then the TLS leg: a certificate from `openssl req
               -x509` (no openssl fails the phase), a third Daemon with
               `serve.read.tls` and the aio listener, 16 REST and 16 gRPC
               Checks through the TLS mux and 16 gRPC Checks on the TLS aio
               listener (the "tls" launch path: K1-K4), each verdict equal
               to the ground truth and the oracle, and plaintext refused on
               both ports
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
               batch ms; (7w) after a small write one batch on the overlay:
               the written roles' roots replay on the host, their trees
               and 64 sampled ones equal the oracle's
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
               split; (8w, run after 4w) after a small write one
               batch of each leg on the overlay: ListObjects with zero
               host replays, equal to the store's ownership maps, and
               ListSubjects with the written file's query replayed on the
               host, it and 16 sampled answers equal to the oracle's
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
               sampled equal to the oracle; (9w, last) (a) one small
               write: the next batch's inline catch-up marks the written
               chain's 22 ancestors dirty, C1 runs once with has_dirty
               (the "closure_write" launch path), the chain's queries fall
               back as dirty and the rest hit, verdicts as expected, and C1
               is held to its plain version on that launch (the
               closure_probe row's "dirty_batch" entry); (b)
               closure_ensure_built() powers the dirty sources again on the
               card (the "closure_refresh" path: P1-P3 only, no host
               fallback), equal to the host powering over the same graph and
               sources, with its stage split; (c) the next batch all hits,
               the written grant included; (d) a write of 4,096 grants
               compacts the mirror, the index is powered on the card again
               over the new base (timed) and the hits resume; (e) a
               ClosureMaintainer brings a further write's lag and dirty
               nodes to 0 (timed, under a printed deadline), then all hits
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
               step-1 launch; (10w, after 8w) after a small write one
               frontier-tier filter on the overlay, 200 sampled verdicts
               equal to the oracle and all equal to check_batch
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

 13. opl + watch — (after phase 11, before phase 12) a directory holding
               `namespaces.keto.ts`, the OPL full example of
               tests/test_opl.py (User, Group, Folder, File: `view` an OR
               over an AND of two traverses, `edit`, `not` a NOT, `rename`
               a traverse of `siblings`), named by a Keto config
               (`namespaces: {location: file://...}`, YAML, or JSON
               without PyYAML) read by Config.from_file into a Registry
               and a Daemon, as `serve` builds them; 6,600 folders of 120
               files, 1,000 groups of 16 users, a folder's viewers a
               group, owners, viewers and siblings on a quarter, an eighth
               and a sixteenth of the files (~1.16e6 tuples). (13a) the
               mirror's build by stage, 20 batches of 4096 checks over the
               four permits: checks/s, p50, host replays by cause, K1-K4
               launched (the "opl" launch path), 512 sampled verdicts equal
               to the oracle's complete walk, K1-K4 against their plain
               versions on one batch's inputs (each row's "at" entry
               "opl"); (13b) the file rewritten with `edit` = owners ||
               viewers: one rebuild, a new config generation, a cached
               `edit` not served stale, 512 sampled equal to the oracle;
               then a file that does not parse: no rebuild, the same
               verdicts, `last_error` names the parse error; (13c) 16
               closed-loop gRPC Check clients for 8 s beside a writer of 10
               transactions of 8 ops a second through the write API, each
               read back at its snaptoken; a threaded gRPC, an aio gRPC
               and an SSE subscriber opened at one snaptoken each get the
               change log's events exactly once and in order (commit to
               delivery p50 and p99 a plane); one killed after a third and
               resumed from its last token misses and repeats nothing; one
               of buffer 4 never read gets one RESET, then live events;
               checks/s and the "opl_watch" launch path; (13d) `python -m
               keto_tpu_torch serve --config` over a copy of the OPL file
               and a few hundred tuples answers a REST and a gRPC check as
               the oracle, a Watch event after a write, and exits 0 on
               SIGTERM
 14. sqlite  — (after phase 13, before phase 12) the durable store: (14a)
               phase 4's dataset written into a file-backed `sqlite://`
               store in transactions of 10,000 by a child process
               (`chip_smoke.py --sqlite-ingest PATH`, started after phase
               6d, so that it runs beside phases 7-13: tuples/s, the
               file's size), a Registry over that DSN, the mirror built on the
               card from the file's columns (all_tuple_columns and every
               stage timed), 20 batches of 4096 checks: checks/s, p50, no
               host replay, 512 sampled verdicts equal to the oracle over
               the file, K1-K4 launched (the "sqlite" launch path) and
               against their plain versions on one batch's inputs (each
               row's "at" entry "sqlite"), peak RSS and card memory;
               (14b) 64 inserts and 64 deletes through the store: the
               next batch runs on the overlay from the SQLite changelog
               (no rebuild, K1 and K2 launched, the "sqlite_write" path),
               its verdicts and the written tuples' equal to the oracle;
               (14c, on a thread beside 14a and 14b) `python -m
               keto_tpu_torch serve --config` over a
               fresh file of a few hundred tuples: a Watch cursor, 20
               acked REST writes, SIGKILL; the restart answers each by
               REST and gRPC as the oracle and resumes the cursor with no
               event lost or repeated; then store_commit_pre,
               store_commit_post and changelog_append armed in turn by
               KETO_FAULTS (crash:137!1): exit 137 on the first write, a
               postmortem of the file (0 lost, 0 phantoms, the store
               version equal to its commits), the crashed write absent
               after _pre and changelog_append, present with its
               changelog row after _post; exit 0 on SIGTERM
 12. scale   — (run last, after phases 4-11's engines and stores are
               released) tools/scale_bench.py's defaults: synth_columns
               at 1e7 tuples (100,000 users) and synth_rbac_columns (1,000
               roles), from keto_tpu_torch/tools/scale.py, bulk-loaded into
               the ColumnarStore of a `dsn: columnar` Registry; (12a) the
               columnar mirror build split into the encode (the native
               unique_encode), the probe tables (the native builder; the
               numpy rounds timed on the direct-edge keys as well, equal
               table for table), the pack and upload, with the card's peak
               memory and the process's peak RSS; (12b) batches of 4096
               checks drawn by scale_bench's law (half owner hits): zero
               host replays, every verdict equal to the construction's
               ground truth, 32 equal to the oracle, K1-K4 launched, then
               K1-K4 against their plain versions on one batch's inputs
               (each row's "at" entry "scale_1e7"); (12c) batches of 256
               RBAC roles at depth 4: zero host expands, 32 sampled trees
               equal to the oracle's, X1, X2, K2 and K4 launched, X1 and
               X2 against their plain versions; (12d) the reverse and
               subjects states by the columnar builders (timed), one
               ListObjects and one ListSubjects batch: zero host replays,
               32 sampled answers of each equal to the generator's
               ownership maps, L1-L4 against their plain versions; (12w)
               a write of 128 ops into the overlay (the next batch holds
               its verdicts), then 4,096 that compact the mirror over its
               ArrayMap vocabularies (incremental_merges + 1, no rebuild)

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
DELTA_PROBES = 8  # the overlay tables' probe depth (engine/delta.py)
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
# write phase: one write into the delta overlay (inserts and as many
# deletes), then one past its 2,048 ops, which compacts the mirror
WRITE_SMALL = 64
WRITE_LARGE = 4096
# phase 9w(e): how long the closure maintainer may take to refresh a write
MAINTAINER_DEADLINE_S = 240
# phase 6: the serve subprocess's batch window, which holds a check while
# the drain starts
SERVE_DRAIN_WINDOW_MS = 500
# phase 6b: bench.py:72-73's SERVE_THREADS and SERVE_SECONDS, closed-loop
# REST clients in a process of their own, then a leg over a hot set
LOAD_THREADS = 32
LOAD_SECONDS = 8.0
LOAD_DRAWS_PER_THREAD = 12_000
HOT_SECONDS = 2.0
HOT_QUERIES = 256
# phase 6c: bench.py:74-79's batch leg, SERVE_BATCH_CLIENTS clients of
# SERVE_BATCH_SIZE checks a BatchCheck RPC, for SERVE_SECONDS; each
# client's draws last GRPC_BATCH_RPCS RPCs (a client that runs out stops,
# and the leg's rate is taken over its longest client's time)
GRPC_BATCH_CLIENTS = 4
GRPC_BATCH = 2048
GRPC_BATCH_RPCS = 128
# phase 6c: each single-check client's draws (a leg of 8 s takes a few
# hundred at 6b's rates)
GRPC_DRAWS_PER_THREAD = 2_000
# phase 12: tools/scale_bench.py's defaults (:119-127, :206, :244-248,
# :299-308)
SCALE_TUPLES = 10_000_000
SCALE_USERS = 100_000
SCALE_ROLES = 1_000
SCALE_DEPTH = 5
SCALE_EXPAND_BATCH = 256
SCALE_EXPAND_DEPTH = 4
SCALE_EXPAND_CAPS = dict(frontier_cap=8192, pool_cap=128 * SCALE_EXPAND_BATCH)
SCALE_ROUNDS = 10
SCALE_SAMPLES = 32
SCALE_WRITE_SMALL = 128
SCALE_WRITE_LARGE = 4096
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


def distinct_rows(pack, h1, probes: int, spb: int) -> int:
    """The distinct bucket rows of `pack` that probe chains of `probes`
    slots from the hashes `h1` reach (kernel._bucket_rows' addressing):
    at most the table's rows, so their bytes are at most the table's."""
    import torch

    from keto_tpu_torch.engine import kernel as tk

    h2 = tk.mix32(h1 ^ tk._GOLDEN) | 1
    nb = pack.shape[0] // spb
    jb = torch.arange(-(-probes // spb), dtype=torch.int64, device=pack.device)
    return int(torch.unique((h1[:, None] + jb * h2[:, None]) & (nb - 1)).numel())


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
    nb = pack.shape[0] // spb
    n_rows = distinct_rows(pack, tk.hash_combine(keys >> 32, keys & 0xFFFFFFFF), kw["probes"], spb)
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
    and gathers count only what this step's data needs: each distinct
    bucket row once that the keys of tasks live with depth >= 1 reach (K1:
    the task's edge key, in dh_pack and, with the overlay, in dd_pack),
    each distinct key's rows once for K2 (pair_probe_case), and for
    K3 the segments and sources of the candidates that land in the
    frontier."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import kernel as tk

    cases = []
    args, kw = rec.args("edge_probe")
    dh_pack, dd_pack, obj, rel, q, qsub, depth, live = args
    F = obj.shape[0]
    spb = kw["spb"]
    expand = live & (depth >= 1)
    n_probe = int(expand.sum())
    sub = qsub[q[expand].long()]
    h1 = tk.hash_combine(obj[expand], rel[expand], sub[:, 0], sub[:, 1], sub[:, 2])
    # each distinct bucket row the probing tasks' keys reach, once
    n_rows = distinct_rows(dh_pack, h1, kw["dh_probes"], spb)
    pb = -(-kw["dh_probes"] // spb)
    if kw["has_delta"]:
        # the overlay round: DELTA_PROBES deep into dd_pack from the same
        # hashes; its distinct rows are at most dd_pack's
        n_rows += distinct_rows(dd_pack, h1, DELTA_PROBES, spb)
        pb += -(-DELTA_PROBES // spb)
    cases.append((
        "edge_probe",
        lambda: cuda_ops.edge_probe(*args, **kw),
        lambda: tk.edge_probe_plain(*args, **kw),
        F * (4 * 4 + 1 + 1) + n_probe * 16 + n_rows * spb * 32,
        n_probe * (6 * HASH_OPS + pb * spb * 6),
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


def run_write(engine, manager, config, queries, t_full_build):
    """Phase 4w on phase 4's engine: (a) one write of WRITE_SMALL inserts
    and as many deletes folds into the delta overlay; the next batch runs
    every launch with has_delta, its host replays are dirty_row replays
    alone, 512 sampled verdicts equal the oracle's, and K1-K4 are held to
    their plain versions on inputs captured from it; (b) one write of
    WRITE_LARGE ops overflows the overlay and compacts the mirror into a
    new base, timed against phase 4a's full build."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationQuery, RelationTuple, SubjectSet

    t0 = phase(f"4w write: {WRITE_SMALL} inserts + {WRITE_SMALL} deletes into the overlay, "
               f"then {WRITE_LARGE} ops into a compacted base")
    rng = random.Random(21)
    files = sorted({q.object for q in queries})
    folders = sorted({f.rsplit("/", 1)[0] for f in files})
    hit = rng.sample(files, WRITE_SMALL // 2)
    # deletes: the parent links of queried files (their rows turn dirty:
    # host replays) and the owners of queried folders (tombstones in the
    # overlay, answered by K1's overlay round)
    deletes = [RelationTuple("videos", f, "parent",
                             subject_set=SubjectSet("videos", f.rsplit("/", 1)[0], "..."))
               for f in hit]
    for d in rng.sample(folders, WRITE_SMALL // 2):
        rows, _ = manager.get_relation_tuples(
            RelationQuery(namespace="videos", object=d, relation="owner"))
        deletes += rows[:1]
    deletes = deletes[:WRITE_SMALL]
    # inserts: owners of queried files (overlay inserts) and new files
    # under existing folders (new vocabulary)
    inserts = [RelationTuple("videos", f, "owner", subject_id=f"user{rng.randrange(N_USERS)}")
               for f in rng.sample(files, WRITE_SMALL // 2)]
    inserts += [RelationTuple("videos", f"{d}/vw{i}.mp4", "parent",
                              subject_set=SubjectSet("videos", d, "..."))
                for i, d in enumerate(rng.sample(folders, WRITE_SMALL - len(inserts)))]
    before = dict(engine.stats)
    causes = dict(engine.stats["host_cause"])
    manager.transact_relation_tuples(inserts, deletes)
    t = time.perf_counter()
    state = engine.ensure_state()
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t
    n_ops = len(manager.changes_since(state.base_version))
    if not state.has_delta or engine.stats["snapshot_builds"] != before["snapshot_builds"]:
        raise AssertionError("the write did not fold into the overlay")
    cuda_ops.reset_launch_counts()
    t = time.perf_counter()
    results = engine.check_batch(queries, MAX_DEPTH)  # the write path's batch, once
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t
    launches = dict(cuda_ops.launches)
    missing = [k for k in cuda_ops.CHECK_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the write path: {missing}")
    replays = {k: v - causes.get(k, 0) for k, v in engine.stats["host_cause"].items()
               if v != causes.get(k, 0)}
    n_host = engine.stats["host_checks"] - before["host_checks"]
    if set(replays) - {"dirty_row"} or n_host != replays.get("dirty_row", 0):
        raise AssertionError(f"host replays after the write other than dirty_row: {replays}")
    oracle = ReferenceEngine(manager, config)
    sample = random.Random(8).sample(range(len(queries)), min(512, len(queries)))
    bad = [i for i in sample
           if oracle.check_relation_tuple(queries[i], MAX_DEPTH).allowed != results[i].allowed]
    if bad:
        raise AssertionError(f"{len(bad)} of 512 sampled verdicts after the write differ")
    lat = []
    for _ in range(5):
        s = time.perf_counter()
        engine.check_batch(queries, MAX_DEPTH)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - s) * 1e3)
    log(f"  {len(inserts)} inserts + {len(deletes)} deletes ({n_ops} ops in the overlay): "
        f"delta refresh {t_refresh * 1e3:.1f} ms; next batch {t_batch * 1e3:.1f} ms, then p50 "
        f"{statistics.median(lat):.2f} ms; {n_host} dirty_row replays; launches {launches}; "
        f"512 sampled equal the oracle")

    # K1-K4 on the post-write batch: pair_probe calls 2 and 3 are step 1's
    # span probe (rh) and dirty-row probe, on the frontier edge_probe's
    # call 1 reads
    with Recorder(cuda_ops, step=1, steps={"pair_probe": 2}, keep=("pair_probe",)) as rec:
        engine.check_batch(queries, MAX_DEPTH)
    cases, _k2_shape = kernel_cases(rec)
    at = {}
    for case in cases:
        name = case[0]
        if name in ("edge_probe", "pair_probe"):
            row = time_kernel(*case)
            at[name] = {**{k: row[k] for k in LARGE_KEYS if k != "note"},
                        "note": "the first batch after a write, has_delta"}
        else:
            err = case[5]()
            log(f"  {name} at write: max_abs_err {err}")
            if err:
                raise AssertionError(f"{name} disagrees with its plain version after a write")
    args2, kw2 = expect_probe(*rec.calls["pair_probe"][3], state.tables["dirty_pack"], DELTA_PROBES,
                              "the step-1 dirty-row probe")
    at["pair_probe_dirty"] = time_pair_probe(args2, kw2, rec.args("edge_probe")[0][7],
                                             "the step-1 dirty-row probe after a write")
    kw1 = rec.args("edge_probe")[1]
    log(f"  K1 at write: {kw1}; K2 at write: {at['pair_probe']}")

    # (b) a write past the overlay's capacity compacts the mirror
    merges = engine.stats["incremental_merges"]
    builds = engine.stats["snapshot_builds"]
    big = []
    for i in range(WRITE_LARGE // 2):
        d = f"/d{rng.randrange(N_FOLDERS)}"
        obj = f"{d}/vx{i}.mp4"
        big.append(RelationTuple("videos", obj, "parent", subject_set=SubjectSet("videos", d, "...")))
        big.append(RelationTuple("videos", obj, "owner",
                                 subject_id=f"user{rng.randrange(N_USERS)}"))
    manager.write_relation_tuples(big)
    t = time.perf_counter()
    merged = engine.ensure_state()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t
    if engine.stats["incremental_merges"] != merges + 1 or \
            engine.stats["snapshot_builds"] != builds or merged.has_delta:
        raise AssertionError(f"the large write did not compact: {engine.stats}")
    before = dict(engine.stats)
    t = time.perf_counter()
    results = engine.check_batch(queries, MAX_DEPTH)
    torch.cuda.synchronize()
    t_after = time.perf_counter() - t
    if engine.stats["host_checks"] != before["host_checks"]:
        raise AssertionError("host replays on the compacted base")
    bad = [i for i in sample
           if oracle.check_relation_tuple(queries[i], MAX_DEPTH).allowed != results[i].allowed]
    if bad:
        raise AssertionError(f"{len(bad)} of 512 sampled verdicts after the compaction differ")
    snap = merged.snapshot
    log(f"  {len(big)} ops: compaction {t_compact:.2f} s against the full build's "
        f"{t_full_build:.2f} s (phase 4a); next batch {t_after * 1e3:.1f} ms, zero host "
        f"replays, 512 sampled equal the oracle; dh_probes {snap.dh_probes}, rh_probes "
        f"{snap.rh_probes}, merge_garbage {snap.merge_garbage}")
    log(f"  write phase {time.perf_counter() - t0:.1f} s")
    out = {"small_ops": n_ops, "delta_refresh_ms": t_refresh * 1e3,
           "next_batch_ms": t_batch * 1e3, "batch_ms_after_write": lat,
           "dirty_row_replays": n_host, "large_ops": len(big),
           "compaction_s": t_compact, "full_build_s": t_full_build,
           "next_batch_after_compaction_ms": t_after * 1e3,
           "merged": {"dh_probes": snap.dh_probes, "rh_probes": snap.rh_probes,
                      "merge_garbage": snap.merge_garbage, "n_tuples": snap.n_tuples}}
    return launches, at, out


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


def run_expand_write(engine, manager, config, subjects):
    """Phase 7w: one expand batch after a small write, on the overlay: a
    written role's root is dirty and its tree comes from the oracle, the
    rest from the device; every written role's tree and 64 sampled trees
    equal the oracle's."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationQuery, RelationTuple

    t0 = phase("7w expand after a write: one batch on the overlay")
    touched = subjects[:4]
    inserts = [RelationTuple("role", s.object, "member", subject_id=f"writer{i}")
               for i, s in enumerate(touched)]
    deletes = []
    for s in touched[:2]:
        rows, _ = manager.get_relation_tuples(
            RelationQuery(namespace="role", object=s.object, relation="member"))
        deletes += rows[:1]
    manager.transact_relation_tuples(inserts, deletes)
    before = dict(engine.stats)
    cuda_ops.reset_launch_counts()
    t = time.perf_counter()
    trees = engine.expand_batch(subjects, EXPAND_DEPTH, **EXPAND_CAPS)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t
    launches = dict(cuda_ops.launches)
    if not engine.ensure_state().has_delta:
        raise AssertionError("the expand write did not fold into the overlay")
    missing = [k for k in cuda_ops.EXPAND_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the expand write path: {missing}")
    oracle = ReferenceEngine(manager, config)
    sample = sorted(set(range(len(touched))) | set(random.Random(12).sample(range(len(subjects)), 64)))
    bad = [i for i in sample
           if normalize(trees[i]) != normalize(oracle.expand(subjects[i], EXPAND_DEPTH))]
    if bad:
        raise AssertionError(f"{len(bad)} of {len(sample)} trees after a write differ")
    n_host = engine.stats["host_expands"] - before["host_expands"]
    log(f"  {len(inserts)} inserts + {len(deletes)} deletes; next batch {t_batch * 1e3:.1f} ms, "
        f"{n_host} host expands (dirty roots), launches {launches}; {len(sample)} trees "
        f"(every written role's) equal the oracle; phase {time.perf_counter() - t0:.1f} s")
    return {"batch_ms": t_batch * 1e3, "host_expands": n_host}


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


def list_objects_check(manager, config, queries, owners):
    """check(results): 32 sampled ListObjects answers against the
    ownership maps, and 4 x 32 of their objects against the oracle's
    check."""
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationTuple

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

    return check


def run_list_objects(engine, manager, config, queries, owners):
    t0 = phase(f"8c list objects: batches of {len(queries)} users' view on the main path")
    check = list_objects_check(manager, config, queries, owners)
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


def run_list_write(engine, manager, config, lo_queries, ls_queries, owners):
    """Phase 8w: one ListObjects and one ListSubjects batch after a small
    write, on the overlay. The write adds a file under a folder that no
    user of the ListObjects batch owns, a second owner of a listed file
    and takes a file owner away from a user outside the batch: the
    ListObjects walks probe the reverse-dirty table with no hit (zero host
    replays), their answers equal the store's ownership maps; the listed
    file's row is dirty, so its ListSubjects query replays on the host,
    and it and 16 sampled answers equal the oracle's."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationTuple, SubjectSet

    t0 = phase("8w list after a write: one batch of each leg on the overlay")
    folders_of, files_of, files_in = owners
    users = {q[2] for q in lo_queries}
    folder = next(d for u, ds in sorted(folders_of.items()) if u not in users for d in ds)
    outsider = next(u for u in sorted(files_of) if u not in users)
    listed = ls_queries[0][1]
    new_file = f"{folder}/v-listed-after-write.mp4"
    inserts = [RelationTuple("videos", new_file, "parent",
                             subject_set=SubjectSet("videos", folder, "...")),
               RelationTuple("videos", listed, "owner", subject_id="lister")]
    deletes = [RelationTuple("videos", files_of[outsider][0], "owner", subject_id=outsider)]
    manager.transact_relation_tuples(inserts, deletes)
    files_in[folder].append(new_file)
    files_of.setdefault("lister", []).append(listed)
    files_of[outsider] = files_of[outsider][1:]

    out = {}
    for leg, queries, caps in (("objects", lo_queries, LO_CAPS),
                               ("subjects", ls_queries, LS_CAPS)):
        before = engine.stats[f"host_list_{leg}"]
        cuda_ops.reset_launch_counts()
        t = time.perf_counter()
        results = getattr(engine, f"list_{leg}_batch")(queries, LIST_DEPTH, **caps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = {k: v for k, v in cuda_ops.launches.items() if v}
        n_host = engine.stats[f"host_list_{leg}"] - before
        if not engine.ensure_state().has_delta:
            raise AssertionError("the list write did not fold into the overlay")
        if leg == "objects":
            if n_host:
                raise AssertionError(f"{n_host} host replays on ListObjects after the write")
            list_objects_check(manager, config, queries, owners)(results)
        else:
            oracle = ReferenceEngine(manager, config)
            dirty = [i for i, q in enumerate(queries) if q[1] == listed]
            # 16 sampled: the oracle's list_subjects takes ~1.8 s a query here
            sample = sorted(set(dirty) | set(random.Random(18).sample(range(len(queries)), 16)))
            bad = [i for i in sample
                   if results[i] != oracle.list_subjects(*queries[i], LIST_DEPTH)]
            if bad or n_host < 1 or "lister" not in results[dirty[0]]:
                raise AssertionError(f"ListSubjects after a write: {len(bad)} differ, "
                                     f"{n_host} host replays")
        log(f"  list_{leg}: {ms:.1f} ms, {n_host} host replays, launches {launches}")
        out[f"list_{leg}"] = {"batch_ms": ms, "host_replays": n_host, "launches": launches}
    log(f"  list write phase {time.perf_counter() - t0:.1f} s")
    return out


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
    rounds, the main path's launches, the oracle. Returns the launches,
    the figures and the verdicts (phase 9w's reference)."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine

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

    out = {
        "on_checks_per_s": BATCH / (statistics.median(lat["on"]) / 1e3),
        "off_checks_per_s": BATCH / (statistics.median(lat["off"]) / 1e3),
        "on_p50_batch_ms": statistics.median(lat["on"]),
        "off_p50_batch_ms": statistics.median(lat["off"]),
        "batch_ms": lat, "off_steps_per_batch": bfs_steps,
        "allowed": sum(expected), "launches": {k: v for k, v in launches.items() if v},
        "profile_off": profile, "profile_on": profile_on,
    }
    log(f"  launches on the closure path: {launches}; {len(queries)} closure hits, 0 fallbacks")
    log(f"  closure on {out['on_checks_per_s']:.1f} checks/s, p50 {out['on_p50_batch_ms']:.2f} ms "
        f"(idle share {profile_on['idle_share']}); off (BFS, {bfs_steps} steps) "
        f"{out['off_checks_per_s']:.1f} checks/s, p50 {out['off_p50_batch_ms']:.2f} ms "
        f"(idle share {profile['idle_share']}); {DEEP_ROUNDS} rounds each, alternating; "
        f"0 mismatches; 512 sampled equal the oracle; {sum(expected)} allowed")
    log(f"  closure phase {time.perf_counter() - t0:.1f} s")
    return launches, out, expected


def run_closure_write(engine, manager, queries, expected):
    """Phase 9w on phase 9's engine: (a) one small write, which the next
    batch's inline catch-up marks dirty (the written chain's ancestors
    only): C1 runs with has_dirty, the chain's queries fall back as dirty
    and the rest hit; (b) closure_ensure_built() powers the dirty sources
    again on the card (a refresh), equal to the host powering over the same
    graph and sources; (c) the next batch is all hits; (d) a write of
    4,096 grants compacts the mirror and the index is powered again in
    full over the new base; (e) a ClosureMaintainer brings a further
    write's lag and dirty nodes to 0. `expected` are phase 9's verdicts
    on `queries` before any write. Returns the figures, the launches of
    the dirty batch and of the refresh, and the dirty batch's C1 inputs."""
    import numpy as np
    import torch

    from keto_tpu_torch.closure import ClosureMaintainer
    from keto_tpu_torch.registry import Registry
    from keto_tpu_torch.engine import closure as tcl
    from keto_tpu_torch.engine import closure_power as tcp
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.ketoapi import RelationTuple

    t0 = phase(f"9w closure after a write: dirty marks and C1's cd table, a refresh on the "
               f"card, {WRITE_LARGE} grants compacted and powered again, the maintainer")
    engine.closure_enabled = True
    idx = engine.closure_index()

    def chain(q):
        return int(q.object[1:].split("f")[0])

    # (a) one small write: the batch's inline catch-up marks the chain's
    # ancestors, and only they fall back
    c = chain(queries[0])
    fresh = RelationTuple("deep", f"c{c}f0", "viewer", subject_id="newbie")
    batch = list(queries[:-1]) + [fresh]
    want = expected[:-1] + [True]
    on_chain = sum(chain(q) == c for q in batch)
    manager.write_relation_tuples([RelationTuple("deep", f"c{c}f{DEEP_DEPTH}", "owner",
                                                 subject_id="newbie")])
    before = {k: engine.stats[k] for k in ("closure_hits", "host_checks")}
    fallback = dict(engine.stats["closure_fallback"])
    cuda_ops.reset_launch_counts()
    with Recorder(cuda_ops, step=-1, steps={"closure_probe": 0}) as rec:
        t_w = time.perf_counter()
        got = engine.check_batch(batch)
        torch.cuda.synchronize()
        t_dirty = time.perf_counter() - t_w
    dirty_launches = dict(cuda_ops.launches)
    c1_args = rec.args("closure_probe")
    n_hits = engine.stats["closure_hits"] - before["closure_hits"]
    n_dirty = engine.stats["closure_fallback"].get("dirty", 0) - fallback.get("dirty", 0)
    n_host = engine.stats["host_checks"] - before["host_checks"]
    desc = idx.describe()
    log(f"  a write of 1 owner: the next batch {t_dirty * 1e3:.1f} ms (delta refresh, inline "
        f"catch-up, C1 with has_dirty, the BFS for the dirty leftovers): {n_hits} closure hits, "
        f"{n_dirty} dirty fallbacks ({on_chain} queries on the written chain), {n_host} host "
        f"replays; {desc['dirty_nodes']} dirty nodes, applied ops {desc['applied_ops']}; "
        f"launches {({k: v for k, v in dirty_launches.items() if v})}")
    if not c1_args[1]["has_dirty"] or dirty_launches["closure_probe"] != 1:
        raise AssertionError(f"C1 did not run once with has_dirty: {c1_args[1]}, "
                             f"{dirty_launches['closure_probe']} launches")
    if desc["dirty_nodes"] != DEEP_DEPTH + 2 or n_dirty != on_chain \
            or n_hits != len(batch) - on_chain:
        raise AssertionError(f"the catch-up marked {desc['dirty_nodes']} nodes; {n_dirty} dirty "
                             f"fallbacks, {n_hits} hits of {len(batch)}")
    if [r.allowed for r in got] != want:
        raise AssertionError("the verdicts after the write differ from the expected ones")
    if not engine.ensure_state().has_delta:
        raise AssertionError("the small write did not fold into the overlay")

    # (b) the refresh: the dirty sources powered again on the card
    captured: dict = {}
    power = tcp.power_closure_device

    def capture(*args, **kw):
        out = power(*args, **kw)
        captured.update(args=args, kw=kw, build=out[0], record=out[1])
        return out

    cuda_ops.reset_launch_counts()
    tcp.power_closure_device = capture
    try:
        t_w = time.perf_counter()
        ready = engine.closure_ensure_built()
        torch.cuda.synchronize()
        t_refresh = time.perf_counter() - t_w
    finally:
        tcp.power_closure_device = power
    refresh_launches = dict(cuda_ops.launches)
    desc = idx.describe()
    split = dict(idx.last_refresh)
    stray = [k for k in cuda_ops.KERNELS if k not in cuda_ops.POWER_KERNELS
             and refresh_launches[k]]
    missing = [k for k in cuda_ops.POWER_KERNELS if refresh_launches[k] == 0]
    if not ready or missing or stray or desc["device_fallbacks"] or desc["refreshes"] != 1 \
            or desc["device_builds"] != 2 or desc["builds"] != 1 or desc["dirty_nodes"]:
        raise AssertionError(f"the refresh: ready {ready}, launches {refresh_launches}, "
                             f"{desc}")
    graph, snap, mdepth, rows, base = captured["args"][:5]
    sources = captured["kw"]["sources"]
    host = tcl.power_closure(graph, snap, mdepth, rows, base, sources=sources)
    fields = ("covered_keys", "ent_obj", "ent_rel", "ent_skind", "ent_sa", "ent_sb", "ent_req")
    dev_build = captured["build"]
    differ = [k for k in fields if getattr(host, k).dtype != getattr(dev_build, k).dtype
              or not np.array_equal(getattr(host, k), getattr(dev_build, k))]
    if differ or host.n_entries != dev_build.n_entries:
        raise AssertionError(f"the refresh's device build differs from the host's: {differ}")
    log(f"  closure_ensure_built (a refresh): {t_refresh:.2f} s: catch-up "
        f"{split['catch_up_s'] * 1e3:.1f} ms, content read {split['content_s']:.2f} s "
        f"({split['rows']} rows, {'scoped' if split['scoped'] else 'the whole store'}), "
        f"extract {split['extract_s'] * 1e3:.1f} ms, power {split['power_s'] * 1e3:.1f} ms on "
        f"the card ({split['sources']} sources, {split['power_waves']} waves, "
        f"{split['power_steps']} steps; prep {split['power_prep_s'] * 1e3:.1f} ms, waves "
        f"{split['power_wave_s'] * 1e3:.1f} ms), merge {split['merge_s']:.2f} s, pack "
        f"{split['pack_s']:.2f} s, upload {split['upload_s']:.2f} s; equal to the host powering "
        f"over the same {len(sources)} sources ({host.n_entries} entries); launches "
        f"{({k: v for k, v in refresh_launches.items() if v})}")

    # (c) the next batch: every query a hit, the written grant included
    hits = engine.stats["closure_hits"]
    t_w = time.perf_counter()
    got = engine.check_batch(batch)
    torch.cuda.synchronize()
    t_clean = time.perf_counter() - t_w
    if engine.stats["closure_hits"] - hits != len(batch) or [r.allowed for r in got] != want:
        raise AssertionError("the refreshed index did not resume the hits")
    log(f"  the next batch: {len(batch)} closure hits in {t_clean * 1e3:.1f} ms, newbie allowed")

    # (d) a write past the overlay's capacity compacts the mirror into a
    # new base, which the index powers on the card in full
    grng = random.Random(31)
    grants = [RelationTuple("deep", f"c{grng.randrange(DEEP_CHAINS)}f{grng.randrange(DEEP_DEPTH + 1)}",
                            "viewer", subject_id=f"w{i}") for i in range(WRITE_LARGE)]
    merges = engine.stats["incremental_merges"]
    builds = engine.stats["snapshot_builds"]
    manager.write_relation_tuples(grants)
    t_w = time.perf_counter()
    engine.ensure_state()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t_w
    if engine.stats["incremental_merges"] != merges + 1 or engine.stats["snapshot_builds"] != builds:
        raise AssertionError(f"the large write did not compact: {engine.stats}")
    t_w = time.perf_counter()
    if not engine.closure_ensure_built():
        raise AssertionError("the index did not build over the compacted base")
    torch.cuda.synchronize()
    t_rebuild = time.perf_counter() - t_w
    rebuilt = idx.describe()
    if rebuilt["device_builds"] != 3 or rebuilt["builds"] != 2 or rebuilt["device_fallbacks"]:
        raise AssertionError(f"the rebuild was not powered on the card: {rebuilt['device_builds']} "
                             f"device builds, {rebuilt['device_fallbacks']} fallbacks")
    hits = engine.stats["closure_hits"]
    got = engine.check_batch(batch)
    if engine.stats["closure_hits"] - hits != len(batch) or [r.allowed for r in got] != want:
        raise AssertionError("the rebuilt index did not resume the hits")
    fresh_grants = [RelationTuple("deep", g.object, "viewer", subject_id=g.subject_id)
                    for g in grants[:64]]
    if not all(r.allowed for r in engine.check_batch(fresh_grants)):
        raise AssertionError("the compacted base lost a written grant")
    log(f"  {WRITE_LARGE} grants compacted in {t_compact:.2f} s; closure powered again in "
        f"{t_rebuild:.1f} s (on the card {rebuilt['power_s']:.2f} s), hits resumed")

    # (e) the maintainer: a further write, brought to lag 0 and no dirty
    # node off the request path
    c2 = chain(queries[1])
    maintainer = ClosureMaintainer(Registry(engine.config, device="cuda", engine=engine))
    maintainer.start()
    try:
        refreshes = idx.stats["refreshes"]
        manager.write_relation_tuples([RelationTuple("deep", f"c{c2}f{DEEP_DEPTH}", "owner",
                                                     subject_id="maintained")])
        t_w = time.perf_counter()
        deadline = t_w + MAINTAINER_DEADLINE_S
        log(f"  maintainer started; waiting up to {MAINTAINER_DEADLINE_S} s for lag 0 and no "
            f"dirty node")
        while time.perf_counter() < deadline and (
                idx.lag_versions(manager.version()) or idx.describe()["dirty_nodes"]
                or idx.stats["refreshes"] == refreshes):
            time.sleep(0.05)
        t_maint = time.perf_counter() - t_w
        m_desc = idx.describe()
        if idx.lag_versions(manager.version()) or m_desc["dirty_nodes"] \
                or idx.stats["refreshes"] != refreshes + 1:
            raise AssertionError(f"the maintainer did not catch up in {MAINTAINER_DEADLINE_S} s: "
                                 f"{m_desc}")
        m_split = dict(idx.last_refresh)
        m_batch = batch + [RelationTuple("deep", f"c{c2}f0", "viewer", subject_id="maintained")]
        hits = engine.stats["closure_hits"]
        got = engine.check_batch(m_batch)
        if engine.stats["closure_hits"] - hits != len(m_batch) or \
                [r.allowed for r in got] != want + [True]:
            raise AssertionError("the maintained index did not answer every query")
    finally:
        maintainer.stop()
    log(f"  the maintainer: lag 0 and no dirty node {t_maint:.2f} s after the write "
        f"({maintainer.stats['passes']} passes; its refresh: content "
        f"{m_split['content_s']:.2f} s, power {m_split['power_s'] * 1e3:.1f} ms, pack "
        f"{m_split['pack_s']:.2f} s), then {len(m_batch)} closure hits; phase "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"dirty_batch_s": t_dirty, "dirty_batch": {"hits": n_hits, "dirty": n_dirty,
                                                     "host_replays": n_host,
                                                     "dirty_nodes": DEEP_DEPTH + 2},
           "refresh_s": t_refresh, "refresh": split, "next_batch_s": t_clean,
           "compaction_s": t_compact, "closure_rebuild_s": t_rebuild,
           "rebuild_power": {k: rebuilt[k] for k in ("power_s", "power_prep_s", "power_wave_s")},
           "maintainer_lag0_s": t_maint, "maintainer_passes": maintainer.stats["passes"],
           "maintainer_refresh": m_split}
    return out, dirty_launches, refresh_launches, c1_args


def closure_case(args, kw, note):
    """C1's (name, kernel fn, plain fn, bytes, operations, compare fn,
    kernel functions) on one launch's captured inputs, and the launch's
    shape. Bytes count the query pack, the distinct bucket rows the
    verdicts need, each once (cc for valid queries, with has_dirty cd for
    covered ones, ch for covered and clean ones; at most each table's
    rows, distinct_rows) and the output.
    The kernel also reads the ch rows of valid queries that are not
    covered and clean, as the JAX body probes every table and masks after:
    the shape gives their share and bytes, which the bound leaves out."""
    from keto_tpu_torch.engine import closure_kernel as tck
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import kernel as tk
    from keto_tpu_torch.engine.snapshot import slots_per_bucket

    cc_pack, ch_pack, cd_pack, qpack = args
    B = qpack.shape[1]
    out = tck.closure_probe_plain(*args, **kw)
    cause = out[B : 2 * B]
    valid = qpack[6] != 0
    n_valid = int(valid.sum())
    n_cov = int((cause == 0).sum())
    s2, s5 = slots_per_bucket(2, kw["layout"]), slots_per_bucket(5, kw["layout"])
    pb2, pb5 = -(-kw["cc_probes"] // s2), -(-kw["ch_probes"] // s5)
    h2 = tk.hash_combine(qpack[0], qpack[1])
    rows_cc = distinct_rows(cc_pack, h2[valid], kw["cc_probes"], s2)
    # the cd rows of covered queries (resolved or dirty), DELTA_PROBES deep
    cd_q = (cause == 0) | (cause == 2)
    n_cd = int(cd_q.sum()) if kw["has_dirty"] else 0
    rows_cd = distinct_rows(cd_pack, h2[cd_q], DELTA_PROBES, s2) if kw["has_dirty"] else 0
    pbd = -(-DELTA_PROBES // s2)
    ok = cause == 0
    rows_ch = distinct_rows(ch_pack, tk.hash_combine(*(qpack[i][ok] for i in (0, 1, 3, 4, 5))),
                            kw["ch_probes"], s5)
    shape = {"note": note, "B": B, "has_dirty": kw["has_dirty"], "cc_probes": kw["cc_probes"],
             "ch_probes": kw["ch_probes"], "valid_share": n_valid / max(B, 1),
             "covered_share": n_cov / max(B, 1), "dirty_share": max(n_cd - n_cov, 0) / max(B, 1),
             "distinct_rows": {"cc": rows_cc, "cd": rows_cd, "ch": rows_ch},
             "speculative_ch_bytes": (n_valid - n_cov) * pb5 * s5 * 32}
    case = (
        "closure_probe",
        lambda: cuda_ops.closure_probe(*args, **kw),
        lambda: tck.closure_probe_plain(*args, **kw),
        7 * B * 4 + rows_cc * s2 * 16 + rows_cd * s2 * 16 + rows_ch * s5 * 32 + (2 * B + 8) * 4,
        n_valid * (3 * HASH_OPS + pb2 * s2 * 4) + n_cd * pbd * s2 * 4
        + n_cov * (6 * HASH_OPS + pb5 * s5 * 6),
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


def run_filter_write(engine, manager, config, subject):
    """Phase 10w: one frontier-tier filter batch on phase 4's engine after
    a small write that does not touch the subject's walk: the walk runs
    with the reverse-dirty probes on and finds no dirty key, so every
    valid candidate stays on the frontier tier; 200 sampled verdicts
    equal the oracle's and all equal check_batch over the same pairs."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationTuple

    t0 = phase("10w filter after a write: one frontier-tier batch on the overlay")
    objects = filter_candidates()
    manager.write_relation_tuples([
        RelationTuple("videos", f"/d{d}/v0.mp4", "owner", subject_id="filter-writer")
        for d in range(8)])
    engine.closure_enabled = False
    before = {k: engine.stats[k] for k in ("filter_frontier", "filter_host", "filter_vocab")}
    cuda_ops.reset_launch_counts()
    t = time.perf_counter()
    verdicts = engine.filter_batch("videos", "view", subject, objects, chunk_size=FILTER_CHUNK)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = {k: v for k, v in cuda_ops.launches.items() if v}
    tiers = {k: engine.stats[k] - v for k, v in before.items()}
    if not engine.ensure_state().has_delta or "filter_mark" not in launches:
        raise AssertionError(f"the filter after a write did not walk the overlay: {launches}")
    if tiers["filter_host"] or tiers["filter_frontier"] + tiers["filter_vocab"] != len(objects):
        raise AssertionError(f"filter tiers after a write {tiers}")
    oracle = ReferenceEngine(manager, config)
    sample = random.Random(80).sample(range(len(objects)), 200)
    want = oracle.filter_objects("videos", "view", subject, [objects[i] for i in sample])
    checks = engine.check_batch([RelationTuple("videos", o, "view", subject_id=subject)
                                 for o in objects])
    if [verdicts[i] for i in sample] != want or [r.allowed for r in checks] != verdicts:
        raise AssertionError("filter verdicts after a write differ from the oracle or check")
    log(f"  {ms:.1f} ms, tiers {tiers}, launches {launches}; 200 sampled equal the oracle, "
        f"all equal check_batch; phase {time.perf_counter() - t0:.1f} s")
    return {"batch_ms": ms, "tiers": tiers, "launches": launches}


def run_serve():
    import signal
    import threading
    import urllib.error
    import urllib.parse
    import urllib.request

    import grpc

    from keto_tpu_torch.api.client import ReadClient
    from keto_tpu_torch.api.descriptors import HEALTH_SERVICE, pb
    from keto_tpu_torch.engine.snaptoken import encode_snaptoken
    from keto_tpu_torch.ketoapi import RelationTuple

    t0 = phase("6 serve: python -m keto_tpu_torch serve on a free port")
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ns = {"name": "videos", "relations": [
            {"name": "owner"}, {"name": "parent"},
            {"name": "view", "rewrite": {"operator": "or", "children": [
                {"type": "computed_subject_set", "relation": "owner"},
                {"type": "tuple_to_subject_set", "relation": "parent",
                 "computed_subject_set_relation": "view"}]}}]}
        # the routes run on the default serve keys; the drain step (the end
        # of this phase) runs in a serve process of its own, whose long
        # batch window holds a check in the batcher while the drain starts
        cfg = {"namespaces": [ns], "serve": {"read": {"host": "127.0.0.1", "port": 0},
                                             "write": {"host": "127.0.0.1", "port": 0}}}
        drain_cfg = {**cfg, "check": {"batch_window_ms": SERVE_DRAIN_WINDOW_MS}}
        for name, c in (("cfg.json", cfg), ("drain.json", drain_cfg)):
            with open(os.path.join(tmp, name), "w") as f:
                json.dump(c, f)
        with open(os.path.join(tmp, "tuples.txt"), "w") as f:
            f.write("videos:/cats#owner@cat lady\n"
                    "videos:/cats/1.mp4#parent@(videos:/cats#...)\n"
                    "videos:/cats/2.mp4#owner@john\n")
        procs = []

        def launch(cfg_name):
            """One `serve` process over the tuples."""
            proc = subprocess.Popen(
                [sys.executable, "-m", "keto_tpu_torch", "serve", "--config",
                 os.path.join(tmp, cfg_name), "--tuples", os.path.join(tmp, "tuples.txt")],
                cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env={**os.environ, "PYTHONPATH": repo},
            )
            procs.append(proc)
            return proc

        def ready(proc):
            """A launched serve's read and write URLs, once it listens."""
            line = proc.stdout.readline()
            if not line.startswith("serving read="):
                raise AssertionError(f"serve did not start: {line!r} {proc.stderr.read()}")
            read_base = "http://" + line.split("=", 1)[1].strip()
            line = proc.stdout.readline()
            if not line.startswith("serving write="):
                raise AssertionError(f"serve has no write listener: {line!r}")
            return read_base, "http://" + line.split("=", 1)[1].strip()

        try:
            # the drain's serve starts beside the first, so that its start
            # overlaps the routes' checks
            proc, drain_proc = launch("cfg.json"), launch("drain.json")
            base, write_base = ready(proc)

            def get(params, route="/relation-tuples/check", at=None):
                url = (at or base) + route + "?" + urllib.parse.urlencode(params)
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

            def send(method, body=None, params=None):
                url = write_base + "/admin/relation-tuples"
                if params:
                    url += "?" + urllib.parse.urlencode(params)
                req = urllib.request.Request(
                    url, method=method, headers={"Content-Type": "application/json"},
                    data=None if body is None else json.dumps(body).encode())
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, r.headers.get("X-Keto-Snaptoken"), r.read()

            # each write's answer, then a check carrying its token
            john = {"namespace": "videos", "object": "/cats/1.mp4", "relation": "owner",
                    "subject_id": "john"}
            put = send("PUT", john)
            seen_put = get({**q, "subject_id": "john", "snaptoken": put[1]})
            patch = send("PATCH", [
                {"action": "delete", "relation_tuple": john},
                {"action": "insert", "relation_tuple": {**john, "subject_id": "ann"}}])
            seen_patch = (get({**q, "subject_id": "john", "snaptoken": patch[1]}),
                          get({**q, "subject_id": "ann", "snaptoken": patch[1]}))
            delete = send("DELETE", params={**john, "subject_id": "ann"})
            seen_delete = get({**q, "subject_id": "ann",
                               "snaptoken": encode_snaptoken(4, "default")})
            log(f"  PUT -> {put[:2]}, a check at its token -> {seen_put}; PATCH -> "
                f"{patch[:2]}, checks at its token -> {seen_patch}; DELETE -> {delete[0]}, "
                f"a check at version 4 -> {seen_delete}")
            if put[0] != 201 or json.loads(put[2]) != john or \
                    put[1] != encode_snaptoken(2, "default") or \
                    seen_put != (200, {"allowed": True}):
                raise AssertionError("the PUT was not seen at its token")
            if patch[0] != 204 or seen_patch != ((403, {"allowed": False}),
                                                 (200, {"allowed": True})):
                raise AssertionError("the PATCH was not seen at its token")
            if delete[0] != 204 or seen_delete != (403, {"allowed": False}):
                raise AssertionError("the DELETE was not seen")

            version = get({}, "/version")
            pages, page = [], {"namespace": "videos", "page_size": "1"}
            while True:
                listed = get(page, "/relation-tuples")
                if listed[0] != 200:
                    raise AssertionError(f"GET /relation-tuples answered {listed}")
                pages.append(listed[1]["relation_tuples"])
                if not listed[1]["next_page_token"]:
                    break
                page = {**page, "page_token": listed[1]["next_page_token"]}
            log(f"  /version -> {version}; GET /relation-tuples a tuple a page -> {pages}")
            if version != (200, {"version": "0.1.0"}):
                raise AssertionError(f"/version answered {version}")
            want_tuples = sorted(["videos:/cats#owner@cat lady",
                                  "videos:/cats/1.mp4#parent@(videos:/cats#...)",
                                  "videos:/cats/2.mp4#owner@john"])
            got_tuples = sorted(str(RelationTuple.from_dict(t)) for p in pages for t in p)
            if [len(p) for p in pages] != [1, 1, 1] or got_tuples != want_tuples:
                raise AssertionError(f"GET /relation-tuples paged {pages}")
            serve_grpc(base, write_base, get, version[1]["version"])

            proc.send_signal(signal.SIGTERM)
            if proc.wait(timeout=60) != 0:
                raise AssertionError(f"serve exited {proc.returncode} after SIGTERM")

            # SIGTERM while a check is in the batcher's window: readiness
            # turns to 503 and a new check is shed while that one answers
            proc = drain_proc
            drain_base, _ = ready(proc)
            drain_addr = drain_base.split("//", 1)[1]
            channel = grpc.insecure_channel(drain_addr)
            watch = channel.unary_stream(
                f"/{HEALTH_SERVICE}/Watch", request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb.HealthCheckResponse.FromString)(
                pb.HealthCheckRequest(), timeout=120)
            statuses = []

            def read_watch():
                """The stream's first two statuses, or what ended it."""
                try:
                    for resp in watch:
                        statuses.append(resp.status)
                        if len(statuses) == 2:
                            return
                except grpc.RpcError as e:
                    statuses.append(e.code().name)

            watcher = threading.Thread(target=read_watch, daemon=True)
            watcher.start()
            end = time.monotonic() + 60
            while not statuses and time.monotonic() < end:
                time.sleep(0.005)
            admitted = {}
            rider = threading.Thread(target=lambda: admitted.update(
                r=get({**q, "subject_id": "cat lady"}, at=drain_base)), daemon=True)
            rider.start()
            time.sleep(SERVE_DRAIN_WINDOW_MS / 5e3)
            proc.send_signal(signal.SIGTERM)
            ready = get({}, "/health/ready", at=drain_base)
            end = time.monotonic() + SERVE_DRAIN_WINDOW_MS / 2e3
            while ready[0] == 200 and time.monotonic() < end:
                ready = get({}, "/health/ready", at=drain_base)
            shed = get({**q, "subject_id": "john"}, at=drain_base)
            g_shed = ReadClient(channel)
            try:
                g_shed.check(RelationTuple.from_string("videos:/cats/2.mp4#view@john"))
                g_shed = ("OK",)
            except grpc.RpcError as e:
                g_shed = (e.code().name, e.details(),
                          tuple((k, v) for k, v in e.trailing_metadata() or ()))
            watcher.join(timeout=60)
            watch.cancel()
            channel.close()
            rider.join(timeout=60)
            log(f"  after SIGTERM: /health/ready -> {ready}, a new check -> {shed}, the "
                f"check admitted before it -> {admitted.get('r')}")
            if ready != (503, {"status": "unavailable"}):
                raise AssertionError(f"/health/ready during the drain answered {ready}")
            if shed[0] != 429 or shed[1]["error"]["message"] != "server is draining":
                raise AssertionError(f"a check during the drain answered {shed}")
            if admitted.get("r") != (200, {"allowed": True}):
                raise AssertionError(f"the admitted check answered {admitted.get('r')}")
            log(f"  gRPC on the draining port: a Check -> {g_shed}; a Health Watch stream -> "
                f"{statuses}")
            if g_shed != ("RESOURCE_EXHAUSTED", shed[1]["error"]["message"],
                          (("retry-after", "1"),)):
                raise AssertionError(f"a gRPC check during the drain answered {g_shed}")
            if statuses != [1, 2]:  # SERVING, then NOT_SERVING
                raise AssertionError(f"the Health Watch stream saw {statuses}")
            if proc.wait(timeout=60) != 0:
                raise AssertionError(f"serve exited {proc.returncode} after SIGTERM")
        finally:
            for proc in procs:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                proc.stdout.close()
                proc.stderr.close()
    log(f"  serve phase {time.perf_counter() - t0:.1f} s")


SERVE_TUPLES = ("videos:/cats#owner@cat lady", "videos:/cats/1.mp4#parent@(videos:/cats#...)",
                "videos:/cats/2.mp4#owner@john")


def serve_grpc(base: str, write_base: str, get, version: str) -> None:
    """Phase 6's gRPC step on the serve process's ports, after its REST
    writes (the store holds SERVE_TUPLES again, at version 4): a Transact
    on the write port, then every read service on the read port at its
    token, each answer equal to the REST route's on the same port and to
    the host oracle's over the same tuples; Version and Health on both."""
    import urllib.request

    from keto_tpu_torch.api.client import ReadClient, WriteClient, open_channel
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.engine.snaptoken import encode_snaptoken
    from keto_tpu_torch.ketoapi import RelationQuery, RelationTuple, SubjectSet
    from keto_tpu_torch.storage import MemoryManager

    read_addr, write_addr = base.split("//", 1)[1], write_base.split("//", 1)[1]
    rc, wc = ReadClient(open_channel(read_addr)), WriteClient(open_channel(write_addr))
    config = Config({"namespaces": [videos_namespace().to_dict()]})
    store = MemoryManager()
    store.write_relation_tuples([RelationTuple.from_string(s) for s in SERVE_TUPLES])
    oracle = ReferenceEngine(store, config)
    try:
        inserts = [RelationTuple.from_string(s) for s in (
            "videos:/cats/3.mp4#parent@(videos:/cats#...)", "videos:/dogs#owner@john")]
        tokens = wc.transact(inserts)
        store.write_relation_tuples(inserts)
        token = encode_snaptoken(5, "default")
        if tokens != [token, token]:
            raise AssertionError(f"Transact answered {tokens}")
        checks = [RelationTuple.from_string(s) for s in (
            "videos:/cats/3.mp4#view@cat lady", "videos:/cats/3.mp4#view@john",
            "videos:/dogs#view@john", "videos:/cats/1.mp4#view@nobody")]
        got = [rc.check_with_token(t, snaptoken=token) for t in checks]
        rest = [get({**t.to_url_query(), "snaptoken": token}) for t in checks]
        want = [oracle.check_relation_tuple(t).allowed for t in checks]
        log(f"  gRPC: Transact -> {tokens}; Checks at its token -> {got}")
        if [a for a, _t in got] != want or [r[1]["allowed"] for r in rest] != want or \
                {t for _a, t in got} != {token} or want != [True, False, True, False]:
            raise AssertionError(f"gRPC checks {got}, REST {rest}, oracle {want}")
        batch = rc.check_batch(checks, snaptoken=token)
        req = urllib.request.Request(base + "/relation-tuples/check/batch", method="POST",
                                     data=json.dumps({"tuples": [t.to_dict() for t in checks],
                                                      "snaptoken": token}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            rest_batch = json.loads(r.read())
        if batch != [(a, "") for a in want] or \
                [r["allowed"] for r in rest_batch["results"]] != want:
            raise AssertionError(f"gRPC BatchCheck {batch}, REST {rest_batch}")
        for sub in (SubjectSet("videos", "/cats/3.mp4", "parent"),
                    SubjectSet("videos", "/cats", "owner")):
            tree = rc.expand(sub)
            rest_tree = get({"namespace": sub.namespace, "object": sub.object,
                             "relation": sub.relation}, "/relation-tuples/expand")
            if rest_tree != (200, tree.to_dict()) or \
                    normalize(tree) != normalize(oracle.expand(sub)):
                raise AssertionError(f"gRPC Expand {tree}, REST {rest_tree}")
        objects = rc.list_objects("videos", "view", "cat lady", snaptoken=token)
        rest_objects = get({"namespace": "videos", "relation": "view", "subject_id": "cat lady",
                            "snaptoken": token}, "/relation-tuples/list-objects")
        want_objects = oracle.list_objects("videos", "view", "cat lady")
        subjects = rc.list_subjects("videos", "/cats/3.mp4", "view", snaptoken=token)
        rest_subjects = get({"namespace": "videos", "object": "/cats/3.mp4", "relation": "view",
                             "snaptoken": token}, "/relation-tuples/list-subjects")
        candidates = ["/cats/1.mp4", "/cats/2.mp4", "/cats/3.mp4", "/cats/9.mp4", "/dogs"]
        allowed, f_token = rc.filter("videos", "view", "cat lady", candidates, snaptoken=token)
        req = urllib.request.Request(base + "/relation-tuples/filter", method="POST",
                                     data=json.dumps({"namespace": "videos", "relation": "view",
                                                      "subject_id": "cat lady",
                                                      "objects": candidates}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            rest_filter = json.loads(r.read())
        want_filter = [o for o, ok in zip(candidates, oracle.filter_objects(
            "videos", "view", "cat lady", candidates)) if ok]
        log(f"  gRPC: ListObjects -> {objects}, ListSubjects -> {subjects}, Filter -> "
            f"{allowed}")
        if objects != (want_objects, "", token) or \
                rest_objects != (200, {"objects": want_objects, "next_page_token": ""}):
            raise AssertionError(f"gRPC ListObjects {objects}, REST {rest_objects}")
        if subjects != (oracle.list_subjects("videos", "/cats/3.mp4", "view"), "", token) or \
                rest_subjects[1]["subject_ids"] != subjects[0]:
            raise AssertionError(f"gRPC ListSubjects {subjects}, REST {rest_subjects}")
        if (allowed, f_token) != (want_filter, token) or \
                rest_filter != {"allowed_objects": want_filter, "snaptoken": token}:
            raise AssertionError(f"gRPC Filter {allowed}, REST {rest_filter}")
        pages, page_token = [], ""
        while True:
            page = rc.list_relation_tuples(RelationQuery(namespace="videos"), page_size=1,
                                           page_token=page_token)
            rest_page = get({"namespace": "videos", "page_size": "1",
                             **({"page_token": page_token} if page_token else {})},
                            "/relation-tuples")
            if rest_page != (200, page.to_dict()):
                raise AssertionError(f"gRPC ListRelationTuples {page}, REST {rest_page}")
            pages.append(page.relation_tuples)
            page_token = page.next_page_token
            if not page_token:
                break
        listed = sorted(str(t) for p in pages for t in p)
        if listed != sorted(str(t) for t in store.all_relation_tuples()) or len(pages) != 5:
            raise AssertionError(f"gRPC ListRelationTuples paged {pages}")
        for client, where in ((rc, base), (wc, write_base)):
            health = get({}, "/health/ready", at=where)
            if (client.get_version(), client.health()) != (version, "SERVING") or \
                    health != (200, {"status": "ok"}):
                raise AssertionError(f"gRPC Version/Health on {where}: {client.get_version()}, "
                                     f"{client.health()}; REST {health}")
        log(f"  gRPC: BatchCheck, Expand (2), ListRelationTuples ({len(pages)} pages), Version "
            "and Health on both ports equal REST on the same port and the oracle")
    finally:
        rc.close()
        wc.close()


# -- phase 6b: the serving plane under load ------------------------------------------


def load_clients(spec_path: str) -> int:
    """The closed-loop REST clients of phase 6b, in a process of their own
    (`chip_smoke.py --load-clients SPEC`, started by run_serve_load): one
    thread and one keep-alive connection a client, each sending the single
    checks of its slice of the spec's draws in order (or, with "cycle",
    round and round) until the leg's seconds are up. Prints one JSON
    object: each client's latencies, answers and errors. Imports nothing
    of torch or the port."""
    import http.client
    import threading
    import urllib.parse

    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    host, port, seconds = spec["host"], spec["port"], spec["seconds"]
    out = [None] * len(spec["slices"])
    start = threading.Barrier(len(spec["slices"]))

    def client(i):
        draws = spec["slices"][i]
        lat, answers, errors = [], [], []
        conn = http.client.HTTPConnection(host, port, timeout=60)
        start.wait(timeout=60)
        end = time.perf_counter() + seconds
        k = 0
        while time.perf_counter() < end and (spec["cycle"] or k < len(draws)):
            idx, obj, sub = draws[k % len(draws)]
            path = "/relation-tuples/check?" + urllib.parse.urlencode(
                {"namespace": "videos", "object": obj, "relation": "view", "subject_id": sub})
            t = time.perf_counter()
            try:
                conn.request("GET", path)
                r = conn.getresponse()
                body = r.read()
                lat.append(time.perf_counter() - t)
                if r.status in (200, 403):
                    answers.append((idx, r.status == 200))
                else:
                    errors.append((idx, r.status, body.decode(errors="replace")[:200]))
            except (OSError, http.client.HTTPException) as e:
                errors.append((idx, None, repr(e)))
                conn.close()
                conn = http.client.HTTPConnection(host, port, timeout=60)
            k += 1
        conn.close()
        out[i] = {"lat": lat, "answers": answers,
                  "errors": errors, "exhausted": not spec["cycle"] and k >= len(draws)}

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(out))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    print(json.dumps(out))
    return 0


def load_draws(owner_of: dict, n: int, seed: int, exclude: set = frozenset()) -> list:
    """n distinct (object, subject) checks drawn by phase 4's law: half a
    folder's owner viewing one of its files (hits), half a random user;
    none of them in `exclude`."""
    rng = random.Random(seed)
    seen, draws = set(exclude), []
    while len(draws) < n:
        d = rng.randrange(N_FOLDERS)
        obj = f"/d{d}/v{rng.randrange(FILES_PER_FOLDER)}.mp4"
        sub = owner_of[f"/d{d}"] if len(draws) % 2 == 0 else f"user{rng.randrange(N_USERS)}"
        if (obj, sub) not in seen:
            seen.add((obj, sub))
            draws.append((obj, sub))
    return draws


def run_load_leg(host: str, port: int, slices: list, seconds: float, cycle: bool) -> list:
    """One leg of closed-loop clients in a child process; their results."""
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump({"host": host, "port": port, "seconds": seconds, "cycle": cycle,
                   "slices": slices}, f)
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--load-clients", f.name],
            capture_output=True, text=True, timeout=seconds + 120,
        )
    finally:
        os.unlink(f.name)
    if proc.returncode != 0:
        raise AssertionError(f"load clients exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


def leg_figures(name: str, results: list, seconds: float, smi: str,
                checks_per_request: int = 1) -> dict:
    """A leg's checks/s and per-request latency percentiles (a request
    carries `checks_per_request` checks)."""
    lat = sorted(x for r in results for x in r["lat"])
    n = len(lat)
    errors = [e for r in results for e in r["errors"]]

    def pct(p):
        return lat[min(n - 1, int(p / 100 * n))] * 1e3 if n else None

    fig = {"leg": name, "clients": len(results), "seconds": seconds, "requests": n,
           "checks": n * checks_per_request, "checks_per_s": n * checks_per_request / seconds,
           "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
           "max_ms": lat[-1] * 1e3 if n else None, "errors": len(errors),
           "exhausted_clients": sum(bool(r["exhausted"]) for r in results), "card": smi}
    log(f"  {name}: {n} requests of {checks_per_request} checks in {seconds:.1f} s by "
        f"{len(results)} clients = {fig['checks_per_s']:.1f} checks/s; p50 "
        f"{fig['p50_ms']:.3f} ms, p95 "
        f"{fig['p95_ms']:.3f} ms, p99 {fig['p99_ms']:.3f} ms, max {fig['max_ms']:.3f} ms; "
        f"{len(errors)} errors ({smi})")
    if errors:
        log(f"  first errors: {errors[:5]}")
    return fig


def run_serve_load(manager, owners, smi: str):
    """Phase 6b: a Registry over phase 4's store (dsn memory) and a Daemon
    with the default serve keys on free ports, driven by 32 closed-loop
    REST clients in a process of their own for 8 s with single checks
    drawn without repeat (cache misses), then 2 s over 256 hot checks
    (cache hits, singleflight). Every check goes admission -> check cache
    -> CheckBatcher -> check_batch_submit / check_batch_resolve_v on the
    card: the "serve" launch path. Then phases 6c and 6d. Returns the
    launches and figures of 6b, of 6c (6d's launches among them) and 6d's
    figures."""
    import torch
    from keto_tpu_torch.api.daemon import Daemon
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationTuple
    from keto_tpu_torch.registry import Registry

    t0 = phase(f"6b serve under load: {LOAD_THREADS} closed-loop REST clients for "
               f"{LOAD_SECONDS:.0f} s, then {HOT_SECONDS:.0f} s over {HOT_QUERIES} hot checks")
    # the read port's direct gRPC listener serves phase 6c's comparison leg
    config = Config({"dsn": "memory", "limit": {"max_read_depth": MAX_DEPTH},
                     "namespaces": [videos_namespace().to_dict()],
                     "serve": {"read": {"host": "127.0.0.1", "port": 0,
                                        "grpc": {"host": "127.0.0.1", "port": 0}},
                               "write": {"host": "127.0.0.1", "port": 0}}})
    registry = Registry(config, device="cuda", manager=manager)
    t = time.perf_counter()
    engine = registry.check_engine()
    engine.ensure_state()
    torch.cuda.synchronize()
    log(f"  registry engine: snapshot + upload {time.perf_counter() - t:.1f} s")
    daemon = Daemon(registry)
    daemon.start()
    owner_of = {f: u for u, folders in owners[0].items() for f in folders}
    draws = load_draws(owner_of, LOAD_THREADS * LOAD_DRAWS_PER_THREAD + HOT_QUERIES + 41 * 64,
                       seed=66)
    solo_draws = [RelationTuple("videos", o, "view", subject_id=u) for o, u in draws[-41 * 64:]]
    draws = draws[:-41 * 64]
    miss_slices = [[(i * LOAD_DRAWS_PER_THREAD + k, *draws[i * LOAD_DRAWS_PER_THREAD + k])
                    for k in range(LOAD_DRAWS_PER_THREAD)] for i in range(LOAD_THREADS)]
    hot = [(len(draws) - HOT_QUERIES + k, *d) for k, d in enumerate(draws[-HOT_QUERIES:])]
    hot_slices = [random.Random(i).sample(hot, len(hot)) for i in range(LOAD_THREADS)]
    breaker = registry.circuit_breaker()
    cache = registry.check_cache()
    # what one batch costs with nothing else running, at the sizes the
    # load makes: the engine's submit and resolve alone, no HTTP, no cache
    solo = {}
    for size in (1, 8, 32):
        batches = [solo_draws[i * 64:i * 64 + size] for i in range(41)]
        engine.check_batch(batches[0])
        times = []
        for batch in batches[1:]:
            t = time.perf_counter()
            engine.check_batch(batch)
            times.append((time.perf_counter() - t) * 1e3)
        solo[size] = statistics.median(times)
    log(f"  one batch alone, submit + resolve, median of 40: "
        + ", ".join(f"{k} checks {v:.3f} ms" for k, v in solo.items()) + f" ({smi})")
    try:
        cuda_ops.reset_launch_counts()
        engine_before, batcher_before = dict(engine.stats), daemon.batcher.stats
        cache_before = dict(cache.counts)
        miss = run_load_leg("127.0.0.1", daemon.read_port, miss_slices, LOAD_SECONDS,
                            cycle=False)
        cache_mid, batcher_mid = dict(cache.counts), daemon.batcher.stats
        hot_res = run_load_leg("127.0.0.1", daemon.read_port, hot_slices, HOT_SECONDS,
                               cycle=True)
        torch.cuda.synchronize()
        launches = dict(cuda_ops.launches)
        batcher_after, cache_after = daemon.batcher.stats, dict(cache.counts)
        engine_after = dict(engine.stats)
        figs = {"miss": leg_figures("miss leg", miss, LOAD_SECONDS, smi),
                "hot": leg_figures("hot leg", hot_res, HOT_SECONDS, smi)}

        def delta(a, b, key):
            return b[key] - a[key]

        for name, (b0, b1, c0, c1) in (("miss", (batcher_before, batcher_mid, cache_before,
                                                 cache_mid)),
                                       ("hot", (batcher_mid, batcher_after, cache_mid,
                                                cache_after))):
            batches = delta(b0, b1, "batches")
            figs[name].update({
                "batches": batches, "batched_checks": delta(b0, b1, "batched_checks"),
                "mean_batch": delta(b0, b1, "batched_checks") / batches if batches else 0.0,
                "coalesced": delta(b0, b1, "coalesced"),
                "cache_hits": delta(c0, c1, "hit"), "cache_misses": delta(c0, c1, "miss"),
                "cache_stale": delta(c0, c1, "stale"),
            })
            log(f"  {name} leg: {batches} batches, mean {figs[name]['mean_batch']:.2f} checks a "
                f"batch; {figs[name]['coalesced']} coalesced riders; cache "
                f"{figs[name]['cache_hits']} "
                f"hits, {figs[name]['cache_misses']} misses ({smi})")
        device = delta(engine_before, engine_after, "device_checks")
        host = delta(engine_before, engine_after, "host_checks")
        failed = batcher_after["check_batch_failed"]
        shed = registry.counters().snapshot()["shed"]
        log(f"  engine: {device} device checks, {host} host checks; idle share not measured "
            f"({smi}); failed batches {failed}, shed {shed}, deadline drops "
            f"{batcher_after['deadline_exceeded']}, breaker {breaker.state} (transitions "
            f"{list(breaker.transitions)})")
        log(f"  launches on the serve path: {launches}")
        if figs["miss"]["errors"] or figs["hot"]["errors"]:
            raise AssertionError("load clients met errors")
        if sum(failed.values()) or sum(shed.values()) \
                or sum(batcher_after["deadline_exceeded"].values()):
            raise AssertionError("the load met a failed batch, a shed or a deadline drop")
        if list(breaker.transitions) or breaker.state != "closed":
            raise AssertionError(f"the breaker moved: {list(breaker.transitions)}")
        if host:
            raise AssertionError(f"{host} host checks under load")
        if figs["miss"]["cache_hits"]:
            raise AssertionError("draws without repeat hit the cache")
        missing = [k for k in cuda_ops.CHECK_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the serve path: {missing}")
        answered = [a for r in miss for a in r["answers"]]
        oracle = ReferenceEngine(manager, config)
        sample = random.Random(8).sample(answered, min(512, len(answered)))
        bad = [(i, allowed) for i, allowed in sample if oracle.check_relation_tuple(
            RelationTuple("videos", draws[i][0], "view",
                          subject_id=draws[i][1])).allowed != allowed]
        if len(sample) < 512 or bad:
            raise AssertionError(f"{len(bad)} of {len(sample)} sampled verdicts differ from the "
                                 "oracle")
        log(f"  512 sampled verdicts equal the oracle; {sum(a for _i, a in answered)} allowed of "
            f"{len(answered)}")
        # the hot leg whole: every answer, from a cache hit, a coalesced rider
        # or a batch slot, against the oracle's verdict on its query
        hot_want = {i: oracle.check_relation_tuple(
            RelationTuple("videos", obj, "view", subject_id=sub)).allowed for i, obj, sub in hot}
        hot_answered = [a for r in hot_res for a in r["answers"]]
        bad = [(i, allowed) for i, allowed in hot_answered if hot_want[i] != allowed]
        if not figs["hot"]["cache_hits"] or len(hot_answered) != figs["hot"]["requests"] or bad:
            raise AssertionError(f"hot leg: {len(bad)} of {len(hot_answered)} verdicts differ "
                                 f"from the oracle ({figs['hot']['cache_hits']} cache hits)")
        log(f"  hot leg: all {len(hot_answered)} verdicts ({figs['hot']['cache_hits']} cache hits, "
            f"{figs['hot']['coalesced']} coalesced riders) equal the oracle, over "
            f"{len({i for i, _a in hot_answered})} of its {HOT_QUERIES} queries")
        log(f"  serve-load phase {time.perf_counter() - t0:.1f} s")
        serve_load = {**figs, "device_checks": device, "host_checks": host,
                      "solo_batch_ms": solo, "idle_share": "not measured", "window_ms": 2.0,
                      "pipeline_depth": 2, "card": smi,
                      "note": "REST through the read port's mux (PortMux)"}
        g_launches, grpc_load, g_draws = run_grpc_load(registry, daemon, manager, config,
                                                       owners, set(draws), smi)
        a_launches, aio_load = run_aio_load(manager, engine, config, owners,
                                            set(draws) | g_draws, daemon, smi)
        g_launches.update(a_launches)
        return launches, serve_load, g_launches, grpc_load, aio_load
    finally:
        daemon.stop()


# -- phase 6c: the gRPC plane under load ---------------------------------------------


def grpc_clients(spec_path: str) -> int:
    """The closed-loop gRPC clients of phase 6c, in a process of their own
    (`chip_smoke.py --grpc-clients SPEC`, started by run_grpc_leg): one
    thread and one channel a client. Mode "check": single
    CheckService/Check RPCs over the client's slice of draws in order (or,
    with "cycle", round and round) until the leg's seconds are up; mode
    "batch": BatchCheck RPCs of the spec's "batch" draws each; mode "raw":
    the spec's serialized requests once each, in order, on one channel.
    Prints one JSON object: each client's latencies, answers and errors.
    A draw is (index, object, subject[, relation]) in the spec's
    "namespace" ("videos" and "view" by default). Imports grpc,
    google.protobuf and the port's descriptors, nothing of torch."""
    import base64
    import threading

    import grpc

    from keto_tpu_torch.api.descriptors import BATCH_CHECK_SERVICE, CHECK_SERVICE, pb

    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    target, seconds, mode = f"{spec['host']}:{spec['port']}", spec["seconds"], spec["mode"]

    namespace = spec.get("namespace", "videos")

    def check_request(obj, sub, relation="view"):
        return pb.RelationTuple(namespace=namespace, object=obj, relation=relation,
                                subject=pb.Subject(id=sub))

    if mode == "raw":
        channel = grpc.insecure_channel(target)
        out = []
        for path, request in spec["requests"]:
            t = time.perf_counter()
            try:
                resp = channel.unary_unary(path)(base64.b64decode(request), timeout=600)
                out.append({"ms": (time.perf_counter() - t) * 1e3, "code": "OK",
                            "response": base64.b64encode(resp).decode()})
            except grpc.RpcError as e:
                out.append({"ms": (time.perf_counter() - t) * 1e3, "code": e.code().name,
                            "details": e.details()})
        channel.close()
    else:
        out = [None] * len(spec["slices"])
        start = threading.Barrier(len(out))

        def client(i):
            draws = spec["slices"][i]
            lat, answers, errors = [], [], []
            channel = grpc.insecure_channel(target)
            grpc.channel_ready_future(channel).result(timeout=60)
            if mode == "check":
                rpc = channel.unary_unary(
                    f"/{CHECK_SERVICE}/Check", request_serializer=lambda m: m.SerializeToString(),
                    response_deserializer=pb.CheckResponse.FromString)
                step = 1
            else:
                rpc = channel.unary_unary(
                    f"/{BATCH_CHECK_SERVICE}/BatchCheck",
                    request_serializer=lambda m: m.SerializeToString(),
                    response_deserializer=pb.BatchCheckResponse.FromString)
                step = spec["batch"]
            start.wait(timeout=60)
            t_start = time.perf_counter()
            end = t_start + seconds
            k = 0
            while time.perf_counter() < end and (spec["cycle"] or k + step <= len(draws)):
                group = [draws[(k + j) % len(draws)] for j in range(step)]
                if mode == "check":
                    req = pb.CheckRequest(tuple=check_request(*group[0][1:]))
                else:
                    req = pb.BatchCheckRequest(tuples=[check_request(*d[1:]) for d in group])
                t = time.perf_counter()
                try:
                    resp = rpc(req, timeout=60)
                    lat.append(time.perf_counter() - t)
                    if mode == "check":
                        answers.append((group[0][0], resp.allowed))
                    else:
                        # [first index, a verdict a draw as "0"/"1", the item errors]
                        answers.append((group[0][0], "".join("1" if r.allowed else "0"
                                                             for r in resp.results),
                                        [r.error for r in resp.results if r.error][:5]))
                except grpc.RpcError as e:
                    errors.append((group[0][0], e.code().name, e.details()))
                k += step
            channel.close()
            out[i] = {"lat": lat, "answers": answers, "errors": errors,
                      "elapsed": time.perf_counter() - t_start,
                      "exhausted": not spec["cycle"] and k + step > len(draws)}

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(out))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    leaked = sorted(m for m in sys.modules if m == "torch" or m.startswith("torch."))
    if leaked:
        print(f"the gRPC clients imported {leaked[:3]}", file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


def run_grpc_leg(host: str, port: int, spec: dict, seconds: float):
    """One leg of phase 6c's clients in a child process; their results."""
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump({"host": host, "port": port, "seconds": seconds, **spec}, f)
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--grpc-clients", f.name],
            capture_output=True, text=True, timeout=seconds + 600,
        )
    finally:
        os.unlink(f.name)
    if proc.returncode != 0:
        raise AssertionError(f"gRPC clients exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


def run_grpc_load(registry, daemon, manager, config, owners, exclude: set, smi: str):
    """Phase 6c, on phase 6b's Registry and Daemon, through the read port's
    mux: (a) 32 closed-loop clients of single CheckService/Check RPCs for
    8 s, drawn without repeat and apart from 6b's draws (cache misses),
    then the same on the direct gRPC listener; (b) the same clients over 256 new hot checks for 2 s; (c) bench.py's
    batch leg, 4 clients of BatchCheck RPCs of 2,048 draws for 8 s; (d)
    one Expand, ListObjects, ListSubjects and Filter RPC. (a) and (b) are
    the "grpc" launch path, (c) "grpc_batch", (d) "grpc_reads". Returns
    (launches by path, figures)."""
    import base64

    import torch
    from keto_tpu_torch.api.descriptors import (
        EXPAND_SERVICE,
        FILTER_SERVICE,
        REVERSE_READ_SERVICE,
        pb,
    )
    from keto_tpu_torch.api.messages import subject_to_proto, tree_to_proto
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationTuple, SubjectSet

    t0 = phase(f"6c gRPC under load: {LOAD_THREADS} clients of single Check RPCs for "
               f"{LOAD_SECONDS:.0f} s, {HOT_SECONDS:.0f} s over {HOT_QUERIES} hot checks, then "
               f"{GRPC_BATCH_CLIENTS} clients of BatchCheck RPCs of {GRPC_BATCH} for "
               f"{LOAD_SECONDS:.0f} s, then one Expand, ListObjects, ListSubjects and Filter")
    engine = registry.check_engine()
    breaker, cache = registry.circuit_breaker(), registry.check_cache()
    folders_of, files_of, _files_in = owners
    owner_of = {f: u for u, folders in folders_of.items() for f in folders}
    file_owner = {f: u for u, files in files_of.items() for f in files}

    def truth(obj, sub):
        return owner_of[obj.rsplit("/", 1)[0]] == sub or file_owner.get(obj) == sub

    n = GRPC_DRAWS_PER_THREAD
    draws = load_draws(owner_of, 2 * LOAD_THREADS * n + HOT_QUERIES, seed=67, exclude=exclude)
    # the mux leg's slices, then the direct listener's
    single_slices = [[[(leg * LOAD_THREADS * n + i * n + k, *draws[leg * LOAD_THREADS * n + i * n
                                                                   + k]) for k in range(n)]
                      for i in range(LOAD_THREADS)] for leg in range(2)]
    hot = [(len(draws) - HOT_QUERIES + k, *d) for k, d in enumerate(draws[-HOT_QUERIES:])]
    hot_slices = [random.Random(100 + i).sample(hot, len(hot)) for i in range(LOAD_THREADS)]
    per_client = GRPC_BATCH * GRPC_BATCH_RPCS
    b_draws = load_draws(owner_of, GRPC_BATCH_CLIENTS * per_client, seed=68)
    batch_slices = [[(i * per_client + k, *b_draws[i * per_client + k])
                     for k in range(per_client)] for i in range(GRPC_BATCH_CLIENTS)]
    oracle = ReferenceEngine(manager, config)
    host = "127.0.0.1"

    def counts():
        return dict(engine.stats), daemon.batcher.stats, dict(cache.counts)

    def check_clean(name, before, after):
        """No error, shed, failed batch, deadline drop, host check or
        breaker move between two counts."""
        (e0, b0, _c0), (e1, b1, _c1) = before, after
        failed = {k: b1["check_batch_failed"][k] - b0["check_batch_failed"][k]
                  for k in b1["check_batch_failed"]}
        drops = {k: b1["deadline_exceeded"][k] - b0["deadline_exceeded"][k]
                 for k in b1["deadline_exceeded"]}
        host_checks = e1["host_checks"] - e0["host_checks"]
        if sum(failed.values()) or sum(drops.values()) or host_checks:
            raise AssertionError(f"{name}: failed batches {failed}, deadline drops {drops}, "
                                 f"host checks {host_checks}")
        shed = registry.counters().snapshot()["shed"]
        if sum(shed.values()) or list(breaker.transitions) or breaker.state != "closed":
            raise AssertionError(f"{name}: shed {shed}, breaker {list(breaker.transitions)}")

    def batcher_figures(fig, before, after):
        (_e0, b0, c0), (_e1, b1, c1) = before, after
        batches = b1["batches"] - b0["batches"]
        fig.update({"batches": batches, "batched_checks": b1["batched_checks"] -
                    b0["batched_checks"],
                    "mean_batch": (b1["batched_checks"] - b0["batched_checks"]) / batches
                    if batches else 0.0,
                    "coalesced": b1["coalesced"] - b0["coalesced"],
                    "cache_hits": c1["hit"] - c0["hit"], "cache_misses": c1["miss"] - c0["miss"]})
        log(f"  {fig['leg']}: {batches} batches, mean {fig['mean_batch']:.2f} checks a batch; "
            f"{fig['coalesced']} coalesced riders; cache {fig['cache_hits']} hits, "
            f"{fig['cache_misses']} misses ({smi})")

    # (a), the same on the direct listener, and (b): the "grpc" launch path
    cuda_ops.reset_launch_counts()
    c_a0 = counts()
    single = run_grpc_leg(host, daemon.read_port, {"mode": "check", "cycle": False,
                                                   "slices": single_slices[0]}, LOAD_SECONDS)
    c_a1 = counts()
    direct = run_grpc_leg(host, daemon.read_grpc_port, {"mode": "check", "cycle": False,
                                                        "slices": single_slices[1]}, LOAD_SECONDS)
    c_a2 = counts()
    hot_res = run_grpc_leg(host, daemon.read_port, {"mode": "check", "cycle": True,
                                                    "slices": hot_slices}, HOT_SECONDS)
    torch.cuda.synchronize()
    c_b1 = counts()
    launches = {"grpc": dict(cuda_ops.launches)}
    figs = {"single": leg_figures("gRPC single leg", single, LOAD_SECONDS, smi),
            "single_direct": leg_figures("gRPC single leg, direct listener", direct,
                                         LOAD_SECONDS, smi),
            "hot": leg_figures("gRPC hot leg", hot_res, HOT_SECONDS, smi)}
    batcher_figures(figs["single"], c_a0, c_a1)
    batcher_figures(figs["single_direct"], c_a1, c_a2)
    batcher_figures(figs["hot"], c_a2, c_b1)
    check_clean("gRPC single and hot legs", c_a0, c_b1)
    if any(f["errors"] for f in figs.values()):
        raise AssertionError("gRPC clients met errors")
    if figs["single"]["cache_hits"] or figs["single_direct"]["cache_hits"]:
        raise AssertionError("gRPC draws without repeat hit the cache")
    answered = [a for r in single + direct for a in r["answers"]]
    wrong = [(i, a) for i, a in answered if truth(*draws[i]) != a]
    sample = random.Random(9).sample(answered, min(512, len(answered)))
    bad = [(i, a) for i, a in sample if oracle.check_relation_tuple(
        RelationTuple("videos", draws[i][0], "view", subject_id=draws[i][1])).allowed != a]
    # every verdict is held to the ground truth; the oracle takes 512 of
    # them (all, on a host too slow to answer 512 in the two legs)
    if wrong or bad or not answered:
        raise AssertionError(f"gRPC single legs: {len(wrong)} of {len(answered)} verdicts differ "
                             f"from the ground truth, {len(bad)} of {len(sample)} from the oracle")
    hot_want = {i: oracle.check_relation_tuple(
        RelationTuple("videos", obj, "view", subject_id=sub)).allowed for i, obj, sub in hot}
    hot_answered = [a for r in hot_res for a in r["answers"]]
    bad = [(i, a) for i, a in hot_answered if hot_want[i] != a or truth(*draws[i]) != a]
    if not figs["hot"]["cache_hits"] or len(hot_answered) != figs["hot"]["requests"] or bad:
        raise AssertionError(f"gRPC hot leg: {len(bad)} of {len(hot_answered)} verdicts differ")
    log(f"  gRPC single legs: all {len(answered)} verdicts equal the ground truth, "
        f"{len(sample)} sampled the oracle; hot leg: all {len(hot_answered)} equal the oracle and the ground truth")

    # (c) the batch leg: BatchCheck goes straight to engine.check_batch
    cuda_ops.reset_launch_counts()
    c_c0 = counts()
    batch = run_grpc_leg(host, daemon.read_port, {"mode": "batch", "cycle": False,
                                                  "batch": GRPC_BATCH, "slices": batch_slices},
                         LOAD_SECONDS)
    torch.cuda.synchronize()
    c_c1 = counts()
    launches["grpc_batch"] = dict(cuda_ops.launches)
    elapsed = max(r["elapsed"] for r in batch)
    fig = leg_figures("gRPC batch leg", batch, elapsed, smi, checks_per_request=GRPC_BATCH)
    fig["device_checks"] = c_c1[0]["device_checks"] - c_c0[0]["device_checks"]
    fig["batcher_batches"] = c_c1[1]["batches"] - c_c0[1]["batches"]
    figs["batch"] = fig
    check_clean("gRPC batch leg", c_c0, c_c1)
    item_errors = [e for r in batch for a in r["answers"] for e in a[2]]
    if fig["errors"] or item_errors:
        raise AssertionError(f"gRPC batch leg: {fig['errors']} RPC errors, item errors "
                             f"{item_errors[:3]}")
    verdicts = {first + j: bit == "1" for r in batch for first, bits, _e in r["answers"]
                for j, bit in enumerate(bits)}
    wrong = [i for i, a in verdicts.items() if truth(*b_draws[i]) != a]
    sample = random.Random(10).sample(sorted(verdicts), min(512, len(verdicts)))
    bad = [i for i in sample if oracle.check_relation_tuple(RelationTuple(
        "videos", b_draws[i][0], "view", subject_id=b_draws[i][1])).allowed != verdicts[i]]
    if wrong or bad or fig["device_checks"] != len(verdicts) or fig["batcher_batches"]:
        raise AssertionError(f"gRPC batch leg: {len(wrong)} of {len(verdicts)} verdicts differ "
                             f"from the ground truth, {len(bad)} sampled from the oracle; "
                             f"{fig['device_checks']} device checks, {fig['batcher_batches']} "
                             "batcher batches")
    log(f"  gRPC batch leg: all {len(verdicts)} verdicts equal the ground truth, 512 sampled "
        f"the oracle; {fig['device_checks']} device checks, no batcher batch")

    # (d) one RPC of each other read verb, against the engine called
    # directly and the ground truth or the oracle
    counts_d = sorted((len(folders_of.get(u, ())) * FILES_PER_FOLDER + len(files_of.get(u, ())),
                       u) for u in folders_of)
    lo_user = counts_d[0][1]  # the fewest objects: the walk stays inside its caps
    f_user = owner_of["/d0"]
    expand_set = SubjectSet("videos", "/d1/v3.mp4", "parent")
    ls_obj = next(f for f in sorted(file_owner) if f.startswith("/d2/"))
    candidates = filter_candidates()
    expand_req = pb.ExpandRequest(max_depth=MAX_DEPTH)
    expand_req.subject.CopyFrom(subject_to_proto(expand_set))
    lo_req = pb.ListObjectsRequest(namespace="videos", relation="view", page_size=1 << 20,
                                   subject=subject_to_proto(lo_user))
    ls_req = pb.ListSubjectsRequest(namespace="videos", object=ls_obj, relation="view")
    f_req = pb.FilterRequest(namespace="videos", relation="view",
                             subject=subject_to_proto(f_user), objects=candidates)
    requests = [(f"/{EXPAND_SERVICE}/Expand", expand_req),
                (f"/{REVERSE_READ_SERVICE}/ListObjects", lo_req),
                (f"/{REVERSE_READ_SERVICE}/ListSubjects", ls_req),
                (f"/{FILTER_SERVICE}/Filter", f_req)]
    # the states these verbs read (the expand CSR, the reverse and subjects
    # mirrors) are built before the RPCs, so that each RPC times serving
    t = time.perf_counter()
    engine.expand(SubjectSet("videos", "/d0/v0.mp4", "parent"), MAX_DEPTH)
    engine.list_objects("videos", "view", counts_d[1][1])
    engine.list_subjects("videos", "/d0/v0.mp4", "view")
    engine.filter_objects("videos", "view", counts_d[1][1], candidates)
    torch.cuda.synchronize()
    log(f"  the expand, reverse and subjects states built, and one filter run, in "
        f"{time.perf_counter() - t:.1f} s")
    cuda_ops.reset_launch_counts()
    e_d0 = dict(engine.stats)
    got = run_grpc_leg(host, daemon.read_port, {"mode": "raw", "requests": [
        (path, base64.b64encode(req.SerializeToString()).decode()) for path, req in requests]},
        0.0)
    torch.cuda.synchronize()
    launches["grpc_reads"] = dict(cuda_ops.launches)
    e_d1 = dict(engine.stats)
    if any(g["code"] != "OK" for g in got):
        raise AssertionError(f"gRPC reads failed: {got}")
    resp = [cls.FromString(base64.b64decode(g["response"])) for g, cls in zip(got, (
        pb.ExpandResponse, pb.ListObjectsResponse, pb.ListSubjectsResponse, pb.FilterResponse))]
    host_reads = {k: e_d1.get(k, 0) - e_d0.get(k, 0) for k in
                  ("host_expands", "host_list_objects", "host_list_subjects", "filter_host")}
    if sum(host_reads.values()):
        raise AssertionError(f"gRPC reads replayed on the host: {host_reads}")
    # the engine's own answers, called directly
    tree = engine.expand(expand_set, MAX_DEPTH)
    direct = (pb.ExpandResponse(tree=tree_to_proto(tree)) if tree is not None
              else pb.ExpandResponse(),
              engine.list_objects("videos", "view", lo_user, page_size=1 << 20),
              engine.list_subjects("videos", ls_obj, "view"),
              engine.filter_objects("videos", "view", f_user, candidates))
    if resp[0].SerializeToString() != direct[0].SerializeToString() or \
            (list(resp[1].objects), resp[1].next_page_token) != tuple(direct[1]) or \
            (list(resp[2].subject_ids), resp[2].next_page_token) != tuple(direct[2]) or \
            list(resp[3].allowed_objects) != direct[3]:
        raise AssertionError("a gRPC read differs from the engine's own answer")
    # the ground truth and the oracle
    want_objects = sorted(set(folders_of[lo_user]) | {f"{d}/v{k}.mp4" for d in folders_of[lo_user]
                                                      for k in range(FILES_PER_FOLDER)}
                          | set(files_of.get(lo_user, ())))
    lo_sample = random.Random(11).sample(list(resp[1].objects), min(8, len(resp[1].objects)))
    want_subjects = sorted({owner_of[ls_obj.rsplit("/", 1)[0]], file_owner[ls_obj]})
    f_sample = random.Random(12).sample(range(len(candidates)), 200)
    f_allowed = set(resp[3].allowed_objects)
    if normalize(tree) != normalize(oracle.expand(expand_set, MAX_DEPTH)) or \
            list(resp[1].objects) != want_objects or \
            not all(oracle.check_relation_tuple(RelationTuple(
                "videos", o, "view", subject_id=lo_user)).allowed for o in lo_sample) or \
            list(resp[2].subject_ids) != want_subjects or \
            list(resp[2].subject_ids) != oracle.list_subjects("videos", ls_obj, "view") or \
            list(resp[3].allowed_objects) != [o for o in candidates if truth(o, f_user)] or \
            any(oracle.check_relation_tuple(RelationTuple(
                "videos", candidates[i], "view", subject_id=f_user)).allowed
                != (candidates[i] in f_allowed) for i in f_sample):
        raise AssertionError("a gRPC read differs from the ground truth or the oracle")
    reads = {name: {"ms": g["ms"], **extra} for name, g, extra in zip(
        ("expand", "list_objects", "list_subjects", "filter"), got,
        ({"tree_nodes": tree_size(tree)}, {"objects": len(resp[1].objects)},
         {"subject_ids": len(resp[2].subject_ids)},
         {"candidates": len(candidates), "allowed": len(resp[3].allowed_objects)}))}
    log(f"  gRPC reads on videos-1e6, each equal to the engine's own answer and the ground truth "
        f"or the oracle: {reads} ({smi})")
    log(f"  launches: {launches}")
    for path, want in (("grpc", cuda_ops.CHECK_KERNELS), ("grpc_batch", cuda_ops.CHECK_KERNELS)):
        missing = [k for k in want if launches[path][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} path: {missing}")
    log(f"  gRPC load phase {time.perf_counter() - t0:.1f} s")
    return launches, {**figs, "reads": reads, "idle_share": "not measured", "card": smi}, \
        set(draws)


# -- phase 6d: the asyncio read plane, and TLS ---------------------------------------


TLS_CHECKS = 16


def make_certificate(directory: str) -> tuple:
    """A self-signed certificate for 127.0.0.1 by `openssl req -x509`
    (cert path, key path); a missing openssl fails the phase."""
    cert, key = os.path.join(directory, "cert.pem"), os.path.join(directory, "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
                    "-out", cert, "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1",
                    "-addext", "subjectAltName=IP:127.0.0.1"],
                   check=True, capture_output=True, timeout=120)
    return cert, key


def run_aio_load(manager, engine, config, owners, exclude: set, daemon, smi: str):
    """Phase 6d, on phase 4's store and engine: a second Registry and
    Daemon with `serve.read.grpc.aio`, whose direct read listener is the
    asyncio plane; 32 closed-loop clients of single Check RPCs (6c(a)'s)
    for 8 s on it (the "grpc_aio" launch path), then 8 s on 6b's threaded
    direct listener ("grpc_direct"), draws without repeat and apart from
    6b's and 6c's; then the TLS leg on a third Daemon with
    `serve.read.tls` and the aio listener: REST and gRPC Checks through
    the TLS mux and gRPC Checks on the TLS aio listener ("tls"), each
    verdict held to the ground truth and the oracle, and plaintext against
    both ports refused. Returns (launches by path, figures)."""
    import ssl
    import urllib.error
    import urllib.parse
    import urllib.request

    import grpc
    import torch
    from keto_tpu_torch.api.daemon import Daemon
    from keto_tpu_torch.api.descriptors import CHECK_SERVICE, pb
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationTuple
    from keto_tpu_torch.registry import Registry

    t0 = phase(f"6d asyncio read plane: {LOAD_THREADS} clients of single Check RPCs for "
               f"{LOAD_SECONDS:.0f} s on the aio listener, then {LOAD_SECONDS:.0f} s on the "
               f"threaded direct listener; then {TLS_CHECKS} REST and 2 x {TLS_CHECKS} gRPC "
               "Checks over TLS")
    folders_of, files_of, _files_in = owners
    owner_of = {f: u for u, folders in folders_of.items() for f in folders}
    file_owner = {f: u for u, files in files_of.items() for f in files}

    def truth(obj, sub):
        return owner_of[obj.rsplit("/", 1)[0]] == sub or file_owner.get(obj) == sub

    n = GRPC_DRAWS_PER_THREAD
    draws = load_draws(owner_of, 2 * LOAD_THREADS * n + 3 * TLS_CHECKS, seed=69,
                       exclude=exclude)
    slices = [[[(leg * LOAD_THREADS * n + i * n + k, *draws[leg * LOAD_THREADS * n + i * n + k])
                for k in range(n)] for i in range(LOAD_THREADS)] for leg in range(2)]
    tls_draws = draws[2 * LOAD_THREADS * n:]
    oracle = ReferenceEngine(manager, config)
    namespaces = [videos_namespace().to_dict()]

    def served(serve):
        registry = Registry(Config({"dsn": "memory", "limit": {"max_read_depth": MAX_DEPTH},
                                    "namespaces": namespaces, "serve": serve}),
                            device="cuda", manager=manager, engine=engine)
        d = Daemon(registry)
        d.start()
        return registry, d

    listen = {"host": "127.0.0.1", "port": 0}
    aio_grpc = {**listen, "aio": True}
    registry, aio = served({"read": {**listen, "grpc": aio_grpc}, "write": listen})
    legs = {}
    try:
        for name, reg, port, path, sl in (
                ("aio", registry, aio.read_grpc_port, "grpc_aio", slices[0]),
                ("threaded_direct", daemon.registry, daemon.read_grpc_port, "grpc_direct",
                 slices[1])):
            before = (dict(engine.stats), reg.counters().snapshot(), dict(reg.check_cache().counts),
                      list(reg.circuit_breaker().transitions))
            cuda_ops.reset_launch_counts()
            res = run_grpc_leg("127.0.0.1", port, {"mode": "check", "cycle": False, "slices": sl},
                               LOAD_SECONDS)
            torch.cuda.synchronize()
            launches = dict(cuda_ops.launches)
            e1, b1, c1 = dict(engine.stats), reg.counters().snapshot(), \
                dict(reg.check_cache().counts)
            e0, b0, c0, tr0 = before
            label = "aio listener" if name == "aio" else "threaded direct listener"
            fig = leg_figures(f"gRPC single leg, {label}", res, LOAD_SECONDS, smi)
            batches = b1["batches"] - b0["batches"]
            fig.update({
                "batches": batches, "batched_checks": b1["batched_checks"] - b0["batched_checks"],
                "mean_batch": (b1["batched_checks"] - b0["batched_checks"]) / batches
                if batches else 0.0,
                "coalesced": b1["coalesced"] - b0["coalesced"],
                "cache_hits": c1["hit"] - c0["hit"], "cache_misses": c1["miss"] - c0["miss"],
                "host_checks": e1["host_checks"] - e0["host_checks"],
                "launches": {k: launches[k] for k in cuda_ops.CHECK_KERNELS}})
            log(f"  {label}: {batches} batches, mean {fig['mean_batch']:.2f} checks a batch; "
                f"{fig['coalesced']} coalesced riders; cache {fig['cache_hits']} hits, "
                f"{fig['cache_misses']} misses; K1-K4 launches {fig['launches']} ({smi})")
            failed = {k: b1["check_batch_failed"][k] - b0["check_batch_failed"][k]
                      for k in b1["check_batch_failed"]}
            drops = {k: b1["deadline_exceeded"][k] - b0["deadline_exceeded"][k]
                     for k in b1["deadline_exceeded"]}
            shed = {k: b1["shed"][k] - b0["shed"][k] for k in b1["shed"]}
            moved = list(reg.circuit_breaker().transitions)[len(tr0):]
            if fig["errors"] or sum(failed.values()) or sum(drops.values()) or \
                    sum(shed.values()) or fig["host_checks"] or moved or fig["cache_hits"]:
                raise AssertionError(f"6d {name} leg: {fig['errors']} errors, failed batches "
                                     f"{failed}, deadline drops {drops}, shed {shed}, host checks "
                                     f"{fig['host_checks']}, breaker {moved}, cache hits "
                                     f"{fig['cache_hits']}")
            missing = [k for k in cuda_ops.CHECK_KERNELS if launches[k] == 0]
            if missing or not batches:
                raise AssertionError(f"6d {name} leg: kernels never launched {missing}, "
                                     f"{batches} batches")
            legs[name] = (fig, res, path, launches)
    finally:
        aio.stop()
    answered = [a for _f, res, _p, _l in legs.values() for r in res for a in r["answers"]]
    wrong = [(i, a) for i, a in answered if truth(*draws[i]) != a]
    sample = random.Random(13).sample(answered, min(512, len(answered)))
    bad = [(i, a) for i, a in sample if oracle.check_relation_tuple(
        RelationTuple("videos", draws[i][0], "view", subject_id=draws[i][1])).allowed != a]
    if wrong or bad or not answered:
        raise AssertionError(f"6d: {len(wrong)} of {len(answered)} verdicts differ from the "
                             f"ground truth, {len(bad)} of {len(sample)} from the oracle")
    log(f"  6d legs: all {len(answered)} verdicts equal the ground truth, {len(sample)} sampled "
        f"the oracle; aio {legs['aio'][0]['checks_per_s']:.1f} checks/s against threaded direct "
        f"{legs['threaded_direct'][0]['checks_per_s']:.1f} ({smi})")

    # the TLS leg: a TLS mux (REST and gRPC) and the TLS aio listener
    with tempfile.TemporaryDirectory() as tmp:
        cert, key = make_certificate(tmp)
        tls = {"cert_path": cert, "key_path": key}
        t_reg, t_daemon = served({"read": {**listen, "grpc": aio_grpc, "tls": tls},
                                  "write": listen})
        try:
            ctx = ssl.create_default_context(cafile=cert)
            with open(cert, "rb") as f:
                creds = grpc.ssl_channel_credentials(f.read())
            cuda_ops.reset_launch_counts()
            e0 = dict(engine.stats)
            got = []
            for k, (obj, sub) in enumerate(tls_draws):
                i = 2 * LOAD_THREADS * n + k
                if k < TLS_CHECKS:  # REST through the TLS mux
                    url = (f"https://127.0.0.1:{t_daemon.read_port}/relation-tuples/check?" +
                           urllib.parse.urlencode({"namespace": "videos", "object": obj,
                                                   "relation": "view", "subject_id": sub}))
                    try:
                        with urllib.request.urlopen(url, context=ctx, timeout=60) as r:
                            status, body = r.status, json.loads(r.read())
                    except urllib.error.HTTPError as e:
                        status, body = e.code, json.loads(e.read())
                    if (status, body) not in ((200, {"allowed": True}),
                                              (403, {"allowed": False})):
                        raise AssertionError(f"TLS REST check answered {status} {body}")
                    got.append(("rest_mux", i, body["allowed"]))
                else:  # gRPC through the TLS mux, then on the TLS aio listener
                    where = "grpc_mux" if k < 2 * TLS_CHECKS else "grpc_aio"
                    port = t_daemon.read_port if where == "grpc_mux" else t_daemon.read_grpc_port
                    req = pb.CheckRequest(tuple=pb.RelationTuple(
                        namespace="videos", object=obj, relation="view", subject=pb.Subject(id=sub)))
                    with grpc.secure_channel(f"127.0.0.1:{port}", creds) as ch:
                        resp = ch.unary_unary(
                            f"/{CHECK_SERVICE}/Check",
                            request_serializer=lambda m: m.SerializeToString(),
                            response_deserializer=pb.CheckResponse.FromString)(req, timeout=60)
                    got.append((where, i, resp.allowed))
            torch.cuda.synchronize()
            tls_launches = dict(cuda_ops.launches)
            host = dict(engine.stats)["host_checks"] - e0["host_checks"]
            # plaintext against both TLS ports is refused
            refused = []
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{t_daemon.read_port}/version",
                                       timeout=10)
            except Exception:  # noqa: BLE001 - any failure is the refusal wanted
                refused.append("rest_mux")
            with grpc.insecure_channel(f"127.0.0.1:{t_daemon.read_grpc_port}") as ch:
                try:
                    ch.unary_unary(f"/{CHECK_SERVICE}/Check")(
                        pb.CheckRequest().SerializeToString(), timeout=10)
                except grpc.RpcError as e:
                    if e.code() == grpc.StatusCode.UNAVAILABLE:
                        refused.append("grpc_aio")
        finally:
            t_daemon.stop()
    wrong = [(w, i, a) for w, i, a in got if truth(*draws[i]) != a or oracle.check_relation_tuple(
        RelationTuple("videos", draws[i][0], "view", subject_id=draws[i][1])).allowed != a]
    missing = [k for k in cuda_ops.CHECK_KERNELS if tls_launches[k] == 0]
    if wrong or len(got) != 3 * TLS_CHECKS or host or missing or \
            refused != ["rest_mux", "grpc_aio"]:
        raise AssertionError(f"6d TLS leg: {len(wrong)} of {len(got)} verdicts differ "
                             f"({wrong[:3]}), {host} host checks, kernels never launched "
                             f"{missing}, plaintext refused on {refused}")
    log(f"  TLS leg: {len(got)} checks ({TLS_CHECKS} REST and {TLS_CHECKS} gRPC through the TLS "
        f"mux, {TLS_CHECKS} gRPC on the TLS aio listener), every verdict equal to the ground "
        f"truth and the oracle, {sum(a for _w, _i, a in got)} allowed; plaintext refused on both "
        f"ports; K1-K4 launches {({k: tls_launches[k] for k in cuda_ops.CHECK_KERNELS})}")
    log(f"  6d phase {time.perf_counter() - t0:.1f} s")
    launches = {path: counts for _f, _r, path, counts in legs.values()}
    launches["tls"] = tls_launches
    return launches, {"aio": legs["aio"][0], "threaded_direct": legs["threaded_direct"][0],
                      "tls": {"checks": len(got), "allowed": sum(a for _w, _i, a in got),
                              "plaintext_refused": refused},
                      "window_ms": 2.0, "pipeline_depth": 2,
                      "idle_share": "not measured", "card": smi}


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


# -- phase 13: OPL namespace files and the Watch API ---------------------------------


# tests/test_opl.py's full example (Keto's internal/schema testdata): view is
# an OR whose first child is an AND of two traverses, `not` a NOT, `rename`
# a traverse of `siblings` to `edit`
OPL_FULL_EXAMPLE = """
class User implements Namespace {
  related: {
    manager: User[]
  }
}

class Group implements Namespace {
  related: {
    members: (User | Group)[]
  }
}

class Folder implements Namespace {
  related: {
    parents: File[]
    viewers: SubjectSet<Group, "members">[]
  }

  permits = {
    view: (ctx: Context): boolean => this.related.viewers.includes(ctx.subject),
  }
}

class File implements Namespace {
  related: {
    parents: (File | Folder)[]
    viewers: (User | SubjectSet<Group, "members">)[]
    owners: (User | SubjectSet<Group, "members">)[]
    siblings: File[]
  }

  // Some comment
  permits = {
    view: (ctx: Context): boolean =>
      (
      this.related.parents.traverse((p) =>
        p.related.viewers.includes(ctx.subject),
      ) &&
      this.related.parents.traverse(p => p.permits.view(ctx)) ) ||
      (this.related.viewers.includes(ctx.subject) ||
      this.related.viewers.includes(ctx.subject) ||
      this.related.viewers.includes(ctx.subject) ) ||
      this.related.owners.includes(ctx.subject),

    edit: (ctx: Context) => this.related.owners.includes(ctx.subject),

    not: (ctx: Context) => !this.related.owners.includes(ctx.subject),

    rename: (ctx: Context) =>
      this.related.siblings.traverse(s => s.permits.edit(ctx)),
  }
}
"""
OPL_EDIT = "edit: (ctx: Context) => this.related.owners.includes(ctx.subject),"
OPL_EDIT_WIDE = ("edit: (ctx: Context) => this.related.owners.includes(ctx.subject) || "
                 "this.related.viewers.includes(ctx.subject),")
OPL_BROKEN = "class File implements Namespace { related: { owners: User[] "
OPL_PERMITS = ("view", "edit", "not", "rename")
# phase 4's videos-1e6 size: 6,600 folders of 120 files, 1,000 groups of 16
OPL_FOLDERS = 6600
OPL_FILES = 120
OPL_GROUPS = 1000
OPL_GROUP_SIZE = 16
OPL_ROUNDS = 20
OPL_SAMPLES = 512
# 13c: 16 closed-loop gRPC Check clients beside a writer of 10
# transactions of 8 ops a second, for 8 s
WATCH_SECONDS = 8.0
WATCH_TX_PER_S = 10
WATCH_TX_OPS = 8
WATCH_CLIENTS = 16
WATCH_DRAWS_PER_CLIENT = 4_000
WATCH_RESET_BUFFER = 4
# 13d: the serve subprocess's few hundred tuples
OPL_SERVE_SHAPE = dict(n_folders=4, files_per_folder=40, n_groups=8)


def build_opl_dataset(n_folders: int, files_per_folder: int, n_groups: int = OPL_GROUPS,
                      seed: int = 25):
    """The full example's namespaces filled in: groups of OPL_GROUP_SIZE
    users, a folder's viewers one group's members, files with a parent
    folder, owners (a user) on a quarter, viewers (a user) on an eighth,
    a sibling on a sixteenth. Returns the tuples, a batch of BATCH checks
    (the four permits in turn; half the subjects a likely hit) and, by
    file, its owner and viewer."""
    from keto_tpu_torch.ketoapi import RelationTuple, SubjectSet

    rng = random.Random(seed)
    n_users = n_groups * OPL_GROUP_SIZE
    tuples = [RelationTuple("Group", f"g{g}", "members", subject_id=f"u{g * OPL_GROUP_SIZE + k}")
              for g in range(n_groups) for k in range(OPL_GROUP_SIZE)]
    group_of, owner_of, viewer_of = {}, {}, {}
    for d in range(n_folders):
        g = rng.randrange(n_groups)
        group_of[d] = g
        tuples.append(RelationTuple("Folder", f"d{d}", "viewers",
                                    subject_set=SubjectSet("Group", f"g{g}", "members")))
        parent = SubjectSet("Folder", f"d{d}", "...")
        for f in range(files_per_folder):
            obj = f"d{d}f{f}"
            tuples.append(RelationTuple("File", obj, "parents", subject_set=parent))
            if rng.random() < 0.25:
                owner_of[obj] = f"u{rng.randrange(n_users)}"
                tuples.append(RelationTuple("File", obj, "owners", subject_id=owner_of[obj]))
            if rng.random() < 0.125:
                viewer_of[obj] = f"u{rng.randrange(n_users)}"
                tuples.append(RelationTuple("File", obj, "viewers", subject_id=viewer_of[obj]))
            if rng.random() < 0.0625:
                tuples.append(RelationTuple("File", obj, "siblings", subject_set=SubjectSet(
                    "File", f"d{d}f{(f + 1) % files_per_folder}", "...")))
    queries = []
    for i in range(BATCH):
        d, f = rng.randrange(n_folders), rng.randrange(files_per_folder)
        obj, permit = f"d{d}f{f}", OPL_PERMITS[i % 4]
        if i % 8 < 4:
            sub = f"u{rng.randrange(n_users)}"
        elif permit == "view":
            sub = f"u{group_of[d] * OPL_GROUP_SIZE + rng.randrange(OPL_GROUP_SIZE)}"
        elif permit == "rename":
            sub = owner_of.get(f"d{d}f{(f + 1) % files_per_folder}", f"u{rng.randrange(n_users)}")
        else:
            sub = owner_of.get(obj) or viewer_of.get(obj) or f"u{rng.randrange(n_users)}"
        queries.append(RelationTuple("File", obj, permit, subject_id=sub))
    return tuples, queries, owner_of, viewer_of


def write_opl(path: str, text: str, bump_s: float) -> None:
    """Replace a namespace file at once, its mtime moved `bump_s` past its
    last one (a hot reload keys on the mtime)."""
    old = os.stat(path).st_mtime if os.path.exists(path) else time.time()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    os.utime(path, (old + bump_s, old + bump_s))


def keto_config(path: str, location: str, serve: dict) -> str:
    """A Keto config naming its namespaces by `location`, in YAML when
    PyYAML is there (Keto's own format), else JSON; the file's path."""
    cfg = {"dsn": "memory", "namespaces": {"location": f"file://{location}"},
           "limit": {"max_read_depth": MAX_DEPTH}, "serve": serve}
    try:
        import yaml
    except ModuleNotFoundError:
        path = os.path.splitext(path)[0] + ".json"
        with open(path, "w") as f:
            json.dump(cfg, f)
        return path
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def percentile_ms(values: list, p: float):
    v = sorted(values)
    return v[min(len(v) - 1, int(p / 100 * len(v)))] * 1e3 if v else None


def opl_oracle_check(manager, config, queries, results, what: str) -> None:
    """OPL_SAMPLES sampled verdicts against the exact oracle's complete
    walk (visited_pruning=False, the device's semantics: the pruning walk
    cuts the second traverse of `view`'s AND, which meets the folder's
    viewers again)."""
    from keto_tpu_torch.engine.reference import ReferenceEngine

    oracle = ReferenceEngine(manager, config, visited_pruning=False)
    sample = random.Random(13).sample(range(len(queries)), min(OPL_SAMPLES, len(queries)))
    bad = [i for i in sample
           if oracle.check_relation_tuple(queries[i], MAX_DEPTH).allowed != results[i].allowed]
    if bad:
        raise AssertionError(f"{len(bad)} of {len(sample)} sampled verdicts {what} differ from "
                             f"the oracle: {[str(queries[i]) for i in bad[:3]]}")


def opl_serve_subprocess(tmp: str, repo: str):
    """13d's `python -m keto_tpu_torch serve --config keto.yml --tuples ...`
    over a copy of the OPL file: the process, its config, tuples and
    queries."""
    d = os.path.join(tmp, "serve_namespaces")
    os.makedirs(d)
    write_opl(os.path.join(d, "namespaces.keto.ts"), OPL_FULL_EXAMPLE, 0)
    listen = {"host": "127.0.0.1", "port": 0}
    cfg = keto_config(os.path.join(tmp, "serve.yml"), d, {"read": listen, "write": listen})
    tuples, queries, owner_of, _v = build_opl_dataset(**OPL_SERVE_SHAPE)
    with open(os.path.join(tmp, "serve_tuples.txt"), "w") as f:
        f.write("".join(f"{t}\n" for t in tuples))
    proc = subprocess.Popen(
        [sys.executable, "-m", "keto_tpu_torch", "serve", "--config", cfg,
         "--tuples", os.path.join(tmp, "serve_tuples.txt")],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": repo})
    return proc, cfg, tuples, queries, owner_of


def run_opl_serve(proc, cfg_path, tuples, queries, owner_of) -> dict:
    """13d: the serve subprocess answers one REST and one gRPC check equal
    to the oracle, one Watch event after one write, then stops on
    SIGTERM."""
    import signal
    import urllib.parse
    import urllib.request

    from keto_tpu_torch.api.client import ReadClient, open_channel
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationTuple
    from keto_tpu_torch.storage import MemoryManager

    t0 = phase("13d serve: python -m keto_tpu_torch serve --config <keto.yml> under the OPL file")
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving read="):
            raise AssertionError(f"serve did not start: {line!r} {proc.stderr.read()[-2000:]}")
        read = line.split("=", 1)[1].strip()
        line = proc.stdout.readline()
        if not line.startswith("serving write="):
            raise AssertionError(f"serve has no write listener: {line!r}")
        write = line.split("=", 1)[1].strip()
        t_ready = time.perf_counter() - t0
        config = Config.from_file(cfg_path)
        manager = MemoryManager()
        manager.write_relation_tuples(tuples)
        oracle = ReferenceEngine(manager, config, visited_pruning=False)
        owned = next(iter(owner_of))
        q_rest = RelationTuple("File", owned, "edit", subject_id=owner_of[owned])
        q_grpc = next(q for q in queries if q.relation == "view"
                      and oracle.check_relation_tuple(q, MAX_DEPTH).allowed)
        params = {"namespace": "File", "object": q_rest.object, "relation": "edit",
                  "subject_id": q_rest.subject_id}
        with urllib.request.urlopen(f"http://{read}/relation-tuples/check/openapi?"
                                    + urllib.parse.urlencode(params), timeout=60) as r:
            rest = json.loads(r.read())["allowed"]
            token = r.headers["X-Keto-Snaptoken"]
        client = ReadClient(open_channel(read))
        try:
            via_grpc = client.check(q_grpc, timeout=60)
            want = (oracle.check_relation_tuple(q_rest, MAX_DEPTH).allowed,
                    oracle.check_relation_tuple(q_grpc, MAX_DEPTH).allowed)
            if (rest, via_grpc) != want or want != (True, True):
                raise AssertionError(f"serve answered {(rest, via_grpc)}, the oracle {want}")
            new = RelationTuple("File", q_rest.object, "owners", subject_id="serve-watch")
            req = urllib.request.Request(f"http://{write}/admin/relation-tuples", method="PUT",
                                         data=json.dumps(new.to_dict()).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                if r.status != 201:
                    raise AssertionError(f"PUT answered {r.status}")
            events = list(client.watch(snaptoken=token, max_events=1, timeout=60))
        finally:
            client.close()
        got = [(e.event_type, [(op, str(t)) for op, t in e.changes]) for e in events]
        if got != [("change", [("insert", str(new))])]:
            raise AssertionError(f"the watch after the write gave {got}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"serve exited {rc}: {proc.stderr.read()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"  serve ready {t_ready:.1f} s into 13d; REST check {rest} and gRPC check {via_grpc} "
        f"equal the oracle; one Watch event after one write: {got[0][0]}; exit 0 on SIGTERM "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"tuples": len(tuples), "ready_s": t_ready, "config": os.path.basename(cfg_path)}


def run_opl_watch(smi: str):
    """Phase 13: OPL namespaces from a Keto config, served by a Registry
    and a Daemon as `serve` builds them, and the Watch API under load.
    Returns (the 13a batch's launches, 13c's launches, the K1-K4 "opl"
    entries, the figures)."""
    import torch

    from keto_tpu_torch.api.client import ReadClient, open_channel
    from keto_tpu_torch.api.daemon import Daemon
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.ketoapi import RelationTuple
    from keto_tpu_torch.registry import Registry

    fig = {"card": smi}
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        serve = opl_serve_subprocess(tmp, repo)  # its start overlaps 13a-13c
        t0 = phase(f"13a opl: {OPL_FOLDERS} folders x {OPL_FILES} files under the OPL full "
                   "example, from a Keto config")
        ns_dir = os.path.join(tmp, "namespaces")
        os.makedirs(ns_dir)
        ts_path = os.path.join(ns_dir, "namespaces.keto.ts")
        write_opl(ts_path, OPL_FULL_EXAMPLE, 0)
        listen = {"host": "127.0.0.1", "port": 0}
        cfg_path = keto_config(os.path.join(tmp, "keto.yml"), ns_dir, {
            "read": {**listen, "grpc": {**listen, "aio": True}}, "write": listen})
        fig["config"] = os.path.basename(cfg_path)
        t = time.perf_counter()
        tuples, queries, owner_of, viewer_of = build_opl_dataset(OPL_FOLDERS, OPL_FILES)
        t_data = time.perf_counter() - t
        config = Config.from_file(cfg_path)
        registry = Registry(config)
        manager = registry.relation_tuple_manager()
        t = time.perf_counter()
        manager.write_relation_tuples(tuples)
        t_store = time.perf_counter() - t
        n_tuples = len(tuples)
        del tuples
        engine = registry.check_engine()
        t = time.perf_counter()
        engine.ensure_state()
        torch.cuda.synchronize()
        fig["build"] = {"tuples": n_tuples, "data_s": t_data, "store_s": t_store,
                        "mirror_s": time.perf_counter() - t, **engine.last_build}
        log(f"  {n_tuples} tuples ({fig['config']}, namespaces "
            f"{sorted(ns.name for ns in registry.namespace_manager().namespaces())}): data "
            f"{t_data:.1f} s, store {t_store:.1f} s, mirror {fig['build']['mirror_s']:.1f} s "
            f"({engine.last_build})")

        cuda_ops.reset_launch_counts()
        before = dict(engine.stats)
        results = engine.check_batch(queries, MAX_DEPTH)  # the main path, once
        torch.cuda.synchronize()
        launches = dict(cuda_ops.launches)
        missing = [k for k in cuda_ops.CHECK_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the OPL check path: {missing}")
        t1 = time.perf_counter()
        handles = []
        for _ in range(OPL_ROUNDS):
            handles.append(engine.check_batch_submit(queries, MAX_DEPTH))
            if len(handles) > 8:
                engine.check_batch_resolve(handles.pop(0))
        for h in handles:
            engine.check_batch_resolve(h)
        torch.cuda.synchronize()
        qps = OPL_ROUNDS * BATCH / (time.perf_counter() - t1)
        lat = []
        for _ in range(9):
            s = time.perf_counter()
            engine.check_batch(queries, MAX_DEPTH)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - s) * 1e3)
        runs = 1 + OPL_ROUNDS + 9
        host = engine.stats["host_checks"] - before["host_checks"]
        causes = {k: v - before["host_cause"].get(k, 0)
                  for k, v in engine.stats["host_cause"].items()
                  if v != before["host_cause"].get(k, 0)}
        opl_oracle_check(manager, config, queries, results, "under the OPL file")
        by_permit = {p: sum(r.allowed for q, r in zip(queries, results) if q.relation == p)
                     for p in OPL_PERMITS}
        fig["check"] = {"checks_per_s": qps, "p50_batch_ms": statistics.median(lat),
                        "batch_ms": lat, "allowed_by_permit": by_permit,
                        "host_replays_per_batch": host / runs, "host_cause": causes,
                        "launches": launches}
        log(f"  launches on the main path: {launches}")
        log(f"  allowed by permit of {BATCH}: {by_permit}; {OPL_SAMPLES} sampled equal the "
            f"oracle; host replays {host} over {runs} batches, by cause {causes}")
        log(f"  throughput {qps:.1f} checks/s ({OPL_ROUNDS} batches of {BATCH}); p50 batch "
            f"{statistics.median(lat):.2f} ms (min {min(lat):.2f}, max {max(lat):.2f}) ({smi})")
        with Recorder(cuda_ops, step=1) as rec:
            engine.check_batch(queries, MAX_DEPTH)
        cases, k2_shape = kernel_cases(rec)
        at = [(case[0], "opl", scale_kernel_entry(
            case, "one OPL check batch, step 1", k2_shape if case[0] == "pair_probe" else None))
            for case in cases]
        del rec, cases
        log(f"  13a {time.perf_counter() - t0:.1f} s")

        t0 = phase("13b hot reload: edit = owners || viewers, then a file that does not parse")
        daemon = Daemon(registry)
        daemon.start()
        try:
            nm = registry.namespace_manager()
            cache = registry.check_cache()
            read = f"127.0.0.1:{daemon.read_port}"
            client = ReadClient(open_channel(read))
            # a viewer who owns nothing: `edit` flips with the reload
            obj = next(o for o, v in viewer_of.items() if owner_of.get(o) != v)
            probe = RelationTuple("File", obj, "edit", subject_id=viewer_of[obj])
            first = client.check(probe, timeout=60)
            again = client.check(probe, timeout=60)  # a cache hit at the same version
            hits0, gen0 = cache.stats()["hit"], nm.config_generation
            builds0 = engine.stats["snapshot_builds"]
            write_opl(ts_path, OPL_FULL_EXAMPLE.replace(OPL_EDIT, OPL_EDIT_WIDE), 5)
            t = time.perf_counter()
            wide = engine.check_batch(queries, MAX_DEPTH)
            torch.cuda.synchronize()
            reload_s = time.perf_counter() - t
            if engine.stats["snapshot_builds"] != builds0 + 1:
                raise AssertionError(f"the reload made {engine.stats['snapshot_builds'] - builds0}"
                                     " builds, not 1")
            after = client.check(probe, timeout=60)
            if (first, again, after) != (False, False, True) or nm.config_generation == gen0:
                raise AssertionError(f"the cache served {first, again, after} across the "
                                     f"reload (generation {gen0} -> {nm.config_generation})")
            opl_oracle_check(manager, config, queries, wide, "after the reload")
            flipped = sum(a.allowed != b.allowed for a, b in zip(results, wide))
            write_opl(ts_path, OPL_BROKEN, 10)
            builds1 = engine.stats["snapshot_builds"]
            broken = engine.check_batch(queries, MAX_DEPTH)
            kept = client.check(probe, timeout=60)
            if engine.stats["snapshot_builds"] != builds1 or not kept or \
                    [r.allowed for r in broken] != [r.allowed for r in wide]:
                raise AssertionError("a file that does not parse changed what is served")
            if "could not parse" not in str(nm.last_error):
                raise AssertionError(f"last_error is {nm.last_error!r}")
            # the wide file again: a load that succeeds, the same set, no rebuild
            write_opl(ts_path, OPL_FULL_EXAMPLE.replace(OPL_EDIT, OPL_EDIT_WIDE), 15)
            engine.check_batch(queries[:64], MAX_DEPTH)
            if nm.last_error is not None or engine.stats["snapshot_builds"] != builds1:
                raise AssertionError("restoring the file rebuilt or failed")
            fig["reload"] = {"rebuild_batch_s": reload_s, "build": dict(engine.last_build),
                             "verdicts_flipped": flipped, "cache_hits_before": hits0,
                             "last_error": str(nm.last_error) if nm.last_error else None,
                             "broken_error": "could not parse"}
            log(f"  reload: one rebuild, its batch {reload_s:.2f} s ({engine.last_build}); "
                f"{flipped} of {BATCH} verdicts flipped; the cached `edit` of a viewer "
                f"{again} before, {after} after (generation {gen0} -> "
                f"{nm.config_generation}); {OPL_SAMPLES} sampled equal the oracle")
            log(f"  a file that does not parse: no rebuild, verdicts unchanged, last_error "
                f"named the parse error; restored without a rebuild "
                f"({time.perf_counter() - t0:.1f} s)")

            t0 = phase(f"13c watch: {WATCH_CLIENTS} gRPC Check clients beside "
                       f"{WATCH_TX_PER_S} writes of {WATCH_TX_OPS} ops a second for "
                       f"{WATCH_SECONDS:.0f} s; threaded, aio and SSE subscribers")
            fig["watch"] = run_watch_load(registry, daemon, manager, client, owner_of, viewer_of,
                                          queries, smi)
            client.close()
            log(f"  13c {time.perf_counter() - t0:.1f} s")
        finally:
            daemon.stop()
            engine.stop_push_refresh()
        fig["serve"] = run_opl_serve(*serve)
    return launches, fig["watch"].pop("launches"), at, fig


def run_watch_load(registry, daemon, manager, client, owner_of, viewer_of, queries, smi):
    """13c (see run_opl_watch)."""
    import http.client
    import queue
    import threading
    import urllib.parse

    import grpc

    from keto_tpu_torch.api.client import WriteClient, open_channel
    from keto_tpu_torch.api.descriptors import WATCH_SERVICE, pb
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.snaptoken import encode_snaptoken, parse_snaptoken
    from keto_tpu_torch.ketoapi import RelationTuple

    nid = registry.nid
    hub = registry.watch_hub()
    n_tx = int(WATCH_SECONDS * WATCH_TX_PER_S)
    v0 = manager.version(nid=nid)
    tok0 = encode_snaptoken(v0, nid)
    commit_t: dict = {}
    # the commit's time, taken by the store's first write listener: before
    # the hub's, which wakes the tailer
    manager._write_listeners.insert(
        0, lambda n: commit_t.setdefault(manager.version(nid=n), time.monotonic()))
    got = {name: [] for name in ("grpc", "aio", "sse", "resumed")}
    arrived = {name: {} for name in got}
    errors = []

    def record(name, version, changes):
        arrived[name].setdefault(version, time.monotonic())
        got[name].append((version, changes))

    def grpc_frames(name, port, token, n, calls):
        ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        call = ch.unary_stream(f"/{WATCH_SERVICE}/Watch")(
            pb.WatchRequest(snaptoken=token).SerializeToString(), timeout=WATCH_SECONDS + 120)
        calls.append(call)
        k = 0
        try:
            for raw in call:
                e = pb.WatchResponse.FromString(raw)
                if e.event_type == "heartbeat":
                    continue
                record(name, parse_snaptoken(e.snaptoken, nid),
                       [(c.action, f"{c.relation_tuple.namespace}:{c.relation_tuple.object}#"
                                   f"{c.relation_tuple.relation}@{c.relation_tuple.subject.id}")
                        for c in e.changes])
                k += 1
                if k >= n:
                    break
        finally:
            call.cancel()
            ch.close()

    def sub_grpc(name, port):
        try:
            grpc_frames(name, port, tok0, n_tx, [])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((name, repr(e)))

    def sub_resumed(port):
        """Killed after a third of the events, resumed from its last token."""
        try:
            grpc_frames("resumed", port, tok0, n_tx // 3, [])
            last = encode_snaptoken(got["resumed"][-1][0], nid)
            grpc_frames("resumed", port, last, n_tx - len(got["resumed"]), [])
        except Exception as e:  # noqa: BLE001
            errors.append(("resumed", repr(e)))

    def sub_sse():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", daemon.read_port,
                                              timeout=WATCH_SECONDS + 60)
            conn.request("GET", "/relation-tuples/watch?" + urllib.parse.urlencode(
                {"snaptoken": tok0, "max_events": n_tx}))
            resp = conn.getresponse()
            if resp.status != 200:
                raise AssertionError(f"SSE answered {resp.status}")
            while True:
                line = resp.readline()
                if not line:
                    break
                if line.startswith(b"data: "):
                    d = json.loads(line[6:])
                    record("sse", parse_snaptoken(d["snaptoken"], nid),
                           [(c["action"], str(RelationTuple.from_dict(c["relation_tuple"])))
                            for c in d["changes"]])
            conn.close()
        except Exception as e:  # noqa: BLE001
            errors.append(("sse", repr(e)))

    subs_before = len(hub._states[nid].subs) if nid in hub._states else 0
    threads = [threading.Thread(target=sub_grpc, args=("grpc", daemon.read_port)),
               threading.Thread(target=sub_grpc, args=("aio", daemon.read_grpc_port)),
               threading.Thread(target=sub_sse),
               threading.Thread(target=sub_resumed, args=(daemon.read_grpc_port,))]
    for th in threads:
        th.start()
    reset_sub = hub.subscribe(nid, buffer=WATCH_RESET_BUFFER)  # never read in the window
    deadline = time.monotonic() + 60
    while len(hub._states[nid].subs) < subs_before + 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    if len(hub._states[nid].subs) < subs_before + 5:
        raise AssertionError(f"{len(hub._states[nid].subs) - subs_before} of 5 subscribers")

    # the load: draws without repeat over the four permits
    rng = random.Random(29)
    files = list(owner_of) + list(viewer_of)
    draws = []
    for i in range(WATCH_CLIENTS * WATCH_DRAWS_PER_CLIENT):
        q = queries[rng.randrange(len(queries))]
        draws.append((i, q.object if i % 2 else rng.choice(files),
                      f"u{rng.randrange(OPL_GROUPS * OPL_GROUP_SIZE)}", OPL_PERMITS[i % 4]))
    slices = [draws[c::WATCH_CLIENTS] for c in range(WATCH_CLIENTS)]
    load: dict = {}

    def run_load():
        try:
            load["results"] = run_grpc_leg("127.0.0.1", daemon.read_port, {
                "mode": "check", "cycle": False, "slices": slices, "namespace": "File"},
                WATCH_SECONDS)
        except Exception as e:  # noqa: BLE001
            errors.append(("load", repr(e)))

    # the writer: 8 ops a transaction (new owners; from the second on, 2
    # of the last one's removed), each read back at its snaptoken by a
    # reader of its own, so that the writer keeps its pace
    wc = WriteClient(open_channel(f"127.0.0.1:{daemon.write_port}"))
    owned = list(owner_of)
    writes, ryw_ms, acked = [], [], queue.Queue()

    def read_back():
        while (item := acked.get()) is not None:
            i, token, ins, dels = item
            t = time.perf_counter()
            try:
                seen = client.check(RelationTuple("File", ins.object, "edit",
                                                  subject_id=ins.subject_id),
                                    timeout=60, snaptoken=token)
                gone = [client.check(RelationTuple("File", d.object, "edit",
                                                   subject_id=d.subject_id),
                                     timeout=60, snaptoken=token) for d in dels[:1]]
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(("read back", i, repr(e)))
                continue
            ryw_ms.append((time.perf_counter() - t) * 1e3)
            if not seen or any(gone):
                errors.append(("read back", i, seen, gone))

    cuda_ops.reset_launch_counts()
    b0 = registry.counters().snapshot()
    loader = threading.Thread(target=run_load)
    reader = threading.Thread(target=read_back)
    loader.start()
    reader.start()
    t_start = time.monotonic()
    prev = []
    try:
        for i in range(n_tx):
            wait = t_start + i / WATCH_TX_PER_S - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            n_del = min(2, len(prev))
            ins = [RelationTuple("File", owned[rng.randrange(len(owned))], "owners",
                                 subject_id=f"w{i}_{k}") for k in range(WATCH_TX_OPS - n_del)]
            tokens = wc.transact(ins, prev[:n_del], timeout=60)
            acked.put((i, tokens[0], ins[0], prev[:n_del]))
            writes.append(parse_snaptoken(tokens[0], nid))
            prev = ins[-2:]
    finally:
        t_writes = time.monotonic() - t_start
        acked.put(None)
        reader.join(timeout=WATCH_SECONDS + 120)
        loader.join(timeout=WATCH_SECONDS + 600)
        wc.close()
    launches = dict(cuda_ops.launches)
    b1 = registry.counters().snapshot()
    batches = b1["batches"] - b0["batches"]
    batched = b1["batched_checks"] - b0["batched_checks"]
    if len(ryw_ms) != n_tx:
        raise AssertionError(f"{len(ryw_ms)} of {n_tx} writes read back: {errors[:3]}")
    for th in threads:
        th.join(timeout=60)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"watch subscribers: {errors}, "
                             f"{[th.is_alive() for th in threads]} alive")
    v1 = manager.version(nid=nid)
    by_v: dict = {}
    for v, op, t in manager.changelog_since(v0, nid=nid):
        by_v.setdefault(v, []).append((op, str(t)))
    want = list(by_v.items())
    if len(want) != n_tx or v1 != v0 + n_tx or writes != list(range(v0 + 1, v1 + 1)):
        raise AssertionError(f"{len(want)} committed versions of {n_tx} writes")
    for name, events in got.items():
        if events != want:
            bad = next(i for i, (a, b) in enumerate(zip(events + [None] * len(want), want))
                       if a != b)
            raise AssertionError(f"{name}: {len(events)} events; the first difference from "
                                 f"the change log at {bad}")
    # the unread subscriber: one RESET, then live events
    first = reset_sub.get(timeout=10)
    extra = reset_sub.get(timeout=0.3)
    wc = WriteClient(open_channel(f"127.0.0.1:{daemon.write_port}"))
    wc.transact([RelationTuple("File", owned[0], "owners", subject_id="after-reset")], [],
                timeout=60)
    wc.close()
    live = reset_sub.get(timeout=10)
    reset_sub.close()
    if first is None or not first.is_reset or extra is not None or live is None \
            or live.kind != "change" or live.version != v1 + 1:
        raise AssertionError(f"the unread subscriber got {first}, {extra}, {live}")
    results = load.get("results") or []
    legfig = leg_figures("13c gRPC Check beside the writer", results, WATCH_SECONDS, smi)
    if legfig["errors"]:
        raise AssertionError(f"{legfig['errors']} load errors")
    legfig.update(batches=batches, batched_checks=batched,
                  mean_batch=batched / batches if batches else 0.0)
    log(f"  the batcher: {batches} batches of {legfig['mean_batch']:.2f} checks on average "
        "(the load's and the read backs')")
    missing = [k for k in cuda_ops.CHECK_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched under the watch load: {missing}")
    planes = {}
    for name in ("grpc", "aio", "sse"):
        lat = [arrived[name][v] - commit_t[v] for v in by_v]
        planes[name] = {"p50_ms": percentile_ms(lat, 50), "p99_ms": percentile_ms(lat, 99),
                        "max_ms": max(lat) * 1e3, "min_ms": min(lat) * 1e3}
        log(f"  {name}: {n_tx} events equal the change log, once each, in order; commit to "
            f"delivery p50 {planes[name]['p50_ms']:.3f} ms, p99 {planes[name]['p99_ms']:.3f} "
            f"ms (min {planes[name]['min_ms']:.3f}, max {planes[name]['max_ms']:.3f})")
    log(f"  kill and resume after {n_tx // 3} events: no gap, no duplicate; the unread "
        f"subscriber (buffer {WATCH_RESET_BUFFER}): one RESET at v{first.version}, then v"
        f"{live.version} live")
    log(f"  {n_tx} writes in {t_writes:.2f} s, each seen at its snaptoken (read back p50 "
        f"{statistics.median(ryw_ms):.2f} ms, one or two checks); hub counts {hub.counts}; "
        f"launches {launches}")
    return {"writes": n_tx, "ops_per_write": WATCH_TX_OPS, "write_s": t_writes,
            "delivery": planes, "ryw_p50_ms": statistics.median(ryw_ms), "load": legfig,
            "hub": dict(hub.counts), "reset_at": first.version, "launches": launches}


# -- phase 14: the durable SQLite store ------------------------------------------------

SQLITE_TX = 10_000  # tuples a transaction of the ingest
SQLITE_SAMPLES = 512
SQLITE_SERVE_SHAPE = (5, 60)  # folders x files of 14c's file: a few hundred tuples
SQLITE_ACKS = 20  # REST writes acked before the SIGKILL
SQLITE_WATCH_FIRST = 8  # events the cursor reads before the SIGKILL
FAULT_POINTS = ("store_commit_pre", "store_commit_post", "changelog_append")
# processes main starts and the directories they write, ended and removed
# at exit whatever happens (stop_children)
CHILDREN: list = []
TEMP_DIRS: list = []


def sqlite_oracle_check(manager, config, queries, results, what: str, seed: int) -> None:
    """SQLITE_SAMPLES sampled verdicts against the exact oracle reading
    the SQLite store itself."""
    from keto_tpu_torch.engine.reference import ReferenceEngine

    oracle = ReferenceEngine(manager, config)
    sample = random.Random(seed).sample(range(len(queries)), min(SQLITE_SAMPLES, len(queries)))
    bad = [i for i in sample
           if oracle.check_relation_tuple(queries[i], MAX_DEPTH).allowed != results[i].allowed]
    if bad:
        raise AssertionError(f"{len(bad)} of {len(sample)} sampled verdicts {what} differ "
                             f"from the oracle: {[str(queries[i]) for i in bad[:3]]}")


def file_bytes(path: str) -> int:
    """The database file and its write-ahead log."""
    return sum(os.path.getsize(p) for p in (path, path + "-wal") if os.path.exists(p))


def sqlite_config(path: str, dsn_path: str) -> str:
    """14c's serve config: the videos namespace over `sqlite://<dsn_path>`."""
    listen = {"host": "127.0.0.1", "port": 0}
    with open(path, "w") as f:
        json.dump({"dsn": f"sqlite://{dsn_path}", "namespaces": [videos_namespace().to_dict()],
                   "limit": {"max_read_depth": MAX_DEPTH},
                   "serve": {"read": listen, "write": listen}}, f)
    return path


class Serve:
    """One `python -m keto_tpu_torch serve --config` process, with
    KETO_FAULTS set to `faults` (none when empty); its stderr goes to a
    file, read when it fails."""

    def __init__(self, repo: str, cfg_path: str, log_path: str, faults: str = ""):
        env = {k: v for k, v in os.environ.items() if k != "KETO_FAULTS"}
        env["PYTHONPATH"] = repo
        if faults:
            env["KETO_FAULTS"] = faults
        self.log_path = log_path
        self.err = open(log_path, "w")
        t = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "keto_tpu_torch", "serve", "--config", cfg_path],
            cwd=repo, stdout=subprocess.PIPE, stderr=self.err, text=True, env=env)
        self.read = self._address("serving read=")
        self.write = self._address("serving write=")
        self.ready_s = time.perf_counter() - t

    def _address(self, prefix: str) -> str:
        line = self.proc.stdout.readline()
        if not line.startswith(prefix):
            raise AssertionError(f"serve did not start: {line!r} {self.stderr()}")
        return line.split("=", 1)[1].strip()

    def stderr(self) -> str:
        self.err.flush()
        with open(self.log_path) as f:
            return f.read()[-2000:]

    def wait(self, timeout: float = 60) -> int:
        try:
            return self.proc.wait(timeout=timeout)
        finally:
            self.err.close()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.wait()


def rest_put(write: str, t) -> str:
    """PUT one tuple through the write API; its snaptoken (201), or raise."""
    import urllib.request

    req = urllib.request.Request(f"http://{write}/admin/relation-tuples", method="PUT",
                                 data=json.dumps(t.to_dict()).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        if r.status != 201:
            raise AssertionError(f"PUT {t} answered {r.status}")
        return r.headers["X-Keto-Snaptoken"]


def rest_check(read: str, t, snaptoken: str = "") -> bool:
    import urllib.parse
    import urllib.request

    params = {"namespace": t.namespace, "object": t.object, "relation": t.relation,
              "subject_id": t.subject_id, "max_depth": MAX_DEPTH}
    if snaptoken:
        params["snaptoken"] = snaptoken
    with urllib.request.urlopen(f"http://{read}/relation-tuples/check/openapi?"
                                + urllib.parse.urlencode(params), timeout=60) as r:
        return json.loads(r.read())["allowed"]


def served_checks(serve: Serve, oracle, checks: list) -> None:
    """Each (query, snaptoken) by REST and by gRPC, as the oracle answers."""
    from keto_tpu_torch.api.client import ReadClient, open_channel

    client = ReadClient(open_channel(serve.read))
    try:
        for q, token in checks:
            want = oracle.check_relation_tuple(q, MAX_DEPTH).allowed
            got = (rest_check(serve.read, q, token), client.check(q, MAX_DEPTH, timeout=60))
            if got != (want, want):
                raise AssertionError(f"{q}: REST and gRPC answered {got}, the oracle {want}")
    finally:
        client.close()


def postmortem(path: str, attempted: set, acked: list) -> dict:
    """keto_tpu's crash audit (tools/crash_smoke.py), off the file the dead
    server left: acked writes lost, tuples never attempted (phantoms), the
    rows present and the store version, the commits in the changelog."""
    from keto_tpu_torch.storage.sqlite import SQLitePersister

    store = SQLitePersister(path)
    try:
        present = {str(t) for t in store.all_relation_tuples()}
        log = store.changelog_since(0)
        return {"lost": len([t for t in acked if t not in present]),
                "phantoms": len([t for t in present if t not in attempted]),
                "present": len(present), "store_version": store.version(),
                "commits": len({v for v, _op, _t in log}), "rows": present,
                "logged": {str(t) for _v, op, t in log if op == "insert"}}
    finally:
        store.close()


def run_sqlite_restart(tmp: str, repo: str, smi: str, say, serves: list) -> dict:
    """14c: `serve --config` over a fresh SQLite file; a Watch cursor, 20
    acked writes, a SIGKILL, a restart that answers each as the oracle and
    resumes the cursor; three fault-point crashes and their postmortems;
    exit 0 on SIGTERM. It runs beside 14a and 14b on a thread of its own:
    `say` keeps its log lines for the main thread, and every server it
    starts joins `serves`."""
    import http.client
    import signal

    from keto_tpu_torch.api.client import ReadClient, open_channel
    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine.reference import ReferenceEngine
    from keto_tpu_torch.ketoapi import RelationTuple
    from keto_tpu_torch.storage import MemoryManager, SQLitePersister

    t0 = time.perf_counter()
    say("== 14c kill and restart: serve --config over sqlite://, SIGKILL, fault points "
        "(beside 14a and 14b)")
    path = os.path.join(tmp, "serve.sqlite")
    tuples, _queries = build_dataset(*SQLITE_SERVE_SHAPE, seed=14)
    store = SQLitePersister(path)
    store.write_relation_tuples(tuples)  # version 1
    store.close()
    cfg_path = sqlite_config(os.path.join(tmp, "serve.json"), path)
    config = Config.from_file(cfg_path)
    attempted = {str(t) for t in tuples}
    acked = [str(t) for t in tuples]
    files = sorted({t.object for t in tuples if t.relation == "parent"})
    writes = [RelationTuple("videos", files[i * 7 % len(files)], "owner", subject_id=f"acked{i}")
              for i in range(SQLITE_ACKS + len(FAULT_POINTS))]
    fig = {"tuples": len(tuples), "card": smi}

    def oracle():
        m = MemoryManager()
        m.write_relation_tuples([RelationTuple.from_string(s) for s in acked])
        return ReferenceEngine(m, config)

    serve = Serve(repo, cfg_path, os.path.join(tmp, "serve0.log"))
    serves.append(serve)
    try:
        token0 = encode_snaptoken_of(1)
        tokens = []
        for t in writes[:SQLITE_ACKS]:
            attempted.add(str(t))
            tokens.append(rest_put(serve.write, t))
            acked.append(str(t))
        client = ReadClient(open_channel(serve.read))
        try:
            first = list(client.watch(snaptoken=token0, max_events=SQLITE_WATCH_FIRST,
                                      timeout=60))
        finally:
            client.close()
        serve.proc.send_signal(signal.SIGKILL)
        rc = serve.wait()
    finally:
        serve.kill()
    if rc != -signal.SIGKILL:
        raise AssertionError(f"the killed server exited {rc}")
    fig["ready_s"] = [serve.ready_s]

    serve = Serve(repo, cfg_path, os.path.join(tmp, "serve1.log"))
    serves.append(serve)
    try:
        served_checks(serve, oracle(), list(zip(writes, tokens)))
        client = ReadClient(open_channel(serve.read))
        try:
            rest = list(client.watch(snaptoken=first[-1].snaptoken,
                                     max_events=SQLITE_ACKS - SQLITE_WATCH_FIRST, timeout=60))
        finally:
            client.close()
        got = [(e.event_type, [(op, str(t)) for op, t in e.changes]) for e in first + rest]
        want = [("change", [("insert", str(t))]) for t in writes[:SQLITE_ACKS]]
        if got != want:
            raise AssertionError(f"the Watch cursor across the kill gave {got[:3]}..., "
                                 f"not the {SQLITE_ACKS} acked writes once each in order")
        serve.proc.send_signal(signal.SIGTERM)
        if serve.wait() != 0:
            raise AssertionError(f"serve exited {serve.proc.returncode} on SIGTERM")
    finally:
        serve.kill()
    fig["ready_s"].append(serve.ready_s)
    say(f"  {len(tuples)} tuples in a fresh file; {SQLITE_ACKS} acked writes, the cursor read "
        f"{SQLITE_WATCH_FIRST} events, SIGKILL; the restart answered every acked write by REST "
        f"and gRPC as the oracle and resumed the cursor: {len(rest)} events, none lost or "
        f"repeated; exit 0 on SIGTERM")

    cycles = []
    for i, point in enumerate(FAULT_POINTS):
        serve = Serve(repo, cfg_path, os.path.join(tmp, f"fault{i}.log"),
                      faults=f"{point}=crash:137!1")
        serves.append(serve)
        try:
            if cycles:  # this start is the last crash's restart
                served_checks(serve, oracle(), [(writes[SQLITE_ACKS + i - 1], "")])
            t = writes[SQLITE_ACKS + i]
            attempted.add(str(t))
            try:
                rest_put(serve.write, t)
                raise AssertionError(f"the write under {point} was acked")
            except (OSError, http.client.HTTPException):
                pass  # the server died under the request
            rc = serve.wait()
        finally:
            serve.kill()
        pm = postmortem(path, attempted, acked)
        committed = str(t) in pm["rows"]
        if rc != 137 or pm["lost"] or pm["phantoms"] or pm["store_version"] != pm["commits"]:
            raise AssertionError(f"{point}: exit {rc}, postmortem {pm}")
        if committed != (point == "store_commit_post") or committed != (str(t) in pm["logged"]):
            raise AssertionError(f"{point}: the crashed write present {committed}, "
                                 f"logged {str(t) in pm['logged']}")
        if committed:
            acked.append(str(t))  # durable but unacked: the restart may serve it
        cycles.append({"tag": point, "exit_code": rc, "ready_s": serve.ready_s,
                       "postmortem": {k: pm[k] for k in ("lost", "phantoms", "present",
                                                         "store_version")},
                       "crashed_write_present": committed})
        say(f"  {point}=crash:137!1: exit {rc}; lost {pm['lost']}, phantoms {pm['phantoms']}, "
            f"present {pm['present']}, store version {pm['store_version']} = its commits; the "
            f"crashed write {'present, with its changelog row' if committed else 'absent'}")
    serve = Serve(repo, cfg_path, os.path.join(tmp, "final.log"))
    serves.append(serve)
    try:
        served_checks(serve, oracle(), [(writes[-1], "")] + list(zip(writes, tokens)))
        serve.proc.send_signal(signal.SIGTERM)
        if serve.wait() != 0:
            raise AssertionError(f"serve exited {serve.proc.returncode} on SIGTERM")
    finally:
        serve.kill()
    fig.update(cycles=cycles, acked_writes=SQLITE_ACKS, watch_events=len(first) + len(rest),
               seconds=time.perf_counter() - t0)
    say(f"  the last restart answered every acked write again; exit 0 on SIGTERM "
        f"({fig['seconds']:.1f} s)")
    return fig


def encode_snaptoken_of(version: int) -> str:
    from keto_tpu_torch.engine.snaptoken import encode_snaptoken

    return encode_snaptoken(version, "default")


def sqlite_ingest(path: str) -> int:
    """`python3 chip_smoke.py --sqlite-ingest PATH`: phase 4's dataset (the
    same build_dataset and seed) written into a sqlite:// file at PATH in
    transactions of SQLITE_TX; its figures as one JSON line. It imports
    the port's store and no torch."""
    from keto_tpu_torch.storage.sqlite import SQLitePersister

    tuples, _queries = build_dataset(N_FOLDERS, FILES_PER_FOLDER)
    store = SQLitePersister(path)
    t = time.perf_counter()
    for i in range(0, len(tuples), SQLITE_TX):
        store.write_relation_tuples(tuples[i:i + SQLITE_TX])
    seconds = time.perf_counter() - t
    fig = {"tuples": len(tuples), "seconds": seconds, "tuples_per_s": len(tuples) / seconds,
           "commits": store.version(), "file_bytes": file_bytes(path)}
    store.close()
    print(json.dumps(fig), flush=True)
    return 0


def start_sqlite_ingest():
    """Phase 14a's ingest in a child process, started after phase 6d so
    that its minutes of host work (one core, in the store) run beside
    phases 7-13 and not beside the serve loads; (the process, the
    file's path). `stop_children` ends it and removes its directory."""
    tmp = tempfile.mkdtemp(prefix="keto-sqlite-")
    TEMP_DIRS.append(tmp)
    path = os.path.join(tmp, "keto.sqlite")
    err = open(os.path.join(tmp, "ingest.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sqlite-ingest", path],
                            stdout=subprocess.PIPE, stderr=err, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    err.close()
    CHILDREN.append(proc)
    log(f"  phase 14a's ingest started in process {proc.pid}, beside phases 7-13")
    return proc, path


def stop_children() -> None:
    """End every child process main started that still runs, and remove
    their directories."""
    import shutil

    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for d in TEMP_DIRS:
        shutil.rmtree(d, ignore_errors=True)


def run_sqlite(smi: str, queries, ingest):
    """Phase 14: phase 4's dataset in a file-backed `sqlite://` store (the
    `ingest` child of start_sqlite_ingest), a Registry over its DSN, the
    mirror built from its columns on the card and Checks served from it
    (14a); a write into the overlay from the SQLite changelog (14b); 14c
    on a thread beside them (it waits on its servers). Returns (14a's
    launches, 14b's, the K1-K4 "sqlite" entries, the figures)."""
    import shutil
    import threading

    repo = os.path.dirname(os.path.abspath(__file__))
    fig = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        lines, failed, serves, restart = [], [], [], {}

        def leg():
            try:
                restart.update(run_sqlite_restart(tmp, repo, smi, lines.append, serves))
            except Exception:  # raised by the main thread once 14b is done
                failed.append(traceback.format_exc())

        thread = threading.Thread(target=leg, name="phase-14c")
        thread.start()
        try:
            launches, w_launches, at = run_sqlite_mirror(ingest, queries, smi, fig)
        finally:
            thread.join(timeout=600)
            for serve in serves:
                serve.kill()
        for line in lines:
            log(line)
        if thread.is_alive() or failed:
            raise AssertionError("14c failed: " + (failed[0] if failed else "it did not end"))
        fig["restart"] = restart
    shutil.rmtree(os.path.dirname(ingest[1]), ignore_errors=True)
    return launches, w_launches, at, fig


def run_sqlite_mirror(ingest, queries, smi: str, fig: dict):
    """14a and 14b over the file the `ingest` child writes, their figures
    into `fig`; (14a's launches, 14b's, the K1-K4 "sqlite" entries)."""
    import resource

    import torch

    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.ketoapi import RelationQuery, RelationTuple
    from keto_tpu_torch.registry import Registry

    t0 = phase(f"14a sqlite: {N_FOLDERS} folders x {FILES_PER_FOLDER} files in a sqlite:// "
               f"file, written in transactions of {SQLITE_TX}; a Registry over its DSN")
    proc, path = ingest
    t = time.perf_counter()
    out, _ = proc.communicate(timeout=1200)
    waited = time.perf_counter() - t
    if proc.returncode != 0:
        with open(os.path.join(os.path.dirname(path), "ingest.log")) as f:
            raise AssertionError(f"the ingest exited {proc.returncode}: {f.read()[-2000:]}")
    fig["ingest"] = {**json.loads(out.strip().splitlines()[-1]), "waited_s": waited}
    ing = fig["ingest"]
    log(f"  {ing['tuples']} tuples written in {ing['seconds']:.1f} s ({ing['tuples_per_s']:.0f} "
        f"tuples/s, {ing['commits']} commits) by the child beside phases 7-13 (waited "
        f"{waited:.1f} s for it here); the file {ing['file_bytes'] / 1e6:.1f} MB")
    config = Config({"dsn": f"sqlite://{path}", "limit": {"max_read_depth": MAX_DEPTH},
                     "namespaces": [videos_namespace().to_dict()]})
    registry = Registry(config)
    manager = registry.relation_tuple_manager()
    if manager.version() != ing["commits"]:
        raise AssertionError(f"the Registry's store is at version {manager.version()}")
    engine = registry.check_engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = engine.ensure_state()
    torch.cuda.synchronize()
    fig["mirror"] = {"seconds": time.perf_counter() - t, **engine.last_build,
                     "layout": state.snapshot.layout}
    log(f"  the mirror from the file's columns: {fig['mirror']['seconds']:.1f} s "
        f"({engine.last_build}; all_tuple_columns {engine.last_build['columns_s']:.1f} s)")

    cuda_ops.reset_launch_counts()
    before = dict(engine.stats)
    results = engine.check_batch(queries, MAX_DEPTH)  # the main path, once
    torch.cuda.synchronize()
    launches = dict(cuda_ops.launches)
    missing = [k for k in cuda_ops.CHECK_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the SQLite check path: {missing}")
    t = time.perf_counter()
    handles = []
    for _ in range(ROUNDS):
        handles.append(engine.check_batch_submit(queries, MAX_DEPTH))
        if len(handles) > 8:
            engine.check_batch_resolve(handles.pop(0))
    for h in handles:
        engine.check_batch_resolve(h)
    torch.cuda.synchronize()
    qps = ROUNDS * BATCH / (time.perf_counter() - t)
    lat = []
    for _ in range(9):
        s = time.perf_counter()
        engine.check_batch(queries, MAX_DEPTH)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - s) * 1e3)
    host = engine.stats["host_checks"] - before["host_checks"]
    if host:
        raise AssertionError(f"{host} host replays over the SQLite mirror")
    sqlite_oracle_check(manager, config, queries, results, "over the SQLite mirror", 14)
    fig["check"] = {"checks_per_s": qps, "p50_batch_ms": statistics.median(lat),
                    "batch_ms": lat, "host_replays": host, "launches": launches,
                    "allowed": sum(r.allowed for r in results)}
    log(f"  launches on the main path: {launches}")
    log(f"  throughput {qps:.1f} checks/s ({ROUNDS} batches of {BATCH}); p50 batch "
        f"{statistics.median(lat):.2f} ms (min {min(lat):.2f}, max {max(lat):.2f}); no host "
        f"replay; {SQLITE_SAMPLES} sampled equal the oracle over the file ({smi})")
    with Recorder(cuda_ops, step=1) as rec:
        engine.check_batch(queries, MAX_DEPTH)
    cases, k2_shape = kernel_cases(rec)
    at = [(case[0], "sqlite", scale_kernel_entry(
        case, "one Check batch over the SQLite mirror, step 1",
        k2_shape if case[0] == "pair_probe" else None)) for case in cases]
    del rec, cases
    fig["peaks"] = {"card_peak_bytes": torch.cuda.max_memory_allocated(),
                    "host_peak_rss_bytes":
                        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    log(f"  peaks: card {fig['peaks']['card_peak_bytes'] / 1e9:.3f} GB, host RSS "
        f"{fig['peaks']['host_peak_rss_bytes'] / 1e9:.3f} GB; 14a "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = phase(f"14b write: {WRITE_SMALL} inserts + {WRITE_SMALL} deletes through the "
               "SQLite store into the overlay")
    rng = random.Random(141)
    files = sorted({q.object for q in queries})
    deletes = []
    for f in rng.sample(files, 8 * WRITE_SMALL):  # a quarter of the files have an owner
        rows, _ = manager.get_relation_tuples(
            RelationQuery(namespace="videos", object=f, relation="owner"))
        deletes += rows[:1]
    deletes = deletes[:WRITE_SMALL]
    if len(deletes) != WRITE_SMALL:
        raise AssertionError(f"found {len(deletes)} file owners to delete")
    inserts = [RelationTuple("videos", f, "owner", subject_id=f"user{rng.randrange(N_USERS)}")
               for f in rng.sample(files, WRITE_SMALL)]
    builds = engine.stats["snapshot_builds"]
    v0 = manager.version()
    manager.transact_relation_tuples(inserts, deletes)
    t = time.perf_counter()
    state = engine.ensure_state()
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t
    ops = manager.changes_since(state.base_version)
    if not state.has_delta or engine.stats["snapshot_builds"] != builds or \
            state.covered_version != v0 + 1:
        raise AssertionError("the SQLite write did not fold into the overlay")
    cuda_ops.reset_launch_counts()
    causes = dict(engine.stats["host_cause"])
    host0 = engine.stats["host_checks"]
    t = time.perf_counter()
    after = engine.check_batch(queries, MAX_DEPTH)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t
    w_launches = dict(cuda_ops.launches)
    if w_launches["edge_probe"] == 0 or w_launches["pair_probe"] == 0:
        raise AssertionError(f"K1 and K2 not launched on the overlay: {w_launches}")
    replays = {k: v - causes.get(k, 0) for k, v in engine.stats["host_cause"].items()
               if v != causes.get(k, 0)}
    if set(replays) - {"dirty_row"}:
        raise AssertionError(f"host replays after the write other than dirty_row: {replays}")
    sqlite_oracle_check(manager, config, queries, after, "after the write", 142)
    written = [RelationTuple("videos", t.object, "view", subject_id=t.subject_id)
               for t in inserts + deletes]
    got = engine.check_batch(written, MAX_DEPTH)
    sqlite_oracle_check(manager, config, written, got, "of the written tuples", 143)
    fig["write"] = {"inserts": len(inserts), "deletes": len(deletes), "ops": len(ops),
                    "refresh_ms": t_refresh * 1e3, "batch_ms": t_batch * 1e3,
                    "dirty_row_replays": engine.stats["host_checks"] - host0,
                    "launches": w_launches}
    log(f"  {len(ops)} ops from the SQLite changelog into the overlay: refresh "
        f"{t_refresh * 1e3:.1f} ms, no rebuild; the next batch {t_batch * 1e3:.1f} ms with "
        f"has_delta, {fig['write']['dirty_row_replays']} dirty_row replays; launches "
        f"{w_launches}; {SQLITE_SAMPLES} sampled and the written tuples' views equal the "
        f"oracle ({time.perf_counter() - t0:.1f} s)")
    engine.stop_push_refresh()
    registry.watch_hub().stop()
    manager.close()
    del engine, state, registry, manager
    gc.collect()
    torch.cuda.empty_cache()
    return launches, w_launches, at


# -- phase 12: the scale tier --------------------------------------------------------


def scale_namespaces():
    from keto_tpu_torch.namespace import Namespace

    return [videos_namespace(),
            Namespace.from_dict({"name": "rbac", "relations": [{"name": "member"}]})]


def scale_build(smi):
    """12a: the data, the store behind a `dsn: columnar` Registry and the
    columnar mirror, each stage timed; the numpy rounds against the native
    builder on the direct-edge keys. Returns (engine, store, config,
    generator draws, record)."""
    import resource

    import numpy as np
    import torch

    from keto_tpu_torch.config import Config
    from keto_tpu_torch.engine import snapshot as tsnap
    from keto_tpu_torch.engine.torch_engine import TorchCheckEngine
    from keto_tpu_torch.registry import Registry
    from keto_tpu_torch.storage.columnar import ColumnarStore
    from keto_tpu_torch.storage.columns import concat_columns
    from keto_tpu_torch.tools.scale import synth_columns, synth_rbac_columns

    phase(f"12a scale data: synth_columns({SCALE_TUPLES}, n_users={SCALE_USERS}, seed=7) + "
          f"synth_rbac_columns({SCALE_ROLES}, {SCALE_USERS}) into a dsn: columnar Registry")
    rec = {"card": smi}
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cols, f_names, owners, files_per = synth_columns(SCALE_TUPLES, SCALE_USERS, seed=7)
    cols = concat_columns([cols, synth_rbac_columns(SCALE_ROLES, SCALE_USERS)])
    rec["generate_s"] = time.perf_counter() - t
    rec["tuples"] = len(cols)
    rec["column_bytes"] = cols.nbytes()
    config = Config({"dsn": "columnar", "limit": {"max_read_depth": SCALE_DEPTH}})
    config.set_namespaces(scale_namespaces())
    store = Registry(config).relation_tuple_manager()
    if not isinstance(store, ColumnarStore):
        raise AssertionError(f"dsn columnar gave a {type(store).__name__}")
    t = time.perf_counter()
    store.bulk_load(cols)
    rec["ingest_s"] = time.perf_counter() - t
    del cols
    gc.collect()
    log(f"  {rec['tuples']} tuples ({rec['column_bytes'] / 1e9:.2f} GB of columns): generate "
        f"{rec['generate_s']:.1f} s, ingest (bulk_load, native dedupe) {rec['ingest_s']:.1f} s")

    engine = TorchCheckEngine(store, config, device="cuda",
                              frontier_cap=max(1 << 14, 2 * BATCH))
    t = time.perf_counter()
    state = engine.ensure_state()
    torch.cuda.synchronize()
    rec["mirror_s"] = time.perf_counter() - t
    rec.update(engine.last_build)  # encode_s, probe_tables_s, pack_upload_s
    snap = state.snapshot
    if not isinstance(snap.obj_slots, tsnap.ArrayMap) or engine.stats["snapshot_builds"] != 1:
        raise AssertionError("the mirror did not build by the columnar builder")
    nbytes = engine.tables_nbytes()
    rec["table_bytes"] = sum(nbytes.values())
    rec["dh_probes"], rec["rh_probes"] = snap.dh_probes, snap.rh_probes
    rec["objects"], rec["subjects"] = len(snap.obj_slots), len(snap.subj_ids)
    rec["card_peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["host_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"  mirror {rec['mirror_s']:.1f} s: encode {rec['encode_s']:.1f} s, probe tables "
        f"{rec['probe_tables_s']:.1f} s, pack + upload {rec['pack_upload_s']:.1f} s; "
        f"{rec['objects']} object slots, {rec['subjects']} subjects (ArrayMaps); dh_probes "
        f"{snap.dh_probes}, rh_probes {snap.rh_probes}")
    log(f"  device tables {rec['table_bytes'] / 1e9:.3f} GB; card peak "
        f"{rec['card_peak_bytes'] / 1e9:.3f} GB; host peak RSS "
        f"{rec['host_peak_rss_bytes'] / 1e9:.2f} GB")
    # the direct-edge table once more from the store's columns, through
    # both builders: each equals the table the mirror holds
    *edges, keep = tsnap.encode_edge_columns(store.all_tuple_columns(), snap)
    if not keep.all():
        raise AssertionError(f"{int((~keep).sum())} rows missing from the base vocabulary")
    edges, ones = tuple(edges), np.ones(len(keep), dtype=np.int32)
    del keep
    t = time.perf_counter()
    got = tsnap._build_hash_table(edges, ones, snap.layout)
    rec["dh_native_s"] = time.perf_counter() - t
    t = time.perf_counter()
    want = tsnap._build_hash_table_plain(edges, ones, snap.layout)
    rec["dh_numpy_s"] = time.perf_counter() - t
    held = (snap.dh_obj, snap.dh_rel, snap.dh_skind, snap.dh_sa, snap.dh_sb, snap.dh_val)
    for name, table in (("native", got), ("numpy rounds'", want)):
        if table[-1] != snap.dh_probes or any(
                not np.array_equal(a, b) for a, b in zip(table[:-1], held)):
            raise AssertionError(f"the {name} direct-edge table differs from the mirror's")
    del got, want, edges, ones
    log(f"  direct-edge table of {len(snap.dh_val)} slots: native {rec['dh_native_s']:.2f} s, "
        f"numpy rounds {rec['dh_numpy_s']:.2f} s, both equal to the mirror's")
    draws = {"f_names": f_names, "owners": owners, "files_per": files_per}
    return engine, store, config, draws, rec


def scale_checks(draws):
    """tools/scale_bench.py:244-248's batch: half owner hits, seed 11,
    and its ground truth; then the expand roles drawn from the same
    generator (:301-303)."""
    import numpy as np

    from keto_tpu_torch.ketoapi import RelationTuple, SubjectSet

    rng = np.random.default_rng(11)
    f_names, owners = draws["f_names"], draws["owners"]
    fi = rng.integers(0, len(f_names), BATCH)
    vi = rng.integers(0, draws["files_per"], BATCH)
    hit = rng.random(BATCH) < 0.5
    subs = np.where(hit, owners[fi], np.char.add("nobody", fi.astype("U10")))
    queries = [RelationTuple("videos", f"{f_names[fi[i]]}/v{vi[i]}", "view",
                             subject_id=str(subs[i])) for i in range(BATCH)]
    roles = rng.integers(0, SCALE_ROLES, SCALE_EXPAND_BATCH)
    subjects = [SubjectSet("rbac", f"role{int(r)}", "member") for r in roles]
    return queries, [bool(h) for h in hit], subjects


def scale_kernel_entry(case, note, shape=None):
    row = time_kernel(*case)
    return {**{k: row[k] for k in LARGE_KEYS if k != "note"}, "note": note, **(shape or {})}


def check_index_limit(engine):
    """The 32-bit indices of the kernels (cuda_ops.INDEX_LIMIT) at 1e7:
    the CSR edge counts, the table rows and the list frontiers."""
    from keto_tpu_torch.engine import cuda_ops

    state = engine.ensure_state()
    sizes = {"e_obj": len(state.snapshot.e_obj), "dh slots": len(state.snapshot.dh_val)}
    if state.expand_np is not None:
        sizes["f_sa"] = len(state.expand_np["f_sa"])
    if state.reverse_np is not None:
        sizes.update(rv_pobj=len(state.reverse_np["rv_pobj"]),
                     rs_obj=len(state.reverse_np["rs_obj"]))
        S = 1 + state.reverse_np["RK"]
        sizes["ListObjects F*S"] = LO_CAPS["frontier_cap"] * S
    over = {k: v for k, v in sizes.items() if v >= cuda_ops.INDEX_LIMIT}
    if over:
        raise AssertionError(f"past the kernels' 32-bit index limit at 1e7: {over}")
    return sizes


def scale_check(engine, store, config, queries, truth):
    """12b: the check batch on the main path once, its launches, zero
    host replays, the ground truth, 32 verdicts against the oracle, the
    rate and p50; then K1-K4 on one batch's captured inputs."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine

    t0 = phase(f"12b scale check: batches of {BATCH} on the main path over 1e7 tuples")
    cuda_ops.reset_launch_counts()
    before = dict(engine.stats)
    results = engine.check_batch(queries, SCALE_DEPTH)  # the main path, once
    torch.cuda.synchronize()
    launches = dict(cuda_ops.launches)
    if engine.stats["host_checks"] != before["host_checks"]:
        raise AssertionError(f"{engine.stats['host_checks'] - before['host_checks']} host "
                             "replays on the 1e7 batch")
    missing = [k for k in cuda_ops.CHECK_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the 1e7 check path: {missing}")
    wrong = [i for i, (r, w) in enumerate(zip(results, truth)) if r.allowed != w]
    if wrong:
        raise AssertionError(f"{len(wrong)} of {BATCH} verdicts differ from the ground truth")
    t1 = time.perf_counter()
    handles = []
    for _ in range(SCALE_ROUNDS):
        handles.append(engine.check_batch_submit(queries, SCALE_DEPTH))
        if len(handles) > 8:
            engine.check_batch_resolve(handles.pop(0))
    for h in handles:
        engine.check_batch_resolve(h)
    torch.cuda.synchronize()
    qps = SCALE_ROUNDS * BATCH / (time.perf_counter() - t1)
    lat = []
    for _ in range(9):
        s = time.perf_counter()
        engine.check_batch(queries, SCALE_DEPTH)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - s) * 1e3)
    if engine.stats["host_checks"] != before["host_checks"]:
        raise AssertionError("host replays during the timed 1e7 rounds")
    oracle = ReferenceEngine(store, config)
    t = time.perf_counter()
    sample = random.Random(7).sample(range(BATCH), SCALE_SAMPLES)
    bad = [i for i in sample
           if oracle.check_relation_tuple(queries[i], SCALE_DEPTH).allowed != results[i].allowed]
    if bad:
        raise AssertionError(f"{len(bad)} of {SCALE_SAMPLES} sampled verdicts differ from the "
                             "oracle")
    t_oracle = time.perf_counter() - t
    log(f"  launches on the main path: {launches}")
    log(f"  {sum(truth)} allowed of {BATCH}, all equal to the ground truth; {SCALE_SAMPLES} "
        f"sampled equal the oracle ({t_oracle:.1f} s); zero host replays")
    log(f"  throughput {qps:.1f} checks/s ({SCALE_ROUNDS} batches of {BATCH}); p50 batch "
        f"{statistics.median(lat):.2f} ms (min {min(lat):.2f}, max {max(lat):.2f})")

    with Recorder(cuda_ops, step=1) as rec:
        engine.check_batch(queries, SCALE_DEPTH)
    cases, k2_shape = kernel_cases(rec)
    at = [(case[0], "scale_1e7", scale_kernel_entry(
        case, "one 1e7 check batch, step 1", k2_shape if case[0] == "pair_probe" else None))
        for case in cases]
    log(f"  K2 at 1e7: {k2_shape}")
    log(f"  scale check phase {time.perf_counter() - t0:.1f} s")
    return launches, at, {"checks_per_s": qps, "p50_batch_ms": statistics.median(lat),
                          "batch_ms": lat, "allowed": sum(truth), "oracle_s": t_oracle}


def scale_expand(engine, store, config, subjects):
    """12c: the RBAC expand batch on the main path once, zero host
    expands, 32 sampled trees against the oracle's, the rate and p50;
    then X1 and X2 on its captured inputs."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine.reference import ReferenceEngine

    t0 = phase(f"12c scale expand: batches of {SCALE_EXPAND_BATCH} RBAC roles at depth "
               f"{SCALE_EXPAND_DEPTH}")
    t = time.perf_counter()
    engine.ensure_expand_state()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    cuda_ops.reset_launch_counts()
    before = engine.stats["host_expands"]
    trees = engine.expand_batch(subjects, SCALE_EXPAND_DEPTH, **SCALE_EXPAND_CAPS)
    torch.cuda.synchronize()
    launches = dict(cuda_ops.launches)
    if engine.stats["host_expands"] != before:
        raise AssertionError(f"{engine.stats['host_expands'] - before} host expands at 1e7")
    missing = [k for k in ("pair_probe", "dedupe_compact", *cuda_ops.EXPAND_KERNELS)
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the 1e7 expand path: {missing}")
    lat = []
    for _ in range(SCALE_ROUNDS):
        s = time.perf_counter()
        engine.expand_batch(subjects, SCALE_EXPAND_DEPTH, **SCALE_EXPAND_CAPS)
        lat.append((time.perf_counter() - s) * 1e3)
    if engine.stats["host_expands"] != before:
        raise AssertionError("host expands during the timed 1e7 rounds")
    oracle = ReferenceEngine(store, config)
    t = time.perf_counter()
    sample = random.Random(11).sample(range(len(subjects)), SCALE_SAMPLES)
    bad = [i for i in sample if normalize(trees[i]) != normalize(
        oracle.expand(subjects[i], SCALE_EXPAND_DEPTH))]
    if bad:
        raise AssertionError(f"{len(bad)} of {SCALE_SAMPLES} sampled trees differ from the oracle")
    t_oracle = time.perf_counter() - t
    nodes = [tree_size(tr) for tr in trees]
    log(f"  full-edge CSR by the columnar builder + upload {build_s:.1f} s; tables "
        f"{sum(engine.tables_nbytes('expand').values()) / 1e9:.3f} GB")
    log(f"  launches on the main path: {launches}; {SCALE_SAMPLES} sampled trees equal the "
        f"oracle ({t_oracle:.1f} s); mean tree {sum(nodes) / len(nodes):.1f} nodes")
    log(f"  throughput {SCALE_ROUNDS * len(subjects) / (sum(lat) / 1e3):.1f} trees/s; p50 batch "
        f"{statistics.median(lat):.2f} ms")
    with Recorder(cuda_ops, step=1) as rec:
        engine.expand_batch(subjects, SCALE_EXPAND_DEPTH, **SCALE_EXPAND_CAPS)
    at = [(case[0], "scale_1e7", scale_kernel_entry(
        case, "one 1e7 expand batch, step 1 (X1), its tail (X2)"))
        for case in expand_kernel_cases(rec)]
    log(f"  scale expand phase {time.perf_counter() - t0:.1f} s")
    return launches, at, {"build_upload_s": build_s, "trees_per_s":
                          SCALE_ROUNDS * len(subjects) / (sum(lat) / 1e3),
                          "p50_batch_ms": statistics.median(lat), "batch_ms": lat,
                          "mean_tree_nodes": sum(nodes) / len(nodes), "oracle_s": t_oracle}


def scale_lists(engine, draws):
    """12d: the reverse and subjects states by the columnar builders, one
    ListObjects batch (256 owners' view) and one ListSubjects batch (256
    files' view) on the main path, zero host replays, 32 sampled answers
    of each equal to the generator's ownership maps; L1-L4 on their
    captured inputs."""
    import numpy as np
    import torch

    from keto_tpu_torch.engine import cuda_ops

    t0 = phase("12d scale lists: the columnar reverse and subjects states, one ListObjects "
               f"and one ListSubjects batch of {LIST_BATCH}")
    out = {}
    for path, ensure in (("reverse", engine.ensure_reverse_state),
                         ("subjects", engine.ensure_subjects_state)):
        t = time.perf_counter()
        ensure()
        torch.cuda.synchronize()
        out[f"{path}_build_upload_s"] = time.perf_counter() - t
        out[f"{path}_table_bytes"] = sum(engine.tables_nbytes(path).values())
        log(f"  {path} state: build + upload {out[f'{path}_build_upload_s']:.1f} s, tables "
            f"{out[f'{path}_table_bytes'] / 1e9:.3f} GB")
    f_names, owners, files_per = draws["f_names"], draws["owners"], draws["files_per"]
    rng = random.Random(12)
    users = [str(owners[rng.randrange(len(owners))]) for _ in range(LIST_BATCH)]
    folders = [rng.randrange(len(f_names)) for _ in range(LIST_BATCH)]
    lo = [("videos", "view", u) for u in users]
    ls = [("videos", f"{f_names[d]}/v{rng.randrange(files_per)}", "view") for d in folders]

    def owned(user):
        ds = f_names[owners == user]
        return sorted([str(d) for d in ds] + [f"{d}/v{k}" for d in ds for k in range(files_per)])

    legs = {}
    for leg, queries, caps, want_kernels, expected in (
            ("objects", lo, LO_CAPS, ("pair_probe", "dedupe_compact", "list_emit",
                                      "reverse_gather", "list_pool_compact"),
             lambda i: owned(users[i])),
            ("subjects", ls, LS_CAPS, ("pair_probe", "dedupe_compact", "list_emit",
                                       "subjects_gather", "list_pool_compact"),
             lambda i: [str(owners[folders[i]])])):
        batch = getattr(engine, f"list_{leg}_batch")
        host_key = f"host_list_{leg}"
        cuda_ops.reset_launch_counts()
        before = engine.stats[host_key]
        t = time.perf_counter()
        results = batch(queries, LIST_DEPTH, **caps)  # the main path, once
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t) * 1e3
        launches = dict(cuda_ops.launches)
        if engine.stats[host_key] != before:
            raise AssertionError(f"host replays on the 1e7 list_{leg} batch")
        missing = [k for k in want_kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the 1e7 list_{leg} path: {missing}")
        sample = random.Random(13).sample(range(len(queries)), SCALE_SAMPLES)
        bad = [i for i in sample if results[i] != expected(i)]
        if bad:
            raise AssertionError(f"{len(bad)} of {SCALE_SAMPLES} sampled list_{leg} answers "
                                 "differ from the ownership maps")
        sizes = [len(r) for r in results]
        legs[leg] = {"launches": launches, "batch_ms": batch_ms,
                     "mean_results": sum(sizes) / len(sizes), "max_results": max(sizes)}
        log(f"  list_{leg}: launches {launches}; batch {batch_ms:.1f} ms; mean "
            f"{legs[leg]['mean_results']:.1f} results (max {max(sizes)}); {SCALE_SAMPLES} "
            "sampled equal the ownership maps; zero host replays")
    with Recorder(cuda_ops, step=1, steps={"list_emit": 2}) as rec_lo:
        engine.list_objects_batch(lo, LIST_DEPTH, **LO_CAPS)
    with Recorder(cuda_ops, step=1) as rec_ls:
        engine.list_subjects_batch(ls, LIST_DEPTH, **LS_CAPS)
    notes = {"list_emit": "one 1e7 ListObjects batch, step 2",
             "reverse_gather": "one 1e7 ListObjects batch, step 1",
             "subjects_gather": "one 1e7 ListSubjects batch, step 1",
             "list_pool_compact": "one 1e7 ListObjects batch's tail"}
    at = [(case[0], "scale_1e7", scale_kernel_entry(case, notes[case[0]]))
          for case in list_kernel_cases(rec_lo, rec_ls)]
    at.append(("list_pool_compact", "scale_1e7_list_subjects", scale_kernel_entry(
        list_pool_case(*rec_ls.args("list_pool_compact")), "one 1e7 ListSubjects batch's tail")))
    log(f"  scale lists phase {time.perf_counter() - t0:.1f} s")
    return legs, at, out


def scale_write(engine, store, queries, truth, draws):
    """12w: SCALE_WRITE_SMALL owner grants and revocations fold into the
    overlay and the next batch holds their verdicts; SCALE_WRITE_LARGE
    new files and owners compact the mirror over its ArrayMaps."""
    import torch

    from keto_tpu_torch.engine import cuda_ops
    from keto_tpu_torch.engine import snapshot as tsnap
    from keto_tpu_torch.ketoapi import RelationTuple, SubjectSet

    t0 = phase(f"12w scale write: {SCALE_WRITE_SMALL} ops into the overlay, then "
               f"{SCALE_WRITE_LARGE} into a compacted base")
    f_names, owners = draws["f_names"], draws["owners"]
    rng = random.Random(14)
    picks = rng.sample(range(len(f_names)), SCALE_WRITE_SMALL)
    grants, revokes, probe, want = [], [], [], []
    for k, d in enumerate(picks):
        folder = str(f_names[d])
        if k % 2:
            grants.append(RelationTuple("videos", folder, "owner", subject_id=f"w{k}"))
            probe.append(RelationTuple("videos", f"{folder}/v1", "view", subject_id=f"w{k}"))
            want.append(True)
        else:
            revokes.append(RelationTuple("videos", folder, "owner", subject_id=str(owners[d])))
            probe.append(RelationTuple("videos", f"{folder}/v1", "view",
                                       subject_id=str(owners[d])))
            want.append(False)
    revoked = {q.object for q in revokes}
    base_want = [w and q.object.rsplit("/", 1)[0] not in revoked for q, w in zip(queries, truth)]
    before = dict(engine.stats)
    t = time.perf_counter()
    store.transact_relation_tuples(grants, revokes)
    t_store = time.perf_counter() - t
    t = time.perf_counter()
    state = engine.ensure_state()
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t
    if not state.has_delta or engine.stats["snapshot_builds"] != before["snapshot_builds"]:
        raise AssertionError("the 1e7 write did not fold into the overlay")
    cuda_ops.reset_launch_counts()
    t = time.perf_counter()
    results = engine.check_batch(queries + probe, SCALE_DEPTH)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t
    launches = dict(cuda_ops.launches)
    checked = queries + probe
    wrong = [(str(checked[i]), w) for i, (r, w) in enumerate(zip(results, base_want + want))
             if r.allowed != w]
    if wrong:
        raise AssertionError(f"{len(wrong)} verdicts after the 1e7 write differ from the ground "
                             f"truth: {wrong[:8]}")
    replays = engine.stats["host_checks"] - before["host_checks"]
    log(f"  {len(grants)} grants + {len(revokes)} revocations: store {t_store * 1e3:.1f} ms, "
        f"delta refresh {t_refresh * 1e3:.1f} ms; next batch ({len(results)} checks) "
        f"{t_batch * 1e3:.1f} ms, {replays} host replays, every verdict equal to the ground "
        f"truth; launches {launches}")

    merges, builds = engine.stats["incremental_merges"], engine.stats["snapshot_builds"]
    big, probe2 = [], []
    for i in range(SCALE_WRITE_LARGE // 2):
        d = rng.randrange(len(f_names))
        folder, obj = str(f_names[d]), f"{f_names[d]}/x{i}"
        big.append(RelationTuple("videos", obj, "parent",
                                 subject_set=SubjectSet("videos", folder, "...")))
        big.append(RelationTuple("videos", obj, "owner", subject_id=f"x{i}"))
        if i < 64:
            probe2.append(RelationTuple("videos", obj, "view", subject_id=f"x{i}"))
    t = time.perf_counter()
    store.write_relation_tuples(big)
    t_store2 = time.perf_counter() - t
    t = time.perf_counter()
    merged = engine.ensure_state()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t
    if engine.stats["incremental_merges"] != merges + 1 or \
            engine.stats["snapshot_builds"] != builds or merged.has_delta:
        raise AssertionError(f"the 1e7 write did not compact: {engine.stats}")
    if not isinstance(merged.snapshot.obj_slots, tsnap.ArrayMap):
        raise AssertionError("the compacted vocabulary is no ArrayMap")
    before = dict(engine.stats)
    t = time.perf_counter()
    results = engine.check_batch(queries + probe2, SCALE_DEPTH)
    torch.cuda.synchronize()
    t_after = time.perf_counter() - t
    if engine.stats["host_checks"] != before["host_checks"]:
        raise AssertionError("host replays on the compacted 1e7 base")
    wrong = [i for i, (r, w) in enumerate(zip(results, base_want + [True] * len(probe2)))
             if r.allowed != w]
    if wrong:
        raise AssertionError(f"{len(wrong)} verdicts after the 1e7 compaction differ")
    snap = merged.snapshot
    log(f"  {len(big)} ops: store {t_store2:.2f} s (the write buffer folds into the columns), "
        f"compaction {t_compact:.2f} s (no rebuild; incremental_merges "
        f"{engine.stats['incremental_merges']}); next batch {t_after * 1e3:.1f} ms, zero host "
        f"replays, every verdict equal to the ground truth; dh_probes {snap.dh_probes}, "
        f"merge_garbage {snap.merge_garbage}")
    log(f"  scale write phase {time.perf_counter() - t0:.1f} s")
    return launches, {"small_ops": len(grants) + len(revokes), "store_ms": t_store * 1e3,
                      "delta_refresh_ms": t_refresh * 1e3, "next_batch_ms": t_batch * 1e3,
                      "host_replays": replays, "large_ops": len(big), "store_large_s": t_store2,
                      "compaction_s": t_compact, "next_batch_after_compaction_ms": t_after * 1e3}


def run_scale(smi):
    """Phase 12 on its own engine and store: returns (launches by path,
    (kernel row, "at" key, entry) triples, the record)."""
    import resource

    import torch

    engine, store, config, draws, rec = scale_build(smi)
    queries, truth, subjects = scale_checks(draws)
    c_launches, at, rec["check"] = scale_check(engine, store, config, queries, truth)
    x_launches, x_at, rec["expand"] = scale_expand(engine, store, config, subjects)
    legs, l_at, rec["lists"] = scale_lists(engine, draws)
    at += x_at + l_at
    rec["index_sizes"] = check_index_limit(engine)
    log(f"  32-bit indices at 1e7: {rec['index_sizes']} (limit 2^31)")
    w_launches, rec["write"] = scale_write(engine, store, queries, truth, draws)
    rec["card_peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["host_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"  phase 12 peaks: card {rec['card_peak_bytes'] / 1e9:.3f} GB, host RSS "
        f"{rec['host_peak_rss_bytes'] / 1e9:.2f} GB")
    by_path = {"scale_check": c_launches, "scale_expand": x_launches,
               "scale_list_objects": legs["objects"]["launches"],
               "scale_list_subjects": legs["subjects"]["launches"], "scale_write": w_launches}
    engine.stop_push_refresh()
    return by_path, at, rec



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
    import google.protobuf
    import grpc

    log(f"  grpc {grpc.__version__}, protobuf {google.protobuf.__version__}")
    try:
        import yaml

        log(f"  PyYAML {yaml.__version__}: phase 13's Keto config is YAML")
    except ModuleNotFoundError:
        log("  no PyYAML: phase 13's Keto config is JSON")

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
    del tuples

    rows = run_kernels(engine, queries)
    launches, check = run_check(engine, queries, manager, config)
    profile = run_profile(engine, queries)
    owners = ownership(manager.all_relation_tuples())
    run_islands()
    run_serve()
    s_launches, serve_load, g_launches, grpc_load, aio_load = run_serve_load(manager, owners,
                                                                             smi)
    ingest = start_sqlite_ingest()
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
    expand["after_write"] = run_expand_write(x_engine, x_manager, x_config, subjects)
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
    c_launches, closure, d_expected = run_closure(d_engine, d_manager, d_config, d_queries)
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
    # the write phases run last, so that every phase above measures the
    # stores as loaded: 4w, 8w and 10w on phase 4's engine (4w's large
    # write compacts it first), 9w on phase 9's
    w_launches, write_at, write = run_write(engine, manager, config, queries, t_mirror)
    next(row for row in rows if row["name"] == "edge_probe")["at"] = {
        "write": write_at["edge_probe"]}
    next(row for row in rows if row["name"] == "pair_probe")["at"].update(
        write=write_at["pair_probe"], write_dirty=write_at["pair_probe_dirty"])
    # the writes moved ownership: 8w holds its answers to the store's maps
    owners = ownership(manager.all_relation_tuples())
    list_write = run_list_write(engine, manager, config, lo_queries, ls_queries, owners)
    filt["after_write"] = run_filter_write(engine, manager, config, v_subject)
    closure["after_write"], cw_launches, cr_launches, c1_dirty = run_closure_write(
        d_engine, d_manager, d_queries, d_expected)
    phase("9w kernels: C1 at the dirty batch, against its plain version")
    next(row for row in rows if row["name"] == "closure_probe")["at"]["dirty_batch"] = \
        time_closure_probe(*c1_dirty, "the first batch after a write, has_dirty")
    del c1_dirty
    m_launches, m_rows, tools = run_microbench()
    rows += m_rows
    # phase 13 on the card after phase 11, before phase 12's release
    o_launches, ow_launches, o_at, opl = run_opl_watch(smi)
    for name, key, entry in o_at:
        next(row for row in rows if row["name"] == name).setdefault("at", {})[key] = entry
    # phase 14 after phase 13, before phase 12
    q_launches, qw_launches, q_at, sqlite_fig = run_sqlite(smi, queries, ingest)
    for name, key, entry in q_at:
        next(row for row in rows if row["name"] == name).setdefault("at", {})[key] = entry
    gc.collect()
    # phase 12 loads its own 1e7-tuple store: release phases 4-11's
    # engines, stores and captured tensors first
    for e in (engine, x_engine, d_engine):
        e.stop_push_refresh()
    n_tuples = snap.n_tuples
    del engine, manager, state, snap, rstate, x_engine, x_manager, d_engine, d_manager
    del rec_c, rec_f, rec_fc, f1_case, searchsorted, case, args2, kw2, owners, d_owners
    gc.unfreeze()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== released phases 4-11: {torch.cuda.memory_allocated() / 1e9:.3f} GB still "
        "allocated on the card")
    sc_by_path, sc_at, scale = run_scale(smi)
    for name, key, entry in sc_at:
        next(row for row in rows if row["name"] == name).setdefault("at", {})[key] = entry
    by_path = {"check": launches, "check_write": w_launches, "serve": s_launches,
               **g_launches, "expand": x_launches,
               "list_objects": lo_launches,
               "list_subjects": ls_launches, "closure_build": b_launches, "closure": c_launches,
               "closure_write": cw_launches, "closure_refresh": cr_launches,
               "filter": f_launches, "microbench": m_launches, "opl": o_launches,
               "opl_watch": ow_launches, "sqlite": q_launches, "sqlite_write": qw_launches,
               **sc_by_path}
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

    log(json.dumps({"check": {**check, "card": smi, "tuples": n_tuples,
                              "device_table_bytes": sum(nbytes.values()),
                              "profile": profile}}))
    log(json.dumps({"write": {**write, "card": smi}}))
    log(json.dumps({"serve_load": serve_load}))
    log(json.dumps({"grpc_load": grpc_load}))
    log(json.dumps({"grpc_aio": aio_load}))
    log(json.dumps({"expand": {**expand, "card": smi}}))
    log(json.dumps({"list": {**l_info, "card": smi, "list_objects": list_objects,
                             "list_subjects": list_subjects, "after_write": list_write,
                             "caps": {"list_objects": LO_CAPS, "list_subjects": LS_CAPS}}}))
    log(json.dumps({"closure": {**d_info, **closure, "powering": powering, "card": smi}}))
    log(json.dumps({"filter": {**filt, "card": smi}}))
    log(json.dumps({"microbench": {**tools, "card": smi}}))
    log(json.dumps({"scale": scale}))
    log(json.dumps({"opl_watch": opl}))
    log(json.dumps({"sqlite": sqlite_fig}))
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
    if len(sys.argv) == 3 and sys.argv[1] == "--load-clients":
        sys.exit(load_clients(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--grpc-clients":
        sys.exit(grpc_clients(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--sqlite-ingest":
        sys.exit(sqlite_ingest(sys.argv[2]))
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    finally:
        stop_children()
    sys.exit(code)

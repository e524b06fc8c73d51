// The four hot phases of keto_tpu_torch's batched BFS check, for Hopper
// (sm_90a), with a plain C interface bound by ctypes
// (keto_tpu_torch/engine/cuda_ops.py). Every kernel launches on the
// caller's stream, allocates nothing, and computes exactly what its plain
// PyTorch version in keto_tpu_torch/engine/kernel.py computes; each entry
// point returns cudaGetLastError().
//
// K1 keto_edge_probe     replaces keto_tpu/engine/kernel.py
//                        _bucket_rows + _edge_key_probe as probe_phase
//                        uses them (dh, and dd when has_delta): three
//                        dependent trips, every row load in flight at once.
// K2 keto_pair_probe     replaces _multi_pair_key_probe / _pair_key_probe
//                        (every span, dirty-row and reverse probe): equal
//                        keys of a warp share one probe.
// K3 keto_expand_gather  replaces expand_phase's counts -> exclusive scan
//                        -> covering-segment map -> source gather ->
//                        e_pack child gather: tile sums, then a scan of
//                        each tile from its base, then the gather.
// K4 keto_dedupe_compact replaces dedupe_phase: claim, keep and count,
//                        then scan and scatter.
//
// K3's and K4's scans are multi-block (scan.cuh): a launch over the slots
// or the candidates never runs on one block; only the at most kMaxTiles
// tile sums are summed by each block on its own.

#include "probe.cuh"
#include "scan.cuh"

namespace {

constexpr int kCauseFrontierOverflow = 2;
constexpr int kProbeThreads = 256;
// K3's counts and K4's candidates a tile (scan_tile doubles it past
// kMaxTiles tiles): one round of 4 a thread. Timed against 2,048 and
// 4,096 (PERF.md §6): fewer items a block win at every shape.
constexpr int kScanTile = 1024;
// K3: output slots a gather block
constexpr int kGatherThreads = 256;
// K4's keep pass: candidates a thread loads before it waits on any
constexpr int kKeepUnroll = 4;

// ---------------------------------------------------------------------------
// K1 edge_probe
//
// Bound: bytes. Each live task reads ceil(probes/spb) bucket rows of the
// [cap, 8] int32 edge table (256 B each under the bucketized layout) at
// random addresses; the arithmetic is a few hashes. At Check's shape (F =
// 8,192) that is ~2.4 MB, so the time is a chain of dependent round
// trips, not bytes. Design: 16 threads per task, each loading one 16-byte
// half-slot per round, so one round is one fully coalesced 256 B bucket
// row (eight 32 B sectors); the two halves of a slot are matched by a pair
// shuffle, and found/value reduce over the group. Three dependent trips:
// (1) the task's live, depth, q, obj and rel, all read before any branch;
// (2) qsub[q]; (3) every bucket-row load of the main table (up to
// kMaxEdgeRounds rounds, 64 probes under either layout) and of the
// overlay's first round, all issued before any compare or shuffle. Deeper probe
// sequences take further groups of rounds after them. Every slot of every
// probed row is compared, and the value is the max of lane 5 over the
// matches, as the plain version's. The overlay probe, the value == 1
// liveness test, the overlay override and the live / depth >= 1 gate are
// fused, so the hit mask is the only output. This replaced a body that
// read live and depth, then q, qsub, then the rows one round at a time
// (each round's shuffles before the next round's loads), then the
// overlay's rows after the main table's. (The chunk and match helpers
// are probe.cuh's, shared with C1.)
// ---------------------------------------------------------------------------

// the most rounds of K1's main-table loads in flight together: 8 rounds
// of 16 lanes cover 64 probes under either layout (8 bucketized rows of 8
// slots, or 64 compact rows of one 32 B slot). A launch holds only the
// rounds its probe depth needs (1, 2, 4 or 8: kEdgeRounds below), so a
// shallow table costs no registers, and a task's 16 threads stay few
// enough for Check's frontier to be resident at once.
constexpr int kMaxEdgeRounds = 8;

template <int kEdgeRounds>
__global__ void __launch_bounds__(kProbeThreads) edge_probe_staged_kernel(
    const int4* __restrict__ dh, uint32_t dh_nb, const int4* __restrict__ dd,
    uint32_t dd_nb, int spb, int dh_pb, int dd_pb, int has_delta,
    const int* __restrict__ obj, const int* __restrict__ rel,
    const int* __restrict__ q, const int4* __restrict__ qsub,
    const int* __restrict__ depth, const uint8_t* __restrict__ live,
    uint8_t* __restrict__ hit, int F) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int task = (int)(gtid / kGroup);
  const int lane = threadIdx.x % kGroup;
  if (task >= F) return;  // the whole group leaves together
  // trip 1: every column of the task, before any branch
  const bool lv = __ldg(live + task) != 0;
  const int d = __ldg(depth + task), qi = __ldg(q + task);
  const int o = __ldg(obj + task), r = __ldg(rel + task);
  if (!lv || d < 1) {
    if (lane == 0) hit[task] = 0;
    return;
  }
  // trip 2: the query's subject
  const int4 s = __ldg(qsub + qi);
  const int key[5] = {o, r, s.x, s.y, s.z};
  const uint32_t h1 = key_hash(key, 5);
  const uint32_t h2 = stride_hash(h1);
  const unsigned gmask = group_mask();
  const int per_row = 2 * spb;  // int4 chunks per bucket row (8 ints a slot)
  const int tm = dh_pb * per_row;
  const int td = has_delta ? dd_pb * per_row : 0;
  // trip 3: the main table's rounds and the overlay's first round, all in
  // flight before any is used
  int4 xm[kEdgeRounds];
#pragma unroll
  for (int u = 0; u < kEdgeRounds; ++u) {
    xm[u] = edge_chunk(dh, dh_nb, per_row, tm, u * kGroup + lane, h1, h2);
  }
  const int4 xd = edge_chunk(dd, dd_nb, per_row, td, lane, h1, h2);
  bool fm = false, fd = false;
  int vm = kEmpty, vd = kEmpty;
#pragma unroll
  for (int u = 0; u < kEdgeRounds; ++u) {
    edge_match(xm[u], u * kGroup + lane, tm, key, lane, gmask, fm, vm);
  }
  if (td > 0) edge_match(xd, lane, td, key, lane, gmask, fd, vd);
  // sequences past kMaxEdgeRounds rounds (main) or one (overlay): further
  // groups, each issued whole before it is used
  for (int base = kEdgeRounds * kGroup; base < tm; base += kEdgeRounds * kGroup) {
#pragma unroll
    for (int u = 0; u < kEdgeRounds; ++u) {
      xm[u] = edge_chunk(dh, dh_nb, per_row, tm, base + u * kGroup + lane, h1, h2);
    }
#pragma unroll
    for (int u = 0; u < kEdgeRounds; ++u) {
      edge_match(xm[u], base + u * kGroup + lane, tm, key, lane, gmask, fm, vm);
    }
  }
  for (int c0 = kGroup; c0 < td; c0 += kGroup) {
    edge_match(edge_chunk(dd, dd_nb, per_row, td, c0 + lane, h1, h2), c0 + lane, td, key,
               lane, gmask, fd, vd);
  }
  for (int off = kGroup / 2; off >= 1; off >>= 1) {
    fm = (__shfl_xor_sync(gmask, (int)fm, off) != 0) || fm;
    vm = max(vm, __shfl_xor_sync(gmask, vm, off));
    fd = (__shfl_xor_sync(gmask, (int)fd, off) != 0) || fd;
    vd = max(vd, __shfl_xor_sync(gmask, vd, off));
  }
  const bool out = fd ? vd == 1 : (fm && vm == 1);
  if (lane == 0) hit[task] = out;
}

// ---------------------------------------------------------------------------
// K2 pair_probe
//
// Bound: bytes. The function returns a value for every (task, slot) of
// the [F, S] relation matrix, dead tasks and slots without an instruction
// included, and equal keys give equal answers, so the least work reads
// each distinct (obj, rel) key's ceil(probes/spb) bucket rows of the
// [cap, 4] int32 table once (256 B under the bucketized layout, 16 B a
// row under the compact one), the [F] objects and [F, S] relations, and
// writes the [F, S, n_vals] values. On ListObjects' step launches (2^20
// tasks, a live head of 10-40% and the zero-filled tail K4 leaves) most
// keys are one key, (0, 0); on the other paths' launches (4,096-49,152
// items) the time is a launch and a few dependent trips.
// Design: a warp takes W consecutive (task, slot) items (W = 32 where
// that leaves kMinWarps warps or more, else halved down to 2, so a small
// launch still spreads over the SMs) and reads their objects and
// relations in one trip. __match_any_sync on the 64-bit key makes the
// lowest lane of each set of equal keys its leader (lanes past W repeat
// an item, so they never lead); the leaders write their keys and hashes
// to shared memory in rank order. The warp's two halves then probe two
// leaders at a time, 16 lanes a bucket row (one coalesced 256-byte row a
// round), kPairLoads rounds a lane issued before any compare. A round's
// matches are one ballot, and every lane whose leader owns a matching
// slot takes its values by shuffle from the matching lane (each lane the
// max over the matches, as the plain version), so a repeated key costs
// neither a probe nor a reduction of its own. Every slot of every probed
// row is compared. One store a (task, slot): an int2 when n_vals = 2.
// At W = 2 (pair_probe_two_kernel) no election is needed: the two halves
// compare their keys by one shuffle, and the second probes only when its
// key differs. This replaced 16 lanes for every (task, slot) whatever its
// key, each group reducing both values over its lanes, and two 4-byte
// stores a slot.
// ---------------------------------------------------------------------------

constexpr int kPairThreads = 256;
// bucket-row loads a lane keeps in flight: kPairLoads / kRounds leader
// pairs of kRounds rounds each (4 timed against 8 and 16: 48 registers
// against 80, so more warps resident on ListObjects' launch)
constexpr int kPairLoads = 4;
// the fewest warps a launch gets before a warp's items are halved (about
// 16 a Hopper SM)
constexpr int kMinWarps = 2048;

// W = 2 (a launch of under 4 kMinWarps items): a half-warp an item, with
// no leader election; the second half probes only when its key differs
// from the first's, and otherwise takes the first half's matches.
template <int kRounds>
__global__ void __launch_bounds__(kPairThreads) pair_probe_two_kernel(
    const int4* __restrict__ pack, uint32_t nb, int spb_log2, int total,
    const int* __restrict__ obj, const int* __restrict__ rels, int n, int S, int n_vals,
    int* __restrict__ out) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int base = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) << 1;
  if (base >= n) return;  // the whole warp leaves together
  const int half = lane >> 4;
  const int l16 = lane & (kGroup - 1);
  const int item = min(base + half, n - 1);  // past the last item, repeat it
  const int o = __ldg(obj + (S == 1 ? item : item / S));
  const int r = __ldg(rels + item);
  const uint32_t h1 = mix32(mix32(kGolden ^ (uint32_t)o) ^ (uint32_t)r);
  const uint32_t h2 = stride_hash(h1);
  const bool same = __shfl_xor_sync(kAll, o, 16) == o && __shfl_xor_sync(kAll, r, 16) == r;
  const bool probe = half == 0 || !same;
  const int from = same ? 0 : 16 * half;  // the half whose matches are this item's
  const int spb_mask = (1 << spb_log2) - 1;
  int a0 = kEmpty, a1 = kEmpty;
  for (int r0 = 0; r0 * kGroup < total; r0 += kRounds) {
    int4 x[kRounds];
#pragma unroll
    for (int rr = 0; rr < kRounds; ++rr) {
      const int c = (r0 + rr) * kGroup + l16;
      x[rr] = make_int4(0, 0, 0, 0);
      if (probe && c < total) {
        const uint32_t b = (h1 + (uint32_t)(c >> spb_log2) * h2) & (nb - 1u);
        x[rr] = __ldg(pack + ((size_t)b << spb_log2) + (c & spb_mask));
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRounds; ++rr) {
      const int c = (r0 + rr) * kGroup + l16;
      const int4 v = x[rr];
      unsigned hits = __ballot_sync(kAll, probe && c < total && v.x == o && v.y == r);
      while (hits) {
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
        const int v0 = __shfl_sync(kAll, v.z, src);
        const int v1 = n_vals == 2 ? __shfl_sync(kAll, v.w, src) : kEmpty;
        if ((src & 16) == from) {
          a0 = max(a0, v0);
          a1 = max(a1, v1);
        }
      }
    }
  }
  if (l16 == 0 && base + half < n) {
    if (n_vals == 2) {
      reinterpret_cast<int2*>(out)[base + half] = make_int2(a0, a1);
    } else {
      out[base + half] = a0;
    }
  }
}

template <int kRounds>
__global__ void __launch_bounds__(kPairThreads) pair_probe_shared_kernel(
    const int4* __restrict__ pack, uint32_t nb, int spb_log2, int total,
    const int* __restrict__ obj, const int* __restrict__ rels, int n, int S, int w_log2,
    int n_vals, int* __restrict__ out) {
  constexpr int kPairs = kPairLoads / kRounds;
  constexpr unsigned kAll = 0xFFFFFFFFu;
  __shared__ int4 s_key[kPairThreads];
  const int lane = threadIdx.x & 31;
  const int base = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) << w_log2;
  if (base >= n) return;  // the whole warp leaves together
  const int w = 1 << w_log2;
  // lanes past W, and past the last item, repeat an item of the warp
  const int item = min(base + (lane & (w - 1)), n - 1);
  const int o = __ldg(obj + (S == 1 ? item : item / S));
  const int r = __ldg(rels + item);
  const unsigned long long key = ((unsigned long long)(uint32_t)o << 32) | (uint32_t)r;
  const uint32_t h1 = mix32(mix32(kGolden ^ (uint32_t)o) ^ (uint32_t)r);
  const unsigned peers = __match_any_sync(kAll, key);
  const int leader = __ffs(peers) - 1;
  const unsigned leaders = __ballot_sync(kAll, leader == lane);
  const int n_lead = __popc(leaders);
  const int my_rank = __popc(leaders & ((1u << leader) - 1u));  // my leader's rank
  int4* keys = s_key + (threadIdx.x - lane);
  if (leader == lane) keys[my_rank] = make_int4(o, r, (int)h1, (int)stride_hash(h1));
  __syncwarp();
  const int half = lane >> 4;
  const int l16 = lane & (kGroup - 1);
  const int rounds = (total + kGroup - 1) / kGroup;  // of 16 slots a key
  const int n_pairs = (n_lead + 1) >> 1;
  const int spb_mask = (1 << spb_log2) - 1;
  int a0 = kEmpty, a1 = kEmpty;
  for (int p0 = 0; p0 < n_pairs; p0 += kPairs) {
    // one pass over the rounds unless a key's sequence is longer than
    // kRounds rounds (past 64 probes)
    for (int r0 = 0; r0 < rounds; r0 += kRounds) {
      int ko[kPairs], kr[kPairs];
      int4 x[kPairs][kRounds];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        // the pairs past the warp's leaders cost no instruction (a small
        // launch has many warps of one or two leaders)
        if (p0 + i >= n_pairs) break;  // the same for the whole warp
        const int k = 2 * (p0 + i) + half;
        const int4 kv = keys[min(k, 31)];
        ko[i] = kv.x;
        kr[i] = kv.y;
#pragma unroll
        for (int rr = 0; rr < kRounds; ++rr) {
          const int c = (r0 + rr) * kGroup + l16;
          x[i][rr] = make_int4(0, 0, 0, 0);
          if (k < n_lead && c < total) {
            const uint32_t b = ((uint32_t)kv.z + (uint32_t)(c >> spb_log2) * (uint32_t)kv.w) &
                               (nb - 1u);
            x[i][rr] = __ldg(pack + ((size_t)b << spb_log2) + (c & spb_mask));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (p0 + i >= n_pairs) break;  // the same for the whole warp
        const int k = 2 * (p0 + i) + half;
#pragma unroll
        for (int rr = 0; rr < kRounds; ++rr) {
          const int c = (r0 + rr) * kGroup + l16;
          const int4 v = x[i][rr];
          unsigned hits = __ballot_sync(kAll, k < n_lead && c < total && v.x == ko[i] &&
                                                  v.y == kr[i]);
          while (hits) {
            const int src = __ffs(hits) - 1;
            hits &= hits - 1;
            const int v0 = __shfl_sync(kAll, v.z, src);
            const int v1 = n_vals == 2 ? __shfl_sync(kAll, v.w, src) : kEmpty;
            if (my_rank == 2 * (p0 + i) + (src >> 4)) {
              a0 = max(a0, v0);
              a1 = max(a1, v1);
            }
          }
        }
      }
    }
  }
  if (lane < w && base + lane < n) {
    if (n_vals == 2) {
      reinterpret_cast<int2*>(out)[base + lane] = make_int2(a0, a1);
    } else {
      out[base + lane] = a0;
    }
  }
}

// ---------------------------------------------------------------------------
// K3 expand_gather
//
// Bound: bytes: the F*S counts read once; per candidate that lands, its
// segment's starts, slot_ctx, crel and is_comp, its task's q, obj and
// depth, and an e_pack pair; six [F] columns and the causes written. A
// few hundred KB at Check's shape, so the launches' latency, not the
// card's memory rate, sets the time. Design: three launches, none of
// them one block over the slots. (1) Each block sums a tile of the flat
// counts with 16-byte loads (and the grid zeroes the causes). (2) Each
// block sums the tile sums before its own (scan.cuh), scans its tile in
// slot order from there, writes the exclusive offsets and raises the
// frontier-overflow cause of every segment the cap cuts off (c > 0 and
// off + c > F); block 0 writes the total. (3) One thread per output slot
// j < F binary-searches the offsets, now in L2, for its segment,
// searchsorted(offsets, j, right) - 1 clamped to [0, F*S - 1], and
// gathers the source columns and the (obj, rel) edge pair. A slot at or
// past the total maps to the last segment, F*S - 1, and carries its
// columns with valid 0, as the plain version does. (A block-local map,
// each block finding its first segment by a 256-way search and searching
// the offsets after it in shared memory, timed slower at Check's shape:
// PERF.md §6.) This replaced one block that scanned the counts in
// thread-contiguous, uncoalesced chunks. Candidates land in the same
// order as the JAX kernel's.
// ---------------------------------------------------------------------------

// zeroes overflow too: the offsets pass, one launch later, raises it
__global__ void expand_tile_sums_kernel(const int* __restrict__ counts, int n, int tile,
                                        int* __restrict__ tile_sums, int* __restrict__ overflow,
                                        int n_queries) {
  __shared__ unsigned warp_sums[64];
  zero_grid(overflow, n_queries);
  const int lo = blockIdx.x * tile;
  const int hi = min(n, lo + tile);
  unsigned s = 0;
  for (int i0 = lo + 4 * (int)threadIdx.x; i0 < hi; i0 += 4 * (int)blockDim.x) {
    const int4 c = load4(counts, i0, hi);
    s += (unsigned)c.x + (unsigned)c.y + (unsigned)c.z + (unsigned)c.w;
  }
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = (int)s;
}

// offsets is 16-byte aligned (the wrapper allocates it), and so is every
// i0 below, tiles being whole rounds of 4 slots a thread
__global__ void expand_offsets_kernel(
    const int* __restrict__ counts, int n, int tile, const int* __restrict__ tile_sums,
    int n_tiles, int F, int S, const int* __restrict__ q, int* __restrict__ offsets,
    int* __restrict__ total, int* __restrict__ overflow) {
  __shared__ unsigned warp_sums[64];
  unsigned all;
  unsigned base = tile_base(tile_sums, n_tiles, warp_sums, &all);
  const int lo = blockIdx.x * tile;
  const int hi = min(n, lo + tile);
  for (int r = lo; r < hi; r += 4 * (int)blockDim.x) {
    const int i0 = r + 4 * (int)threadIdx.x;
    const int4 c4 = load4(counts, i0, hi);
    const int c[4] = {c4.x, c4.y, c4.z, c4.w};
    unsigned round_total;
    unsigned off = base + block_exclusive_scan(
        (unsigned)c[0] + (unsigned)c[1] + (unsigned)c[2] + (unsigned)c[3], warp_sums,
        &round_total);
    int o[4];
    for (int e = 0; e < 4; ++e) {
      o[e] = (int)off;
      if (i0 + e < hi && c[e] > 0 && (int)(off + (unsigned)c[e]) > F) {
        raise_cause(overflow, q[(i0 + e) / S], kCauseFrontierOverflow);
      }
      off += (unsigned)c[e];
    }
    if (i0 + 3 < hi) {
      *reinterpret_cast<int4*>(offsets + i0) = make_int4(o[0], o[1], o[2], o[3]);
    } else {
      for (int e = 0; e < 4 && i0 + e < hi; ++e) offsets[i0 + e] = o[e];
    }
    base += round_total;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *total = (int)all;
}

__global__ void expand_gather_kernel(
    const int* __restrict__ offsets, int n, const int* __restrict__ total, int F, int S,
    const int* __restrict__ starts, const int* __restrict__ slot_ctx,
    const int* __restrict__ crel, const int* __restrict__ is_comp,
    const int* __restrict__ q, const int* __restrict__ obj,
    const int* __restrict__ depth, const int2* __restrict__ e_pack, int n_edges,
    int wildcard_rel, int* __restrict__ out_q, int* __restrict__ out_ctx,
    int* __restrict__ out_obj, int* __restrict__ out_rel, int* __restrict__ out_depth,
    uint8_t* __restrict__ out_valid) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= F) return;
  const int tot = *total;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= j) lo = mid + 1; else hi = mid;
  }
  const int seg = min(max(lo - 1, 0), n - 1);
  const int ti = seg / S;
  const bool slot0 = (seg % S) == 0;
  const bool comp = is_comp[seg] != 0;
  const bool in_range = j < min(tot, F);
  const int within = j - offsets[seg];
  int e = starts[seg] + within;
  e = min(max(e, 0), max(n_edges - 1, 0));
  int eo = 0, er = 0;
  if (n_edges > 0) {
    const int2 p = e_pack[e];
    eo = p.x;
    er = p.y;
  }
  out_q[j] = q[ti];
  out_ctx[j] = slot_ctx[seg];
  out_obj[j] = comp ? obj[ti] : eo;
  out_rel[j] = slot0 ? er : crel[seg];
  out_depth[j] = comp ? depth[ti] : depth[ti] - 1;
  out_valid[j] = in_range && !(slot0 && er == wildcard_rel);
}

// ---------------------------------------------------------------------------
// K4 dedupe_compact
//
// Bound: bytes: G candidates of 21 B (five int columns and valid) read
// once, F frontier rows of 20 B and the causes written; besides, one L2
// atomicMax a valid candidate into a winner table of 2G buckets (8 MB at
// G = 2^20, held in the 50 MB L2) and a random read of its bucket's
// winner and, when it lost, of the winner's key. Design: four grid-wide
// passes in the shape of M6 (microbench_kernels.cu pack_count_kernel /
// pack_scatter_kernel). (1) A memset of the winner table. (2) Claim: one
// thread a candidate races for its bucket with atomicMax on (depth <<
// idx_bits) | index; the max is order-free, so the winner is
// deterministic. (3) Keep and count: each block takes a tile of
// candidates, kKeepUnroll a thread a round (coalesced), computes keep
// once (valid, and it won its bucket or lost to a different key), writes
// it to a [G] byte scratch and the tile's count to tile_counts; the grid
// zeroes the causes. (4) Scan and scatter: each block sums the counts of
// the tiles before its own (scan.cuh), scans its tile's keep bytes in
// candidate order (4 a thread a round, one 4-byte load), writes the five
// columns of a survivor below F and raises the overflow cause of one at
// or past F, and zeroes its grid-stride share of [min(n_keep, F), F),
// where the JAX scatter leaves zeros; block 0 writes n_new. This
// replaced one block of 1,024 threads that walked thread-contiguous
// chunks (uncoalesced), re-hashing each candidate twice, while 131 SMs
// idled.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t hash3(int a, int b, int c) {
  return mix32(mix32(mix32(kGolden ^ (uint32_t)a) ^ (uint32_t)b) ^ (uint32_t)c);
}

__global__ void dedupe_claim_kernel(
    const int* __restrict__ ctx, const int* __restrict__ obj, const int* __restrict__ rel,
    const int* __restrict__ depth, const uint8_t* __restrict__ valid, int G,
    uint32_t cap, int idx_bits, unsigned* __restrict__ winner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G || !valid[i]) return;
  const uint32_t b = hash3(ctx[i], obj[i], rel[i]) & (cap - 1u);
  const uint32_t dmax = (1u << (32 - idx_bits)) - 1u;
  const int d = depth[i];
  const uint32_t dc = d < 0 ? 0u : min((uint32_t)d, dmax);
  atomicMax(&winner[b], (dc << idx_bits) | (uint32_t)i);
}

// zeroes overflow too: the scatter pass, one launch later, raises it
__global__ void dedupe_keep_kernel(
    const int* __restrict__ ctx, const int* __restrict__ obj, const int* __restrict__ rel,
    const uint8_t* __restrict__ valid, int G, int tile, uint32_t cap, int idx_bits,
    const unsigned* __restrict__ winner, uint8_t* __restrict__ keep,
    int* __restrict__ tile_counts, int* __restrict__ overflow, int n_queries) {
  __shared__ unsigned warp_sums[64];
  zero_grid(overflow, n_queries);
  const uint32_t idx_mask = (1u << idx_bits) - 1u;
  const int lo = blockIdx.x * tile;
  const int hi = min(G, lo + tile);
  unsigned kept = 0;
  // kKeepUnroll candidates a thread a round, each level of loads issued
  // for all of them before any is used: three waits a round, not three
  // a candidate
  for (int r = lo; r < hi; r += kKeepUnroll * (int)blockDim.x) {
    int c[kKeepUnroll], o[kKeepUnroll], rl[kKeepUnroll], w[kKeepUnroll];
    bool v[kKeepUnroll];
#pragma unroll
    for (int u = 0; u < kKeepUnroll; ++u) {
      const int i = r + u * (int)blockDim.x + (int)threadIdx.x;
      v[u] = i < hi && valid[i];
      c[u] = v[u] ? ctx[i] : 0;
      o[u] = v[u] ? obj[i] : 0;
      rl[u] = v[u] ? rel[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kKeepUnroll; ++u) {
      w[u] = v[u] ? (int)(winner[hash3(c[u], o[u], rl[u]) & (cap - 1u)] & idx_mask) : 0;
    }
#pragma unroll
    for (int u = 0; u < kKeepUnroll; ++u) {
      const int i = r + u * (int)blockDim.x + (int)threadIdx.x;
      const bool k = v[u] && (w[u] == i || !(ctx[w[u]] == c[u] && obj[w[u]] == o[u] &&
                                              rel[w[u]] == rl[u]));
      if (i < hi) keep[i] = k;
      kept += k;
    }
  }
  kept = block_sum(kept, warp_sums);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = (int)kept;
}

// keep is 4-byte aligned (the wrapper allocates it), and so is every i0
__global__ void dedupe_scatter_kernel(
    const int* __restrict__ q, const int* __restrict__ ctx, const int* __restrict__ obj,
    const int* __restrict__ rel, const int* __restrict__ depth,
    const uint8_t* __restrict__ keep, int G, int F, int tile,
    const int* __restrict__ tile_counts, int n_tiles, int* __restrict__ overflow,
    int* __restrict__ nt_q, int* __restrict__ nt_ctx, int* __restrict__ nt_obj,
    int* __restrict__ nt_rel, int* __restrict__ nt_depth, int* __restrict__ n_new) {
  __shared__ unsigned warp_sums[64];
  unsigned all;
  unsigned pos = tile_base(tile_counts, n_tiles, warp_sums, &all);
  const int lo = blockIdx.x * tile;
  const int hi = min(G, lo + tile);
  for (int r = lo; r < hi; r += 4 * (int)blockDim.x) {
    const int i0 = r + 4 * (int)threadIdx.x;
    uchar4 k4 = make_uchar4(0, 0, 0, 0);
    if (i0 + 3 < hi) {
      k4 = __ldg(reinterpret_cast<const uchar4*>(keep + i0));
    } else if (i0 < hi) {
      k4.x = keep[i0];
      k4.y = i0 + 1 < hi ? keep[i0 + 1] : 0;
      k4.z = i0 + 2 < hi ? keep[i0 + 2] : 0;
    }
    const uint8_t k[4] = {k4.x, k4.y, k4.z, k4.w};
    unsigned round_total;
    unsigned p = pos + block_exclusive_scan(
        (unsigned)k[0] + (unsigned)k[1] + (unsigned)k[2] + (unsigned)k[3], warp_sums,
        &round_total);
    for (int e = 0; e < 4; ++e) {
      if (!k[e]) continue;
      const int i = i0 + e;
      if ((int)p < F) {
        nt_q[p] = q[i];
        nt_ctx[p] = ctx[i];
        nt_obj[p] = obj[i];
        nt_rel[p] = rel[i];
        nt_depth[p] = depth[i];
      } else {
        raise_cause(overflow, q[i], kCauseFrontierOverflow);
      }
      ++p;
    }
    pos += round_total;
  }
  const int n_in = min((int)all, F);
  for (int t = n_in + blockIdx.x * blockDim.x + threadIdx.x; t < F;
       t += gridDim.x * blockDim.x) {
    nt_q[t] = 0;
    nt_ctx[t] = 0;
    nt_obj[t] = 0;
    nt_rel[t] = 0;
    nt_depth[t] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_new = n_in;
}

}  // namespace

extern "C" {

const char* keto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int keto_edge_probe(
    const int* dh, long long dh_cap, const int* dd, long long dd_cap, int spb,
    int dh_probes, int dd_probes, int has_delta, const int* obj, const int* rel,
    const int* q, const int* qsub, const int* depth, const uint8_t* live,
    uint8_t* hit, int F, void* stream) {
  if (F > 0) {
    const int dh_pb = (dh_probes + spb - 1) / spb;
    const int rounds = (dh_pb * 2 * spb + kGroup - 1) / kGroup;  // of the main table
    auto kernel = rounds <= 1 ? edge_probe_staged_kernel<1>
                : rounds <= 2 ? edge_probe_staged_kernel<2>
                : rounds <= 4 ? edge_probe_staged_kernel<4>
                              : edge_probe_staged_kernel<kMaxEdgeRounds>;
    kernel<<<blocks_for((long long)F * kGroup, kProbeThreads), kProbeThreads, 0,
             (cudaStream_t)stream>>>(
        (const int4*)dh, (uint32_t)(dh_cap / spb), (const int4*)dd,
        (uint32_t)(dd_cap / spb), spb, dh_pb, (dd_probes + spb - 1) / spb, has_delta, obj,
        rel, q, (const int4*)qsub, depth, live, hit, F);
  }
  return (int)cudaGetLastError();
}

int keto_pair_probe(
    const int* pack, long long cap, int spb, int probes, const int* obj,
    const int* rels, int F, int S, int n_vals, int* out, void* stream) {
  const long long n = (long long)F * S;
  if (n <= 0) return (int)cudaGetLastError();
  // one index of 32 bits a slot; spb a power of two (16 or 1)
  if (n >= (1LL << 31) || spb <= 0 || (spb & (spb - 1)) || (n_vals != 1 && n_vals != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int spb_log2 = __builtin_ctz((unsigned)spb);
  const int total = (probes + spb - 1) / spb * spb;  // slots of the probed rows
  const int rounds = (total + kGroup - 1) / kGroup;
  int w_log2 = 5;  // items a warp: 32, halved down to 2 below kMinWarps warps
  while (w_log2 > 1 && (n >> w_log2) < kMinWarps) --w_log2;
  const long long warps = (n + (1 << w_log2) - 1) >> w_log2;
  const int blocks = blocks_for(warps * 32, kPairThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (w_log2 == 1) {
    auto kernel = rounds <= 1 ? pair_probe_two_kernel<1>
                : rounds <= 2 ? pair_probe_two_kernel<2>
                              : pair_probe_two_kernel<4>;
    kernel<<<blocks, kPairThreads, 0, st>>>((const int4*)pack, (uint32_t)(cap / spb), spb_log2,
                                            total, obj, rels, (int)n, S, n_vals, out);
  } else {
    auto kernel = rounds <= 1 ? pair_probe_shared_kernel<1>
                : rounds <= 2 ? pair_probe_shared_kernel<2>
                              : pair_probe_shared_kernel<4>;
    kernel<<<blocks, kPairThreads, 0, st>>>((const int4*)pack, (uint32_t)(cap / spb), spb_log2,
                                            total, obj, rels, (int)n, S, w_log2, n_vals, out);
  }
  return (int)cudaGetLastError();
}

int keto_expand_gather(
    const int* counts, const int* starts, const int* slot_ctx, const int* crel,
    const int* is_comp, const int* q, const int* obj, const int* depth,
    const int* e_pack, int n_edges, int F, int S, int n_queries, int wildcard_rel,
    int* offsets, int* total, int* tile_sums, int* overflow, int* out_q, int* out_ctx,
    int* out_obj, int* out_rel, int* out_depth, uint8_t* out_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n = F * S;
  const int tile = scan_tile(n, kScanTile);
  const int nt = scan_tiles(n, tile);
  expand_tile_sums_kernel<<<nt, kTileThreads, 0, st>>>(counts, n, tile, tile_sums, overflow,
                                                       n_queries);
  expand_offsets_kernel<<<nt, kTileThreads, 0, st>>>(counts, n, tile, tile_sums, nt, F, S, q,
                                                     offsets, total, overflow);
  if (F > 0) {
    expand_gather_kernel<<<blocks_for(F, kGatherThreads), kGatherThreads, 0, st>>>(
        offsets, n, total, F, S, starts, slot_ctx, crel, is_comp, q, obj, depth,
        (const int2*)e_pack, n_edges, wildcard_rel, out_q, out_ctx, out_obj, out_rel,
        out_depth, out_valid);
  }
  return (int)cudaGetLastError();
}

int keto_dedupe_compact(
    const int* q, const int* ctx, const int* obj, const int* rel, const int* depth,
    const uint8_t* valid, int G, int F, int n_queries, int cap, int idx_bits,
    unsigned* winner, uint8_t* keep, int* tile_counts, int* overflow, int* nt_q,
    int* nt_ctx, int* nt_obj, int* nt_rel, int* nt_depth, int* n_new, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(winner, 0, sizeof(unsigned) * (size_t)cap, st);
  const int tile = scan_tile(G, kScanTile);
  const int nt = scan_tiles(G, tile);
  if (G > 0) {
    dedupe_claim_kernel<<<blocks_for(G, 256), 256, 0, st>>>(
        ctx, obj, rel, depth, valid, G, (uint32_t)cap, idx_bits, winner);
  }
  dedupe_keep_kernel<<<nt, kTileThreads, 0, st>>>(ctx, obj, rel, valid, G, tile, (uint32_t)cap,
                                                  idx_bits, winner, keep, tile_counts, overflow,
                                                  n_queries);
  dedupe_scatter_kernel<<<nt, kTileThreads, 0, st>>>(
      q, ctx, obj, rel, depth, keep, G, F, tile, tile_counts, nt, overflow, nt_q, nt_ctx,
      nt_obj, nt_rel, nt_depth, n_new);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Closure powering for Hopper (sm_90a): one step of bit-packed boolean
// matrix powering and its bookkeeping, with a plain C interface bound by
// ctypes (keto_tpu_torch/engine/cuda_ops.py). Each entry point launches on
// the caller's stream, allocates nothing, computes exactly what its plain
// PyTorch version computes (engine/closure_power.py power_step_plain,
// power_account_plain, power_poison_plain) and returns cudaGetLastError().
//
// All three replace keto_tpu/engine/closure_power.py closure_power_wave
// (:132) with _pack_bits / _unpack_bits (:105-117):
// P1 keto_power_step    the step body up to R |= fresh and the reach counts
//                       (:152-178), with its launch counters (two kernels);
// P2 keto_power_account the level plane, the row-cap kill and the next
//                       frontier (:169-188), and the loop's status;
// P3 keto_power_poison  the poison read after the loop and the packed
//                       summary (:199-208) (two kernels).
//
// Layout: R, F and fresh are [N, W] uint32 words held in int32 tensors;
// bit s of word w is source w * 32 + s of the wave (W a power of two). The JAX kernel unpacks every gathered row into [E, S] uint8 bit
// planes, takes a segment max over destinations and packs again; here the
// words are ORed as they are, so no plane is ever materialized.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 528;  // grid-stride kernels: 4 blocks an SM

// blocks of kThreads for n threads, at least one and at most `cap`
int blocks_for(long long n, long long cap = 1LL << 30) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : b > cap ? cap : b);
}

__device__ __forceinline__ int warp_sum(int x) {
  return __reduce_add_sync(0xFFFFFFFFu, x);
}

// ---------------------------------------------------------------------------
// P1 power_step
//
// Bound: bytes, lightly. A step reads each edge's source row of F (W
// words; on chains most rows are read once), needs R only at the words
// the gathered OR sets, writes fresh [N, W], and adds one atomic per
// fresh bit into the reach counts; its operations are an OR, a popcount
// and a test per gathered word. Design, two passes; pass (b) and the
// accumulator's memset sweep all of [N, W] while the frontier is sparse,
// which is what holds P1 above its bound. (a) A group of G = min(W, 32) lanes owns one edge and reads
// words t, t + G, ... of its source row: one coalesced row read per edge,
// all edges at once; a non-zero word is ORed into the destination's
// accumulator row with atomicOr (frontiers are sparse, so few words are),
// and a ballot over the group tells whether the edge's row was non-zero
// (keto_tpu's probe_hits counts edges, not words). (b) One thread per
// (node, word) forms fresh = acc & ~R, writes it, lets R take it in
// place, and adds one to a source's count for each fresh bit (one per
// newly reached (node, source) pair). A walk of each node's in-edge
// segment instead serializes a long segment: the wave's padding edges
// all end at the dummy node, and such a walk took 2.08 ms at the widest
// deep-1e6 wave (NVIDIA H100 80GB HBM3, 700 W). The launch counters
// reduce in the block and land with one atomic per block; block 0 of (b)
// adds the step and the frontier popcount the previous P2 left in
// status[0]. The entry point zeroes the accumulator first.
// ---------------------------------------------------------------------------

__global__ void power_gather_kernel(
    const uint32_t* __restrict__ F, const int* __restrict__ e_src,
    const int* __restrict__ e_dst, int E, int W, int G, uint32_t* __restrict__ acc,
    int* __restrict__ stats) {
  __shared__ int s_hits, s_rows;
  if (threadIdx.x == 0) {
    s_hits = 0;
    s_rows = 0;
  }
  __syncthreads();
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int k = (int)(gid / G);
  const int t = (int)(gid % G);
  const int lane = threadIdx.x & 31;
  int hits = 0, rows = 0;
  if (k < E) {  // the whole group takes the same branches
    const unsigned gmask = G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << (lane & ~(G - 1));
    const uint32_t* row = F + (size_t)e_src[k] * W;
    uint32_t* out = acc + (size_t)e_dst[k] * W;
    uint32_t any = 0u;
    for (int w = t; w < W; w += G) {
      const uint32_t x = row[w];
      if (x) {
        atomicOr(&out[w], x);
        rows += __popc(x);
        any |= x;
      }
    }
    if ((__ballot_sync(gmask, any != 0u) & gmask) && t == 0) hits = 1;
  }
  hits = warp_sum(hits);
  rows = warp_sum(rows);
  if (lane == 0) {
    if (hits) atomicAdd(&s_hits, hits);
    if (rows) atomicAdd(&s_rows, rows);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_hits) atomicAdd(&stats[4], s_hits);  // probe hits
    if (s_rows) atomicAdd(&stats[5], s_rows);  // edge rows
  }
}

__global__ void power_fresh_kernel(
    const uint32_t* __restrict__ acc, uint32_t* __restrict__ R, int N, int W,
    uint32_t* __restrict__ fresh, int* __restrict__ counts, int* __restrict__ stats,
    const int* __restrict__ status) {
  __shared__ int s_kept;
  if (threadIdx.x == 0) s_kept = 0;
  __syncthreads();
  const long long total = (long long)N * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int kept = 0;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const uint32_t r = R[e];
    uint32_t f = acc[e] & ~r;
    fresh[e] = f;
    if (f) {
      R[e] = r | f;
      kept += __popc(f);
      const int base = (int)(e % W) * 32;
      for (; f; f &= f - 1u) atomicAdd(&counts[base + __ffs(f) - 1], 1);
    }
  }
  kept = warp_sum(kept);
  if ((threadIdx.x & 31) == 0 && kept) atomicAdd(&s_kept, kept);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_kept) atomicAdd(&stats[6], s_kept);  // dedupe kept
    if (blockIdx.x == 0) {  // no other block writes slots 0-3
      const int n = status[0];
      stats[0] += 1;                  // steps
      stats[1] += n;                  // frontier sum
      stats[2] = max(stats[2], n);    // frontier max
      stats[3] += n;                  // live sum
    }
  }
}

// ---------------------------------------------------------------------------
// P2 power_account
//
// Bound: bytes. It reads fresh once, writes F once ([N, W] each), reads
// the fresh words of the D direct rows and writes a level byte only where
// a fresh bit lands; operations are an AND-NOT and a popcount a word.
// Design: each block first turns the S reach counts into the W kill words
// in shared memory (32 counts a warp ballot: bit s of word w is set when
// source w * 32 + s holds more than max_set_rows), since every count is
// final once P1 has run. Then a grid-stride loop over N * W frontier words
// (F = fresh & ~kill, popcount into the status) and D * W direct-row words
// (for each fresh bit, lvl = level where it is still -1; one thread per
// (row, word) owns those 32 bytes, so no two threads write one). The
// popcount reduces in the block and lands with one atomic per block in
// status[0], which the entry point zeroes first.
// ---------------------------------------------------------------------------

__global__ void power_account_kernel(
    const uint32_t* __restrict__ fresh, int8_t* __restrict__ lvl, const int* __restrict__ counts,
    const int* __restrict__ d_rows, int N, int D, int W, int level, int max_set_rows,
    uint32_t* __restrict__ F, int* __restrict__ status) {
  extern __shared__ uint32_t kill[];
  __shared__ int s_pop;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) s_pop = 0;
  for (int w = warp; w < W; w += nwarps) {
    const unsigned b = __ballot_sync(0xFFFFFFFFu, counts[w * 32 + lane] > max_set_rows);
    if (lane == 0) kill[w] = b;
  }
  __syncthreads();
  const long long nF = (long long)N * W;
  const long long total = nF + (long long)D * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int S = W * 32;
  int pop = 0;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    if (e < nF) {
      const uint32_t f = fresh[e] & ~kill[e % W];
      F[e] = f;
      pop += __popc(f);
    } else {
      const long long e2 = e - nF;
      const int j = (int)(e2 / W);
      const int w = (int)(e2 % W);
      uint32_t f = fresh[(size_t)d_rows[j] * W + w];
      int8_t* row = lvl + (size_t)j * S + w * 32;
      for (; f; f &= f - 1u) {
        const int b = __ffs(f) - 1;
        if (row[b] < 0) row[b] = (int8_t)level;
      }
    }
  }
  pop = warp_sum(pop);
  if (lane == 0 && pop) atomicAdd(&s_pop, pop);
  __syncthreads();
  if (threadIdx.x == 0 && s_pop) atomicAdd(status, s_pop);
}

// ---------------------------------------------------------------------------
// P3 power_poison
//
// Bound: bytes, lightly: the N-byte poison mask, the R rows of poisoned
// nodes (few: AND/NOT islands and relation-not-found nodes) and the
// (2S + 8)-int summary. Design: a grid-stride pass ORs the seen words of
// every poisoned row into W scratch words with atomicOr (the entry point
// zeroes them), then a second kernel writes the summary, one thread an
// int: the counts, each source's poison bit, the stats.
// ---------------------------------------------------------------------------

__global__ void poison_or_kernel(
    const uint32_t* __restrict__ R, const uint8_t* __restrict__ pois_mask, int N, int W,
    uint32_t* __restrict__ pw) {
  const long long total = (long long)N * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    if (pois_mask[e / W]) {
      const uint32_t x = R[e];
      if (x) atomicOr(&pw[e % W], x);
    }
  }
}

__global__ void poison_summary_kernel(
    const uint32_t* __restrict__ pw, const int* __restrict__ counts,
    const int* __restrict__ stats, int S, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < S) {
    out[i] = counts[i];
  } else if (i < 2 * S) {
    const int s = i - S;
    out[i] = (int)((pw[s >> 5] >> (s & 31)) & 1u);
  } else if (i < 2 * S + 8) {
    out[i] = stats[i - 2 * S];
  }
}

}  // namespace

extern "C" {

int keto_power_step(
    const int* F, int* R, const int* e_src, const int* e_dst, int E, int N, int W, int* acc,
    int* fresh, int* counts, int* stats, const int* status, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = W < 32 ? W : 32;
  cudaMemsetAsync(acc, 0, (size_t)N * W * sizeof(int), st);
  if (E > 0) {
    power_gather_kernel<<<blocks_for((long long)E * G), kThreads, 0, st>>>(
        (const uint32_t*)F, e_src, e_dst, E, W, G, (uint32_t*)acc, stats);
  }
  power_fresh_kernel<<<blocks_for((long long)N * W, kMaxBlocks), kThreads, 0, st>>>(
      (const uint32_t*)acc, (uint32_t*)R, N, W, (uint32_t*)fresh, counts, stats, status);
  return (int)cudaGetLastError();
}

int keto_power_account(
    const int* fresh, int8_t* lvl, const int* counts, const int* d_rows, int N, int D, int W,
    int level, int max_set_rows, int* F, int* status, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(status, 0, sizeof(int), st);
  power_account_kernel<<<blocks_for((long long)(N + D) * W, kMaxBlocks), kThreads,
                         W * sizeof(uint32_t), st>>>(
      (const uint32_t*)fresh, lvl, counts, d_rows, N, D, W, level, max_set_rows,
      (uint32_t*)F, status);
  return (int)cudaGetLastError();
}

int keto_power_poison(
    const int* R, const uint8_t* pois_mask, const int* counts, const int* stats, int N, int W,
    int* pw, int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(pw, 0, W * sizeof(int), st);
  poison_or_kernel<<<blocks_for((long long)N * W, kMaxBlocks), kThreads, 0, st>>>(
      (const uint32_t*)R, pois_mask, N, W, (uint32_t*)pw);
  const int S = W * 32;
  poison_summary_kernel<<<blocks_for(2LL * S + 8), kThreads, 0, st>>>(
      (const uint32_t*)pw, counts, stats, S, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

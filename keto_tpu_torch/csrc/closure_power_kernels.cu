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

#include "reduce.cuh"

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
// the D direct rows' node ids and writes a level byte where a fresh bit
// lands on one; operations are an AND-NOT and a popcount a word. Design,
// one launch a call on a grid of the card's resident blocks, 32-bit index
// math (W = 1 << lw: shifts and masks, no division a word):
// - each block turns the S reach counts into the W kill words in shared
//   memory (32 counts a warp ballot, a lane's counts of up to 8 words
//   read at once: bit s of word w is set when source w * 32 + s holds
//   more than max_set_rows; every count is final once P1 has run), while
//   each thread's first frontier item and first level item (the direct
//   row's node, then its fresh words) are already being read;
// - a grid-stride pass over the frontier, four words a thread in one
//   16-byte load and store when W >= 4 (one word when W is 1 or 2): F =
//   fresh & ~kill, its popcount summed;
// - then one thread per (direct row j, item of words w) reads the item
//   of fresh at node d_rows[j] (one 16-byte load when W >= 4) and, for
//   each non-zero word, owns the row's 32 level bytes of that word (so no
//   two threads write one): two 16-byte loads, lvl = level in each byte
//   whose fresh bit is set and which is still negative, two 16-byte
//   stores;
// - the popcount reduces in the block and lands in status[0] through the
//   last-block sum of reduce.cuh: no memset precedes the kernel.
// The resident grid (8 blocks an SM, the kernel held to 32 registers)
// beat 528 blocks and 6 blocks an SM at 40 registers, and four words a
// level item beat one (PERF.md §6).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t kill_word(uint32_t v, const uint32_t* kill, int w, int& pop) {
  const uint32_t f = v & ~kill[w];
  pop += __popc(f);
  return f;
}

__device__ __forceinline__ uint4 kill_word(uint4 v, const uint32_t* kill, int w, int& pop) {
  const uint4 k = *reinterpret_cast<const uint4*>(kill + w);
  const uint4 f = make_uint4(v.x & ~k.x, v.y & ~k.y, v.z & ~k.z, v.w & ~k.w);
  pop += __popc(f.x) + __popc(f.y) + __popc(f.z) + __popc(f.w);
  return f;
}

// Four level bytes x of lanes 4i..4i+3 of a word whose fresh bits are f:
// `level` in each byte whose bit of f is set and whose value is negative.
__device__ __forceinline__ uint32_t level_bytes(uint32_t x, uint32_t f, int i, uint32_t lev4) {
  const uint32_t bits = ((f >> (4 * i)) & 0xFu) * 0x204081u & 0x01010101u;  // bit b -> byte b
  const uint32_t set = (bits & (x >> 7) & 0x01010101u) * 0xFFu;
  return (x & ~set) | (lev4 & set);
}

__device__ __forceinline__ uint4 level_bytes(uint4 x, uint32_t f, int i, uint32_t lev4) {
  return make_uint4(level_bytes(x.x, f, i, lev4), level_bytes(x.y, f, i + 1, lev4),
                    level_bytes(x.z, f, i + 2, lev4), level_bytes(x.w, f, i + 3, lev4));
}

// The 32 level bytes of one fresh word f, at `chunk`.
__device__ __forceinline__ void level_word(uint32_t f, uint4* chunk, uint32_t lev4) {
  if (f) {
    const uint4 lo = chunk[0], hi = chunk[1];
    chunk[0] = level_bytes(lo, f, 0, lev4);
    chunk[1] = level_bytes(hi, f, 4, lev4);
  }
}

__device__ __forceinline__ void level_words(uint32_t f, uint4* chunk, uint32_t lev4) {
  level_word(f, chunk, lev4);
}

__device__ __forceinline__ void level_words(uint4 f, uint4* chunk, uint32_t lev4) {
  level_word(f.x, chunk, lev4);
  level_word(f.y, chunk + 2, lev4);
  level_word(f.z, chunk + 4, lev4);
  level_word(f.w, chunk + 6, lev4);
}

// The fresh word that word w of the direct rows ([D, W], flat) reads:
// word w & (W - 1) of node d_rows[w >> lw].
__device__ __forceinline__ unsigned lvl_item(const int* __restrict__ d_rows, unsigned w, int lw) {
  return ((unsigned)d_rows[w >> lw] << lw) | (w & ((1u << lw) - 1u));
}

constexpr int kWarps = kThreads / 32;
constexpr int kKillRounds = 8;  // W = 64 in one round of kWarps warps
// 32 registers a thread, so that an SM holds 8 blocks (2,048 threads)
constexpr int kAccountBlocksPerSM = 8;

// T is one item of words: uint4 (four) or uint32_t (one). n_items and
// n_lvl count items of the frontier and of the direct rows.
template <typename T>
__global__ void __launch_bounds__(kThreads, kAccountBlocksPerSM) power_account_vec_kernel(
    const uint32_t* __restrict__ fresh, int8_t* __restrict__ lvl, const int* __restrict__ counts,
    const int* __restrict__ d_rows, int n_items, int n_lvl, int lw, int level, int max_set_rows,
    uint32_t* __restrict__ F, int* __restrict__ status,
    unsigned long long* __restrict__ scratch) {
  constexpr int kWords = sizeof(T) / sizeof(uint32_t);
  extern __shared__ __align__(16) uint32_t kill[];
  __shared__ int s_pop;
  const int W = 1 << lw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* __restrict__ fresh_t = reinterpret_cast<const T*>(fresh);
  T* __restrict__ F_t = reinterpret_cast<T*>(F);
  // unsigned: e + stride stays exact past n_items, which is below 2^31
  const unsigned stride = gridDim.x * kThreads, n = n_items;
  unsigned e = blockIdx.x * kThreads + threadIdx.x;
  // the thread's first frontier item, and the direct-row node and fresh
  // item of its first level item (its first index at or past n), go out
  // before the kill words are built
  T first{}, first_lvl{};
  if (e < n) first = fresh_t[e];
  const unsigned i0 = e < n ? e + (n - e + stride - 1) / stride * stride - n : e - n;
  if (i0 < (unsigned)n_lvl) first_lvl = fresh_t[lvl_item(d_rows, i0 * kWords, lw) / kWords];
  if (threadIdx.x == 0) s_pop = 0;
  // each lane's counts of up to kKillRounds words are read at once
  for (int w0 = warp; w0 < W; w0 += kKillRounds * kWarps) {
    int c[kKillRounds];
#pragma unroll
    for (int r = 0; r < kKillRounds; ++r) {
      const int w = w0 + r * kWarps;
      c[r] = w < W ? counts[(w << 5) | lane] : 0;
    }
#pragma unroll
    for (int r = 0; r < kKillRounds; ++r) {
      const int w = w0 + r * kWarps;
      const unsigned b = __ballot_sync(0xFFFFFFFFu, c[r] > max_set_rows);
      if (lane == 0 && w < W) kill[w] = b;
    }
  }
  __syncthreads();
  int pop = 0;
  if (e < n) {
    F_t[e] = kill_word(first, kill, (e * kWords) & (W - 1), pop);
    e += stride;
  }
  for (; e + stride < n; e += 2 * stride) {
    const T a = fresh_t[e], b = fresh_t[e + stride];
    F_t[e] = kill_word(a, kill, (e * kWords) & (W - 1), pop);
    F_t[e + stride] = kill_word(b, kill, ((e + stride) * kWords) & (W - 1), pop);
  }
  if (e < n) {
    F_t[e] = kill_word(fresh_t[e], kill, (e * kWords) & (W - 1), pop);
    e += stride;
  }
  const uint32_t lev4 = (uint32_t)(uint8_t)level * 0x01010101u;
  // level byte 32 w + s is lane 32 (w & (W - 1)) + s of direct row w >> lw
  uint4* const lvl16 = reinterpret_cast<uint4*>(lvl);
  if (i0 < (unsigned)n_lvl) level_words(first_lvl, lvl16 + 2 * i0 * kWords, lev4);
  for (unsigned i = i0 + stride; i < (unsigned)n_lvl; i += stride) {
    level_words(fresh_t[lvl_item(d_rows, i * kWords, lw) / kWords], lvl16 + 2 * i * kWords,
                lev4);
  }
  pop = warp_sum(pop);
  if (lane == 0 && pop) atomicAdd(&s_pop, pop);
  __syncthreads();
  if (threadIdx.x == 0) grid_sum_last_block(s_pop, scratch, status);
}

// The blocks of P2 the current card holds at once: the grid of its
// grid-stride pass. The blocks an SM holds depend on the kernel alone
// (its registers and kThreads; the kill words are at most a few KB), so
// they are asked once a process.
template <typename T>
int account_blocks() {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, power_account_vec_kernel<T>, kThreads,
                                                  0);
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * per_sm;
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
    int level, int max_set_rows, int* F, int* status, void* scratch, void* stream) {
  const int lw = __builtin_ctz((unsigned)W);
  const size_t smem = W * sizeof(uint32_t);
  const bool vec = W >= 4;
  const int n_items = vec ? N * W / 4 : N * W;
  const int n_lvl = vec ? D * W / 4 : D * W;
  auto kernel = vec ? power_account_vec_kernel<uint4> : power_account_vec_kernel<uint32_t>;
  const int cap = vec ? account_blocks<uint4>() : account_blocks<uint32_t>();
  const int blocks = blocks_for((long long)n_items + n_lvl, cap);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)fresh, lvl, counts, d_rows, n_items, n_lvl, lw, level, max_set_rows,
      (uint32_t*)F, status, (unsigned long long*)scratch);
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

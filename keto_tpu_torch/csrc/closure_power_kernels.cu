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
//                       summary (:199-208) (one kernel).
// None of them launches a memset.
//
// Layout: R, F and fresh are [N, W] uint32 words held in int32 tensors;
// bit s of word w is source w * 32 + s of the wave (W a power of two). The
// JAX kernel unpacks every gathered row into [E, S] uint8 bit planes,
// takes a segment max over destinations and packs again; here the words
// are ORed as they are, so no plane is ever materialized. Index math is
// 32-bit (the wrappers hold N W below 2^31): W = 1 << lw, so a word's
// column is a mask and a row's first word a shift.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// P1's gather held to 32 registers a thread, so that an SM holds 8 blocks
constexpr int kStepBlocksPerSM = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

// blocks of kThreads for n threads, at least one and at most `cap`
int blocks_for(long long n, long long cap = 1LL << 30) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : b > cap ? cap : b);
}

__device__ __forceinline__ int warp_sum(int x) {
  return __reduce_add_sync(kFull, x);
}

// The blocks of kKernel the current card holds at once, kThreads a block:
// the grid of a grid-stride pass. The blocks an SM holds depend on the
// kernel alone (its registers, kThreads and its static shared memory; P2's
// kill words are at most a few KB), so they are asked once a process.
template <auto kKernel>
int resident_blocks() {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads, 0);
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * per_sm;
}

// ---------------------------------------------------------------------------
// P1 power_step
//
// Bound: bytes, lightly. A step reads each edge's source row of F (W
// words; on chains most rows are read once), needs R only at the words
// the gathered OR sets, writes fresh [N, W] whole (zero wherever no bit
// lands), and adds one per fresh bit into the reach counts; its
// operations are an OR, a popcount and a test per gathered word. Design,
// two launches, 16 bytes a load when W >= 4 (one word when W is 1 or 2):
// (a) the gather, on a grid of the card's resident blocks. A grid-stride
//     pass writes fresh's zeros: the one pass over all N W words, the
//     output's own write. Then a group of G = min(W / 4, 32) lanes owns
//     one edge and reads its source row of F, a coalesced row read per
//     edge, two edges a thread at once. Each non-zero word is ORed into
//     the destination's word of an accumulator with an atomicOr whose
//     result nobody waits for, and its index goes to the block's list (a
//     warp's appends take one shared-memory atomic, placed by three
//     ballots, skipped by a warp with nothing to append; a word that
//     several edges set is listed once for each). A ballot over the group
//     tells whether the edge's row was non-zero (keto_tpu's probe_hits
//     counts edges, not words).
// (b) the walk, a warp for each block of (a). A warp takes one block's
//     list: for each listed word it takes the accumulator's word with
//     atomicExch(0), so the first entry of a word gets its OR and every
//     later one 0; the owner forms fresh = acc & ~R, writes it and lets R
//     take it in place; the fresh bits add into the block's reach counts
//     in shared memory, which go out with one atomic for each non-zero
//     count (a dense step sets ~10^6 fresh bits on 2,048 counts). Each
//     lane's first entry is read with the list's length.
// So R and the accumulator are touched only where the gather set a word,
// and the accumulator (engine/cuda_ops.py power_scratch, zeroed once per
// device and stream) is zero again when the call ends. One list a block,
// not one for the grid: a block's count is a shared-memory atomic, and
// the walk's warps find their lists with no ticket. The launch counters
// reduce in the block (the walk's in the warp) and land with one atomic
// each; block 0 of (a) adds the step and the frontier popcount the
// previous P2 left in status[0].
// ---------------------------------------------------------------------------

// One warp's appends, lane by lane: the word indices base + c for each
// bit c of `mask` (at most four) go to consecutive slots of `list`, whose
// fill is *count. Every lane of the warp calls it.
__device__ __forceinline__ void warp_append(unsigned mask, unsigned base, int* list, int* count,
                                            int lane) {
  if (!__any_sync(kFull, mask != 0u)) return;
  const int n = __popc(mask);
  const unsigned b0 = __ballot_sync(kFull, n & 1), b1 = __ballot_sync(kFull, n & 2),
                 b2 = __ballot_sync(kFull, n & 4);
  const unsigned lower = (1u << lane) - 1u;
  int start = 0;
  if (lane == 0) start = atomicAdd(count, __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2));
  int pos = __shfl_sync(kFull, start, 0) + __popc(b0 & lower) + 2 * __popc(b1 & lower) +
            4 * __popc(b2 & lower);
  for (; mask; mask &= mask - 1u) list[pos++] = (int)(base + __ffs(mask) - 1);
}

// The words of one item x of the row gathered for an edge into the
// accumulator's words from `base` on. Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ void gather_item(const T& x, unsigned base, uint32_t* acc, int* list,
                                            int* count, int lane, int& rows, uint32_t& any) {
  constexpr int kWords = sizeof(T) / sizeof(uint32_t);
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(&x);
  unsigned set = 0u;
#pragma unroll
  for (int c = 0; c < kWords; ++c) {
    if (xw[c]) {
      rows += __popc(xw[c]);
      any |= xw[c];
      atomicOr(&acc[base + c], xw[c]);
      set |= 1u << c;
    }
  }
  warp_append(set, base, list, count, lane);
}

// T is one item of words: uint4 (four) or uint32_t (one). An item of the
// gather is (edge j >> lg, lane j & (G - 1)); a row holds 1 << lv items.
// lists holds one count a block, then one list of `cap` ints a block.
template <typename T>
__global__ void __launch_bounds__(kThreads, kStepBlocksPerSM) power_step_gather_kernel(
    const T* __restrict__ F, const int* __restrict__ e_src, const int* __restrict__ e_dst,
    unsigned n_items, int lg, int lv, int lw, T* __restrict__ fresh, unsigned n_fresh,
    uint32_t* __restrict__ acc, int* __restrict__ lists, int cap, int* __restrict__ stats,
    const int* __restrict__ status) {
  constexpr int kWords = sizeof(T) / sizeof(uint32_t);
  __shared__ int s_hits, s_rows, s_count;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_hits = 0;
    s_rows = 0;
    s_count = 0;
  }
  const unsigned stride = gridDim.x * kThreads;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  for (unsigned e = tid; e < n_fresh; e += stride) fresh[e] = T{};
  __syncthreads();
  const int G = 1 << lg;
  const int t = lane & (G - 1);
  const unsigned gmask = (G == 32 ? kFull : (1u << G) - 1u) << (lane & ~(G - 1));
  int* const list = lists + gridDim.x + blockIdx.x * cap;
  int hits = 0, rows = 0;
  // whole warps run the loop (its bound is the warp's first item), so the
  // ballots see every lane; a group is one edge, its lanes all in or out
  for (unsigned j = tid; j - lane < n_items; j += 2 * stride) {
    const unsigned j2 = j + stride;
    const bool in = j < n_items, in2 = j2 < n_items;
    const unsigned src = in ? e_src[j >> lg] : 0u, src2 = in2 ? e_src[j2 >> lg] : 0u;
    const unsigned dst = in ? e_dst[j >> lg] : 0u, dst2 = in2 ? e_dst[j2 >> lg] : 0u;
    uint32_t any = 0u, any2 = 0u;
    for (int v = t; v < (1 << lv); v += G) {  // as many rounds in every lane
      T x{}, x2{};
      if (in) x = F[(src << lv) | v];
      if (in2) x2 = F[(src2 << lv) | v];
      const unsigned col = (unsigned)(v * kWords);
      gather_item(x, (dst << lw) | col, acc, list, &s_count, lane, rows, any);
      gather_item(x2, (dst2 << lw) | col, acc, list, &s_count, lane, rows, any2);
    }
    const unsigned hit = __ballot_sync(kFull, any != 0u) & gmask;
    const unsigned hit2 = __ballot_sync(kFull, any2 != 0u) & gmask;
    if (t == 0) hits += (in && hit) + (in2 && hit2);
  }
  hits = warp_sum(hits);
  rows = warp_sum(rows);
  if (lane == 0) {
    if (hits) atomicAdd(&s_hits, hits);
    if (rows) atomicAdd(&s_rows, rows);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    lists[blockIdx.x] = s_count;
    if (s_hits) atomicAdd(&stats[4], s_hits);  // probe hits
    if (s_rows) atomicAdd(&stats[5], s_rows);  // edge rows
    if (blockIdx.x == 0) {  // no other block writes slots 0-3
      const int n_tasks = status[0];
      stats[0] += 1;                              // steps
      stats[1] += n_tasks;                        // frontier sum
      stats[2] = max(stats[2], n_tasks);          // frontier max
      stats[3] += n_tasks;                        // live sum
    }
  }
}

// A warp a list: warp w of block b walks the list of the gather's block
// b * kWarps + w (n_lists of them). The block's reach counts, 32 << lw
// of them, add up in dynamic shared memory first.
__global__ void __launch_bounds__(kThreads) power_step_walk_kernel(
    uint32_t* __restrict__ acc, uint32_t* __restrict__ R, uint32_t* __restrict__ fresh,
    const int* __restrict__ lists, int n_lists, int cap, int lw, int* __restrict__ counts,
    int* __restrict__ stats) {
  extern __shared__ int s_counts[];
  const int S = 32 << lw;
  for (int s = threadIdx.x; s < S; s += kThreads) s_counts[s] = 0;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int* const list = lists + n_lists + b * cap;
  const bool mine = b < n_lists;
  const int n = mine ? lists[b] : 0;
  const int i0 = mine && lane < cap ? list[lane] : 0;  // read with n, not after it
  const unsigned column = (1u << lw) - 1u;
  __syncthreads();
  int kept = 0;
  for (int k = lane; k < n; k += 32) {
    const unsigned i = k == lane ? i0 : list[k];
    const uint32_t x = atomicExch(&acc[i], 0u);
    const uint32_t r = R[i];
    uint32_t f = x & ~r;
    if (f) {
      fresh[i] = f;
      R[i] = r | f;
      kept += __popc(f);
      int* const c = s_counts + ((i & column) << 5);
      for (; f; f &= f - 1u) atomicAdd(&c[__ffs(f) - 1], 1);
    }
  }
  kept = warp_sum(kept);
  if (lane == 0 && kept) atomicAdd(&stats[6], kept);  // dedupe kept
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kThreads) {
    if (s_counts[s]) atomicAdd(&counts[s], s_counts[s]);
  }
}

// P1's launch shape, shared by the entry point and the wrapper's sizing
// call: items of 16 bytes when W >= 4, G lanes an edge, the gather's grid
// (the walk takes a warp for each of its blocks), and the room of each
// block's list (a block appends at most W / G words an item it takes).
struct StepPlan {
  bool vec;
  int lg, lv, blocks, cap;
  unsigned n_items, n_fresh;
};

StepPlan step_plan(int E, int N, int W) {
  StepPlan p;
  p.vec = W >= 4;
  const int words = p.vec ? 4 : 1;
  const int V = W / words, G = V < 32 ? V : 32;
  p.lv = __builtin_ctz((unsigned)V);
  p.lg = __builtin_ctz((unsigned)G);
  p.n_items = (unsigned)E << p.lg;
  p.n_fresh = (unsigned)N * (unsigned)V;
  const int resident = p.vec ? resident_blocks<power_step_gather_kernel<uint4>>()
                             : resident_blocks<power_step_gather_kernel<uint32_t>>();
  p.blocks = blocks_for(p.n_items > p.n_fresh ? p.n_items : p.n_fresh, resident);
  const long long stride = (long long)p.blocks * kThreads;
  p.cap = (int)((p.n_items + stride - 1) / stride * kThreads * (W / G));
  return p;
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

// ---------------------------------------------------------------------------
// P3 power_poison
//
// Bound: bytes, lightly: the N-byte poison mask, the R rows of poisoned
// nodes (few: AND/NOT islands and relation-not-found nodes) and the
// (2S + 8)-int summary. Design, one launch, no memset, a chain of five
// dependent round trips to memory (mask, rows, ORs, ticket, read-back):
// - a block takes tiles of 512 nodes: warp 0 reads the tile's mask, 16
//   bytes a lane, and lists the tile's poisoned nodes in shared memory (a
//   warp prefix sum of each lane's count); then the block's threads read
//   those rows and no others, W threads a row (a warp a row, or 32 / W
//   rows a warp), thread t always word t & (W - 1), so one OR in a
//   register holds what it read across rows and tiles;
// - the block's ORs meet in W shared words, and each non-zero word goes
//   out with one atomicOr into W persistent words (engine/cuda_ops.py
//   power_scratch, zeroed once per device and stream);
// - then every thread copies its share of the counts and the stats to
//   their places in the summary (after the ticket, so that no fence waits
//   for those stores), and the block that took the last ticket
//   (reduce.cuh's last_block, on grid_scratch's word) reads the W words
//   back, returns them to zero and writes the S poison bits.
// ---------------------------------------------------------------------------

constexpr int kTile = 16 * 32;  // nodes a tile: 16 mask bytes a lane of warp 0
constexpr int kMaxWords = 256;  // W of the widest wave, 8,192 lanes

// bit j set where byte j of x is non-zero
__device__ __forceinline__ unsigned nonzero_bytes(uint32_t x) {
  const uint32_t high = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
  return ((high >> 7) * 0x10204080u) >> 28;
}

__global__ void __launch_bounds__(kThreads) power_poison_kernel(
    const uint32_t* __restrict__ R, const uint8_t* __restrict__ pois, int N, int lw,
    const int* __restrict__ counts, const int* __restrict__ stats, uint32_t* __restrict__ pw,
    unsigned long long* __restrict__ scratch, int* __restrict__ out) {
  __shared__ uint32_t s_pw[kMaxWords];
  __shared__ int s_rows[kTile];
  __shared__ int s_n;
  __shared__ bool s_last;
  const int W = 1 << lw;
  const unsigned S = (unsigned)W << 5;
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x; w < W; w += kThreads) s_pw[w] = 0u;
  const unsigned word = threadIdx.x & (W - 1);
  uint32_t seen = 0u;
  for (int tile = blockIdx.x; tile < (N + kTile - 1) / kTile; tile += gridDim.x) {
    if (threadIdx.x < 32) {
      const int first = tile * kTile + lane * 16;  // the lane's 16 nodes
      unsigned bits = 0u;
      if (first + 16 <= N) {
        const uint4 m = *reinterpret_cast<const uint4*>(pois + first);
        bits = nonzero_bytes(m.x) | nonzero_bytes(m.y) << 4 | nonzero_bytes(m.z) << 8 |
               nonzero_bytes(m.w) << 12;
      } else {
        for (int j = 0; first + j < N; ++j) bits |= (unsigned)(pois[first + j] != 0) << j;
      }
      const int n = __popc(bits);
      int end = n;  // inclusive prefix sum over the warp
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, end, o);
        if (lane >= o) end += y;
      }
      for (int pos = end - n; bits; bits &= bits - 1u) s_rows[pos++] = first + __ffs(bits) - 1;
      if (lane == 31) s_n = end;
    }
    __syncthreads();
    const int n = s_n;
#pragma unroll 4
    for (int r = threadIdx.x >> lw; r < n; r += kThreads >> lw) {
      seen |= R[((unsigned)s_rows[r] << lw) | word];
    }
    __syncthreads();  // s_rows and s_n are the next tile's
  }
  if (seen) atomicOr(&s_pw[word], seen);
  __syncthreads();
  bool wrote = false;
  for (int w = threadIdx.x; w < W; w += kThreads) {
    if (s_pw[w]) {
      atomicOr(&pw[w], s_pw[w]);
      wrote = true;
    }
  }
  if (wrote) __threadfence();  // the ORs land before the block's ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long none;
    s_last = last_block(0, scratch, &none);
  }
  __syncthreads();
  const bool last = s_last;
  if (last) {
    __threadfence();
    for (int w = threadIdx.x; w < W; w += kThreads) s_pw[w] = atomicExch(&pw[w], 0u);
  }
  // the counts and the stats, straight to their places in the summary
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < S + 8u; i += stride) {
    out[i < S ? i : i + S] = i < S ? counts[i] : stats[i - S];
  }
  if (!last) return;
  __syncthreads();
  for (unsigned s = threadIdx.x; s < S; s += kThreads) {
    out[S + s] = (int)((s_pw[s >> 5] >> (s & 31)) & 1u);
  }
}

}  // namespace

extern "C" {

// The ints of P1's list scratch for a call: a count a block, then each
// block's list.
long long keto_power_step_scratch(int E, int N, int W) {
  const StepPlan p = step_plan(E, N, W);
  return p.blocks + (long long)p.blocks * p.cap;
}

int keto_power_step(
    const int* F, int* R, const int* e_src, const int* e_dst, int E, int N, int W, int* acc,
    int* lists, int* fresh, int* counts, int* stats, const int* status, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const StepPlan p = step_plan(E, N, W);
  const int lw = __builtin_ctz((unsigned)W);
  if (p.vec) {
    power_step_gather_kernel<uint4><<<p.blocks, kThreads, 0, st>>>(
        (const uint4*)F, e_src, e_dst, p.n_items, p.lg, p.lv, lw, (uint4*)fresh, p.n_fresh,
        (uint32_t*)acc, lists, p.cap, stats, status);
  } else {
    power_step_gather_kernel<uint32_t><<<p.blocks, kThreads, 0, st>>>(
        (const uint32_t*)F, e_src, e_dst, p.n_items, p.lg, p.lv, lw, (uint32_t*)fresh,
        p.n_fresh, (uint32_t*)acc, lists, p.cap, stats, status);
  }
  power_step_walk_kernel<<<(p.blocks + kWarps - 1) / kWarps, kThreads, 32 * W * sizeof(int),
                           st>>>((uint32_t*)acc, (uint32_t*)R, (uint32_t*)fresh, lists, p.blocks,
                                 p.cap, lw, counts, stats);
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
  const int cap = vec ? resident_blocks<power_account_vec_kernel<uint4>>()
                      : resident_blocks<power_account_vec_kernel<uint32_t>>();
  const int blocks = blocks_for((long long)n_items + n_lvl, cap);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)fresh, lvl, counts, d_rows, n_items, n_lvl, lw, level, max_set_rows,
      (uint32_t*)F, status, (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}

int keto_power_poison(
    const int* R, const uint8_t* pois_mask, const int* counts, const int* stats, int N, int W,
    int* pw, void* scratch, int* out, void* stream) {
  const int blocks = blocks_for((long long)(N + kTile - 1) / kTile * kThreads,
                                resident_blocks<power_poison_kernel>());
  power_poison_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)R, pois_mask, N, __builtin_ctz((unsigned)W), counts, stats,
      (uint32_t*)pw, (unsigned long long*)scratch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

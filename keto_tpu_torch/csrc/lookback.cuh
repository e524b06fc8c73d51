// A decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", NVIDIA, 2016): the exclusive
// prefix of each tile's sum over the tiles before it, in the launch that
// computes the sums, so an order-preserving compaction needs no second
// pass over its input and no one-block scan of tile sums. M5
// mb_pack_onepass (microbench_kernels.cu) is its user; K4, X1, F1, L2 and
// L3 still scan their tile sums in a launch of their own (csrc/scan.cuh).
//
// Each tile has one 64-bit status word: its value in the low 32 bits, a
// flag in the next two (kAggregate: the tile's own sum; kPrefix: its
// inclusive prefix), and the call's epoch in the high 30. A word of
// another epoch reads as not yet published, so the words need no reset
// between calls: the wrapper gives each call the next epoch, 1 to 2^30 -
// 1, and zeroes the words when the epoch wraps (engine/cuda_ops.py
// onepass_scratch). A word is written by one 64-bit store and read by
// 64-bit loads, both relaxed at the card's scope (through L2, never a
// stale L1 copy): a word carries its own value and no tile reads
// anything else another tile wrote, so no fence orders them, as in CUB's
// ScanTileState for a value packed beside its status (release stores
// and a fence after the look-back cost 0.002 ms at F = 2^20, PERF.md §6).
// Blocks take their tiles by an atomic ticket, in the order they start,
// so a tile only ever waits on tiles whose blocks are already running:
// the look-back cannot wait on a block that was never scheduled.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEpochShift = 34;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr unsigned long long kFlags = kAggregate | kPrefix;

__device__ __forceinline__ void publish(unsigned long long* word, unsigned long long epoch,
                                        unsigned long long flag, unsigned value) {
  const unsigned long long w = (epoch << kEpochShift) | flag | value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(word) : "memory");
  return w;
}

// The exclusive prefix of tile t (t >= 1, its aggregate already
// published), in every lane of the one warp that calls it: lane j reads
// the word of tile t - 1 - j, 32 tiles a round, until the window holds a
// published prefix. It reads again while any word of its window is
// unpublished (each belongs to a block that is running), then sums the
// aggregates up to the nearest prefix, that prefix included. (Four words
// a lane, a window of 128 tiles, was no faster: PERF.md §6.)
__device__ unsigned look_back(const unsigned long long* status, int t, unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0;
  for (int end = t;; end -= 32) {
    const int j = end - 1 - lane;
    unsigned long long w = kPrefix;  // before tile 0: a prefix of 0
    bool ready = true;
    do {
      if (j >= 0) {
        w = peek(status + j);
        ready = (w >> kEpochShift) == epoch && (w & kFlags) != 0;
      }
    } while (!__all_sync(0xFFFFFFFFu, ready));
    const unsigned prefixes = __ballot_sync(0xFFFFFFFFu, (w & kPrefix) != 0);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned v = lane <= stop ? (unsigned)w : 0u;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    prefix += v;
    if (prefixes) return prefix;
  }
}

}  // namespace

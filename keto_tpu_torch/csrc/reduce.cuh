// A grid-wide sum in one launch, with no memset before it: F1 filter_mark
// (closure_filter_kernels.cu), P2 power_account
// (closure_power_kernels.cu) and L1 list_emit's landed count
// (list_kernels.cu); and, with nothing to sum, the last block of P3
// power_poison. The scratch's first 64-bit word holds the sum in its low
// 40 bits and the tickets taken in its high 24. Every block adds its
// value and one ticket in a single atomic, so the block that takes the
// last ticket sees every other block's value in what the atomic returns
// (no fence, no second round trip); it stores the sum and returns the
// scratch to zero. C1 closure_probe's two counts take two words
// (grid_counts_last_block). The scratch is zeroed once, when the wrapper
// allocates it (engine/cuda_ops.py grid_scratch, one per device and stream):
// launches on one stream run one after the other, so each finds it at
// zero, and no two launches in flight share it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSumBits = 40;

// Thread 0 of every block calls this once, with the block's value (v >=
// 0, the grid's sum below 2^40, fewer than 2^24 blocks). True in the one
// block that takes the last ticket, which gets the grid's sum in *sum
// and leaves the scratch at zero.
__device__ __forceinline__ bool last_block(long long v, unsigned long long* scratch,
                                           unsigned long long* sum) {
  const unsigned long long add = (1ull << kSumBits) | (unsigned long long)v;
  const unsigned long long before = atomicAdd(scratch, add);
  if ((before >> kSumBits) != gridDim.x - 1) return false;
  *sum = before + (unsigned long long)v;
  *scratch = 0ull;
  return true;
}

// last_block with the sum's low 32 bits stored in *out: the plain
// versions' int32 result.
__device__ __forceinline__ void grid_sum_last_block(long long v, unsigned long long* scratch,
                                                    int* out) {
  unsigned long long sum;
  if (last_block(v, scratch, &sum)) *out = (int)(uint32_t)sum;
}

// Two grid counts in one launch (C1's live count and probe hits), each
// on a scratch word of its own: the count in the low kCountBits bits (a
// count below 2^31 queries), the tickets in the high 28 (any grid of
// fewer than 2^28 blocks). Thread 0 of every block issues both atomics
// before it reads either; as in last_block, the block that takes a
// word's last ticket finds that word's count in what its atomic returns,
// stores it and returns the word to zero, so no fence orders the two.
constexpr int kCountBits = 36;

__device__ __forceinline__ void grid_counts_last_block(unsigned a, unsigned b,
                                                       unsigned long long* scratch, int* out_a,
                                                       int* out_b) {
  const unsigned long long ta = atomicAdd(scratch, (1ull << kCountBits) | a);
  const unsigned long long tb = atomicAdd(scratch + 1, (1ull << kCountBits) | b);
  const unsigned long long last = gridDim.x - 1ull;
  if ((ta >> kCountBits) == last) {
    *out_a = (int)(uint32_t)(ta + a);
    scratch[0] = 0ull;
  }
  if ((tb >> kCountBits) == last) {
    *out_b = (int)(uint32_t)(tb + b);
    scratch[1] = 0ull;
  }
}

}  // namespace

// A grid-wide sum in one launch, with no memset before it: F1 filter_mark
// (closure_filter_kernels.cu), P2 power_account
// (closure_power_kernels.cu) and L1 list_emit's landed count
// (list_kernels.cu); and, with nothing to sum, the last block of P3
// power_poison. The scratch is one 64-bit word: the sum in
// its low 40 bits, the tickets taken in its high 24. Every block adds its
// value and one ticket in a single atomic, so the block that takes the
// last ticket sees every other block's value in what the atomic returns
// (no fence, no second round trip); it stores the sum and returns the
// scratch to zero. The scratch is zeroed once, when the wrapper allocates
// it (engine/cuda_ops.py grid_scratch, one per device and stream):
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

}  // namespace

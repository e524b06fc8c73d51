// The hash-table probes every kernel of keto_tpu_torch shares: the
// snapshot builder's hash (murmur3 fmix32 chained from a golden-ratio
// seed) and the double-hash bucket sequence of keto_tpu/engine/kernel.py
// _bucket_rows (:227), read 16 lanes at a time so that one round of loads
// is one coalesced 256-byte bucket row under the bucketized layout. The
// edge-table chunk and match are K1's and C1's: each loads its rounds
// before it compares any.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kEmpty = -1;
// threads that share one probe task: 16 lanes x 16 B = one 256 B bucket
// row per load round
constexpr int kGroup = 16;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// mask of the 16 lanes of this thread's probe group inside its warp
__device__ __forceinline__ unsigned group_mask() {
  return 0xFFFFu << (threadIdx.x & 16);
}

// h1 of a key of `n` int lanes, and the odd stride h2 of its sequence
__device__ __forceinline__ uint32_t key_hash(const int* key, int n) {
  uint32_t h = kGolden;
  for (int k = 0; k < n; ++k) h = mix32(h ^ (uint32_t)key[k]);
  return h;
}

__device__ __forceinline__ uint32_t stride_hash(uint32_t h1) {
  return mix32(h1 ^ kGolden) | 1u;
}

// chunk c (16 bytes) of a task's probe sequence over a packed [cap, 8]
// edge table: row c / per_row of the double-hash sequence; zero past total
__device__ __forceinline__ int4 edge_chunk(const int4* __restrict__ pack, uint32_t nb,
                                           int per_row, int total, int c, uint32_t h1,
                                           uint32_t h2) {
  if (c >= total) return make_int4(0, 0, 0, 0);
  const int r = c / per_row;
  const uint32_t b = (h1 + (uint32_t)r * h2) & (nb - 1u);
  return __ldg(pack + (size_t)b * per_row + (c - r * per_row));
}

// folds chunk c (loaded as x) into the group's (found, max value): even
// lanes hold lanes 0-3 of a slot, odd lanes lanes 4-7; every lane of the
// group calls it
__device__ __forceinline__ void edge_match(int4 x, int c, int total, const int key[5],
                                           int lane, unsigned gmask, bool& f, int& v) {
  const bool part = (lane & 1) == 0
      ? (x.x == key[0] && x.y == key[1] && x.z == key[2] && x.w == key[3])
      : (x.x == key[4]);
  const bool other = __shfl_xor_sync(gmask, (int)part, 1) != 0;
  if ((lane & 1) && c < total && part && other) {
    f = true;
    v = max(v, x.y);  // lane 5 of the slot
  }
}

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

}  // namespace

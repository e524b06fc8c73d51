// The hash-table probes every kernel of keto_tpu_torch shares: the
// snapshot builder's hash (murmur3 fmix32 chained from a golden-ratio
// seed) and the double-hash bucket sequence of keto_tpu/engine/kernel.py
// _bucket_rows (:227), read 16 lanes at a time so that one round of loads
// is one coalesced 256-byte bucket row under the bucketized layout.

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

// Whole-row match of a 5-int key in a packed [cap, 8] edge table (lanes
// obj, rel, skind, sa, sb, val, 0, 0): found, and the largest value
// lane 5 of a matching slot holds (kEmpty when none). Every lane of the
// group calls it and gets the group's result.
__device__ __forceinline__ void probe_edge_table(
    const int4* __restrict__ pack, uint32_t nb, int spb, int pb, const int key[5],
    uint32_t h1, uint32_t h2, int lane, unsigned gmask, bool& found, int& val) {
  const int per_row = 2 * spb;  // int4 chunks per bucket row (8 ints a slot)
  const int total = pb * per_row;
  bool f = false;
  int v = kEmpty;
  for (int base = 0; base < total; base += kGroup) {
    const int c = base + lane;
    const bool in = c < total;
    int4 x = make_int4(0, 0, 0, 0);
    if (in) {
      const int r = c / per_row;
      const uint32_t b = (h1 + (uint32_t)r * h2) & (nb - 1u);
      x = __ldg(pack + (size_t)b * per_row + (c - r * per_row));
    }
    // even lanes hold lanes 0-3 of a slot, odd lanes lanes 4-7
    const bool part = (lane & 1) == 0
        ? (x.x == key[0] && x.y == key[1] && x.z == key[2] && x.w == key[3])
        : (x.x == key[4]);
    const bool other = __shfl_xor_sync(gmask, (int)part, 1) != 0;
    if ((lane & 1) && in && part && other) {
      f = true;
      v = max(v, x.y);  // lane 5 of the slot
    }
  }
  for (int off = kGroup / 2; off >= 1; off >>= 1) {
    f = (__shfl_xor_sync(gmask, (int)f, off) != 0) || f;
    v = max(v, __shfl_xor_sync(gmask, v, off));
  }
  found = f;
  val = v;
}

// (obj, rel) match in a packed [cap, 4] pair table (lanes obj, rel, v0,
// v1): the largest v0 and v1 of a matching slot (kEmpty when none), one
// 16-byte slot per lane per round. Every lane gets the group's result.
// C1's probe; K2 shares probes among equal keys (check_kernels.cu).
__device__ __forceinline__ void probe_pair_table(
    const int4* __restrict__ pack, uint32_t nb, int spb, int pb, int o, int r,
    int lane, unsigned gmask, int& v0, int& v1) {
  const uint32_t h1 = mix32(mix32(kGolden ^ (uint32_t)o) ^ (uint32_t)r);
  const uint32_t h2 = stride_hash(h1);
  const int total = pb * spb;  // one int4 chunk per slot
  int a = kEmpty, b = kEmpty;
  for (int base = 0; base < total; base += kGroup) {
    const int c = base + lane;
    if (c < total) {
      const int row = c / spb;
      const uint32_t bk = (h1 + (uint32_t)row * h2) & (nb - 1u);
      const int4 x = __ldg(pack + (size_t)bk * spb + (c - row * spb));
      if (x.x == o && x.y == r) {
        a = max(a, x.z);
        b = max(b, x.w);
      }
    }
  }
  for (int off = kGroup / 2; off >= 1; off >>= 1) {
    a = max(a, __shfl_xor_sync(gmask, a, off));
    b = max(b, __shfl_xor_sync(gmask, b, off));
  }
  v0 = a;
  v1 = b;
}

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

}  // namespace

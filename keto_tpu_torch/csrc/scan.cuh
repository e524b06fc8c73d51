// The multi-block scan of K3 and K4 (check_kernels.cu): reduce, then
// scan and scatter. A pass cuts its n items into at most kMaxTiles tiles;
// one launch writes each tile's sum; the next has every block sum the
// tile sums before its own (at most kMaxTiles ints, from L2), then scan
// its own tile in item order from that base. No launch over per-item data
// runs on one block, and the tiles are scanned in order, so a scatter
// lands where a serial scan would put it.
//
// The one copy of the block scans and sums: K3 and K4, X1's task-order
// offsets (its tiles are the keyed rank's blocks), L2, L3, L4 and X2
// (csrc/pool.cuh: every block's count scan, and the tile sums of a batch
// too wide for shared memory) and M3's bin pass use them; K3, K4, L2, L4 and X2
// also the 4-int load; K3, K4 and L2 the grid zeroing and the cause
// raise; L1, X1, L4 and X2 the shared memory opt-in below.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileThreads = 256;
constexpr int kMaxTiles = 1024;

// Items per tile for n items: `tile`, doubled until at most kMaxTiles
// tiles cover n (a tile is a whole number of rounds of 4 items a thread).
inline int scan_tile(long long n, int tile) {
  long long t = tile;
  while ((n + t - 1) / t > kMaxTiles) t *= 2;
  return (int)t;
}

inline int scan_tiles(long long n, int tile) {
  return n > 0 ? (int)((n + tile - 1) / tile) : 1;
}

// Exclusive prefix of v over the block's threads in thread order; *total
// gets the block's sum. Any block size that is a multiple of 32 (as for
// every helper here). Ends with a barrier, so the caller may call it
// again at once.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* warp_sums, unsigned* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    unsigned w = lane < nwarps ? warp_sums[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const unsigned prefix = wid > 0 ? warp_sums[wid - 1] : 0u;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return prefix + x - v;
}

// The block's sums of a and of b, in every thread: one shuffle reduction
// a warp, one barrier, each thread adding the warp sums, one barrier so
// warp_sums may be used again. warp_sums holds 64 words.
__device__ void block_sum2(unsigned& a, unsigned& b, unsigned* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xFFFFFFFFu, a, o);
    b += __shfl_xor_sync(0xFFFFFFFFu, b, o);
  }
  const int nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_sums[threadIdx.x >> 5] = a;
    warp_sums[32 + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  a = b = 0;
  for (int w = 0; w < nwarps; ++w) {
    a += warp_sums[w];
    b += warp_sums[32 + w];
  }
  __syncthreads();
}

__device__ unsigned block_sum(unsigned v, unsigned* warp_sums) {
  unsigned zero = 0;
  block_sum2(v, zero, warp_sums);
  return v;
}

// The sum of the tile sums before this block's tile, and in *all the sum
// of all n_tiles of them.
__device__ unsigned tile_base(const int* __restrict__ tile_sums, int n_tiles,
                              unsigned* warp_sums, unsigned* all) {
  unsigned before = 0, every = 0;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const unsigned c = (unsigned)tile_sums[t];
    every += c;
    if (t < (int)blockIdx.x) before += c;
  }
  block_sum2(before, every, warp_sums);
  *all = every;
  return before;
}

// the 4 ints of a from i0, zeros at or past hi; one 16-byte load where
// all four lie below hi and the address is aligned
__device__ __forceinline__ int4 load4(const int* __restrict__ a, int i0, int hi) {
  if (i0 + 3 < hi && (reinterpret_cast<uintptr_t>(a + i0) & 15) == 0) {
    return __ldg(reinterpret_cast<const int4*>(a + i0));
  }
  int4 v;
  v.x = i0 < hi ? __ldg(a + i0) : 0;
  v.y = i0 + 1 < hi ? __ldg(a + i0 + 1) : 0;
  v.z = i0 + 2 < hi ? __ldg(a + i0 + 2) : 0;
  v.w = i0 + 3 < hi ? __ldg(a + i0 + 3) : 0;
  return v;
}

// a[0, n) = 0 over the whole grid: the per-query causes, zeroed by the
// first pass of K3, K4 and L2 instead of a memset launch of their own
__device__ __forceinline__ void zero_grid(int* a, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) a[i] = 0;
}

// Raises query qi's cause to at least c (by max). The read first means a
// query that many items raise (a filter walk's one query) takes a few
// atomics, not one each.
__device__ __forceinline__ void raise_cause(int* cause, int qi, int c) {
  if (cause[qi] < c) atomicMax(&cause[qi], c);
}

// Sets a kernel's dynamic shared memory limit where it needs more than
// the default 48 KB; returns the CUDA error, or 0.
inline int allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// The per-query pool compaction of L4 (list_kernels.cu
// keto_list_pool_compact) and X2 (expand_kernels.cu keto_pool_compact):
// the packed result [offsets(B+1) | flag rows(B each) | stats(8) |
// pool(P rows of kCols ints)], query b's used buffer rows at pool rows
// offsets[b]:offsets[b+1], EMPTY past the used ones, offsets clamped to
// the pool and a query whose span crosses the pool's end flagged.
//
// Bound: bytes: B counts and flags and the used buffer rows read, the
// whole packed vector written. Design: one launch, no memset. Every
// block owns a run of the pool's 16-byte words (cut on absolute
// addresses: the pool starts 2B + 9 or 3B + 9 ints into the vector, so a
// word at either end may hold ints of another part, which stay scalar),
// scans the B clamped counts itself into shared memory and writes its
// slice of the header from that scan. Then each thread writes a word:
// two lanes search shared memory for the queries of the warp's first and
// last rows, each lane its four ints' queries between them (no search
// where a warp's 128 ints are one query's rows), four loads, one int4
// store; past the used rows EMPTY, with no search and no load. Counts of
// more queries than shared memory holds (no engine batch is that large)
// take two launches of scan.cuh's tile sums first, which write the
// header, and the same gather searching the header's offsets.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kPoolThreads = 256;
constexpr int kPoolStats = 8;
constexpr int kPoolEmpty = -1;
// the dynamic shared memory a block may take (the static part is under
// 1 KB)
constexpr size_t kPoolMaxSmem = 232448 - 1024;
// a block's tile covers at least B / kPoolCountsPerInt pool ints, so the
// counts every block reads stay within kPoolCountsPerInt times its writes
constexpr int kPoolCountsPerInt = 4;

template <int kCols>
struct PoolCols {
  const int* col[kCols];
};

inline long long pool_round4(long long n) { return (n + 3) & ~3LL; }

// a block's B inclusive query ends, when it scans them
inline size_t pool_smem_bytes(int B) { return (size_t)pool_round4(B) * sizeof(int); }

inline bool pool_scans_in_block(int B) { return pool_smem_bytes(B) <= kPoolMaxSmem; }

// The inclusive ends of queries [lo, hi) from carry on, counts clamped to
// [0, cap]: four consecutive counts a thread, block_exclusive_scan a
// round of 4 * blockDim. Writes ends[b - lo] (a whole int4 from b, so
// ends holds round4(hi - lo) ints) when ends is given, and the header of
// queries [h_lo, h_hi): offsets clamped to P, and the flags from
// Flags::load(b) and whether the span crosses P (Flags::write).
template <class Flags>
__device__ void pool_scan(const int* __restrict__ counts, int lo, int hi, int cap,
                          unsigned carry, int* ends, int h_lo, int h_hi, const Flags& flags,
                          int B, int P, int* out, unsigned* warp_sums) {
  for (int base = lo; base < hi; base += 4 * blockDim.x) {
    const int i = base + 4 * threadIdx.x;
    int4 c = load4(counts, i, hi);
    c.x = min(max(c.x, 0), cap);
    c.y = min(max(c.y, 0), cap);
    c.z = min(max(c.z, 0), cap);
    c.w = min(max(c.w, 0), cap);
    // the header's flag inputs, read before the scan so no barrier waits
    // on them
    int pre[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = i + k;
      pre[k] = b < hi && b >= h_lo && b < h_hi ? flags.load(b) : 0;
    }
    unsigned all;
    const unsigned run =
        carry + block_exclusive_scan((unsigned)(c.x + c.y + c.z + c.w), warp_sums, &all);
    carry += all;
    if (i >= hi) continue;
    const int cnt[4] = {c.x, c.y, c.z, c.w};
    int e[4];
    e[0] = (int)(run + (unsigned)c.x);
    e[1] = e[0] + c.y;
    e[2] = e[1] + c.z;
    e[3] = e[2] + c.w;
    if (ends) *reinterpret_cast<int4*>(ends + (i - lo)) = make_int4(e[0], e[1], e[2], e[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = i + k;
      if (b < hi && b >= h_lo && b < h_hi) {
        out[b + 1] = min(e[k], P);
        flags.write(out + B + 1, B, b, pre[k], e[k] > P && cnt[k] > 0);
      }
    }
  }
}

// wide batches, pass 1: each tile's sum of clamped counts
__global__ void __launch_bounds__(kPoolThreads) pool_tile_sums_kernel(
    const int* __restrict__ counts, int B, int cap, int tile, int* __restrict__ tile_sums) {
  __shared__ unsigned warp_sums[64];
  const int lo = blockIdx.x * tile;
  const int hi = min(B, lo + tile);
  unsigned s = 0;
  for (int i = lo + 4 * threadIdx.x; i < hi; i += 4 * blockDim.x) {
    const int4 c = load4(counts, i, hi);
    s += min(max(c.x, 0), cap) + min(max(c.y, 0), cap) + min(max(c.z, 0), cap) +
         min(max(c.w, 0), cap);
  }
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = (int)s;
}

// wide batches, pass 2: each tile's header from the tile sums before it
template <class Flags>
__global__ void __launch_bounds__(kPoolThreads) pool_header_kernel(
    const int* __restrict__ counts, int B, int cap, int tile,
    const int* __restrict__ tile_sums, int n_tiles, Flags flags, int P, int* __restrict__ out) {
  __shared__ unsigned warp_sums[64];
  unsigned all;
  const unsigned before = tile_base(tile_sums, n_tiles, warp_sums, &all);
  const int lo = blockIdx.x * tile;
  const int hi = min(B, lo + tile);
  pool_scan(counts, lo, hi, cap, before, (int*)nullptr, lo, hi, flags, B, P, out, warp_sums);
}

// #{b < B : ends[b] <= r}: a branchless search from step0, the largest
// power of two <= B, down.
__device__ __forceinline__ int pool_seg(const int* ends, int B, int step0, int r) {
  int seg = 0;
  for (int step = step0; step > 0; step >>= 1) {
    if (seg + step <= B && ends[seg + step - 1] <= r) seg += step;
  }
  return seg;
}

// The pool and the stats, and with kScan the header: every block scans
// the counts into shared memory and writes its slice of the header;
// without, the header's offsets (clamped to P, which no used row reaches)
// are the ends searched. A thread writes one 16-byte word a round: two
// lanes search the queries of the warp's first and last rows, each lane
// its four ints' queries between them (none where they are one query),
// and reads their values from the buffers (a query's rows are contiguous
// there, so a warp's reads are too); EMPTY past the used rows, with no
// search and no load.
template <int kCols, bool kScan, class Flags>
__global__ void __launch_bounds__(kPoolThreads) pool_compact_kernel(
    PoolCols<kCols> cols, const int* __restrict__ counts, Flags flags,
    const int* __restrict__ stats, int B, int cap, int P, long long tile_words, int* out) {
  extern __shared__ int4 pool_ends4[];
  __shared__ unsigned warp_sums[32];
  const int hdr = (1 + Flags::kRows) * B + 1 + kPoolStats;
  const bool has_stat = blockIdx.x == 0 && threadIdx.x < kPoolStats;
  const int stat = has_stat ? stats[threadIdx.x] : 0;
  const int* ends = out + 1;
  if constexpr (kScan) {
    int* s_ends = reinterpret_cast<int*>(pool_ends4);
    const int slice = (B + gridDim.x - 1) / gridDim.x;
    const int h_lo = min(B, (int)blockIdx.x * slice);
    pool_scan(counts, 0, B, cap, 0u, s_ends, h_lo, min(B, h_lo + slice), flags, B, P, out,
              warp_sums);
    __syncthreads();
    ends = s_ends;
  }
  if (has_stat) out[hdr - kPoolStats + threadIdx.x] = stat;
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = 0;

  int* pool = out + hdr;
  const long long n_ints = (long long)P * kCols;
  const long long used = (long long)min(max(ends[B - 1], 0), P) * kCols;
  const int step0 = 1 << (31 - __clz(B));
  // word w holds pool ints [4w - a, 4w - a + 4), at a 16-byte address
  const int a = (int)((reinterpret_cast<uintptr_t>(pool) >> 2) & 3);
  const long long n_words = n_ints > 0 ? (n_ints + a + 3) >> 2 : 0;
  const long long w_end = min(n_words, (blockIdx.x + 1LL) * tile_words);
  const int lane = threadIdx.x & 31;
  // the loop is warp-uniform: a warp goes on while its first word is the
  // block's
  for (long long w = blockIdx.x * tile_words + threadIdx.x; w - lane < w_end; w += blockDim.x) {
    const long long p0 = 4 * w - a;
    const long long pw = p0 - 4 * lane;  // the warp's first int
    int v[4] = {kPoolEmpty, kPoolEmpty, kPoolEmpty, kPoolEmpty};
    if (used > 0 && pw < used) {
      // the queries of the warp's first and last used rows, by lanes 0 and
      // 31; each lane's rows lie between, most often in one query
      const int r_first = (int)(max(pw, 0LL) / kCols);
      const int r_last = (int)(min(pw + 127, used - 1) / kCols);
      int s = 0;
      if (lane == 0 || lane == 31) s = pool_seg(ends, B, step0, lane == 0 ? r_first : r_last);
      const int lo = __shfl_sync(0xFFFFFFFFu, s, 0);
      const int hi = __shfl_sync(0xFFFFFFFFu, s, 31);
      int r[4], seg[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r[k] = (int)(min(max(p0 + k, 0LL), used - 1) / kCols);
        seg[k] = lo;
      }
      if (hi > lo) {
        for (int step = 1 << (31 - __clz(hi - lo)); step > 0; step >>= 1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (seg[k] + step <= hi && ends[seg[k] + step - 1] <= r[k]) seg[k] += step;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long p = p0 + k;
        const int b = min(seg[k], B - 1);
        const long long src = (long long)b * cap + (r[k] - (b > 0 ? ends[b - 1] : 0));
        const int c = (int)(min(max(p, 0LL), used - 1) % kCols);
        const int* col = cols.col[0];
#pragma unroll
        for (int j = 1; j < kCols; ++j) col = c == j ? cols.col[j] : col;
        if (p >= 0 && p < used) v[k] = __ldg(col + src);
      }
    }
    if (w >= w_end) continue;
    if (p0 >= 0 && p0 + 3 < n_ints) {
      *reinterpret_cast<int4*>(pool + p0) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (p0 + k >= 0 && p0 + k < n_ints) pool[p0 + k] = v[k];
      }
    }
  }
}

// Launches the compaction of B queries' buffers (cap rows each, kCols
// columns) into a pool of P rows. tile_sums: kMaxTiles ints, read only
// when pool_scans_in_block(B) is false (keto_pool_scratch).
template <int kCols, class Flags>
int pool_compact(PoolCols<kCols> cols, const int* counts, Flags flags, const int* stats, int B,
                 int cap, int P, int* tile_sums, int* out, cudaStream_t st) {
  if (B <= 0 || P < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const bool scan = pool_scans_in_block(B);
  if (!scan && !tile_sums) return (int)cudaErrorInvalidValue;
  const long long hdr = (1LL + Flags::kRows) * B + 1 + kPoolStats;
  const long long n_ints = (long long)P * kCols;
  const int a = (int)((reinterpret_cast<uintptr_t>(out + hdr) >> 2) & 3);
  const long long n_words = n_ints > 0 ? (n_ints + a + 3) / 4 : 0;
  long long tile = kPoolThreads;
  while ((n_words + tile - 1) / tile > kMaxTiles ||
         (scan && 4 * tile * kPoolCountsPerInt < B)) {
    tile *= 2;
  }
  const int blocks = n_words > 0 ? (int)((n_words + tile - 1) / tile) : 1;
  if (scan) {
    const size_t smem = pool_smem_bytes(B);
    auto kernel = pool_compact_kernel<kCols, true, Flags>;
    const int rc = allow_smem((const void*)kernel, smem);
    if (rc != 0) return rc;
    kernel<<<blocks, kPoolThreads, smem, st>>>(cols, counts, flags, stats, B, cap, P, tile,
                                               out);
  } else {
    const int t = scan_tile(B, 4 * kPoolThreads);
    const int nt = scan_tiles(B, t);
    pool_tile_sums_kernel<<<nt, kPoolThreads, 0, st>>>(counts, B, cap, t, tile_sums);
    pool_header_kernel<Flags><<<nt, kPoolThreads, 0, st>>>(counts, B, cap, t, tile_sums, nt,
                                                           flags, P, out);
    pool_compact_kernel<kCols, false, Flags><<<blocks, kPoolThreads, 0, st>>>(
        cols, counts, flags, stats, B, cap, P, tile, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

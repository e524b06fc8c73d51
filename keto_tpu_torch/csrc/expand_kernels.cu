// The two expand-only phases of keto_tpu_torch's batched Expand, for
// Hopper (sm_90a), with a plain C interface bound by ctypes
// (keto_tpu_torch/engine/cuda_ops.py). The row and dirty probes and the
// next-frontier dedupe reuse K2 and K4 (check_kernels.cu). Every kernel
// launches on the caller's stream, allocates nothing, and computes exactly
// what its plain PyTorch version in keto_tpu_torch/engine/expand_kernel.py
// computes; each entry point returns cudaGetLastError().
//
// X1 keto_expand_emit   replaces keto_tpu/engine/expand_kernel.py
//                       expand_kernel's step body between the probes and
//                       the dedupe: row spans, per-query bump allocation,
//                       overflow / dirty / truncation flags, the 4F
//                       emission map, the edge-buffer scatter and the
//                       child candidates.
// X2 keto_pool_compact  replaces expand_kernel_packed's tail: the pool
//                       scan, the pool gather and the packed result, in
//                       one launch.
//
// X1's bump allocation is csrc/keyed_rank.cuh's keyed scan, shared with
// L1; X2 is csrc/pool.cuh's compaction, shared with L4; the block scans
// come from csrc/scan.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed_rank.cuh"
#include "pool.cuh"
#include "scan.cuh"

namespace {

constexpr int kEmpty = -1;
constexpr int kDirtyForExpand = 1;
constexpr int kEmitPerTask = 4;
constexpr int kThreads = 256;

constexpr int kGatherSample = 1024;  // offsets X1's gather stages a block

// The number of entries of the nondecreasing a[0:n] that are <= j
// (searchsorted side=right).
__device__ __forceinline__ int count_le(const int* a, int n, int j) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= j) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The last index in [lo, hi) of the nondecreasing a whose entry is <= j,
// given a[lo] <= j.
__device__ __forceinline__ int last_le_from(const int* a, int lo, int hi, int j) {
  int l = lo + 1;
  while (l < hi) {
    const int mid = (l + hi) >> 1;
    if (a[mid] <= j) l = mid + 1; else hi = mid;
  }
  return l - 1;
}

// ---------------------------------------------------------------------------
// X1 expand_emit
//
// Bound: bytes, and latency at these sizes: per step it reads the [F]
// task columns and the rows of the tasks that emit, writes their edges
// into the buffers and the [4F] candidate columns; a few hundred KB.
// Design: five launches, none of them over per-task data on one block.
// Passes 1-3 are csrc/keyed_rank.cuh's keyed scan with weight = the
// task's row length (key t_q where the task emits), from eb_count: the
// JAX kernel's stable sort by query and segmented scan without a sort.
// Pass 1 computes each task's row span and gates (a dirty row flags the
// query) and its count, written for pass 3 (-1 where it does not emit),
// and the chunk sums. Pass 2 scans them per query. Pass 3 gives each
// emitting task its first edge slot, drops a task whose row does not fit
// (it flags its query, but its count still shifts the later tasks of its
// query) and writes each block's sum of the emitted counts. Pass 4 scans
// the emitted counts in task order over the same tiles (csrc/scan.cuh's
// tile bases), flags truncated rows and adds each task's landed edges to
// its query's count. Pass 5 gives each of the 4F emission slots its task
// (a search of 1,024 offsets staged in shared memory, then of the few
// between two of them in global memory), gathers the edge, writes the
// buffers and the child candidate, every column as the JAX kernel fills
// it, including the out-of-range lanes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void row_span(const int* __restrict__ row_ptr, int n_rows, int row,
                                         int& start, int& len) {
  if (row == kEmpty) {
    start = 0;
    len = 0;
    return;
  }
  const int rc = min(max(row, 0), n_rows);
  start = row_ptr[rc];
  len = row_ptr[min(rc + 1, n_rows)] - start;
}

template <bool kShared>
__global__ void expand_emit_count_kernel(
    const int* __restrict__ t_q, const int* __restrict__ t_depth,
    const uint8_t* __restrict__ live, const int* __restrict__ row,
    const int* __restrict__ dirty, const int* __restrict__ row_ptr, int n_rows, int F, int B,
    int rounds, int* __restrict__ table, uint8_t* __restrict__ needs_host,
    int* __restrict__ start_out, int* __restrict__ cnt_out) {
  extern __shared__ __align__(16) int smem[];
  const WarpCounts<kShared> counts = warp_counts<kShared>(smem, table, B);
  const int lo = ((int)blockIdx.x * (int)(blockDim.x >> 5) + (int)(threadIdx.x >> 5)) *
                 rounds * 32 + (int)(threadIdx.x & 31);
  // a group's first-level columns; the next group's are in flight while
  // a group's rows are read and ranked
  struct Cols {
    int q[kRankUnroll], row[kRankUnroll], depth[kRankUnroll], dirty[kRankUnroll];
    bool live[kRankUnroll];
  } cur, next;
  auto load = [&](int r0, Cols& c) {
#pragma unroll
    for (int u = 0; u < kRankUnroll; ++u) {
      const int i = lo + (r0 + u) * 32;
      const bool in = r0 + u < rounds && i < F;
      c.q[u] = in ? t_q[i] : 0;
      c.row[u] = in ? row[i] : kEmpty;
      c.depth[u] = in ? t_depth[i] : 0;
      c.live[u] = in && live[i];
      c.dirty[u] = in ? dirty[i] : 0;
    }
  };
  load(0, cur);
  rank_begin<kShared>(smem, table, B, true);  // while the first loads are in flight
  for (int r0 = 0; r0 < rounds; r0 += kRankUnroll) {
    load(r0 + kRankUnroll, next);
    int start[kRankUnroll], len[kRankUnroll];
    bool emit[kRankUnroll];
#pragma unroll
    for (int u = 0; u < kRankUnroll; ++u) {
      row_span(row_ptr, n_rows, cur.row[u], start[u], len[u]);
      emit[u] = cur.live[u] && cur.depth[u] >= 2;
      if (emit[u] && (max(cur.dirty[u], 0) & kDirtyForExpand)) {
        needs_host[cur.q[u]] = 1;
        emit[u] = false;
      }
    }
#pragma unroll
    for (int u = 0; u < kRankUnroll; ++u) {
      const int i = lo + (r0 + u) * 32;
      if (r0 + u < rounds && i < F) {
        start_out[i] = start[u];
        cnt_out[i] = emit[u] ? len[u] : -1;
      }
      rank_round<false>(emit[u] ? cur.q[u] : -1, emit[u] ? (unsigned)len[u] : 0u, counts);
    }
    cur = next;
  }
  rank_end<kShared>(smem, table, B);
}

__global__ void expand_emit_scan_kernel(int* __restrict__ table, int B, int chunks, int group,
                                        const int* __restrict__ eb_count) {
  __shared__ unsigned sums[kRankScanThreads / 32];
  const int k = rank_scan_key_of(group);
  rank_scan_key(table, k, B, chunks, group, k < B ? (unsigned)eb_count[k] : 0u, sums);
}

template <bool kShared>
__global__ void expand_emit_rank_kernel(
    const int* __restrict__ t_q, const int* __restrict__ cnt, int F, int B, int E,
    int rounds, int* __restrict__ table, uint8_t* __restrict__ needs_host,
    int* __restrict__ alloc_out, uint8_t* __restrict__ emit_out,
    int* __restrict__ tile_sums) {
  extern __shared__ __align__(16) int smem[];
  __shared__ unsigned warp_sums[64];
  const WarpCounts<kShared> counts = warp_counts<kShared>(smem, table, B);
  const int lo = ((int)blockIdx.x * (int)(blockDim.x >> 5) + (int)(threadIdx.x >> 5)) *
                 rounds * 32 + (int)(threadIdx.x & 31);
  unsigned emitted = 0;
  int qq[kRankUnroll], c[kRankUnroll], next_q[kRankUnroll], next_c[kRankUnroll];
  auto load = [&](int r0, int* qv, int* cv) {
#pragma unroll
    for (int u = 0; u < kRankUnroll; ++u) {
      const int i = lo + (r0 + u) * 32;
      const bool in = r0 + u < rounds && i < F;
      cv[u] = in ? cnt[i] : -1;
      qv[u] = in ? t_q[i] : 0;
    }
  };
  load(0, qq, c);
  rank_begin<kShared>(smem, table, B, false);  // while the first loads are in flight
  for (int r0 = 0; r0 < rounds; r0 += kRankUnroll) {
    load(r0 + kRankUnroll, next_q, next_c);  // in flight while this group is ranked
#pragma unroll
    for (int u = 0; u < kRankUnroll; ++u) {
      const int i = lo + (r0 + u) * 32;
      const bool takes = c[u] >= 0;
      const int alloc =
          (int)rank_round<false>(takes ? qq[u] : -1, takes ? (unsigned)c[u] : 0u, counts);
      const bool emit = takes && (long long)alloc + c[u] <= E;
      if (takes && !emit) needs_host[qq[u]] = 1;  // the row does not fit: overflow
      if (r0 + u < rounds && i < F) {
        alloc_out[i] = takes ? alloc : 0;
        emit_out[i] = emit;
      }
      emitted += emit ? (unsigned)c[u] : 0u;
      qq[u] = next_q[u];
      c[u] = next_c[u];
    }
  }
  emitted = block_sum(emitted, warp_sums);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = (int)emitted;
}

__global__ void expand_emit_offsets_kernel(
    const int* __restrict__ t_q, const int* __restrict__ cnt,
    const uint8_t* __restrict__ emit, int F, int tile, const int* __restrict__ tile_sums,
    int n_tiles, int* __restrict__ eb_count, uint8_t* __restrict__ needs_host,
    int* __restrict__ offsets_out, int* __restrict__ total_out,
    int* __restrict__ emitted_out) {
  __shared__ unsigned warp_sums[64];
  const int G = kEmitPerTask * F;
  const int lo_tile = (int)blockIdx.x * tile;
  const int hi_tile = min(F, lo_tile + tile);
  const int per = (tile + blockDim.x - 1) / blockDim.x;
  const int lo = min(hi_tile, lo_tile + (int)threadIdx.x * per);
  const int hi = min(hi_tile, lo + per);
  // the thread's first task is in flight while the tile sums are read
  const int first = lo < hi && emit[lo] ? cnt[lo] : 0;
  unsigned all;
  const unsigned base = tile_base(tile_sums, n_tiles, warp_sums, &all);
  unsigned s = (unsigned)first;
  for (int i = lo + 1; i < hi; ++i) s += emit[i] ? (unsigned)cnt[i] : 0u;
  unsigned block_total;
  unsigned off = base + block_exclusive_scan(s, warp_sums, &block_total);
  const int lim = min((int)all, G);
  for (int i = lo; i < hi; ++i) {
    const bool e = emit[i];
    const int fc = i == lo ? first : e ? cnt[i] : 0;
    offsets_out[i] = (int)off;
    if (e) {
      const int q = t_q[i];
      if ((int)off + fc > G) needs_host[q] = 1;
      const int landed = min(max(lim - (int)off, 0), fc);
      if (landed > 0) atomicAdd(&eb_count[q], landed);
    }
    off += (unsigned)fc;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *total_out = (int)all;
    *emitted_out = lim;
  }
}

__global__ void expand_emit_gather_kernel(
    const int* __restrict__ offsets, const int* __restrict__ total, int F, int B, int E,
    const int* __restrict__ start, const int* __restrict__ alloc,
    const uint8_t* __restrict__ emit, const int* __restrict__ t_q,
    const int* __restrict__ t_obj, const int* __restrict__ t_rel,
    const int* __restrict__ t_depth, const int* __restrict__ f_skind,
    const int* __restrict__ f_sa, const int* __restrict__ f_sb, int n_edges,
    int* __restrict__ eb_pobj, int* __restrict__ eb_prel, int* __restrict__ eb_skind,
    int* __restrict__ eb_sa, int* __restrict__ eb_sb, int* __restrict__ c_q,
    int* __restrict__ c_obj, int* __restrict__ c_rel, int* __restrict__ c_depth,
    uint8_t* __restrict__ c_valid) {
  // the block stages every step-th offset, searches them, then at most
  // step - 1 offsets in global memory
  __shared__ int sample[kGatherSample];
  const int step = (F + kGatherSample - 1) / kGatherSample;
  const int n_sample = (F + step - 1) / step;
  for (int s = threadIdx.x; s < n_sample; s += blockDim.x) sample[s] = offsets[s * step];
  __syncthreads();
  const int G = kEmitPerTask * F;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= G) return;
  const int p = count_le(sample, n_sample, j);
  const int seg = p == 0 ? 0 : last_le_from(offsets, (p - 1) * step, min(F, p * step), j);
  const int within = j - offsets[seg];
  const bool in_range = j < min(*total, G);
  int e = start[seg] + within;
  e = min(max(e, 0), max(n_edges - 1, 0));
  int sk = 0, sa = 0, sb = 0;
  if (n_edges > 0) {
    sk = f_skind[e];
    sa = f_sa[e];
    sb = f_sb[e];
  }
  const int q = t_q[seg];
  const int cd = t_depth[seg] - 1;
  if (in_range) {
    const long long dest = (long long)q * E + alloc[seg] + within;
    if (dest >= 0 && dest < (long long)B * E) {
      eb_pobj[dest] = t_obj[seg];
      eb_prel[dest] = t_rel[seg];
      eb_skind[dest] = sk;
      eb_sa[dest] = sa;
      eb_sb[dest] = sb;
    }
  }
  c_q[j] = q;
  c_obj[j] = sa;
  c_rel[j] = sb;
  c_depth[j] = cd;
  c_valid[j] = in_range && sk == 1 && cd >= 2 && emit[seg];
}

// ---------------------------------------------------------------------------
// X2 pool_compact
//
// csrc/pool.cuh's compaction with five columns (L4's body); the header
// holds each query's root flag and its needs_host flag ORed with the
// pool's overflow, as int32.
// ---------------------------------------------------------------------------

struct ExpandPoolFlags {
  static constexpr int kRows = 2;
  const uint8_t* root;
  const uint8_t* needs_host;
  __device__ int load(int b) const { return __ldg(root + b) | __ldg(needs_host + b) << 1; }
  __device__ void write(int* flags, int B, int b, int pre, bool over) const {
    flags[b] = pre & 1;
    flags[B + b] = (pre >> 1) | over;
  }
};

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

// X1's scratch, one buffer of keto_expand_emit_scratch(F, B) ints: the
// keyed-rank table (first, so 16-byte aligned), its tiles' sums, start,
// alloc, cnt and offsets F ints each, total one int and emit F bytes,
// each from a multiple of 4 ints. Returns the ints; fills *x from base.
struct EmitScratch {
  int *table, *tile_sums, *start, *alloc, *cnt, *offsets, *total;
  uint8_t* emit;
};

long long emit_scratch(int* base, int F, int B, const RankShape& s, EmitScratch* x) {
  long long at = 0;
  auto take = [&](long long n) {
    int* p = base ? base + at : nullptr;
    at += (n + 3) & ~3LL;
    return p;
  };
  EmitScratch y;
  y.table = take(rank_table_ints(s, B));
  y.tile_sums = take(s.blocks);
  y.start = take(F);
  y.alloc = take(F);
  y.cnt = take(F);
  y.offsets = take(F);
  y.total = take(1);
  y.emit = reinterpret_cast<uint8_t*>(take((F + 3) / 4));
  if (x) *x = y;
  return at;
}

}  // namespace

extern "C" {

long long keto_expand_emit_scratch(int F, int B) {
  return F > 0 && B > 0 ? emit_scratch(nullptr, F, B, rank_shape(F, B), nullptr) : 0;
}

// Scratch: keto_expand_emit_scratch(F, B) ints; emitted one int.
int keto_expand_emit(
    const int* t_q, const int* t_obj, const int* t_rel, const int* t_depth,
    const uint8_t* live, const int* row, const int* dirty, const int* row_ptr, int n_rows,
    const int* f_skind, const int* f_sa, const int* f_sb, int n_edges, int F, int B, int E,
    int* eb_pobj, int* eb_prel, int* eb_skind, int* eb_sa, int* eb_sb, int* eb_count,
    uint8_t* needs_host, int* scratch, int* emitted, int* c_q, int* c_obj, int* c_rel,
    int* c_depth, uint8_t* c_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const RankShape s = rank_shape(F, B);
  EmitScratch x;
  emit_scratch(scratch, F, B, s, &x);
  const size_t smem = rank_smem(s, B);
  const int threads = 32 * s.warps;
  if (s.shared) {
    int rc = allow_smem((const void*)expand_emit_count_kernel<true>, smem);
    if (rc == 0) rc = allow_smem((const void*)expand_emit_rank_kernel<true>, smem);
    if (rc != 0) return rc;
    expand_emit_count_kernel<true><<<s.blocks, threads, smem, st>>>(
        t_q, t_depth, live, row, dirty, row_ptr, n_rows, F, B, s.rounds, x.table, needs_host,
        x.start, x.cnt);
  } else {
    expand_emit_count_kernel<false><<<s.blocks, threads, 0, st>>>(
        t_q, t_depth, live, row, dirty, row_ptr, n_rows, F, B, s.rounds, x.table, needs_host,
        x.start, x.cnt);
  }
  expand_emit_scan_kernel<<<rank_scan_blocks(s, B), kRankScanThreads, 0, st>>>(
      x.table, B, s.warps * s.blocks, s.group, eb_count);
  if (s.shared) {
    expand_emit_rank_kernel<true><<<s.blocks, threads, smem, st>>>(
        t_q, x.cnt, F, B, E, s.rounds, x.table, needs_host, x.alloc, x.emit, x.tile_sums);
  } else {
    expand_emit_rank_kernel<false><<<s.blocks, threads, 0, st>>>(
        t_q, x.cnt, F, B, E, s.rounds, x.table, needs_host, x.alloc, x.emit, x.tile_sums);
  }
  expand_emit_offsets_kernel<<<s.blocks, kThreads, 0, st>>>(
      t_q, x.cnt, x.emit, F, threads * s.rounds, x.tile_sums, s.blocks, eb_count, needs_host,
      x.offsets, x.total, emitted);
  const int G = kEmitPerTask * F;
  expand_emit_gather_kernel<<<blocks_for(G, kThreads), kThreads, 0, st>>>(
      x.offsets, x.total, F, B, E, x.start, x.alloc, x.emit, t_q, t_obj, t_rel, t_depth,
      f_skind, f_sa, f_sb, n_edges, eb_pobj, eb_prel, eb_skind, eb_sa, eb_sb, c_q, c_obj,
      c_rel, c_depth, c_valid);
  return (int)cudaGetLastError();
}

// The int32 scratch of L4 and X2 for B queries: the tile sums of a batch
// whose counts one block's shared memory cannot hold, else none.
long long keto_pool_scratch(int B) { return B > 0 && !pool_scans_in_block(B) ? kMaxTiles : 0; }

// Scratch: keto_pool_scratch(B) ints (none on the engines' batches).
int keto_pool_compact(
    const int* eb_pobj, const int* eb_prel, const int* eb_skind, const int* eb_sa,
    const int* eb_sb, const int* eb_count, const uint8_t* root, const uint8_t* needs_host,
    const int* stats, int B, int E, int P, int* scratch, int* out, void* stream) {
  return pool_compact(PoolCols<5>{{eb_pobj, eb_prel, eb_skind, eb_sa, eb_sb}}, eb_count,
                      ExpandPoolFlags{root, needs_host}, stats, B, E, P, scratch, out,
                      (cudaStream_t)stream);
}

}  // extern "C"

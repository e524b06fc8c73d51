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
//                       scan, the pool gather and the packed result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kDirtyForExpand = 1;
constexpr int kEmitPerTask = 4;
constexpr int kScanThreads = 1024;
constexpr int kThreads = 256;

// Block-wide exclusive scan (any block size that is a multiple of 32).
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* warp_sums) {
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
  return prefix + x - v;
}

// Index of the last entry of the nondecreasing a[0:n] that is <= j
// (searchsorted side=right, minus one), clamped into [0, n).
__device__ __forceinline__ int last_le(const int* a, int n, int j) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= j) lo = mid + 1; else hi = mid;
  }
  return min(max(lo - 1, 0), n - 1);
}

// ---------------------------------------------------------------------------
// X1 expand_emit
//
// Bound: bytes, and latency at these sizes: per step it reads the [F]
// task columns and the rows of the tasks that emit, writes their edges
// into the buffers and the [4F] candidate columns; a few hundred KB.
// Design: pass 1 is one block. Its threads compute each task's row span,
// gates and count into shared memory; then one warp walks the tasks in
// index order, 32 at a time, and gives each task its first edge slot:
// lanes of the same query find each other with __match_any_sync, sum the
// counts of their lower lanes, and add the query's next free slot (kept
// in shared memory, loaded from eb_count once), which the group's highest
// lane then advances. That is the JAX kernel's stable
// sort by query and segmented scan without a sort: within a query, slots
// go in task-index order, and a task that overflows still shifts the
// later ones. The block then scans the emitted counts in thread-contiguous
// chunks (offsets in task order), flags truncated rows and adds each
// task's landed edges to its query's count. Pass 2 gives each of the 4F
// emission slots a binary search for its task, gathers the edge, writes
// the buffers and the child candidate, every column as the JAX kernel
// fills it, including the out-of-range lanes.
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

__global__ void emit_alloc_kernel(
    const int* __restrict__ t_q, const int* __restrict__ t_depth,
    const uint8_t* __restrict__ live, const int* __restrict__ row,
    const int* __restrict__ dirty, const int* __restrict__ row_ptr, int n_rows, int F,
    int B, int E, int* __restrict__ eb_count, uint8_t* __restrict__ needs_host,
    int* __restrict__ start_out, int* __restrict__ alloc_out, uint8_t* __restrict__ emit_out,
    int* __restrict__ offsets_out, int* __restrict__ total_out, int* __restrict__ emitted_out) {
  extern __shared__ int smem[];
  int* sc = smem;          // [F] emit ? count : -1, then emit after overflow ? count : -1
  int* sq = smem + F;      // [F] query of each task
  int* run = smem + 2 * F;  // [B] each query's next free edge slot
  __shared__ unsigned warp_sums[32];
  __shared__ int total_sh;
  const int t = threadIdx.x;

  for (int b = t; b < B; b += blockDim.x) run[b] = eb_count[b];
  for (int i = t; i < F; i += blockDim.x) {
    const int q = t_q[i];
    int start, len;
    row_span(row_ptr, n_rows, row[i], start, len);
    bool emit = live[i] && t_depth[i] >= 2;
    if (emit && (max(dirty[i], 0) & kDirtyForExpand)) {
      needs_host[q] = 1;
      emit = false;
    }
    sc[i] = emit ? len : -1;
    sq[i] = q;
    start_out[i] = start;
  }
  __syncthreads();

  if (t < 32) {
    const unsigned lower = (1u << t) - 1u;
    for (int base = 0; base < F; base += 32) {
      const int i = base + t;
      const bool in = i < F;
      const int c = in ? sc[i] : -1;
      // only tasks that emit take slots: the others add no count
      const bool takes = c >= 0;
      if (__ballot_sync(0xFFFFFFFFu, takes) == 0u) {
        if (in) emit_out[i] = 0;
        continue;
      }
      const int q = takes ? sq[i] : -1;
      const unsigned same = __match_any_sync(0xFFFFFFFFu, q);
      int before = 0;
      if (takes) {
        for (unsigned m = same & lower; m; m &= m - 1) before += sc[base + __ffs(m) - 1];
      }
      const int alloc = takes ? run[q] + before : 0;
      __syncwarp();
      bool emit = false;
      if (takes) {
        if (((same >> t) >> 1) == 0u) run[q] += before + c;  // highest lane of the group
        emit = alloc + c <= E;
        if (!emit) needs_host[q] = 1;  // the row does not fit: overflow
        sc[i] = emit ? c : -1;
      }
      if (in) {
        alloc_out[i] = alloc;
        emit_out[i] = emit;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  const int G = kEmitPerTask * F;
  const int chunk = (F + blockDim.x - 1) / blockDim.x;
  const int lo = min(F, t * chunk);
  const int hi = min(F, lo + chunk);
  unsigned s = 0;
  for (int i = lo; i < hi; ++i) s += (unsigned)max(sc[i], 0);
  unsigned off = block_exclusive_scan(s, warp_sums);
  if (t == (int)blockDim.x - 1) total_sh = (int)(off + s);
  __syncthreads();
  const int lim = min(total_sh, G);
  for (int i = lo; i < hi; ++i) {
    const int c = sc[i];
    const int fc = max(c, 0);
    offsets_out[i] = (int)off;
    if (c >= 0) {
      if ((int)off + fc > G) needs_host[sq[i]] = 1;
      const int landed = min(max(lim - (int)off, 0), fc);
      if (landed > 0) atomicAdd(&eb_count[sq[i]], landed);
    }
    off += (unsigned)fc;
  }
  if (t == 0) {
    *total_out = total_sh;
    *emitted_out = lim;
  }
}

__global__ void emit_gather_kernel(
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
  const int G = kEmitPerTask * F;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= G) return;
  const int seg = last_le(offsets, F, j);
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
// Bound: bytes: B counts and the used buffer rows read, the whole packed
// vector written (pool_cap rows of 5 ints, EMPTY past the used ones).
// Design: pass 1 is one block that scans the clamped counts in
// thread-contiguous chunks and writes the offsets (clamped to the pool),
// the root and needs_host flags (with the pool-overflow flag) and the
// stats; pass 2 gives each pool row a binary search for its query over
// the unclamped offsets and gathers its five columns.
// ---------------------------------------------------------------------------

__global__ void pool_scan_kernel(
    const int* __restrict__ eb_count, const uint8_t* __restrict__ root,
    const uint8_t* __restrict__ needs_host, const int* __restrict__ stats, int B, int E,
    int P, int* __restrict__ offs, int* __restrict__ out) {
  __shared__ unsigned warp_sums[32];
  const int t = threadIdx.x;
  const int chunk = (B + blockDim.x - 1) / blockDim.x;
  const int lo = min(B, t * chunk);
  const int hi = min(B, lo + chunk);
  unsigned s = 0;
  for (int b = lo; b < hi; ++b) s += (unsigned)min(max(eb_count[b], 0), E);
  unsigned run = block_exclusive_scan(s, warp_sums);
  int* out_offs = out;
  int* out_root = out + B + 1;
  int* out_needs = out + 2 * B + 1;
  for (int b = lo; b < hi; ++b) {
    const int c = min(max(eb_count[b], 0), E);
    const int end = (int)(run + (unsigned)c);
    offs[b + 1] = end;
    out_offs[b + 1] = min(end, P);
    out_root[b] = root[b];
    out_needs[b] = needs_host[b] || (end > P && c > 0);
    run += (unsigned)c;
  }
  if (t == 0) {
    offs[0] = 0;
    out_offs[0] = 0;
  }
  if (t < 8) out[3 * B + 1 + t] = stats[t];
}

__global__ void pool_gather_kernel(
    const int* __restrict__ offs, int B, int E, int P, const int* __restrict__ pobj,
    const int* __restrict__ prel, const int* __restrict__ skind, const int* __restrict__ sa,
    const int* __restrict__ sb, int* __restrict__ pool) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  // seg = #{b : offs[b + 1] <= j} (searchsorted side=right over offs[1:])
  int lo = 0, hi = B;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid + 1] <= j) lo = mid + 1; else hi = mid;
  }
  const int seg = lo;
  const int seg_c = min(seg, B - 1);
  const int within = j - offs[seg_c];
  const bool valid = j < offs[B] && seg < B;
  long long src = (long long)seg_c * E + within;
  src = min(max(src, 0LL), (long long)B * E - 1);
  int* row = pool + (size_t)j * 5;
  row[0] = valid ? pobj[src] : kEmpty;
  row[1] = valid ? prel[src] : kEmpty;
  row[2] = valid ? skind[src] : kEmpty;
  row[3] = valid ? sa[src] : kEmpty;
  row[4] = valid ? sb[src] : kEmpty;
}

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

int keto_expand_emit(
    const int* t_q, const int* t_obj, const int* t_rel, const int* t_depth,
    const uint8_t* live, const int* row, const int* dirty, const int* row_ptr, int n_rows,
    const int* f_skind, const int* f_sa, const int* f_sb, int n_edges, int F, int B, int E,
    int* eb_pobj, int* eb_prel, int* eb_skind, int* eb_sa, int* eb_sb, int* eb_count,
    uint8_t* needs_host, int* start, int* alloc, uint8_t* emit, int* offsets, int* total,
    int* emitted, int* c_q, int* c_obj, int* c_rel, int* c_depth, uint8_t* c_valid,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (2 * (size_t)F + (size_t)B);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(emit_alloc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  emit_alloc_kernel<<<1, kScanThreads, smem, st>>>(
      t_q, t_depth, live, row, dirty, row_ptr, n_rows, F, B, E, eb_count, needs_host,
      start, alloc, emit, offsets, total, emitted);
  const int G = kEmitPerTask * F;
  emit_gather_kernel<<<blocks_for(G, kThreads), kThreads, 0, st>>>(
      offsets, total, F, B, E, start, alloc, emit, t_q, t_obj, t_rel, t_depth, f_skind,
      f_sa, f_sb, n_edges, eb_pobj, eb_prel, eb_skind, eb_sa, eb_sb, c_q, c_obj, c_rel,
      c_depth, c_valid);
  return (int)cudaGetLastError();
}

int keto_pool_compact(
    const int* eb_pobj, const int* eb_prel, const int* eb_skind, const int* eb_sa,
    const int* eb_sb, const int* eb_count, const uint8_t* root, const uint8_t* needs_host,
    const int* stats, int B, int E, int P, int* offs, int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  pool_scan_kernel<<<1, kScanThreads, 0, st>>>(eb_count, root, needs_host, stats, B, E, P,
                                                offs, out);
  if (P > 0) {
    pool_gather_kernel<<<blocks_for(P, kThreads), kThreads, 0, st>>>(
        offs, B, E, P, eb_pobj, eb_prel, eb_skind, eb_sa, eb_sb, out + 3 * B + 1 + 8);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

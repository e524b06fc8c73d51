// The four list-only phases of keto_tpu_torch's batched ListObjects and
// ListSubjects, for Hopper (sm_90a), with a plain C interface bound by
// ctypes (keto_tpu_torch/engine/cuda_ops.py). The span, reverse-dirty and
// dirty-row probes and the next-frontier dedupe reuse K2 and K4
// (check_kernels.cu). Every kernel launches on the caller's stream,
// allocates nothing, and computes exactly what its plain PyTorch version
// in keto_tpu_torch/engine/reverse_kernel.py computes; each entry point
// returns cudaGetLastError().
//
// L1 keto_list_emit         replaces keto_tpu/engine/reverse_kernel.py
//                           _bump_emit and the result write of both
//                           step bodies.
// L2 keto_reverse_gather    replaces _list_objects_impl's predecessor
//                           expansion: inverted-entry counts, POISON,
//                           scan, truncation, segment map, rv_pack gather
//                           and the child rules.
// L3 keto_subjects_gather   replaces _list_subjects_impl's expansion: the
//                           same over the full-edge CSR and the rewrite
//                           instructions, with the result mask.
// L4 keto_list_pool_compact replaces the packed tail of
//                           list_objects_kernel_packed and
//                           list_subjects_kernel_packed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kCauseFrontierOverflow = 2;
constexpr int kCauseIslandHost = 8;
constexpr int kInstrComputed = 1;
constexpr int kInstrTtu = 2;
constexpr int kRinstrComputed = 1;
constexpr int kRinstrTtu = 2;
constexpr int kRinstrPoison = 3;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kEmitThreads = 1024;
// L1 gives each block at most this many blocks' worth of rounds, so the
// per-(block, query) counts stay at most kEmitMaxBlocks * B ints
constexpr int kEmitMaxBlocks = 256;

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

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

// ---------------------------------------------------------------------------
// L1 list_emit
//
// Bound: bytes: N entries' (q, emit, value) read, the landed values
// written, and per-(block, query) counts that stay in L2. Design: the
// entries' order is the order of the slots, for any order of q, so the
// rank is a multi-block segmented count. Pass 1: each block counts its
// emitting entries per query in shared memory and writes the row of B
// counts. Pass 2: one warp per query scans that query's counts over the
// blocks, adds res_count[q], and leaves each block its first slot for the
// query; it also advances res_count by the entries that land (slots below
// R). Pass 3: each block walks its entries in index order, 32 at a time,
// one warp after the other: lanes of the same query find each other with
// __match_any_sync, rank among their lower lanes, and the group's highest
// lane advances the query's next slot in shared memory. A slot at or past
// R raises CAUSE_FRONTIER_OVERFLOW on the query by atomicMax; the others
// write the value.
// ---------------------------------------------------------------------------

__global__ void emit_hist_kernel(const int* __restrict__ q, const uint8_t* __restrict__ emit,
                                 int N, int B, int per_block, int* __restrict__ hist) {
  extern __shared__ int cnt[];
  for (int b = threadIdx.x; b < B; b += blockDim.x) cnt[b] = 0;
  __syncthreads();
  const int lo = blockIdx.x * per_block;
  const int hi = min(N, lo + per_block);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    if (emit[i]) atomicAdd(&cnt[q[i]], 1);
  }
  __syncthreads();
  int* row = hist + (size_t)blockIdx.x * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) row[b] = cnt[b];
}

__global__ void emit_scan_kernel(int* __restrict__ hist, int nblk, int B, int R,
                                 int* __restrict__ res_count, int* __restrict__ landed) {
  const int warp = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= B) return;  // the whole warp leaves together
  const int per = (nblk + 31) / 32;
  const int lo = min(nblk, lane * per);
  const int hi = min(nblk, lo + per);
  int s = 0;
  for (int b = lo; b < hi; ++b) s += hist[(size_t)b * B + warp];
  int x = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, x, 31);
  const int rc = res_count[warp];
  int run = rc + x - s;
  for (int b = lo; b < hi; ++b) {
    const size_t k = (size_t)b * B + warp;
    const int c = hist[k];
    hist[k] = run;
    run += c;
  }
  if (lane == 0) {
    const int land = min(max(R - rc, 0), total);
    res_count[warp] = rc + land;
    if (land > 0) atomicAdd(landed, land);
  }
}

__global__ void emit_rank_kernel(const int* __restrict__ q, const uint8_t* __restrict__ emit,
                                 const int* __restrict__ value, int N, int B, int R,
                                 int per_block, const int* __restrict__ hist,
                                 int* __restrict__ res, int* __restrict__ needs_host) {
  extern __shared__ int run[];
  const int* row = hist + (size_t)blockIdx.x * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) run[b] = row[b];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int lo = blockIdx.x * per_block;
  const int hi = min(N, lo + per_block);
  for (int base = lo; base < hi; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool takes = i < hi && emit[i];
    const int qq = takes ? q[i] : -1;
    // ranks inside the warp need no order between warps
    const unsigned same = __match_any_sync(0xFFFFFFFFu, qq);
    const int rank = __popc(same & lower);
    const bool last = ((same >> lane) >> 1) == 0u;
    for (int w = 0; w < nwarps; ++w) {
      if (wid == w && takes) {
        const int slot = run[qq] + rank;
        __syncwarp(same);
        if (last) run[qq] = slot + 1;
        if (slot >= R) {
          atomicMax(&needs_host[qq], kCauseFrontierOverflow);
        } else {
          res[(size_t)qq * R + slot] = value[i];
        }
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// The slot scan shared by L2 and L3: per-task counts over S slots, a
// multi-block exclusive scan in task order (block sums from the count
// pass, one block scanning the block sums, then each block's tasks their
// offsets), and the truncation cause of every segment the frontier cap
// cuts off. One thread per task, kThreads tasks per block.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void block_sum_out(unsigned s, unsigned* warp_sums,
                                              int* __restrict__ block_sums) {
  const unsigned ex = block_exclusive_scan(s, warp_sums);
  if (threadIdx.x == blockDim.x - 1) block_sums[blockIdx.x] = (int)(ex + s);
}

__global__ void scan_block_sums_kernel(const int* __restrict__ sums, int n,
                                       int* __restrict__ offs) {
  __shared__ unsigned warp_sums[32];
  const int t = threadIdx.x;
  const int chunk = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, t * chunk);
  const int hi = min(n, lo + chunk);
  unsigned s = 0;
  for (int i = lo; i < hi; ++i) s += (unsigned)sums[i];
  unsigned run = block_exclusive_scan(s, warp_sums);
  for (int i = lo; i < hi; ++i) {
    offs[i] = (int)run;
    run += (unsigned)sums[i];
  }
}

__global__ void slot_offsets_kernel(const int* __restrict__ counts, int F, int S,
                                    const int* __restrict__ q,
                                    const int* __restrict__ block_offs,
                                    int* __restrict__ offsets, int* __restrict__ total,
                                    int* __restrict__ cause) {
  __shared__ unsigned warp_sums[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < F;
  unsigned s = 0;
  if (in) {
    for (int k = 0; k < S; ++k) s += (unsigned)counts[(size_t)i * S + k];
  }
  unsigned off = (unsigned)block_offs[blockIdx.x] + block_exclusive_scan(s, warp_sums);
  if (!in) return;
  bool cut = false;
  for (int k = 0; k < S; ++k) {
    const int c = counts[(size_t)i * S + k];
    offsets[(size_t)i * S + k] = (int)off;
    cut |= c > 0 && (long long)off + c > F;
    off += (unsigned)c;
  }
  if (cut) atomicMax(&cause[q[i]], kCauseFrontierOverflow);
  if (i == F - 1) *total = (int)off;
}

// ---------------------------------------------------------------------------
// L2 reverse_gather
//
// Bound: bytes, and latency at these sizes: per task its columns and one
// inverted-instruction row (RK x 16 B); per candidate the segment search
// over the F*S offsets, one 16-byte rv_pack row and one objslot_ns entry.
// Design: the count pass computes every slot's count (and POISON) from
// the task's columns and its row; the scan above orders the slots; the
// gather pass gives each of the F candidates a binary search for its
// segment, recomputes the slot's kind from the task, and fills every
// candidate column, in range or not, as the plain version does.
// ---------------------------------------------------------------------------

__global__ void rev_count_kernel(
    const int* __restrict__ q, const int* __restrict__ rel, const int* __restrict__ depth,
    const uint8_t* __restrict__ live, const int* __restrict__ ns_t,
    const int* __restrict__ rlen, const int4* __restrict__ rinstr, int RK, int F,
    int wildcard_rel, int ncr, int* __restrict__ counts, int* __restrict__ block_sums,
    int* __restrict__ cause) {
  __shared__ unsigned warp_sums[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int S = RK + 1;
  unsigned s = 0;
  if (i < F) {
    const bool lv = live[i] != 0;
    const int d = depth[i], r = rel[i], ns = ns_t[i], rl = rlen[i];
    const bool has_ri = lv && r < ncr;
    const int c0 = (lv && d >= 1 && r != wildcard_rel) ? rl : 0;
    counts[(size_t)i * S] = c0;
    s = (unsigned)c0;
    bool poison = false;
    const int4* row = rinstr + (size_t)(has_ri ? r : 0) * RK;
    for (int k = 0; k < RK; ++k) {
      const int4 e = row[k];
      const int rik = has_ri ? e.x : 0;
      poison |= lv && rik == kRinstrPoison && (e.w == -1 || e.w == ns);
      const bool is_rc = rik == kRinstrComputed && lv && e.w == ns;
      const bool is_rt = rik == kRinstrTtu && lv && d >= 1;
      const int c = is_rc ? 1 : (is_rt ? rl : 0);
      counts[(size_t)i * S + 1 + k] = c;
      s += (unsigned)c;
    }
    if (poison) atomicMax(&cause[q[i]], kCauseIslandHost);
  }
  block_sum_out(s, warp_sums, block_sums);
}

__global__ void rev_gather_kernel(
    const int* __restrict__ offsets, const int* __restrict__ total, int F, int RK,
    const int* __restrict__ q, const int* __restrict__ obj, const int* __restrict__ rel,
    const int* __restrict__ depth, const uint8_t* __restrict__ live,
    const int* __restrict__ ns_t, const int* __restrict__ rstart,
    const int4* __restrict__ rinstr, const int4* __restrict__ rv_pack, int n_redges,
    const int* __restrict__ objslot_ns, int n_objslot, int ncr,
    int* __restrict__ c_q, int* __restrict__ c_obj, int* __restrict__ c_rel,
    int* __restrict__ c_depth, uint8_t* __restrict__ c_valid) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= F) return;
  const int S = RK + 1;
  const int n = F * S;
  const int seg = last_le(offsets, n, j);
  const int ti = seg / S;
  const int slot = seg - ti * S;
  const int within = j - offsets[seg];
  const bool in_range = j < min(*total, F);
  const int o = obj[ti], r = rel[ti], d = depth[ti];
  int kind = 0, relp = 0, relt = 0, src_ns = -2;
  if (slot > 0) {
    const bool lv = live[ti] != 0;
    const bool has_ri = lv && r < ncr;
    const int4 e = rinstr[(size_t)(has_ri ? r : 0) * RK + (slot - 1)];
    const int rik = has_ri ? e.x : 0;
    if (rik == kRinstrComputed && lv && e.w == ns_t[ti]) {
      kind = 1;
    } else if (rik == kRinstrTtu && lv && d >= 1) {
      kind = 2;
    }
    relp = e.y;
    relt = e.z;
    src_ns = e.w;
  }
  int e_idx = rstart[ti] + within;
  e_idx = min(max(e_idx, 0), max(n_redges - 1, 0));
  int p_obj = 0, p_rel = 0, e_sb = 0;
  if (n_redges > 0) {
    const int4 p = rv_pack[e_idx];
    p_obj = p.x;
    p_rel = p.y;
    e_sb = p.z;
  }
  const int p_ns = objslot_ns[min(max(p_obj, 0), n_objslot - 1)];
  const bool is_es = kind == 0;
  const bool is_c = kind == 1;
  const bool cond = is_es ? e_sb == r : (is_c || (p_rel == relt && p_ns == src_ns));
  c_q[j] = q[ti];
  c_obj[j] = is_c ? o : p_obj;
  c_rel[j] = is_es ? p_rel : relp;
  c_depth[j] = is_c ? d : d - 1;
  c_valid[j] = in_range && cond;
}

// ---------------------------------------------------------------------------
// L3 subjects_gather
//
// Bound: bytes, and latency at these sizes: per task its columns, its
// S spans (8 B each) and K instruction lanes; per candidate the segment
// search, one 16-byte fe_pack row. Design: L2's, over the full-edge CSR:
// the count pass reads the K2 spans and the instruction kinds, the scan
// orders the slots, and the gather pass fills the candidate columns, the
// result mask (a plain-subject edge of the task's own row) and its value.
// ---------------------------------------------------------------------------

__global__ void sub_count_kernel(
    const int* __restrict__ depth, const uint8_t* __restrict__ live,
    const int2* __restrict__ spans, const int* __restrict__ ik, int K, int F,
    int* __restrict__ counts, int* __restrict__ block_sums) {
  __shared__ unsigned warp_sums[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int S = K + 1;
  unsigned s = 0;
  if (i < F) {
    const bool can_row = live[i] != 0 && depth[i] >= 1;
    for (int k = 0; k < S; ++k) {
      const int2 sp = spans[(size_t)i * S + k];
      const int len = sp.x < 0 ? 0 : sp.y - sp.x;
      int c;
      if (k == 0) {
        c = can_row ? len : 0;
      } else {
        const int kk = ik[(size_t)i * K + k - 1];
        c = (kk == kInstrComputed && can_row) ? 1 : ((kk == kInstrTtu && can_row) ? len : 0);
      }
      counts[(size_t)i * S + k] = c;
      s += (unsigned)c;
    }
  }
  block_sum_out(s, warp_sums, block_sums);
}

__global__ void sub_gather_kernel(
    const int* __restrict__ offsets, const int* __restrict__ total, int F, int K,
    const int* __restrict__ q, const int* __restrict__ obj, const int* __restrict__ depth,
    const uint8_t* __restrict__ live, const int2* __restrict__ spans,
    const int* __restrict__ ik, const int* __restrict__ ir, const int* __restrict__ ir2,
    const int4* __restrict__ fe_pack, int n_edges, int wildcard_rel,
    int* __restrict__ c_q, int* __restrict__ c_obj, int* __restrict__ c_rel,
    int* __restrict__ c_depth, uint8_t* __restrict__ c_valid, uint8_t* __restrict__ c_emit,
    int* __restrict__ c_value) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= F) return;
  const int S = K + 1;
  const int n = F * S;
  const int seg = last_le(offsets, n, j);
  const int ti = seg / S;
  const int slot = seg - ti * S;
  const int within = j - offsets[seg];
  const bool in_range = j < min(*total, F);
  const int d = depth[ti];
  int kind = 0, crel = 0;
  if (slot > 0) {
    const bool can_row = live[ti] != 0 && d >= 1;
    const size_t k = (size_t)ti * K + slot - 1;
    const int kk = ik[k];
    if (kk == kInstrComputed && can_row) {
      kind = 1;
    } else if (kk == kInstrTtu && can_row) {
      kind = 2;
    }
    crel = kk == kInstrComputed ? ir[k] : ir2[k];
  }
  int e_idx = spans[seg].x + within;
  e_idx = min(max(e_idx, 0), max(n_edges - 1, 0));
  int e_skind = 0, e_sa = 0, e_sb = 0;
  if (n_edges > 0) {
    const int4 e = fe_pack[e_idx];
    e_skind = e.x;
    e_sa = e.y;
    e_sb = e.z;
  }
  const bool is_row = kind == 0;
  const bool is_c = kind == 1;
  const int cd = is_c ? d : d - 1;
  const bool cond = is_row ? (e_skind == 1 && e_sb != wildcard_rel) : (is_c || e_skind == 1);
  c_q[j] = q[ti];
  c_obj[j] = is_c ? obj[ti] : e_sa;
  c_rel[j] = is_row ? e_sb : crel;
  c_depth[j] = cd;
  c_valid[j] = in_range && cond && cd >= 1;
  c_emit[j] = in_range && is_row && e_skind == 0;
  c_value[j] = e_sa;
}

// ---------------------------------------------------------------------------
// L4 list_pool_compact
//
// Bound: bytes: B counts and flags and the used result rows read, the
// whole packed vector written (pool_cap ints, EMPTY past the used ones).
// Design: X2's, with one column: pass 1 is one block that scans the
// clamped counts in thread-contiguous chunks and writes the offsets
// (clamped to the pool), the causes (with the pool overflow by max) and
// the stats; pass 2 gives each pool entry a binary search for its query
// over the unclamped offsets and gathers it.
// ---------------------------------------------------------------------------

__global__ void list_pool_scan_kernel(
    const int* __restrict__ res_count, const int* __restrict__ needs_host,
    const int* __restrict__ stats, int B, int R, int P, int* __restrict__ offs,
    int* __restrict__ out) {
  __shared__ unsigned warp_sums[32];
  const int t = threadIdx.x;
  const int chunk = (B + blockDim.x - 1) / blockDim.x;
  const int lo = min(B, t * chunk);
  const int hi = min(B, lo + chunk);
  unsigned s = 0;
  for (int b = lo; b < hi; ++b) s += (unsigned)min(max(res_count[b], 0), R);
  unsigned run = block_exclusive_scan(s, warp_sums);
  int* out_needs = out + B + 1;
  for (int b = lo; b < hi; ++b) {
    const int c = min(max(res_count[b], 0), R);
    const int end = (int)(run + (unsigned)c);
    offs[b + 1] = end;
    out[b + 1] = min(end, P);
    out_needs[b] = max(needs_host[b], (end > P && c > 0) ? kCauseFrontierOverflow : 0);
    run += (unsigned)c;
  }
  if (t == 0) {
    offs[0] = 0;
    out[0] = 0;
  }
  if (t < 8) out[2 * B + 1 + t] = stats[t];
}

__global__ void list_pool_gather_kernel(const int* __restrict__ offs, int B, int R, int P,
                                        const int* __restrict__ res, int* __restrict__ pool) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  // seg = #{b : offs[b + 1] <= j} (searchsorted side=right over offs[1:])
  int lo = 0, hi = B;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid + 1] <= j) lo = mid + 1; else hi = mid;
  }
  const int seg_c = min(lo, B - 1);
  const bool valid = j < offs[B] && lo < B;
  long long src = (long long)seg_c * R + (j - offs[seg_c]);
  src = min(max(src, 0LL), (long long)B * R - 1);
  pool[j] = valid ? res[src] : kEmpty;
}

int set_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  }
  return 0;
}

}  // namespace

extern "C" {

// Scratch: hist holds list_emit_blocks(N) * B ints, landed one int.
int keto_list_emit_blocks(int N) {
  const int rounds = blocks_for(N, kEmitThreads * kEmitMaxBlocks);
  return blocks_for(N, (long long)rounds * kEmitThreads);
}

int keto_list_emit(const int* q, const uint8_t* emit, const int* value, int N, int B, int R,
                   int* res, int* res_count, int* needs_host, int* hist, int* landed,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const int nblk = keto_list_emit_blocks(N);
  const int per_block = blocks_for(N, nblk);
  const size_t smem = sizeof(int) * (size_t)B;
  int rc = set_smem((const void*)emit_hist_kernel, smem);
  if (rc == 0) rc = set_smem((const void*)emit_rank_kernel, smem);
  if (rc != 0) return rc;
  cudaMemsetAsync(landed, 0, sizeof(int), st);
  emit_hist_kernel<<<nblk, kEmitThreads, smem, st>>>(q, emit, N, B, per_block, hist);
  emit_scan_kernel<<<blocks_for((long long)B * 32, kThreads), kThreads, 0, st>>>(
      hist, nblk, B, R, res_count, landed);
  emit_rank_kernel<<<nblk, kEmitThreads, smem, st>>>(q, emit, value, N, B, R, per_block,
                                                     hist, res, needs_host);
  return (int)cudaGetLastError();
}

// Scratch: counts and offsets F * (RK + 1) ints, block_sums and
// block_offs blocks_for(F, 256) ints each, total one int.
int keto_reverse_gather(
    const int* q, const int* obj, const int* rel, const int* depth, const uint8_t* live,
    const int* ns_t, const int* rstart, const int* rlen, const int* rinstr, int RK,
    const int* rv_pack, int n_redges, const int* objslot_ns, int n_objslot, int F, int B,
    int wildcard_rel, int ncr, int* counts, int* offsets, int* block_sums, int* block_offs,
    int* total, int* cause, int* c_q, int* c_obj, int* c_rel, int* c_depth,
    uint8_t* c_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F <= 0 || RK <= 0 || n_objslot <= 0) return (int)cudaErrorInvalidValue;
  const int nblk = blocks_for(F, kThreads);
  cudaMemsetAsync(cause, 0, sizeof(int) * (size_t)B, st);
  rev_count_kernel<<<nblk, kThreads, 0, st>>>(q, rel, depth, live, ns_t, rlen,
                                              (const int4*)rinstr, RK, F, wildcard_rel, ncr,
                                              counts, block_sums, cause);
  scan_block_sums_kernel<<<1, kScanThreads, 0, st>>>(block_sums, nblk, block_offs);
  slot_offsets_kernel<<<nblk, kThreads, 0, st>>>(counts, F, RK + 1, q, block_offs, offsets,
                                                 total, cause);
  rev_gather_kernel<<<nblk, kThreads, 0, st>>>(
      offsets, total, F, RK, q, obj, rel, depth, live, ns_t, rstart, (const int4*)rinstr,
      (const int4*)rv_pack, n_redges, objslot_ns, n_objslot, ncr, c_q, c_obj, c_rel,
      c_depth, c_valid);
  return (int)cudaGetLastError();
}

// Scratch as keto_reverse_gather's, with S = K + 1.
int keto_subjects_gather(
    const int* q, const int* obj, const int* depth, const uint8_t* live, const int* spans,
    const int* ik, const int* ir, const int* ir2, int K, const int* fe_pack, int n_edges,
    int F, int B, int wildcard_rel, int* counts, int* offsets, int* block_sums,
    int* block_offs, int* total, int* cause, int* c_q, int* c_obj, int* c_rel,
    int* c_depth, uint8_t* c_valid, uint8_t* c_emit, int* c_value, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int nblk = blocks_for(F, kThreads);
  cudaMemsetAsync(cause, 0, sizeof(int) * (size_t)B, st);
  sub_count_kernel<<<nblk, kThreads, 0, st>>>(depth, live, (const int2*)spans, ik, K, F,
                                              counts, block_sums);
  scan_block_sums_kernel<<<1, kScanThreads, 0, st>>>(block_sums, nblk, block_offs);
  slot_offsets_kernel<<<nblk, kThreads, 0, st>>>(counts, F, K + 1, q, block_offs, offsets,
                                                 total, cause);
  sub_gather_kernel<<<nblk, kThreads, 0, st>>>(
      offsets, total, F, K, q, obj, depth, live, (const int2*)spans, ik, ir, ir2,
      (const int4*)fe_pack, n_edges, wildcard_rel, c_q, c_obj, c_rel, c_depth, c_valid,
      c_emit, c_value);
  return (int)cudaGetLastError();
}

int keto_list_pool_compact(const int* res, const int* res_count, const int* needs_host,
                           const int* stats, int B, int R, int P, int* offs, int* out,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  list_pool_scan_kernel<<<1, kScanThreads, 0, st>>>(res_count, needs_host, stats, B, R, P,
                                                     offs, out);
  if (P > 0) {
    list_pool_gather_kernel<<<blocks_for(P, kThreads), kThreads, 0, st>>>(
        offs, B, R, P, res, out + 2 * B + 1 + 8);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

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
//
// L1 is csrc/keyed_rank.cuh's keyed scan, shared with X1, and its landed
// count csrc/reduce.cuh's last-block sum; the block scans of L2-L4 come
// from csrc/scan.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed_rank.cuh"
#include "reduce.cuh"
#include "scan.cuh"

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
// Bound: bytes: N entries' q and emit read, the values of the entries
// that emit read and the landed ones written, B counts and causes.
// Design: csrc/keyed_rank.cuh's keyed scan with weight 1 (key q[i] where
// the entry emits), in three launches and no memset. Pass 1 counts each
// chunk's emitting entries per query. Pass 2 turns them into first slots
// from res_count, advances res_count by the entries that land (slots
// below R) and sums them into the landed count with
// csrc/reduce.cuh's last-block sum. Pass 3 gives every emitting entry its
// slot: a slot below R writes the value; a slot at or past R raises
// CAUSE_FRONTIER_OVERFLOW on the query by atomicMax, once a round's group
// (from its last lane, which holds the group's highest slot). The walks
// load q, emit and value kRankUnroll rounds at a time, the next group's
// in flight while a group is ranked.
// ---------------------------------------------------------------------------

template <bool kShared>
__global__ void list_emit_count_kernel(const int* __restrict__ q,
                                       const uint8_t* __restrict__ emit, int N, int B,
                                       int rounds, int* __restrict__ table) {
  extern __shared__ __align__(16) int smem[];
  const WarpCounts<kShared> counts = warp_counts<kShared>(smem, table, B);
  const long long lo = ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
                       rounds * 32 + (threadIdx.x & 31);
  int key[kRankUnroll], next[kRankUnroll];
  auto load = [&](int r0, int* k) {
#pragma unroll
    for (int u = 0; u < kRankUnroll; ++u) {
      const long long i = lo + (long long)(r0 + u) * 32;
      const bool in = r0 + u < rounds && i < N;
      const int qq = in ? q[i] : -1;
      k[u] = in && emit[i] ? qq : -1;
    }
  };
  load(0, key);
  rank_begin<kShared>(smem, table, B, true);  // while the first loads are in flight
  for (int r0 = 0; r0 < rounds; r0 += kRankUnroll) {
    load(r0 + kRankUnroll, next);  // in flight while this group is ranked
#pragma unroll
    for (int u = 0; u < kRankUnroll; ++u) {
      rank_round<true>(key[u], 1u, counts);
      key[u] = next[u];
    }
  }
  rank_end<kShared>(smem, table, B);
}

__global__ void list_emit_scan_kernel(int* __restrict__ table, int B, int chunks, int group,
                                      int R, int* __restrict__ res_count,
                                      int* __restrict__ landed,
                                      unsigned long long* __restrict__ scratch) {
  __shared__ unsigned warp_sums[64];
  __shared__ unsigned sums[kRankScanThreads / 32];
  const int k = rank_scan_key_of(group);
  // every warp of the key reads its count before the one that writes it
  // passes the scan's barrier
  const int rc = k < B ? res_count[k] : 0;
  const unsigned total = rank_scan_key(table, k, B, chunks, group, (unsigned)rc, sums);
  unsigned land = 0;
  if (k < B && (threadIdx.x & (32 * group - 1)) == 0) {
    land = (unsigned)min(max(R - rc, 0), (int)total);
    res_count[k] = rc + (int)land;
  }
  land = block_sum(land, warp_sums);
  if (threadIdx.x == 0) grid_sum_last_block(land, scratch, landed);
}

template <bool kShared>
__global__ void list_emit_rank_kernel(const int* __restrict__ q,
                                      const uint8_t* __restrict__ emit,
                                      const int* __restrict__ value, int N, int B, int R,
                                      int rounds, int* __restrict__ table,
                                      int* __restrict__ res, int* __restrict__ needs_host) {
  extern __shared__ __align__(16) int smem[];
  const WarpCounts<kShared> counts = warp_counts<kShared>(smem, table, B);
  const long long lo = ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
                       rounds * 32 + (threadIdx.x & 31);
  int key[kRankUnroll], val[kRankUnroll], next_key[kRankUnroll], next_val[kRankUnroll];
  auto load = [&](int r0, int* k, int* v) {
#pragma unroll
    for (int u = 0; u < kRankUnroll; ++u) {
      const long long i = lo + (long long)(r0 + u) * 32;
      const bool in = r0 + u < rounds && i < N;
      const int qq = in ? q[i] : -1;
      v[u] = in ? value[i] : 0;
      k[u] = in && emit[i] ? qq : -1;
    }
  };
  load(0, key, val);
  rank_begin<kShared>(smem, table, B, false);  // while the first loads are in flight
  for (int r0 = 0; r0 < rounds; r0 += kRankUnroll) {
    load(r0 + kRankUnroll, next_key, next_val);  // in flight while this group is ranked
#pragma unroll
    for (int u = 0; u < kRankUnroll; ++u) {
      bool last;
      const int slot = (int)rank_round<true>(key[u], 1u, counts, &last);
      if (key[u] >= 0 && slot < R) res[(size_t)key[u] * R + slot] = val[u];
      // the group's last lane holds its highest slot: one atomic a group
      if (last && slot >= R) atomicMax(&needs_host[key[u]], kCauseFrontierOverflow);
      key[u] = next_key[u];
      val[u] = next_val[u];
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
  unsigned total;
  block_exclusive_scan(s, warp_sums, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = (int)total;
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
  unsigned all;
  unsigned run = block_exclusive_scan(s, warp_sums, &all);
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
  unsigned all;
  unsigned off = (unsigned)block_offs[blockIdx.x] + block_exclusive_scan(s, warp_sums, &all);
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
  unsigned all;
  unsigned run = block_exclusive_scan(s, warp_sums, &all);
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

}  // namespace

extern "C" {

// The ints of L1's keyed-rank table (csrc/keyed_rank.cuh) for N entries
// over B queries.
long long keto_list_emit_scratch(int N, int B) {
  return B > 0 ? rank_table_ints(rank_shape(N, B), B) : 0;
}

// Scratch: table keto_list_emit_scratch(N, B) ints; landed one int;
// scratch the zeroed word of csrc/reduce.cuh, left at zero.
int keto_list_emit(const int* q, const uint8_t* emit, const int* value, int N, int B, int R,
                   int* res, int* res_count, int* needs_host, int* table, int* landed,
                   unsigned long long* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const RankShape s = rank_shape(N, B);
  const size_t smem = rank_smem(s, B);
  const int threads = 32 * s.warps;
  if (s.shared) {
    int rc = rank_allow_smem((const void*)list_emit_count_kernel<true>, smem);
    if (rc == 0) rc = rank_allow_smem((const void*)list_emit_rank_kernel<true>, smem);
    if (rc != 0) return rc;
    list_emit_count_kernel<true><<<s.blocks, threads, smem, st>>>(q, emit, N, B, s.rounds,
                                                                   table);
  } else {
    list_emit_count_kernel<false><<<s.blocks, threads, 0, st>>>(q, emit, N, B, s.rounds,
                                                                 table);
  }
  list_emit_scan_kernel<<<rank_scan_blocks(s, B), kRankScanThreads, 0, st>>>(
      table, B, s.warps * s.blocks, s.group, R, res_count, landed, scratch);
  if (s.shared) {
    list_emit_rank_kernel<true><<<s.blocks, threads, smem, st>>>(
        q, emit, value, N, B, R, s.rounds, table, res, needs_host);
  } else {
    list_emit_rank_kernel<false><<<s.blocks, threads, 0, st>>>(
        q, emit, value, N, B, R, s.rounds, table, res, needs_host);
  }
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

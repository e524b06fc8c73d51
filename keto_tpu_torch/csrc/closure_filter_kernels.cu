// The closure probe and BatchFilter's candidate marking, for Hopper
// (sm_90a), with a plain C interface bound by ctypes
// (keto_tpu_torch/engine/cuda_ops.py). Each kernel launches on the
// caller's stream, allocates nothing, and computes exactly what its plain
// PyTorch version computes (engine/closure_kernel.py closure_probe_plain,
// engine/filter_kernel.py filter_mark_plain); each entry point returns
// cudaGetLastError().
//
// C1 keto_closure_probe replaces keto_tpu/engine/closure_kernel.py
//                       closure_kernel_packed / _closure_kernel_impl
//                       (:153, :77): the whole launch, one kernel, every
//                       bucket row of every table in flight at once.
// F1 keto_filter_mark   replaces step 2 of keto_tpu/engine/filter_kernel.py
//                       _filter_impl (:185-193): the candidate intersection
//                       of one shared-frontier step.

#include "probe.cuh"
#include "reduce.cuh"

namespace {

constexpr int kCauseInvalid = 3;
constexpr int kCauseUncovered = 1;
constexpr int kCauseDirty = 2;
constexpr int kStats = 8;
constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// C1 closure_probe
//
// Bound: bytes. Each valid query reads ceil(cc_probes/16) bucket rows of
// the cc pair table, with has_dirty ceil(8/16) of the cd table, and, when
// covered and clean, ceil(ch_probes/8) rows of the ch edge table: 256 B
// each under the bucketized layout, at random addresses (deep-1e6's ch
// table is 2.1 GB, so every row is a DRAM trip). At a batch of 4,096 the
// bytes are ~2 MB, so the time is a launch and a chain of dependent trips.
// Design: one 16-lane group per query, as K1 and K2 (one round of loads
// is one coalesced bucket row), and two dependent trips: (1) the query's
// seven columns; (2) after the pair hash of (obj, rel) and the 5-int key
// hash of (obj, rel, skind, sa, sb), every bucket-row load of cc, of cd
// (with has_dirty) and of ch, issued before any compare (kRounds rounds
// of each table's sequence; longer sequences take further groups after).
// So an uncovered or dirty query reads its ch rows too, as the JAX body
// probes every table and masks after; the verdict is the same. Invalid
// queries load nothing. The stats tail needs no memset: block 0 writes
// its constant slots (steps 1, frontier sum and max B, slots 5-7 zero),
// and the live sum and probe hits are summed across the grid by
// reduce.cuh's grid_counts_last_block on the stream's two grid-scratch
// words, one atomic on each a block and no fence, so a call is one
// launch.
// ---------------------------------------------------------------------------

// the most rounds of a table's row loads a group keeps in flight: 8
// rounds of 16 lanes cover 128 pair probes and 64 edge probes under
// either layout. A launch holds only the rounds its deeper table needs
// (1, 2, 4 or 8), so the common one-row tables cost three int4
// registers a lane.
constexpr int kMaxClosureRounds = 8;

// chunk c (one 16-byte slot) of a query's probe sequence over a packed
// [cap, 4] pair table: row c / spb of the double-hash sequence; not
// loaded past total
__device__ __forceinline__ int4 pair_chunk(const int4* __restrict__ pack, uint32_t nb, int spb,
                                           int total, int c, uint32_t h1, uint32_t h2) {
  if (c >= total) return make_int4(0, 0, 0, 0);
  const int r = c / spb;
  const uint32_t b = (h1 + (uint32_t)r * h2) & (nb - 1u);
  return __ldg(pack + (size_t)b * spb + (c - r * spb));
}

// folds a pair-table chunk into the largest v0 of the slots matching (o, r)
__device__ __forceinline__ void pair_match(int4 x, int c, int total, int o, int r, int& v) {
  if (c < total && x.x == o && x.y == r) v = max(v, x.z);
}

template <int kRounds>
__global__ void __launch_bounds__(kThreads) closure_probe_kernel(
    const int4* __restrict__ cc, uint32_t cc_nb, int cc_total,
    const int4* __restrict__ cd, uint32_t cd_nb, int cd_total, int spb_pair,
    const int4* __restrict__ ch, uint32_t ch_nb, int ch_total, int spb_edge,
    const int* __restrict__ qpack, int B, int* __restrict__ out,
    unsigned long long* __restrict__ scratch) {
  __shared__ unsigned n_valid, n_member;
  if (threadIdx.x == 0) {
    n_valid = 0;
    n_member = 0;
  }
  int* stats = out + 2 * (size_t)B;
  if (blockIdx.x == 0 && threadIdx.x < kStats && threadIdx.x != 3 && threadIdx.x != 4) {
    stats[threadIdx.x] = threadIdx.x == 0 ? 1 : threadIdx.x <= 2 ? B : 0;
  }
  const int i = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / kGroup);
  const int lane = threadIdx.x % kGroup;
  bool valid = false, member = false;
  if (i < B) {  // the whole group takes the same branches
    // trip 1: the query's columns, before any branch
    const int o = __ldg(qpack + i), r = __ldg(qpack + (size_t)B + i);
    const int depth = __ldg(qpack + 2 * (size_t)B + i);
    const int key[5] = {o, r, __ldg(qpack + 3 * (size_t)B + i),
                        __ldg(qpack + 4 * (size_t)B + i), __ldg(qpack + 5 * (size_t)B + i)};
    valid = __ldg(qpack + 6 * (size_t)B + i) != 0;
    int cause = kCauseInvalid;
    if (valid) {
      const unsigned gmask = group_mask();
      const uint32_t p1 = mix32(mix32(kGolden ^ (uint32_t)o) ^ (uint32_t)r);
      const uint32_t p2 = stride_hash(p1);
      const uint32_t e1 = key_hash(key, 5);
      const uint32_t e2 = stride_hash(e1);
      const int per_row = 2 * spb_edge;  // int4 chunks per ch bucket row
      // trip 2: every table's rounds in flight before any is used
      int4 xc[kRounds], xe[kRounds];
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        xc[u] = pair_chunk(cc, cc_nb, spb_pair, cc_total, u * kGroup + lane, p1, p2);
      }
      const int4 xd = pair_chunk(cd, cd_nb, spb_pair, cd_total, lane, p1, p2);
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        xe[u] = edge_chunk(ch, ch_nb, per_row, ch_total, u * kGroup + lane, e1, e2);
      }
      int vc = kEmpty, vd = kEmpty, req = kEmpty;
      bool found = false;
#pragma unroll
      for (int u = 0; u < kRounds; ++u) pair_match(xc[u], u * kGroup + lane, cc_total, o, r, vc);
      pair_match(xd, lane, cd_total, o, r, vd);
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        edge_match(xe[u], u * kGroup + lane, ch_total, key, lane, gmask, found, req);
      }
      // sequences past kRounds rounds (cc, ch) or one (cd): further
      // groups, each issued whole before it is used
      for (int base = kRounds * kGroup; base < cc_total; base += kRounds * kGroup) {
#pragma unroll
        for (int u = 0; u < kRounds; ++u) {
          xc[u] = pair_chunk(cc, cc_nb, spb_pair, cc_total, base + u * kGroup + lane, p1, p2);
        }
#pragma unroll
        for (int u = 0; u < kRounds; ++u) {
          pair_match(xc[u], base + u * kGroup + lane, cc_total, o, r, vc);
        }
      }
      for (int c0 = kGroup; c0 < cd_total; c0 += kGroup) {
        pair_match(pair_chunk(cd, cd_nb, spb_pair, cd_total, c0 + lane, p1, p2), c0 + lane,
                   cd_total, o, r, vd);
      }
      for (int base = kRounds * kGroup; base < ch_total; base += kRounds * kGroup) {
#pragma unroll
        for (int u = 0; u < kRounds; ++u) {
          xe[u] = edge_chunk(ch, ch_nb, per_row, ch_total, base + u * kGroup + lane, e1, e2);
        }
#pragma unroll
        for (int u = 0; u < kRounds; ++u) {
          edge_match(xe[u], base + u * kGroup + lane, ch_total, key, lane, gmask, found, req);
        }
      }
      for (int off = kGroup / 2; off >= 1; off >>= 1) {
        vc = max(vc, __shfl_xor_sync(gmask, vc, off));
        vd = max(vd, __shfl_xor_sync(gmask, vd, off));
        found = (__shfl_xor_sync(gmask, (int)found, off) != 0) || found;
        req = max(req, __shfl_xor_sync(gmask, req, off));
      }
      cause = vc != 1 ? kCauseUncovered : vd == 1 ? kCauseDirty : 0;
      member = cause == 0 && found && req >= 1 && req <= depth;
    }
    if (lane == 0) {
      out[i] = member;
      out[(size_t)B + i] = cause;
    }
  }
  // one count a query: lane 0 of each group
  const unsigned vb = __ballot_sync(0xFFFFFFFFu, lane == 0 && valid);
  const unsigned mb = __ballot_sync(0xFFFFFFFFu, lane == 0 && member);
  __syncthreads();  // the shared counts are zeroed
  if ((threadIdx.x & 31) == 0 && (vb | mb)) {
    atomicAdd(&n_valid, (unsigned)__popc(vb));
    atomicAdd(&n_member, (unsigned)__popc(mb));
  }
  __syncthreads();
  // the live sum and the probe hits
  if (threadIdx.x == 0) grid_counts_last_block(n_valid, n_member, scratch, stats + 3, stats + 4);
}

// ---------------------------------------------------------------------------
// F1 filter_mark
//
// Bound: latency. The bytes are few (F task columns, the candidate
// column once, the hit slots set: 0.000035 ms at the filter walk's F =
// 4,096 and C = 16,384), and each task's lower-bound search is a chain of
// dependent loads (ceil(log2 C) + 1 = 15 for a binary search over the
// whole column). Design, one launch a call and a shallow search: one
// thread a task; each block first reads a table of kSamples evenly spaced
// keys into shared memory, one key a thread in one coalesced pass that
// goes out with the task columns. A thread searches the table in shared
// memory, then the at most C / kSamples + 1 keys between two samples in
// global memory (64 at C = 16,384: two 128-byte lines, so after the first
// load the search runs in L1), for the lower bound of its object
// (jnp.searchsorted's left side). A match sets its hit slot with
// atomicExch, so that the thread which sets a slot first counts it into
// the running count of hit slots (status[2]; the host's loop predicate
// reads every candidate as hit when it reaches n_cand). `marks` counts
// matching tasks, not slots, as the JAX stats do: a warp ballot and a
// shared count a block, then the last-block sum of reduce.cuh, so no
// memset precedes the kernel. One warp a task reading 32 keys a round
// (a 33-way search: two rounds and 32 neighbours at C = 16,384) was the
// other design timed, 7-10% slower at the filter walk's shape (PERF.md
// §6).
// ---------------------------------------------------------------------------

constexpr int kSamples = kThreads;  // one table key a thread
static_assert(kSamples == 256, "sample s sits at (s * C) >> 8");

__global__ void __launch_bounds__(kThreads) filter_mark_staged_kernel(
    const int* __restrict__ obj, const int* __restrict__ rel, const int* __restrict__ depth,
    const uint8_t* __restrict__ live, int F, const int* __restrict__ cand, int C,
    const int* __restrict__ head, int* __restrict__ hit, int* __restrict__ status,
    int* __restrict__ marks, unsigned long long* __restrict__ scratch) {
  __shared__ int table[kSamples];
  __shared__ int n_found, n_new;
  if (threadIdx.x == 0) {
    n_found = 0;
    n_new = 0;
  }
  table[threadIdx.x] = cand[(int)(((long long)threadIdx.x * C) >> 8)];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  bool match = false;
  int o = 0;
  if (j < F) {
    match = (live[j] != 0) & (rel[j] == head[2]) & (depth[j] >= 0);
    o = obj[j];
  }
  __syncthreads();
  bool found = false;
  if (match) {
    // a = the samples below o: the bound lies past sample a - 1, and at
    // or before sample a
    int a = 0, b = kSamples;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (table[mid] < o) a = mid + 1; else b = mid;
    }
    int lo = a ? (int)(((long long)(a - 1) * C) >> 8) + 1 : 0;
    int hi = a < kSamples ? (int)(((long long)a * C) >> 8) : C;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cand[mid] < o) lo = mid + 1; else hi = mid;
    }
    const int pos = min(lo, C - 1);
    found = cand[pos] == o;
    if (found && atomicExch(&hit[pos], 1) == 0) atomicAdd(&n_new, 1);
  }
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, found);
  if ((threadIdx.x & 31) == 0 && ballot) atomicAdd(&n_found, __popc(ballot));
  __syncthreads();
  if (threadIdx.x == 0) {
    if (n_new) atomicAdd(&status[2], n_new);
    grid_sum_last_block(n_found, scratch, marks);
  }
}

}  // namespace

extern "C" {

int keto_closure_probe(
    const int* cc, long long cc_cap, int cc_probes, const int* cd, long long cd_cap,
    int cd_probes, int has_dirty, int spb_pair, const int* ch, long long ch_cap,
    int ch_probes, int spb_edge, const int* qpack, int B, int* out, void* scratch,
    void* stream) {
  const int cc_total = (cc_probes + spb_pair - 1) / spb_pair * spb_pair;
  const int cd_total = has_dirty ? (cd_probes + spb_pair - 1) / spb_pair * spb_pair : 0;
  const int ch_total = (ch_probes + spb_edge - 1) / spb_edge * 2 * spb_edge;
  const int deeper = cc_total > ch_total ? cc_total : ch_total;
  const int need = (deeper + kGroup - 1) / kGroup;  // rounds of the deeper table
  const long long threads = (long long)B * kGroup;
  const int blocks = threads > 0 ? blocks_for(threads, kThreads) : 1;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t cc_nb = (uint32_t)(cc_cap / spb_pair);
  const uint32_t cd_nb = has_dirty ? (uint32_t)(cd_cap / spb_pair) : 1u;
  const uint32_t ch_nb = (uint32_t)(ch_cap / spb_edge);
  auto kernel = need <= 1 ? closure_probe_kernel<1>
              : need <= 2 ? closure_probe_kernel<2>
              : need <= 4 ? closure_probe_kernel<4>
                          : closure_probe_kernel<kMaxClosureRounds>;
  kernel<<<blocks, kThreads, 0, st>>>(
      (const int4*)cc, cc_nb, cc_total, (const int4*)cd, cd_nb, cd_total, spb_pair,
      (const int4*)ch, ch_nb, ch_total, spb_edge, qpack, B, out, (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}

int keto_filter_mark(
    const int* obj, const int* rel, const int* depth, const uint8_t* live, int F,
    const int* cand, int C, const int* head, int* hit, int* status, int* marks, void* scratch,
    void* stream) {
  // fewer than 2^23 blocks for F < 2^31: within the grid sum's tickets
  filter_mark_staged_kernel<<<F > 0 ? blocks_for(F, kThreads) : 1, kThreads, 0,
                              (cudaStream_t)stream>>>(
      obj, rel, depth, live, F, cand, C, head, hit, status, marks,
      (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"

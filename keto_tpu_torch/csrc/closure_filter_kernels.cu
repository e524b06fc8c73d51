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
//                       (:153, :77): the whole launch.
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
// each under the bucketized layout, at random addresses. Design: one
// 16-lane group per query, as K1 and K2 (one round of loads is one
// coalesced bucket row); the probes run in the order the verdict needs
// them, so an uncovered or dirty query skips the rest, and a launch
// without has_dirty never touches cd. The verdict and the cause code go
// out per query; the launch counters reduce in the block and land with
// one atomic per block in the stats tail, whose constant slots block 0
// writes after the entry point zeroes the tail.
// ---------------------------------------------------------------------------

__global__ void closure_probe_kernel(
    const int4* __restrict__ cc, uint32_t cc_nb, int cc_pb,
    const int4* __restrict__ cd, uint32_t cd_nb, int cd_pb, int has_dirty, int spb_pair,
    const int4* __restrict__ ch, uint32_t ch_nb, int ch_pb, int spb_edge,
    const int* __restrict__ qpack, int B, int* __restrict__ out) {
  __shared__ int n_valid, n_member;
  if (threadIdx.x == 0) {
    n_valid = 0;
    n_member = 0;
  }
  __syncthreads();
  const int i = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / kGroup);
  const int lane = threadIdx.x % kGroup;
  if (i < B) {  // the whole group takes the same branches
    const unsigned gmask = group_mask();
    const int o = qpack[i], r = qpack[B + i], depth = qpack[2 * B + i];
    const bool valid = qpack[6 * B + i] != 0;
    int cause = kCauseInvalid;
    bool member = false;
    if (valid) {
      int v0, v1;
      probe_pair_table(cc, cc_nb, spb_pair, cc_pb, o, r, lane, gmask, v0, v1);
      cause = v0 == 1 ? 0 : kCauseUncovered;
      if (cause == 0 && has_dirty) {
        probe_pair_table(cd, cd_nb, spb_pair, cd_pb, o, r, lane, gmask, v0, v1);
        if (max(v0, 0) == 1) cause = kCauseDirty;
      }
      if (cause == 0) {
        const int key[5] = {o, r, qpack[3 * B + i], qpack[4 * B + i], qpack[5 * B + i]};
        const uint32_t h1 = key_hash(key, 5);
        bool found;
        int req;
        probe_edge_table(ch, ch_nb, spb_edge, ch_pb, key, h1, stride_hash(h1), lane, gmask,
                         found, req);
        member = found && req >= 1 && req <= depth;
      }
    }
    if (lane == 0) {
      out[i] = member;
      out[B + i] = cause;
      if (valid) atomicAdd(&n_valid, 1);
      if (member) atomicAdd(&n_member, 1);
    }
  }
  __syncthreads();
  int* stats = out + 2 * B;
  if (threadIdx.x == 0) {
    if (blockIdx.x == 0) {
      stats[0] = 1;  // steps
      stats[1] = B;  // frontier sum
      stats[2] = B;  // frontier max
    }
    if (n_valid) atomicAdd(&stats[3], n_valid);  // live sum
    if (n_member) atomicAdd(&stats[4], n_member);  // probe hits
  }
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
    int ch_probes, int spb_edge, const int* qpack, int B, int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(out + 2 * (size_t)B, 0, sizeof(int) * kStats, st);
  const long long threads = (long long)B * kGroup;
  closure_probe_kernel<<<threads > 0 ? blocks_for(threads, kThreads) : 1, kThreads, 0, st>>>(
      (const int4*)cc, (uint32_t)(cc_cap / spb_pair), (cc_probes + spb_pair - 1) / spb_pair,
      (const int4*)cd, has_dirty ? (uint32_t)(cd_cap / spb_pair) : 1u,
      (cd_probes + spb_pair - 1) / spb_pair, has_dirty, spb_pair, (const int4*)ch,
      (uint32_t)(ch_cap / spb_edge), (ch_probes + spb_edge - 1) / spb_edge, spb_edge, qpack,
      B, out);
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

// The four hot phases of keto_tpu_torch's batched BFS check, for Hopper
// (sm_90a), with a plain C interface bound by ctypes
// (keto_tpu_torch/engine/cuda_ops.py). Every kernel launches on the
// caller's stream, allocates nothing, and computes exactly what its plain
// PyTorch version in keto_tpu_torch/engine/kernel.py computes; each entry
// point returns cudaGetLastError().
//
// K1 keto_edge_probe     replaces keto_tpu/engine/kernel.py
//                        _bucket_rows + _edge_key_probe as probe_phase
//                        uses them (dh, and dd when has_delta).
// K2 keto_pair_probe     replaces _multi_pair_key_probe / _pair_key_probe
//                        (the rh span probe and the dirty-row probe).
// K3 keto_expand_gather  replaces expand_phase's counts -> exclusive scan
//                        -> covering-segment map -> source gather ->
//                        e_pack child gather.
// K4 keto_dedupe_compact replaces dedupe_phase.

#include "probe.cuh"

namespace {

constexpr int kCauseFrontierOverflow = 2;
constexpr int kProbeThreads = 256;
constexpr int kScanThreads = 1024;

// ---------------------------------------------------------------------------
// K1 edge_probe
//
// Bound: bytes. Each live task reads ceil(probes/spb) bucket rows of the
// [cap, 8] int32 edge table (256 B each under the bucketized layout) at
// random addresses; the arithmetic is a few hashes. Design: 16 threads
// per task, each loading one 16-byte half-slot per round, so one round
// is one fully coalesced 256 B bucket row (eight 32 B sectors); the two
// halves of a slot are matched by a pair shuffle, and found/value reduce
// over the group. The overlay probe, the value == 1 liveness test, the
// overlay override and the live / depth >= 1 gate are fused, so the hit
// mask is the only output.
// ---------------------------------------------------------------------------

__global__ void edge_probe_kernel(
    const int4* __restrict__ dh, uint32_t dh_nb, const int4* __restrict__ dd,
    uint32_t dd_nb, int spb, int dh_pb, int dd_pb, int has_delta,
    const int* __restrict__ obj, const int* __restrict__ rel,
    const int* __restrict__ q, const int4* __restrict__ qsub,
    const int* __restrict__ depth, const uint8_t* __restrict__ live,
    uint8_t* __restrict__ hit, int F) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int task = (int)(gtid / kGroup);
  const int lane = threadIdx.x % kGroup;
  if (task >= F) return;  // the whole group leaves together
  if (!live[task] || depth[task] < 1) {
    if (lane == 0) hit[task] = 0;
    return;
  }
  const unsigned gmask = group_mask();
  const int4 s = qsub[q[task]];
  const int key[5] = {obj[task], rel[task], s.x, s.y, s.z};
  const uint32_t h1 = key_hash(key, 5);
  const uint32_t h2 = stride_hash(h1);
  bool found;
  int val;
  probe_edge_table(dh, dh_nb, spb, dh_pb, key, h1, h2, lane, gmask, found, val);
  bool out = found && val == 1;
  if (has_delta) {
    probe_edge_table(dd, dd_nb, spb, dd_pb, key, h1, h2, lane, gmask, found, val);
    if (found) out = val == 1;
  }
  if (lane == 0) hit[task] = out;
}

// ---------------------------------------------------------------------------
// K2 pair_probe
//
// Bound: bytes. Each (task, slot) reads ceil(probes/spb) bucket rows of a
// [cap, 4] int32 table (256 B each under the bucketized layout). Design:
// 16 threads per (task, slot), one 16-byte slot per thread per round, so
// a round is one coalesced bucket row; both value lanes reduce over the
// group, so the rh span probe returns (row_start, row_end) from the same
// reads.
// ---------------------------------------------------------------------------

__global__ void pair_probe_kernel(
    const int4* __restrict__ pack, uint32_t nb, int spb, int pb,
    const int* __restrict__ obj, const int* __restrict__ rels, int F, int S,
    int n_vals, int* __restrict__ out) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long task = gtid / kGroup;
  const int lane = threadIdx.x % kGroup;
  if (task >= (long long)F * S) return;
  const unsigned gmask = group_mask();
  int v0, v1;
  probe_pair_table(pack, nb, spb, pb, obj[task / S], rels[task], lane, gmask, v0, v1);
  if (lane == 0) {
    out[task * n_vals] = v0;
    if (n_vals == 2) out[task * 2 + 1] = v1;
  }
}

// ---------------------------------------------------------------------------
// Block-wide exclusive scan (any block size that is a multiple of 32).
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// K3 expand_gather
//
// Bound: bytes, and latency at these sizes: the counts are F*S ints and
// the outputs six [F] columns, a few hundred KB in all. Design: pass 1 is
// one block that scans the counts in thread-contiguous chunks (so the
// offsets come out in candidate order) and raises the frontier-overflow
// cause of every segment the cap cuts off; pass 2 gives each output slot
// j a binary search for the last segment whose offset is <= j (the
// searchsorted map of the JAX kernel), then gathers the source columns
// and the (obj, rel) edge pair. Candidates land in the same order as the
// JAX kernel's.
// ---------------------------------------------------------------------------

__global__ void expand_scan_kernel(
    const int* __restrict__ counts, int n, int F, int S, const int* __restrict__ q,
    int* __restrict__ offsets, int* __restrict__ total_out, int* __restrict__ overflow) {
  __shared__ unsigned warp_sums[32];
  const int t = threadIdx.x;
  const int chunk = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, t * chunk);
  const int hi = min(n, lo + chunk);
  unsigned s = 0;
  for (int i = lo; i < hi; ++i) s += (unsigned)counts[i];
  unsigned run = block_exclusive_scan(s, warp_sums);
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    offsets[i] = (int)run;
    if (c > 0 && (int)(run + (unsigned)c) > F) {
      atomicMax(&overflow[q[i / S]], kCauseFrontierOverflow);
    }
    run += (unsigned)c;
  }
  if (t == (int)blockDim.x - 1) *total_out = (int)run;
}

__global__ void expand_gather_kernel(
    const int* __restrict__ offsets, int n, const int* __restrict__ total, int F, int S,
    const int* __restrict__ starts, const int* __restrict__ slot_ctx,
    const int* __restrict__ crel, const int* __restrict__ is_comp,
    const int* __restrict__ q, const int* __restrict__ obj,
    const int* __restrict__ depth, const int2* __restrict__ e_pack, int n_edges,
    int wildcard_rel, int* __restrict__ out_q, int* __restrict__ out_ctx,
    int* __restrict__ out_obj, int* __restrict__ out_rel, int* __restrict__ out_depth,
    uint8_t* __restrict__ out_valid) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= F) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= j) lo = mid + 1; else hi = mid;
  }
  const int seg = min(max(lo - 1, 0), n - 1);
  const int ti = seg / S;
  const bool slot0 = (seg % S) == 0;
  const bool comp = is_comp[seg] != 0;
  const bool in_range = j < min(*total, F);
  const int within = j - offsets[seg];
  int e = starts[seg] + within;
  e = min(max(e, 0), max(n_edges - 1, 0));
  int eo = 0, er = 0;
  if (n_edges > 0) {
    const int2 p = e_pack[e];
    eo = p.x;
    er = p.y;
  }
  out_q[j] = q[ti];
  out_ctx[j] = slot_ctx[seg];
  out_obj[j] = comp ? obj[ti] : eo;
  out_rel[j] = slot0 ? er : crel[seg];
  out_depth[j] = comp ? depth[ti] : depth[ti] - 1;
  out_valid[j] = in_range && !(slot0 && er == wildcard_rel);
}

// ---------------------------------------------------------------------------
// K4 dedupe_compact
//
// Bound: bytes and atomics: G candidates of 24 B each read twice, one
// atomicMax each into a 2G-bucket table that stays in L2, F frontier rows
// written. Design: pass 1 races every valid candidate for its bucket
// with atomicMax on the unsigned priority (depth << idx_bits) | index;
// pass 2 is one block: each thread takes a contiguous chunk, reads its
// candidates' winners back, applies the same-key test, scans the keep
// counts, and writes the survivors to the next frontier in candidate
// order (zeros past the survivors, as the JAX scatter leaves them).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t hash3(int a, int b, int c) {
  return mix32(mix32(mix32(kGolden ^ (uint32_t)a) ^ (uint32_t)b) ^ (uint32_t)c);
}

__global__ void dedupe_claim_kernel(
    const int* __restrict__ ctx, const int* __restrict__ obj, const int* __restrict__ rel,
    const int* __restrict__ depth, const uint8_t* __restrict__ valid, int G,
    uint32_t cap, int idx_bits, unsigned* __restrict__ winner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G || !valid[i]) return;
  const uint32_t b = hash3(ctx[i], obj[i], rel[i]) & (cap - 1u);
  const uint32_t dmax = (1u << (32 - idx_bits)) - 1u;
  const int d = depth[i];
  const uint32_t dc = d < 0 ? 0u : min((uint32_t)d, dmax);
  atomicMax(&winner[b], (dc << idx_bits) | (uint32_t)i);
}

__device__ __forceinline__ bool dedupe_keep(
    int i, const int* ctx, const int* obj, const int* rel, const uint8_t* valid,
    uint32_t cap, uint32_t idx_mask, const unsigned* winner) {
  if (!valid[i]) return false;
  const int c = ctx[i], o = obj[i], r = rel[i];
  const int w = (int)(winner[hash3(c, o, r) & (cap - 1u)] & idx_mask);
  if (w == i) return true;
  return !(ctx[w] == c && obj[w] == o && rel[w] == r);
}

__global__ void dedupe_compact_kernel(
    const int* __restrict__ q, const int* __restrict__ ctx, const int* __restrict__ obj,
    const int* __restrict__ rel, const int* __restrict__ depth,
    const uint8_t* __restrict__ valid, int G, int F, uint32_t cap, int idx_bits,
    const unsigned* __restrict__ winner, int* __restrict__ overflow,
    int* __restrict__ nt_q, int* __restrict__ nt_ctx, int* __restrict__ nt_obj,
    int* __restrict__ nt_rel, int* __restrict__ nt_depth, int* __restrict__ n_new) {
  __shared__ unsigned warp_sums[32];
  __shared__ int kept_total;
  const uint32_t idx_mask = (1u << idx_bits) - 1u;
  const int t = threadIdx.x;
  const int chunk = (G + blockDim.x - 1) / blockDim.x;
  const int lo = min(G, t * chunk);
  const int hi = min(G, lo + chunk);
  unsigned s = 0;
  for (int i = lo; i < hi; ++i) s += dedupe_keep(i, ctx, obj, rel, valid, cap, idx_mask, winner);
  unsigned pos = block_exclusive_scan(s, warp_sums);
  for (int i = lo; i < hi; ++i) {
    if (!dedupe_keep(i, ctx, obj, rel, valid, cap, idx_mask, winner)) continue;
    if ((int)pos < F) {
      nt_q[pos] = q[i];
      nt_ctx[pos] = ctx[i];
      nt_obj[pos] = obj[i];
      nt_rel[pos] = rel[i];
      nt_depth[pos] = depth[i];
    } else {
      atomicMax(&overflow[q[i]], kCauseFrontierOverflow);
    }
    ++pos;
  }
  if (t == (int)blockDim.x - 1) kept_total = (int)pos;
  __syncthreads();
  const int n_in = min(kept_total, F);
  for (int p = n_in + t; p < F; p += blockDim.x) {
    nt_q[p] = 0;
    nt_ctx[p] = 0;
    nt_obj[p] = 0;
    nt_rel[p] = 0;
    nt_depth[p] = 0;
  }
  if (t == 0) *n_new = n_in;
}

}  // namespace

extern "C" {

const char* keto_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int keto_edge_probe(
    const int* dh, long long dh_cap, const int* dd, long long dd_cap, int spb,
    int dh_probes, int dd_probes, int has_delta, const int* obj, const int* rel,
    const int* q, const int* qsub, const int* depth, const uint8_t* live,
    uint8_t* hit, int F, void* stream) {
  if (F > 0) {
    edge_probe_kernel<<<blocks_for((long long)F * kGroup, kProbeThreads),
                        kProbeThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)dh, (uint32_t)(dh_cap / spb), (const int4*)dd,
        (uint32_t)(dd_cap / spb), spb, (dh_probes + spb - 1) / spb,
        (dd_probes + spb - 1) / spb, has_delta, obj, rel, q, (const int4*)qsub,
        depth, live, hit, F);
  }
  return (int)cudaGetLastError();
}

int keto_pair_probe(
    const int* pack, long long cap, int spb, int probes, const int* obj,
    const int* rels, int F, int S, int n_vals, int* out, void* stream) {
  const long long tasks = (long long)F * S;
  if (tasks > 0) {
    pair_probe_kernel<<<blocks_for(tasks * kGroup, kProbeThreads), kProbeThreads, 0,
                        (cudaStream_t)stream>>>(
        (const int4*)pack, (uint32_t)(cap / spb), spb, (probes + spb - 1) / spb, obj,
        rels, F, S, n_vals, out);
  }
  return (int)cudaGetLastError();
}

int keto_expand_gather(
    const int* counts, const int* starts, const int* slot_ctx, const int* crel,
    const int* is_comp, const int* q, const int* obj, const int* depth,
    const int* e_pack, int n_edges, int F, int S, int n_queries, int wildcard_rel,
    int* offsets, int* total, int* overflow, int* out_q, int* out_ctx, int* out_obj,
    int* out_rel, int* out_depth, uint8_t* out_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n = F * S;
  cudaMemsetAsync(overflow, 0, sizeof(int) * (size_t)n_queries, st);
  if (n > 0) {
    expand_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, n, F, S, q, offsets, total,
                                                   overflow);
    expand_gather_kernel<<<blocks_for(F, 256), 256, 0, st>>>(
        offsets, n, total, F, S, starts, slot_ctx, crel, is_comp, q, obj, depth,
        (const int2*)e_pack, n_edges, wildcard_rel, out_q, out_ctx, out_obj, out_rel,
        out_depth, out_valid);
  }
  return (int)cudaGetLastError();
}

int keto_dedupe_compact(
    const int* q, const int* ctx, const int* obj, const int* rel, const int* depth,
    const uint8_t* valid, int G, int F, int n_queries, int cap, int idx_bits,
    unsigned* winner, int* overflow, int* nt_q, int* nt_ctx, int* nt_obj, int* nt_rel,
    int* nt_depth, int* n_new, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(winner, 0, sizeof(unsigned) * (size_t)cap, st);
  cudaMemsetAsync(overflow, 0, sizeof(int) * (size_t)n_queries, st);
  if (G > 0) {
    dedupe_claim_kernel<<<blocks_for(G, 256), 256, 0, st>>>(
        ctx, obj, rel, depth, valid, G, (uint32_t)cap, idx_bits, winner);
  }
  dedupe_compact_kernel<<<1, kScanThreads, 0, st>>>(
      q, ctx, obj, rel, depth, valid, G, F, (uint32_t)cap, idx_bits, winner, overflow,
      nt_q, nt_ctx, nt_obj, nt_rel, nt_depth, n_new);
  return (int)cudaGetLastError();
}

}  // extern "C"

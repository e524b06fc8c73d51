// The check kernel's irregular primitives measured alone, for Hopper
// (sm_90a), with a plain C interface bound by ctypes
// (keto_tpu_torch/engine/cuda_ops.py): a gather, a scatter-max, an
// order-preserving stream compaction and a double-hash probe, beside the
// three feasibility probes of the TPU tools. Every kernel launches on the
// caller's stream, allocates nothing, and computes exactly what its plain
// PyTorch version in keto_tpu_torch/tools/microbench.py computes; each
// entry point returns cudaGetLastError() (or the error of the attribute
// call before it).
//
// The TPU bodies are serial fori_loops on one core's scalar unit; these
// kernels compute the same functions in parallel. Where the order of the
// updates shows in the result (the compaction) the kernels keep it:
// offsets come from scans in input order, never from an atomic slot
// allocator. The scatter-max needs no order (max commutes).
//
// M1  keto_mb_probe          replaces tools/microbench_pallas.py probe_kernel
//                            (:51) through pallas_call with VMEM (:59)
// M2  keto_mb_probe_smem     the same body with SMEM (:74)
// M3  keto_mb_scatmax        scatmax_kernel (:94, call :107), VMEM: from
//                            kScatBinned updates a bin pass and an own
//                            pass, below it global atomics
// M4  keto_mb_scatmax_smem   scatmax_kernel, SMEM (the same call, :107):
//                            one cluster over distributed shared memory
// M5  keto_mb_pack_onepass   pack_kernel (:137, call :153), one pass
// M6  keto_mb_pack           pack_kernel, one cooperative launch
// M7  keto_mb_hashprobe      hashprobe_kernel (:181, call :204)
// M8  keto_mb_add            tools/microbench_pallas_feasibility.py
//                            add_kernel (:41, call :47)
// M9  keto_mb_row_gather     vgather_kernel (:58, call :65)
// M10 keto_mb_block_gather   gkern / gather_blocks (:80, :83, call :90)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "lookback.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBigBlock = 1024;
// the most dynamic shared memory a block takes here: Hopper's 227 KB less
// 1 KB for static shared memory (cuda_ops.MAX_DYNAMIC_SMEM); M2's table
// and M4's slices
constexpr int kSmemMax = 232448 - 1024;
// M5 and M6: a block compacts one tile of kRounds rounds of 4 inputs a
// thread, all loaded before any is scanned: 8 rounds (tiles of 8,192)
// from kOnepassLarge inputs on, so a 2^20 launch is 128 tiles, about one
// an SM; 4 below it, where more tiles spread a small launch over more
// blocks (PERF.md §6: 2 rounds lost at 2^20, 8 at F = 16,384)
constexpr int kOnepassLarge = 1 << 18;

inline int onepass_rounds(int F) { return F >= kOnepassLarge ? 8 : 4; }

// M3: from kScatBinned updates on, a bin pass over tiles of kBinTile
// updates (kBinPer a thread) and an own pass, one block a range of
// 2^shift buckets: shift is kRangeShift, or larger where more than
// 2^kMaxRangesLog2 ranges would cover the output, and an owner then walks
// its range in parts of kRange buckets, its shared memory. A warp loads
// kOwnPerRun pairs a lane from each of kOwnRuns runs before it applies
// any; the rest of a longer run goes on a queue of up to kQueue runs,
// read kOwnPer pairs a thread at a time. Below kScatBinned, a memset and one global atomic an update,
// which were faster up to 786,432 updates and slower at 2^20 (PERF.md
// §6).
constexpr int kScatBinned = 1 << 20;
constexpr int kBinThreads = 256;
constexpr int kBinPer = 16;
constexpr int kBinTile = kBinThreads * kBinPer;
constexpr int kRangeShift = 14;
constexpr int kRange = 1 << kRangeShift;
constexpr int kMaxRangesLog2 = 10;
constexpr int kOwnThreads = 1024;
constexpr int kOwnRuns = 4;
constexpr int kOwnPerRun = 2;
constexpr int kOwnPer = 8;
constexpr int kQueue = 1024;
// M4: one cluster of kCluster blocks of kClusterThreads, each holding a
// slice of at most kSliceMax buckets (kSmemMax bytes); kClusterPer
// updates a thread loaded before any is applied.
// 16 blocks is past the portable 8, allowed by a function attribute.
constexpr int kCluster = 16;
constexpr int kClusterThreads = 256;
constexpr int kClusterPer = 4;
constexpr int kSliceMax = kSmemMax / 4;

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

// Runs set() on the caller's current device until it succeeds there once:
// function attributes belong to a device, and setting them on every call
// costs a runtime call each.
template <class Set>
cudaError_t once_per_device(std::atomic<unsigned long long>& done, Set set) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = set();
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// Exclusive prefix in place of s[0, n) in index order, n <= kPer *
// blockDim.x (kPer consecutive entries a thread); returns the sum. All
// threads of the block call it; it ends with a barrier.
template <int kPer>
__device__ int block_scan_shared(int* s, int n, unsigned* warp_sums) {
  const int i0 = threadIdx.x * kPer;
  int v[kPer];
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = i0 + j < n ? s[i0 + j] : 0;
    sum += (unsigned)v[j];
  }
  unsigned total;
  int run = (int)block_exclusive_scan(sum, warp_sums, &total);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (i0 + j < n) s[i0 + j] = run;
    run += v[j];
  }
  __syncthreads();
  return (int)total;
}

// ---------------------------------------------------------------------------
// M1 probe: out[i] = tab[idx[i]]
//
// Bound: bytes: idx and out once, and one 32-byte sector of tab for each
// distinct sector the indices touch (the table is 128 KB at the tool's
// size, so it stays in L2 after the first touches). Design: one thread
// per index, from global memory through the read-only path; a warp's
// index and output accesses are coalesced, its table reads are 32
// independent sector loads.
// ---------------------------------------------------------------------------

__global__ void probe_kernel(const int* __restrict__ tab, const int* __restrict__ idx, int F,
                             int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < F) out[i] = __ldg(tab + __ldg(idx + i));
}

// ---------------------------------------------------------------------------
// M2 probe_smem: the same gather from a copy of the table in shared memory
//
// Bound: as M1. Design: the TPU's SMEM variant keeps the whole table in
// the core's scalar memory; here each block of 1024 threads gathers its
// 1024 indices from a copy of the whole table in its dynamic shared
// memory (128 KB at the tool's size). Staging the table into each SM is
// the kernel's time, so both of the SM's ways in carry it at once: one
// thread asks the Tensor Memory Accelerator for the first half (one
// cp.async.bulk, completed on an mbarrier in shared memory), while every
// thread loads its index and its share of the second half with 16-byte
// loads, all in flight before any is stored; the block then waits on
// the barrier and gathers. The bulk copy takes no registers, so the
// largest table a block holds needs at most kStageLoads loads a thread,
// one batch under the 64 registers a thread of 1024 may have. Measured
// (PERF.md §6): the parent's loop of loads 0.00292 ms, the whole table
// by one bulk copy 0.00295, by loads alone 0.00238, half and half
// 0.00241-0.00245; one SM takes in ~107 GB/s by loads, ~75 by one bulk
// copy; clusters sharing the table by multicast or spreading it over
// distributed shared memory lost (0.0036, 0.0043).
// ---------------------------------------------------------------------------

// 16-byte loads a thread for the threads' half of the largest table
constexpr int kStageLoads = (kSmemMax / 32 + kBigBlock - 1) / kBigBlock;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One thread: initialises the mbarrier at `bar` for one arrival, makes
// that visible to the async proxy, and arrives expecting `bytes`
__device__ __forceinline__ void bar_init_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the mbarrier's first phase completes
__device__ __forceinline__ void bar_wait0(unsigned bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global
// memory to this block's shared memory in one bulk copy, completed on
// `bar`: a block's shared memory is below the barrier's transaction
// limit, so one copy always fits one phase
static_assert(kSmemMax < (1 << 20), "an mbarrier phase counts fewer than 2^20 bytes");
static_assert(kStageLoads * kBigBlock >= kSmemMax / 32, "the threads' half fits one batch");
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  if (bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(kBigBlock) probe_smem_kernel(const int* __restrict__ tab,
                                                               int cap, const int* __restrict__ idx,
                                                               int F, int* __restrict__ out) {
  extern __shared__ int4 s_tab4[];
  __shared__ unsigned long long s_bar;
  const unsigned bar = smem_u32(&s_bar);
  const int cap4 = cap / 4, bulk4 = cap4 / 2;
  if (threadIdx.x == 0) {
    bar_init_expect(bar, 16u * bulk4);
    bulk_load(smem_u32(s_tab4), tab, 16u * bulk4, bar);
  }
  const int i = blockIdx.x * kBigBlock + threadIdx.x;
  const int k = i < F ? __ldg(idx + i) : 0;
  const int4* tab4 = reinterpret_cast<const int4*>(tab);
  int4 r[kStageLoads];
#pragma unroll
  for (int j = 0; j < kStageLoads; ++j) {
    const int c = bulk4 + threadIdx.x + j * kBigBlock;
    if (c < cap4) r[j] = __ldg(tab4 + c);
  }
#pragma unroll
  for (int j = 0; j < kStageLoads; ++j) {
    const int c = bulk4 + threadIdx.x + j * kBigBlock;
    if (c < cap4) s_tab4[c] = r[j];
  }
  __syncthreads();  // the loaded half stored, the barrier initialised
  bar_wait0(bar);
  if (i < F) out[i] = reinterpret_cast<const int*>(s_tab4)[k];
}

// ---------------------------------------------------------------------------
// M3 scatmax: out = zeros(n_out); out[b[i]] = max(out[b[i]], p[i])
//
// Bound: bytes: b and p read once, the whole [n_out] output written once
// (16 bytes an update at the tool's n_out = 2F). The max commutes, so the
// order of the updates does not show, and a priority of at most 0 never
// beats the zero the output starts at: the bin pass drops those updates.
//
// Below kScatBinned updates: a memset, then one thread an update with a
// global atomicMax. From kScatBinned on: bin, then own; no memset and no
// global atomic. The memset and atomics wrote the output twice and made
// every update its own read-modify-write of a sector in L2, at the L2
// atomic units' rate: 0.0134 ms at F = 2^20 on an output already in L2,
// half that with the updates sorted by bucket (PERF.md §6).
// Bin pass: a block takes a tile of kBinTile updates (16 a thread, all
// loaded before any is used), counts them by range (bucket >> shift) in
// shared memory (one atomic for a warp wholly in one range, else one an
// update), scans the counts, writes its range offsets to `offsets`
// ([n_ranges + 1] rows of n_tiles, the last row the tile's total), places
// each update in its range's run of a sorted copy of the tile in shared
// memory as (bucket within its range, priority), and writes the copy to
// its own segment of the pairs with 16-byte stores. No tile reads
// another's output, so no look-back. Own pass: one block a range zeroes
// its buckets in shared memory, reads every tile's run of its range (a
// warp kOwnRuns runs at a time, every load in flight before any
// shared atomicMax; the rest of a run past kOwnPerRun pairs a lane read
// by the whole block, so updates sorted by bucket, few long runs a
// range, spread over its warps), and writes each bucket once with
// 16-byte stores.
// Each pass moves 16 bytes an update, as much as one memory-bound pass
// over them, so the two take about twice the bound. Under skew (every
// update in one range) one owner block reads all the pairs at one SM's
// load rate; every answer is still exact (PERF.md §6, m3_skew).
// ---------------------------------------------------------------------------

__global__ void scatmax_kernel(const int* __restrict__ b, const int* __restrict__ p, int F,
                               int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < F) atomicMax(out + __ldg(b + i), __ldg(p + i));
}

__global__ void __launch_bounds__(kBinThreads) scatmax_bin_kernel(
    const int* __restrict__ b, const int* __restrict__ p, int F, int n_out, int shift,
    int n_ranges, int n_tiles, int2* __restrict__ pairs, int* __restrict__ offsets) {
  constexpr int kScanPer = (1 << kMaxRangesLog2) / kBinThreads;
  extern __shared__ int4 smem4[];
  int2* s_pairs = reinterpret_cast<int2*>(smem4);
  int* s_cnt = reinterpret_cast<int*>(s_pairs + kBinTile);
  __shared__ unsigned warp_sums[32];
  const int t = blockIdx.x;
  const long long lo = (long long)t * kBinTile;
  const int n = (int)min((long long)kBinTile, F - lo);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x; r < n_ranges; r += kBinThreads) s_cnt[r] = 0;
  int k[kBinPer], v[kBinPer], rank[kBinPer];
#pragma unroll
  for (int j = 0; j < kBinPer; ++j) {
    const int i = j * kBinThreads + threadIdx.x;
    k[j] = i < n ? __ldg(b + lo + i) : 0;
    v[j] = i < n ? __ldg(p + lo + i) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kBinPer; ++j) {
    const int r = v[j] > 0 && (unsigned)k[j] < (unsigned)n_out ? k[j] >> shift : -1;
    const int r0 = __shfl_sync(0xFFFFFFFFu, r, 0);
    if (__all_sync(0xFFFFFFFFu, r == r0)) {  // the warp in one range: one atomic
      int base = 0;
      if (lane == 0 && r0 >= 0) base = atomicAdd(s_cnt + r0, 32);
      rank[j] = r0 >= 0 ? __shfl_sync(0xFFFFFFFFu, base, 0) + lane : -1;
    } else {
      rank[j] = r >= 0 ? atomicAdd(s_cnt + r, 1) : -1;
    }
  }
  __syncthreads();
  const int total = block_scan_shared<kScanPer>(s_cnt, n_ranges, warp_sums);
  for (int r = threadIdx.x; r <= n_ranges; r += kBinThreads) {
    offsets[(long long)r * n_tiles + t] = r < n_ranges ? s_cnt[r] : total;
  }
  const int mask = (1 << shift) - 1;
#pragma unroll
  for (int j = 0; j < kBinPer; ++j) {
    if (rank[j] >= 0) s_pairs[s_cnt[k[j] >> shift] + rank[j]] = make_int2(k[j] & mask, v[j]);
  }
  __syncthreads();
  int4* dst = reinterpret_cast<int4*>(pairs + lo);
  for (int c = threadIdx.x; c < total / 2; c += kBinThreads) dst[c] = smem4[c];
  if ((total & 1) && threadIdx.x == 0) pairs[lo + total - 1] = s_pairs[total - 1];
}

__device__ __forceinline__ void own_apply(int* s_out, int2 pr, int c_off, int len) {
  const int x = pr.x - c_off;
  if ((unsigned)x < (unsigned)len) atomicMax(s_out + x, pr.y);
}

// Applies pairs first, first + stride, ... below n of `run`, kOwnPer a
// thread loaded before any is applied
__device__ __forceinline__ void own_stream(int* s_out, const int2* __restrict__ run, int n,
                                           int first, int stride, int c_off, int len) {
  for (int x0 = first; x0 < n; x0 += stride * kOwnPer) {
    int2 pr[kOwnPer];
#pragma unroll
    for (int u = 0; u < kOwnPer; ++u) {
      const int x = x0 + stride * u;
      pr[u] = x < n ? __ldg(run + x) : make_int2(-1, 0);
    }
#pragma unroll
    for (int u = 0; u < kOwnPer; ++u) own_apply(s_out, pr[u], c_off, len);
  }
}

__global__ void __launch_bounds__(kOwnThreads, 1) scatmax_own_kernel(
    const int2* __restrict__ pairs, const int* __restrict__ offsets, int n_tiles, int shift,
    int n_out, int* __restrict__ out) {
  constexpr int kWarps = kOwnThreads / 32;
  constexpr int kHead = 32 * kOwnPerRun;  // pairs of a run its warp reads
  extern __shared__ int4 smem4[];
  int* s_out = reinterpret_cast<int*>(smem4);
  __shared__ int2 s_queue[kQueue];  // a long run's rest: (tile, its first pair in the tile)
  __shared__ int s_qlen[kQueue];    // and its length
  __shared__ int s_nq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* lo_off = offsets + (long long)blockIdx.x * n_tiles;
  const int* hi_off = lo_off + n_tiles;
  const long long range_lo = (long long)blockIdx.x << shift;
  const long long range_hi = min(range_lo + (1ll << shift), (long long)n_out);
  const int2 none = make_int2(-1, 0);
  for (long long c_lo = range_lo; c_lo < range_hi; c_lo += kRange) {
    const int len = (int)min((long long)kRange, range_hi - c_lo);
    const int c_off = (int)(c_lo - range_lo);
    for (int c = threadIdx.x; c < (len + 3) / 4; c += kOwnThreads) smem4[c] = make_int4(0, 0, 0, 0);
    if (threadIdx.x == 0) s_nq = 0;
    __syncthreads();
    for (int t0 = warp; t0 < n_tiles; t0 += kWarps * kOwnRuns) {
      int st[kOwnRuns], ln[kOwnRuns];
#pragma unroll
      for (int q = 0; q < kOwnRuns; ++q) {
        const int t = t0 + q * kWarps;
        st[q] = t < n_tiles ? __ldg(lo_off + t) : 0;
        ln[q] = t < n_tiles ? __ldg(hi_off + t) - st[q] : 0;
      }
      int2 pr[kOwnRuns][kOwnPerRun];
#pragma unroll
      for (int q = 0; q < kOwnRuns; ++q) {
        const int2* run = pairs + (long long)(t0 + q * kWarps) * kBinTile + st[q];
#pragma unroll
        for (int i = 0; i < kOwnPerRun; ++i) {
          const int x = lane + 32 * i;
          pr[q][i] = x < ln[q] ? __ldg(run + x) : none;
        }
      }
#pragma unroll
      for (int q = 0; q < kOwnRuns; ++q) {
#pragma unroll
        for (int i = 0; i < kOwnPerRun; ++i) own_apply(s_out, pr[q][i], c_off, len);
      }
#pragma unroll
      for (int q = 0; q < kOwnRuns; ++q) {
        if (ln[q] <= kHead) continue;
        int e = 0;
        if (lane == 0) e = atomicAdd(&s_nq, 1);
        e = __shfl_sync(0xFFFFFFFFu, e, 0);
        if (e < kQueue) {
          if (lane == 0) {
            s_queue[e] = make_int2(t0 + q * kWarps, st[q] + kHead);
            s_qlen[e] = ln[q] - kHead;
          }
          continue;
        }
        // the queue is full: the warp reads the rest itself
        own_stream(s_out, pairs + (long long)(t0 + q * kWarps) * kBinTile + st[q], ln[q],
                   kHead + lane, 32, c_off, len);
      }
    }
    __syncthreads();
    // the queued rests: a warp each, round robin, when there are enough
    // to keep every warp busy (skew: all of a range's runs long); else
    // each read by the whole block in turn (a few long runs, as when the
    // updates come sorted by bucket)
    const int nq = min(s_nq, kQueue);
    const bool by_warp = nq >= kWarps;
    for (int e = by_warp ? warp : 0; e < nq; e += by_warp ? kWarps : 1) {
      const int2 at = s_queue[e];
      own_stream(s_out, pairs + (long long)at.x * kBinTile + at.y, s_qlen[e],
                 by_warp ? lane : (int)threadIdx.x, by_warp ? 32 : kOwnThreads, c_off, len);
    }
    __syncthreads();
    int4* o4 = reinterpret_cast<int4*>(out + c_lo);
    for (int c = threadIdx.x; c < len / 4; c += kOwnThreads) o4[c] = smem4[c];
    for (int c = (len & ~3) + threadIdx.x; c < len; c += kOwnThreads) out[c_lo + c] = s_out[c];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// M4 scatmax_smem: the same function, the output held in shared memory
//
// Bound: as M3. Design: the TPU's SMEM variant keeps the output in the
// scalar core's memory; here one thread-block cluster of kCluster blocks
// holds it in their shared memory, a slice of n_out / kCluster buckets
// (padded to 4) a block. Each block zeroes its slice and arrives at the
// cluster barrier (releasing the zeroes), loads its first updates, waits
// there, then applies each of its contiguous 1 / kCluster of the updates
// to the owning block's slice by a red.shared::cluster max through
// distributed shared memory; the cluster syncs again, and each block
// writes its slice once with 16-byte stores. One launch and no memset.
// One block held the output on one SM before, whose serial updates set
// its time. Remote updates cost about 5x a local shared atomic here, and
// a cluster barrier ~0.0006 ms: binning the updates by owner and pulling
// them over distributed shared memory instead lost, as did 8 blocks, or
// 128, 512 and 1,024 threads a block (PERF.md §6). Capacity:
// kCluster x kSliceMax buckets (the wrapper refuses more).
// ---------------------------------------------------------------------------

// *at = max(*at, v) at the same shared-memory offset in the cluster's
// block `rank`, with no result back: one red.shared::cluster a call
__device__ __forceinline__ void cluster_max(int* at, int rank, int v) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"((unsigned)__cvta_generic_to_shared(at)), "r"(rank));
  asm volatile("red.relaxed.cluster.shared::cluster.max.s32 [%0], %1;" ::"r"(remote), "r"(v)
               : "memory");
}

__global__ void __launch_bounds__(kClusterThreads) scatmax_cluster_kernel(
    const int* __restrict__ b, const int* __restrict__ p, int F, int n_out, int slice,
    int* __restrict__ out) {
  namespace cg = cooperative_groups;
  extern __shared__ int4 s_slice4[];
  int* s_slice = reinterpret_cast<int*>(s_slice4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  for (int c = threadIdx.x; c < slice / 4; c += kClusterThreads) s_slice4[c] = make_int4(0, 0, 0, 0);
  // arrive (releasing this block's zeroes), load the first updates, then
  // wait for every block's: the barrier's latency hides behind the loads
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  const long long per = (F + kCluster - 1) / kCluster;
  const int lo = (int)min(rank * per, (long long)F);
  const int hi = (int)min(lo + per, (long long)F);
  int k[kClusterPer], v[kClusterPer];
  int i0 = lo + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kClusterPer; ++u) {
    const int i = i0 + u * kClusterThreads;
    k[u] = i < hi ? __ldg(b + i) : 0;
    v[u] = i < hi ? __ldg(p + i) : 0;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  while (true) {
#pragma unroll
    for (int u = 0; u < kClusterPer; ++u) {
      if (v[u] > 0 && (unsigned)k[u] < (unsigned)n_out) {
        const int owner = k[u] / slice;
        cluster_max(s_slice + (k[u] - owner * slice), owner, v[u]);
      }
    }
    i0 += kClusterPer * kClusterThreads;
    if (i0 >= hi) break;
#pragma unroll
    for (int u = 0; u < kClusterPer; ++u) {
      const int i = i0 + u * kClusterThreads;
      k[u] = i < hi ? __ldg(b + i) : 0;
      v[u] = i < hi ? __ldg(p + i) : 0;
    }
  }
  cluster.sync();  // every update applied, and no block gone while updated
  const long long base = rank * (long long)slice;
  const int len = (int)max(0ll, min((long long)slice, n_out - base));
  int4* o4 = reinterpret_cast<int4*>(out + base);
  for (int c = threadIdx.x; c < len / 4; c += kClusterThreads) o4[c] = s_slice4[c];
  for (int c = (len & ~3) + threadIdx.x; c < len; c += kClusterThreads) out[base + c] = s_slice[c];
}

// ---------------------------------------------------------------------------
// M5 and M6 compact in input order, out[:n] = vals[keep != 0], out[n:] =
// 0, n_out[0] = n, on one tiling: a block takes a tile of kRounds x 1,024
// inputs (kRounds = onepass_rounds(F)) and scans it in registers
// (pack_tile_scan); given the count e of the kept inputs before its tile,
// it writes its survivors and its share of the zero tail
// (pack_tile_write). M5 finds e by a decoupled look-back, M6 after a
// grid-wide barrier.
//
// Bound: bytes: keep and vals read once, the [F] output and the count
// written once (12 bytes an input). The TPU body's one-core loop maps to
// one block, which one SM's load rate holds to 1% of the bound at F =
// 2^20: the tiles spread the work over the card.
// ---------------------------------------------------------------------------

// keep flags and values of the 4 inputs from i0 (16-byte loads when all
// four lie below hi; keep, vals and i0 are 16-byte aligned)
__device__ __forceinline__ void load4(const int* __restrict__ keep, const int* __restrict__ vals,
                                      int i0, int hi, int k[4], int v[4]) {
  if (i0 + 3 < hi) {
    const int4 kk = __ldg(reinterpret_cast<const int4*>(keep + i0));
    const int4 vv = __ldg(reinterpret_cast<const int4*>(vals + i0));
    k[0] = kk.x; k[1] = kk.y; k[2] = kk.z; k[3] = kk.w;
    v[0] = vv.x; v[1] = vv.y; v[2] = vv.z; v[3] = vv.w;
  } else {
    for (int e = 0; e < 4; ++e) {
      const bool in = i0 + e < hi;
      k[e] = in ? __ldg(keep + i0 + e) : 0;
      v[e] = in ? __ldg(vals + i0 + e) : 0;
    }
  }
}

constexpr int kPackWarps = kThreads / 32;

// Loads the tile [lo, hi) into k and v (round r, thread j: the 4 inputs
// from lo + 4 (r kThreads + j)), every load issued before any is used,
// and scans its keep counts in input order: c[r] is the thread's count
// in round r, x[r] its inclusive count within its warp's round, and
// s_sums[r kPackWarps + w] becomes the count of the tile before warp w's
// round r. Returns the tile's count in warp 0 (0 in the other warps);
// warp 0 writes s_sums after the block barrier, so the caller syncs the
// block before any other warp reads them.
template <int kRounds>
__device__ __forceinline__ unsigned pack_tile_scan(const int* __restrict__ keep,
                                                   const int* __restrict__ vals, int lo, int hi,
                                                   int (&k)[kRounds][4], int (&v)[kRounds][4],
                                                   unsigned (&c)[kRounds], unsigned (&x)[kRounds],
                                                   unsigned* s_sums) {
  constexpr int kSums = kRounds * kPackWarps;  // warp totals, in input order
  constexpr int kPer = (kSums + 31) / 32;      // of them a lane of the scanning warp
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    load4(keep, vals, lo + (r * kThreads + threadIdx.x) * 4, hi, k[r], v[r]);
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    c[r] = (k[r][0] != 0) + (k[r][1] != 0) + (k[r][2] != 0) + (k[r][3] != 0);
    x[r] = c[r];
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xFFFFFFFFu, x[r], o);
      if (lane >= o) x[r] += y;
    }
    if (lane == 31) s_sums[r * kPackWarps + wid] = x[r];
  }
  __syncthreads();
  if (wid != 0) return 0u;
  unsigned part[kPer], run = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int idx = lane * kPer + j;
    part[j] = idx < kSums ? s_sums[idx] : 0u;
    run += part[j];
  }
  unsigned incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  unsigned before = incl - run;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int idx = lane * kPer + j;
    if (idx < kSums) s_sums[idx] = before;
    before += part[j];
  }
  return __shfl_sync(0xFFFFFFFFu, incl, 31);
}

// Writes the tile's survivors from e, the count before the tile, in
// input order, and its share of the zero tail: with i = e + the tile's
// count, the tile drops hi - lo - (i - e) inputs and zeroes out[i + F -
// hi, e + F - lo), that many positions; the shares of the tiles are
// disjoint, lie at or past the total n, and together cover [n, F). So
// no tile needs n.
template <int kRounds>
__device__ __forceinline__ void pack_tile_write(const int (&k)[kRounds][4],
                                                const int (&v)[kRounds][4],
                                                const unsigned (&c)[kRounds],
                                                const unsigned (&x)[kRounds],
                                                const unsigned* s_sums, unsigned e, unsigned i,
                                                int F, int lo, int hi, int* __restrict__ out) {
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    unsigned pos = e + s_sums[r * kPackWarps + wid] + x[r] - c[r];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k[r][q] != 0) out[pos++] = v[r][q];
    }
  }
  for (long long p = (long long)i + F - hi + threadIdx.x; p < (long long)e + F - lo;
       p += kThreads) {
    out[p] = 0;
  }
}

// ---------------------------------------------------------------------------
// M5 pack_onepass: one launch; tile t's count before it by a decoupled
// look-back (lookback.cuh)
//
// Design: a block takes tile t by an atomic ticket (blocks start in no
// order, and the look-back must only wait on tiles already running),
// publishes its aggregate, looks back for its exclusive prefix e,
// publishes e plus its aggregate (its inclusive prefix i), and writes
// from e. The tile holding the last input writes n. The ticket counter
// and the status words live in a scratch the wrapper zeroes once per
// (device, stream); the block that takes the last ticket returns the
// counter to 0, and each call's epoch tells its status words from an
// earlier call's, so no call needs a memset.
// ---------------------------------------------------------------------------

template <int kRounds>
__global__ void __launch_bounds__(kThreads) pack_onepass_kernel(
    const int* __restrict__ keep, const int* __restrict__ vals, int F, int n_tiles,
    int* __restrict__ out, int* __restrict__ n_out, unsigned* __restrict__ ticket,
    unsigned long long* __restrict__ status, unsigned long long epoch) {
  constexpr int kTile = kRounds * 4 * kThreads;
  __shared__ unsigned s_sums[kRounds * kPackWarps];
  __shared__ int s_tile;
  __shared__ unsigned s_excl, s_agg;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    const int t = (int)atomicAdd(ticket, 1u);
    if (t == n_tiles - 1) *ticket = 0u;  // every ticket is taken: the next call starts at 0
    s_tile = t;
  }
  __syncthreads();
  const int t = s_tile;
  const int lo = t * kTile;
  const int hi = min(F, lo + kTile);
  int k[kRounds][4], v[kRounds][4];
  unsigned c[kRounds], x[kRounds];
  const unsigned agg = pack_tile_scan<kRounds>(keep, vals, lo, hi, k, v, c, x, s_sums);
  if (threadIdx.x < 32) {
    unsigned excl = 0;
    if (t == 0) {
      if (lane == 0) publish(status, epoch, kPrefix, agg);
    } else {
      if (lane == 0) publish(status + t, epoch, kAggregate, agg);
      excl = look_back(status, t, epoch);
      if (lane == 0) publish(status + t, epoch, kPrefix, excl + agg);
    }
    if (lane == 0) {
      s_excl = excl;
      s_agg = agg;
    }
  }
  __syncthreads();
  const unsigned e = s_excl, i = s_excl + s_agg;
  pack_tile_write<kRounds>(k, v, c, x, s_sums, e, i, F, lo, hi, out);
  if (t == n_tiles - 1 && threadIdx.x == 0) *n_out = (int)i;
}

// ---------------------------------------------------------------------------
// M6 pack: one cooperative launch that keeps nothing between calls
//
// Design: one block a tile, every block resident (a cooperative launch,
// refused past the resident grid: keto_mb_pack_capacity). A block scans
// its tile in registers, writes its count to its word of `counts` (a
// scratch the wrapper allocates each call), and waits at a grid-wide
// barrier; then it sums the counts before its tile from L2 and writes
// from there. keep and vals are read once (12 bytes an input). Unlike
// M5 it keeps no ticket, status words or epoch from one call to the
// next, so two streams may run it at once and a CUDA graph may replay
// it. The barrier costs ~0.001 ms at 4 tiles, where M5's look-back is
// cheaper; at 2^20 M6 matches M5. Lost (PERF.md §6): the count and a
// programmatic dependent scatter launch (keep read twice), the
// survivors staged in shared memory for coalesced stores, tiles of
// 2,048 or 4,096 at 2^20.
// ---------------------------------------------------------------------------

template <int kRounds>
__global__ void __launch_bounds__(kThreads) pack_kernel(const int* __restrict__ keep,
                                                        const int* __restrict__ vals, int F,
                                                        int n_tiles, int* __restrict__ counts,
                                                        int* __restrict__ out,
                                                        int* __restrict__ n_out) {
  constexpr int kTile = kRounds * 4 * kThreads;
  __shared__ unsigned s_sums[kRounds * kPackWarps];
  const int t = blockIdx.x, lane = threadIdx.x & 31;
  const int lo = t * kTile;
  const int hi = min(F, lo + kTile);
  int k[kRounds][4], v[kRounds][4];
  unsigned c[kRounds], x[kRounds];
  const unsigned agg = pack_tile_scan<kRounds>(keep, vals, lo, hi, k, v, c, x, s_sums);
  if (threadIdx.x == 0) counts[t] = (int)agg;
  cooperative_groups::this_grid().sync();  // every count written; s_sums too
  // the counts before the tile (e) and through it (i), from L2: below
  // kOnepassLarge inputs (at most 64 tiles) every warp sums them itself;
  // from there warp 0 sums them for the block, as the 8 warps' requests
  // for the same lines queue at L2 (0.0003 ms at F = 2^20, where the
  // barrier after warp 0 costs 0.0002 at 16,384: PERF.md §6)
  constexpr bool kOneWarp = kRounds == 8;
  __shared__ unsigned s_ei[2];
  unsigned e = 0, i = 0;
  if (!kOneWarp || threadIdx.x < 32) {
#pragma unroll 4
    for (int j = lane; j < t; j += 32) e += (unsigned)__ldcg(counts + j);
    for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xFFFFFFFFu, e, o);
    i = e + (unsigned)__ldcg(counts + t);
    if (kOneWarp && lane == 0) {
      s_ei[0] = e;
      s_ei[1] = i;
    }
  }
  if (kOneWarp) {
    __syncthreads();
    e = s_ei[0];
    i = s_ei[1];
  }
  pack_tile_write<kRounds>(k, v, c, x, s_sums, e, i, F, lo, hi, out);
  if (t == n_tiles - 1 && threadIdx.x == 0) *n_out = (int)i;
}

// ---------------------------------------------------------------------------
// M7 hashprobe: the two-probe double hash of the tool
//
// h1 = k * 2654435761 & (cap - 1), h2 = (k * 40503 | 1) & (cap - 1); the
// value at h1 if keys[h1] == k, else at (h1 + h2) & (cap - 1) if that
// slot holds k, else -1. Both products are taken modulo 2^32 (uint32):
// only the low log2(cap) bits reach the mask, so the sign of k does not
// matter. (The TPU body multiplies int32 by a literal past int32's range,
// which does not trace; the function it means is this one.)
//
// Bound: bytes: the queries and the output once, and the sectors of keys
// (at h1, and at the second slot for queries that miss at h1) and of
// vals (at the hit slot) the queries touch. Design: one thread per query;
// the second key load and the value load happen only where the verdict
// needs them, so a miss at h1 costs one more dependent load.
// ---------------------------------------------------------------------------

__global__ void hashprobe_kernel(const int* __restrict__ keys, const int* __restrict__ kvals,
                                 uint32_t mask, const int* __restrict__ q, int F,
                                 int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F) return;
  const int k = __ldg(q + i);
  const uint32_t h1 = ((uint32_t)k * 2654435761u) & mask;
  const uint32_t h2 = (((uint32_t)k * 40503u) | 1u) & mask;
  const bool hit0 = __ldg(keys + h1) == k;
  const uint32_t slot = hit0 ? h1 : (h1 + h2) & mask;
  out[i] = (hit0 || __ldg(keys + slot) == k) ? __ldg(kvals + slot) : -1;
}

// ---------------------------------------------------------------------------
// M8 add: out = x + y, float32
//
// Bound: bytes (x, y read, out written). Design: one thread an element.
// The TPU probe asked whether a kernel compiles and runs at all; at
// [8, 128] this is a launch.
// ---------------------------------------------------------------------------

__global__ void add_kernel(const float* __restrict__ x, const float* __restrict__ y, int n,
                           float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + y[i];
}

// ---------------------------------------------------------------------------
// M9 row_gather: out[i, :] = tab[idx[i], :]
//
// The TPU refuses vector integer indexing of a ref in a kernel; Hopper
// has no such limit, so the vector gather is a kernel. Bound: bytes (idx,
// the gathered rows read, out written). Design: one thread per 16-byte
// chunk of an output row, so a warp moves 512 contiguous bytes of one
// row.
// ---------------------------------------------------------------------------

__global__ void row_gather_kernel(const int* __restrict__ idx, int n, const int4* __restrict__ tab4,
                                  int chunks, int4* __restrict__ out4) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)n * chunks) return;
  const int i = (int)(c / chunks);
  const int w = (int)(c - (long long)i * chunks);
  out4[c] = __ldg(tab4 + (size_t)__ldg(idx + i) * chunks + w);
}

// ---------------------------------------------------------------------------
// M10 block_gather: out block i = tab block bidx[i], blocks of
// block_rows x cols int32 (8 x 128 in the tool)
//
// Bound: bytes (bidx, the gathered blocks read, out written). Design: the
// TPU takes one (8, 128) block per grid step, its index prefetched into
// scalar memory; here one CTA per block index loads its own index and
// copies the block with 16-byte loads, 256 threads for the 4 KB block.
// ---------------------------------------------------------------------------

__global__ void block_gather_kernel(const int* __restrict__ bidx, const int4* __restrict__ tab4,
                                    int chunks, int4* __restrict__ out4) {
  const size_t src = (size_t)__ldg(bidx + blockIdx.x) * chunks;
  const size_t dst = (size_t)blockIdx.x * chunks;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) out4[dst + c] = __ldg(tab4 + src + c);
}

// M3's bin shape: (shift, ranges, tiles) for F updates into n_out buckets
struct ScatShape {
  int shift, n_ranges, n_tiles;
};

ScatShape scat_shape(int F, int n_out) {
  int lg = 0;
  while ((1ll << lg) < n_out) ++lg;
  const int shift = lg - kMaxRangesLog2 > kRangeShift ? lg - kMaxRangesLog2 : kRangeShift;
  return {shift, (int)(((long long)n_out + (1ll << shift) - 1) >> shift), blocks_for(F, kBinTile)};
}

bool scat_binned(int F, int n_out) { return F >= kScatBinned && n_out > 0; }

}  // namespace

extern "C" {

int keto_mb_probe(const int* tab, const int* idx, int F, int* out, void* stream) {
  if (F > 0) {
    probe_kernel<<<blocks_for(F, kThreads), kThreads, 0, (cudaStream_t)stream>>>(tab, idx, F,
                                                                                    out);
  }
  return (int)cudaGetLastError();
}

// cap a multiple of 4 ints, at most kSmemMax bytes; tab 16-byte aligned
int keto_mb_probe_smem(const int* tab, int cap, const int* idx, int F, int* out, void* stream) {
  if (cap < 0 || cap % 4 || cap > kSmemMax / 4) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> attrs{0};
  const cudaError_t e = once_per_device(attrs, [] {
    return cudaFuncSetAttribute(probe_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemMax);
  });
  if (e != cudaSuccess) return (int)e;
  if (F > 0) {
    probe_smem_kernel<<<blocks_for(F, kBigBlock), kBigBlock, 4 * cap, (cudaStream_t)stream>>>(
        tab, cap, idx, F, out);
  }
  return (int)cudaGetLastError();
}

long long keto_mb_scatmax_scratch(int F, int n_out) {
  if (!scat_binned(F, n_out)) return 0;
  const ScatShape s = scat_shape(F, n_out);
  return 2ll * F + (long long)(s.n_ranges + 1) * s.n_tiles;
}

// scratch: keto_mb_scatmax_scratch(F, n_out) ints (the pairs, then the
// range offsets), none below kScatBinned
int keto_mb_scatmax(const int* b, const int* p, int F, int* out, int n_out, void* scratch,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!scat_binned(F, n_out)) {
    cudaMemsetAsync(out, 0, sizeof(int) * (size_t)n_out, st);
    if (F > 0) scatmax_kernel<<<blocks_for(F, kThreads), kThreads, 0, st>>>(b, p, F, out);
    return (int)cudaGetLastError();
  }
  constexpr int kBinSmem = kBinTile * (int)sizeof(int2) + (1 << kMaxRangesLog2) * (int)sizeof(int);
  constexpr int kOwnSmem = kRange * (int)sizeof(int);
  static std::atomic<unsigned long long> attrs{0};
  const cudaError_t e = once_per_device(attrs, [] {
    const cudaError_t a = cudaFuncSetAttribute(
        scatmax_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBinSmem);
    return a != cudaSuccess ? a
                            : cudaFuncSetAttribute(scatmax_own_kernel,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   kOwnSmem);
  });
  if (e != cudaSuccess) return (int)e;
  const ScatShape s = scat_shape(F, n_out);
  int2* pairs = (int2*)scratch;
  int* offsets = (int*)scratch + 2ll * F;
  scatmax_bin_kernel<<<s.n_tiles, kBinThreads, kBinTile * sizeof(int2) + s.n_ranges * sizeof(int),
                       st>>>(b, p, F, n_out, s.shift, s.n_ranges, s.n_tiles, pairs, offsets);
  scatmax_own_kernel<<<s.n_ranges, kOwnThreads, kOwnSmem, st>>>(pairs, offsets, s.n_tiles, s.shift,
                                                                n_out, out);
  return (int)cudaGetLastError();
}

int keto_mb_scatmax_smem_capacity() { return kCluster * kSliceMax; }

// n_out at most keto_mb_scatmax_smem_capacity(); cudaErrorLaunchOutOfResources
// where the card cannot schedule the cluster at this slice
int keto_mb_scatmax_smem(const int* b, const int* p, int F, int* out, int n_out, void* stream) {
  const int slice = ((n_out + kCluster - 1) / kCluster + 3) & ~3;
  if (n_out < 0 || slice > kSliceMax) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> attrs{0};
  cudaError_t e = once_per_device(attrs, [] {
    const cudaError_t a = cudaFuncSetAttribute(scatmax_cluster_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSliceMax * (int)sizeof(int));
    return a != cudaSuccess ? a
                            : cudaFuncSetAttribute(scatmax_cluster_kernel,
                                                   cudaFuncAttributeNonPortableClusterSizeAllowed,
                                                   1);
  });
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = (size_t)slice * sizeof(int);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  // the largest slice (in bytes, plus one) a cluster is known to fit with
  // on each device: asked once for each larger one
  static std::atomic<int> fits[64];
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::atomic<int>& fit = fits[dev & 63];
  if ((int)cfg.dynamicSmemBytes >= fit.load(std::memory_order_relaxed)) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)scatmax_cluster_kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    fit.store((int)cfg.dynamicSmemBytes + 1, std::memory_order_relaxed);
  }
  e = cudaLaunchKernelEx(&cfg, scatmax_cluster_kernel, b, p, F, n_out, slice, out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// M5's and M6's tiles for F inputs
int keto_mb_pack_tiles(int F) {
  return F > 0 ? blocks_for(F, onepass_rounds(F) * 4 * kThreads) : 1;
}

// scratch: a ticket counter word, then a status word a tile; epoch in
// [1, 2^30)
int keto_mb_pack_onepass(const int* keep, const int* vals, int F, int* out, int* n_out,
                         void* scratch, int epoch, void* stream) {
  const int tiles = keto_mb_pack_tiles(F);
  unsigned long long* s = (unsigned long long*)scratch;
  auto kernel = onepass_rounds(F) == 8 ? pack_onepass_kernel<8> : pack_onepass_kernel<4>;
  kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
      keep, vals, F, tiles, out, n_out, (unsigned*)s, s + 1, (unsigned long long)epoch);
  return (int)cudaGetLastError();
}

// The most inputs one M6 launch takes on the caller's device: as many
// tiles of 8,192 as blocks can be resident at once; minus the CUDA error
// where a query fails.
long long keto_mb_pack_capacity() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pack_kernel<8>, kThreads, 0);
  }
  if (e != cudaSuccess) return -(long long)e;
  return (long long)per_sm * sms * (8 * 4 * kThreads);
}

// counts: keto_mb_pack_tiles(F) ints, written before they are read; F at
// most keto_mb_pack_capacity() (past it the launch is refused with
// cudaErrorCooperativeLaunchTooLarge)
int keto_mb_pack(const int* keep, const int* vals, int F, int* counts, int* out, int* n_out,
                 void* stream) {
  int tiles = keto_mb_pack_tiles(F);
  void* args[] = {(void*)&keep, (void*)&vals, (void*)&F, (void*)&tiles, (void*)&counts,
                  (void*)&out, (void*)&n_out};
  const void* kernel =
      onepass_rounds(F) == 8 ? (const void*)pack_kernel<8> : (const void*)pack_kernel<4>;
  const cudaError_t e =
      cudaLaunchCooperativeKernel(kernel, tiles, kThreads, args, 0, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

int keto_mb_hashprobe(const int* keys, const int* kvals, int cap, const int* q, int F, int* out,
                      void* stream) {
  if (F > 0) {
    hashprobe_kernel<<<blocks_for(F, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        keys, kvals, (uint32_t)(cap - 1), q, F, out);
  }
  return (int)cudaGetLastError();
}

int keto_mb_add(const float* x, const float* y, int n, float* out, void* stream) {
  if (n > 0) {
    add_kernel<<<blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(x, y, n, out);
  }
  return (int)cudaGetLastError();
}

int keto_mb_row_gather(const int* idx, int n, const int* tab, int cols, int* out,
                       void* stream) {
  const int chunks = cols / 4;
  const long long threads = (long long)n * chunks;
  if (threads > 0) {
    row_gather_kernel<<<blocks_for(threads, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        idx, n, (const int4*)tab, chunks, (int4*)out);
  }
  return (int)cudaGetLastError();
}

int keto_mb_block_gather(const int* bidx, int nb, const int* tab, int block_ints, int* out,
                         void* stream) {
  const int chunks = block_ints / 4;
  if (nb > 0) {
    block_gather_kernel<<<nb, chunks < kThreads ? chunks : kThreads, 0,
                          (cudaStream_t)stream>>>(
        bidx, (const int4*)tab, chunks, (int4*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

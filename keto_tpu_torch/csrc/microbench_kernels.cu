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
// M3  keto_mb_scatmax        scatmax_kernel (:94, call :107), VMEM
// M4  keto_mb_scatmax_smem   scatmax_kernel, SMEM (the same call, :107)
// M5  keto_mb_pack_block     pack_kernel (:137, call :153), one block
// M6  keto_mb_pack           pack_kernel, many blocks
// M7  keto_mb_hashprobe      hashprobe_kernel (:181, call :204)
// M8  keto_mb_add            tools/microbench_pallas_feasibility.py
//                            add_kernel (:41, call :47)
// M9  keto_mb_row_gather     vgather_kernel (:58, call :65)
// M10 keto_mb_block_gather   gkern / gather_blocks (:80, :83, call :90)

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBigBlock = 1024;
// M6: a block compacts kPackTile inputs, in rounds of 4 per thread
constexpr int kPackTile = 2048;

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
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
// the core's scalar memory; here each block of 1024 threads first stages
// the whole table in dynamic shared memory (16-byte loads, 128 KB at the
// tool's size, which needs cudaFuncSetAttribute above 48 KB), then
// gathers its 1024 indices from it. Every block re-reads the table, so
// at F = 16384 sixteen blocks read 2 MB from L2 for a gather whose
// random reads M1 serves from L2 directly: the variant pays only where
// each block gathers many times its table's size.
// ---------------------------------------------------------------------------

__global__ void probe_smem_kernel(const int4* __restrict__ tab4, int cap4,
                                  const int* __restrict__ idx, int F, int* __restrict__ out) {
  extern __shared__ int4 s_tab4[];
  for (int c = threadIdx.x; c < cap4; c += blockDim.x) s_tab4[c] = __ldg(tab4 + c);
  __syncthreads();
  const int* s_tab = reinterpret_cast<const int*>(s_tab4);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < F) out[i] = s_tab[__ldg(idx + i)];
}

// ---------------------------------------------------------------------------
// M3 scatmax: out = zeros(n_out); out[b[i]] = max(out[b[i]], p[i])
//
// Bound: bytes: b and p read once, the whole [n_out] output written. The
// atomics land in L2 (8 MB of output at F = 2^20 fits its 50 MB), so the
// output is one memset and one write-back. Design: a memset, then one
// thread per update with a global signed atomicMax, as K4's claim pass
// does. The max commutes, so the order of the updates does not show.
// ---------------------------------------------------------------------------

__global__ void scatmax_kernel(const int* __restrict__ b, const int* __restrict__ p, int F,
                               int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < F) atomicMax(out + __ldg(b + i), __ldg(p + i));
}

// ---------------------------------------------------------------------------
// M4 scatmax_smem: the same function, the output held in shared memory
//
// Bound: as M3. Design: the TPU's SMEM variant keeps the output in the
// scalar core's memory; here ONE block of 1024 threads zeroes an [n_out]
// copy in dynamic shared memory (128 KB at the tool's size: 2F ints),
// applies every update with a shared-memory atomicMax, and writes the
// copy out once, coalesced. One block, because the output alone fills
// the block's shared memory: block-private copies would each be 128 KB
// and their merge would read and atomically combine n_out words per
// block, and blocks owning ranges of the output would each re-read every
// update. One SM moves the 256 KB this needs in a few microseconds,
// which at the tool's size is of the order of a launch.
// ---------------------------------------------------------------------------

__global__ void scatmax_smem_kernel(const int* __restrict__ b, const int* __restrict__ p, int F,
                                    int n_out, int* __restrict__ out) {
  extern __shared__ int s_out[];
  for (int c = threadIdx.x; c < n_out; c += blockDim.x) s_out[c] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < F; i += blockDim.x) atomicMax(s_out + __ldg(b + i), __ldg(p + i));
  __syncthreads();
  for (int c = threadIdx.x; c < n_out; c += blockDim.x) out[c] = s_out[c];
}

// ---------------------------------------------------------------------------
// M5 and M6 compact through csrc/scan.cuh's block scans and sums (all
// threads of the block must call them)
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

// Compacts vals[i] for keep[i] != 0, i in [lo, hi), into out from `base`
// in input order: rounds of 4 inputs a thread, one block scan a round, a
// running offset across rounds. Returns base plus the kept count.
__device__ unsigned tile_compact(const int* __restrict__ keep, const int* __restrict__ vals,
                                 int lo, int hi, unsigned base, int* __restrict__ out,
                                 unsigned* warp_sums) {
  for (int r = lo; r < hi; r += 4 * (int)blockDim.x) {
    int k[4], v[4];
    load4(keep, vals, r + 4 * (int)threadIdx.x, hi, k, v);
    const unsigned c = (k[0] != 0) + (k[1] != 0) + (k[2] != 0) + (k[3] != 0);
    unsigned round_total;
    unsigned pos = base + block_exclusive_scan(c, warp_sums, &round_total);
    for (int e = 0; e < 4; ++e) {
      if (k[e] != 0) out[pos++] = v[e];
    }
    base += round_total;
  }
  return base;
}

// ---------------------------------------------------------------------------
// M5 pack_block: out[:n] = vals[keep != 0] in input order, out[n:] = 0,
// n_out[0] = n; ONE block
//
// Bound: bytes: keep and vals read once, the [F] output and the count
// written once. Design: K4's compaction pass as it stands: one block of
// 1024 threads walks the input in tiles of 4096 (16-byte loads of keep
// and vals, 4 inputs a thread), scans the tile's keep counts through
// shared memory and writes the survivors at a running offset, then
// zeroes the tail. One SM does all the work, so its own load rate and
// the three barriers of every tile, not the card's memory, set its time.
// ---------------------------------------------------------------------------

__global__ void pack_block_kernel(const int* __restrict__ keep, const int* __restrict__ vals,
                                  int F, int* __restrict__ out, int* __restrict__ n_out) {
  __shared__ unsigned warp_sums[32];
  const unsigned n = tile_compact(keep, vals, 0, F, 0u, out, warp_sums);
  for (int c = (int)n + threadIdx.x; c < F; c += blockDim.x) out[c] = 0;
  if (threadIdx.x == 0) *n_out = (int)n;
}

// ---------------------------------------------------------------------------
// M6 pack: the same function on many blocks
//
// Bound: as M5. Design: reduce, then scan-and-scatter. Pass 1 gives each
// block of 256 threads a tile of 2048 inputs and writes its keep count;
// pass 2 has every block sum the counts of the tiles before its own (a
// few hundred ints from L2, read by the whole block) and the total, then
// compact its tile from that offset as M5 does, and zero the positions
// of its tile at or past the total. keep is read twice, so the kernel
// moves 16 bytes an input against the bound's 12.
// ---------------------------------------------------------------------------

__global__ void pack_count_kernel(const int* __restrict__ keep, int F, int* __restrict__ counts) {
  __shared__ unsigned warp_sums[64];
  const int lo = blockIdx.x * kPackTile;
  const int hi = min(F, lo + kPackTile);
  unsigned c = 0;
  for (int i0 = lo + 4 * (int)threadIdx.x; i0 < hi; i0 += 4 * (int)blockDim.x) {
    if (i0 + 3 < hi) {
      const int4 kk = __ldg(reinterpret_cast<const int4*>(keep + i0));
      c += (kk.x != 0) + (kk.y != 0) + (kk.z != 0) + (kk.w != 0);
    } else {
      for (int e = i0; e < hi; ++e) c += __ldg(keep + e) != 0;
    }
  }
  const unsigned total = block_sum(c, warp_sums);
  if (threadIdx.x == 0) counts[blockIdx.x] = (int)total;
}

__global__ void pack_scatter_kernel(const int* __restrict__ keep, const int* __restrict__ vals,
                                    int F, const int* __restrict__ counts, int n_blocks,
                                    int* __restrict__ out, int* __restrict__ n_out) {
  __shared__ unsigned warp_sums[64];
  unsigned all;
  const unsigned before = tile_base(counts, n_blocks, warp_sums, &all);
  const int lo = blockIdx.x * kPackTile;
  const int hi = min(F, lo + kPackTile);
  tile_compact(keep, vals, lo, hi, before, out, warp_sums);
  for (int c = max(lo, (int)all) + threadIdx.x; c < hi; c += blockDim.x) out[c] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_out = (int)all;
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

}  // namespace

extern "C" {

int keto_mb_probe(const int* tab, const int* idx, int F, int* out, void* stream) {
  if (F > 0) {
    probe_kernel<<<blocks_for(F, kThreads), kThreads, 0, (cudaStream_t)stream>>>(tab, idx, F,
                                                                                    out);
  }
  return (int)cudaGetLastError();
}

int keto_mb_probe_smem(const int* tab, int cap, const int* idx, int F, int* out, void* stream) {
  const int smem = cap * (int)sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(
      probe_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (F > 0) {
    probe_smem_kernel<<<blocks_for(F, kBigBlock), kBigBlock, smem, (cudaStream_t)stream>>>(
        (const int4*)tab, cap / 4, idx, F, out);
  }
  return (int)cudaGetLastError();
}

int keto_mb_scatmax(const int* b, const int* p, int F, int* out, int n_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, sizeof(int) * (size_t)n_out, st);
  if (F > 0) scatmax_kernel<<<blocks_for(F, kThreads), kThreads, 0, st>>>(b, p, F, out);
  return (int)cudaGetLastError();
}

int keto_mb_scatmax_smem(const int* b, const int* p, int F, int* out, int n_out, void* stream) {
  const int smem = n_out * (int)sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(
      scatmax_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  scatmax_smem_kernel<<<1, kBigBlock, smem, (cudaStream_t)stream>>>(b, p, F, n_out, out);
  return (int)cudaGetLastError();
}

int keto_mb_pack_block(const int* keep, const int* vals, int F, int* out, int* n_out,
                       void* stream) {
  pack_block_kernel<<<1, kBigBlock, 0, (cudaStream_t)stream>>>(keep, vals, F, out, n_out);
  return (int)cudaGetLastError();
}

int keto_mb_pack_blocks(int F) { return F > 0 ? blocks_for(F, kPackTile) : 1; }

int keto_mb_pack(const int* keep, const int* vals, int F, int* counts, int* out, int* n_out,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = keto_mb_pack_blocks(F);
  pack_count_kernel<<<nb, kThreads, 0, st>>>(keep, F, counts);
  pack_scatter_kernel<<<nb, kThreads, 0, st>>>(keep, vals, F, counts, nb, out, n_out);
  return (int)cudaGetLastError();
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

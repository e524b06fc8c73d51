// A stable keyed exclusive scan on many blocks: the per-query bump
// allocation of L1 list_emit (list_kernels.cu, weight 1) and X1
// expand_emit (expand_kernels.cu, weight = the task's row length). Entry
// i has a key k[i] in [0, B), or none (-1), and a weight w[i] >= 0; its
// rank is
//
//   base[k[i]] + sum of w[j] over j < i with k[j] == k[i],
//
// what keto_tpu computes as a stable argsort by key and a segmented scan
// (keto_tpu/engine/reverse_kernel.py _bump_emit, expand_kernel.py's
// step body), with no sort. Three passes over one table of per-(key,
// chunk) counts, laid out key-major ([B][chunks]):
//
//  1. Chunk sums. The entries are cut into contiguous chunks of `rounds`
//     rounds of 32, one warp a chunk. In each round the lanes of one key
//     find each other with __match_any_sync, and the group's last lane
//     adds the group's weights to the warp's private count of the key.
//     The block then writes its warps' counts to the table: a block's
//     chunks are adjacent, so each key's counts go out as one run of
//     `warps` ints.
//  2. Key scan. A group of warps a key (more where the rows are long)
//     scans the key's row in chunk order from the key's base, in place,
//     32 chunks a load: each count becomes the key's first rank in that
//     chunk. The group also has the key's total.
//  3. Rank. Each warp walks its chunk again from those first ranks: an
//     entry's rank is its key's running count plus the weights of its
//     lower group-mates in the round (a popcount for unit weights, else
//     a shuffle from each lower mate), and the group's last lane advances
//     the count. There is no block barrier inside a walk, and a round's
//     loads go out before its rank.
//
// A warp's counts take 4 B bytes of shared memory, so the warps a block
// (a power of two) follow from B; where not even one warp's fit, they
// live in the warp's own cells of the table (kShared false), in L2. The
// table is sized so that its traffic stays well under the entries' own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kRankMaxWarps = 8;    // warps a block of passes 1 and 3
constexpr int kRankUnroll = 4;      // rounds whose loads go out together
constexpr int kRankScanUnroll = 8;  // loads of 32 chunks a key-scan warp keeps in flight
constexpr int kRankScanThreads = 256;  // a key-scan block: 8 warps, 8 / group keys
constexpr int kRankScanPart = 256;     // chunks a key-scan warp takes, at least
constexpr int kRankMinChunks = 132; // one chunk an SM, where the entries allow
constexpr long long kRankTableCap = 1 << 19;  // table ints, unless kRankMinChunks * B is more
// the dynamic shared memory one block may take on Hopper, less the
// kernels' static shared memory
constexpr long long kRankSmemMax = 232448 - 1024;

struct RankShape {
  int rounds;   // rounds of 32 entries a warp walks
  int warps;    // warps a block (chunks a block), a power of two
  int blocks;   // blocks of passes 1 and 3
  bool shared;  // the warps' counts in shared memory
  int group;    // pass 2's warps a key, a power of two up to 8
};

inline RankShape rank_shape(long long n, int B) {
  const long long rounds_all = n > 0 ? (n + 31) / 32 : 1;
  const long long by_table = kRankTableCap / B > kRankMinChunks ? kRankTableCap / B
                                                                  : kRankMinChunks;
  // a chunk of one round a warp, as many as the table allows
  long long chunks = rounds_all < by_table ? rounds_all : by_table;
  RankShape s;
  s.rounds = (int)((rounds_all + chunks - 1) / chunks);
  chunks = (rounds_all + s.rounds - 1) / s.rounds;
  const long long fit = kRankSmemMax / (4LL * B);
  s.shared = fit >= 1;
  long long cap = chunks < kRankMaxWarps ? chunks : kRankMaxWarps;
  if (s.shared && fit < cap) cap = fit;
  s.warps = 1;
  while (2 * s.warps <= cap) s.warps *= 2;
  s.blocks = (int)((chunks + s.warps - 1) / s.warps);
  s.group = 1;
  while (2 * s.group <= kRankScanThreads / 32 &&
         2 * s.group * kRankScanPart <= (long long)s.blocks * s.warps) {
    s.group *= 2;
  }
  return s;
}

inline int rank_scan_blocks(const RankShape& s, int B) {
  return (int)(((long long)B * s.group + kRankScanThreads / 32 - 1) / (kRankScanThreads / 32));
}

inline long long rank_table_ints(const RankShape& s, int B) {
  return (long long)s.blocks * s.warps * B;
}

inline size_t rank_smem(const RankShape& s, int B) {
  return s.shared ? sizeof(int) * (size_t)s.warps * B : 0;
}

// One warp's per-key counts: its array in the block's shared memory, or
// its cells of the table (a stride of `chunks` ints).
template <bool kShared>
struct WarpCounts {
  int* p;
  int stride;
  __device__ __forceinline__ int& operator[](int k) const {
    return kShared ? p[k] : p[(size_t)k * stride];
  }
};

template <bool kShared>
__device__ __forceinline__ WarpCounts<kShared> warp_counts(int* smem, int* table, int B) {
  const int w = threadIdx.x >> 5;
  if (kShared) return {smem + (size_t)w * B, 1};
  const int warps = blockDim.x >> 5;
  return {table + (size_t)blockIdx.x * warps + w, (int)gridDim.x * warps};
}

// Moves the block's counts between shared memory ([warp][key]) and the
// table ([key][chunk]; the block's chunks adjacent), all threads. Where a
// block has 4 or 8 warps each key's counts move as int4s (the table is
// 16-byte aligned, and a block's chunks start at a multiple of 4), and a
// thread's loads of up to kRankCopyBatch int4s go out before any store.
constexpr int kRankCopyBatch = 8;

__device__ __forceinline__ void rank_copy(int* smem, int* __restrict__ table, int B,
                                          bool to_table) {
  const int warps = blockDim.x >> 5;
  const size_t chunks = (size_t)gridDim.x * warps;
  int* part = table + (size_t)blockIdx.x * warps;
  if (warps >= 4) {
    const int quads = warps >> 2;
    const int log_q = __ffs(quads) - 1;
    const int n = B * quads;
    for (int e0 = threadIdx.x; e0 < n; e0 += kRankCopyBatch * blockDim.x) {
      int4 v[kRankCopyBatch];
#pragma unroll
      for (int j = 0; j < kRankCopyBatch; ++j) {
        const int e = e0 + j * (int)blockDim.x;
        const int k = e >> log_q, w = (e & (quads - 1)) * 4;
        int4* cell = reinterpret_cast<int4*>(part + (size_t)k * chunks + w);
        const int* mine = smem + (size_t)w * B + k;
        if (e >= n) continue;
        if (to_table) {
          *cell = make_int4(mine[0], mine[B], mine[2 * B], mine[3 * B]);
        } else {
          v[j] = *cell;
        }
      }
      if (to_table) continue;
#pragma unroll
      for (int j = 0; j < kRankCopyBatch; ++j) {
        const int e = e0 + j * (int)blockDim.x;
        if (e >= n) continue;
        const int k = e >> log_q, w = (e & (quads - 1)) * 4;
        int* mine = smem + (size_t)w * B + k;
        mine[0] = v[j].x;
        mine[B] = v[j].y;
        mine[2 * B] = v[j].z;
        mine[3 * B] = v[j].w;
      }
    }
    return;
  }
  const int log_w = __ffs(warps) - 1;
  for (int e = threadIdx.x; e < B * warps; e += blockDim.x) {
    const int k = e >> log_w, w = e & (warps - 1);
    int* cell = part + (size_t)k * chunks + w;
    int* mine = smem + (size_t)w * B + k;
    if (to_table) {
      *cell = *mine;
    } else {
      *mine = *cell;
    }
  }
}

// Before a walk: pass 1 zeroes the warps' counts, pass 3 loads its first
// ranks from the table. In shared memory the whole block does it and
// meets at a barrier; in the table a warp zeroes its own cells.
template <bool kShared>
__device__ void rank_begin(int* smem, int* __restrict__ table, int B, bool zero) {
  if (kShared) {
    if (zero) {
      // B * warps ints, a multiple of 4 where warps >= 4
      const int n = B * (int)(blockDim.x >> 5);
      const int n4 = (n & 3) ? 0 : n >> 2;
      for (int e = threadIdx.x; e < n4; e += blockDim.x) {
        reinterpret_cast<int4*>(smem)[e] = make_int4(0, 0, 0, 0);
      }
      for (int e = 4 * n4 + threadIdx.x; e < n; e += blockDim.x) smem[e] = 0;
    } else {
      rank_copy(smem, table, B, false);
    }
    __syncthreads();
  } else if (zero) {
    const WarpCounts<false> c = warp_counts<false>(smem, table, B);
    for (int k = threadIdx.x & 31; k < B; k += 32) c[k] = 0;
    __syncwarp();
  }
}

// After pass 1's walk: the block's counts to the table.
template <bool kShared>
__device__ void rank_end(int* smem, int* __restrict__ table, int B) {
  if (!kShared) return;
  __syncthreads();
  rank_copy(smem, table, B, true);
}

// The sum of w over the lower lanes of this lane's group (`same`, from
// rank_round; lanes of no key, key -1, pass w = 0 and their result is not
// used): a shuffle from each lower group-mate, as many rounds as the
// largest group of the round has lower mates.
__device__ __forceinline__ unsigned group_exclusive(unsigned w, unsigned same, bool keyed) {
  unsigned m = keyed ? same & ((1u << (threadIdx.x & 31)) - 1u) : 0u;
  unsigned s = 0;
  const unsigned n = __reduce_max_sync(kFullMask, (unsigned)__popc(m));
  for (unsigned r = 0; r < n; ++r) {
    const int src = m ? __ffs(m) - 1 : (int)(threadIdx.x & 31);
    const unsigned y = __shfl_sync(kFullMask, w, src);
    if (m) {
      s += y;
      m &= m - 1u;
    }
  }
  return s;
}

// One round of a walk, all 32 lanes: the lane's key (-1: none) and
// weight (0 where it has no key). Returns the lane's rank: its key's
// count before the round plus its lower group-mates' weights; *last
// tells the group's last lane (the highest rank of its group), which
// advances the count by the group's weights. kUnit: every keyed weight
// is 1.
template <bool kUnit, bool kShared>
__device__ __forceinline__ unsigned rank_round(int key, unsigned w, WarpCounts<kShared> counts,
                                               bool* last = nullptr) {
  const bool keyed = key >= 0;
  if (last) *last = false;
  if (!__any_sync(kFullMask, keyed)) return 0u;
  const int lane = threadIdx.x & 31;
  const unsigned same = __match_any_sync(kFullMask, key);
  const unsigned below = kUnit ? (unsigned)__popc(same & ((1u << lane) - 1u))
                               : group_exclusive(w, same, keyed);
  const unsigned r = keyed ? (unsigned)counts[key] + below : 0u;
  const bool is_last = keyed && (same >> lane) == 1u;
  __syncwarp();
  if (is_last) counts[key] = (int)(r + w);
  __syncwarp();
  if (last) *last = is_last;
  return r;
}

// The key a warp of a pass-2 block scans: `group` warps a key, 8 / group
// keys a block of kRankScanThreads.
__device__ __forceinline__ int rank_scan_key_of(int group) {
  return (int)blockIdx.x * (kRankScanThreads / 32 / group) + (int)(threadIdx.x >> 5) / group;
}

// Pass 2, every thread of the block: this warp's key k (k >= B scans
// nothing), `base` its first rank. The key's row of counts, in chunk
// order, becomes exclusive running sums from `base`. Each of the key's
// `group` warps takes a contiguous part of the row; with more than one,
// they first sum their parts and exchange the sums through `sums` ([8],
// one barrier). A warp scans its part 32 chunks a load, kRankScanUnroll
// loads at a time. Returns the key's total weight, in every lane of its
// warps.
__device__ unsigned rank_scan_key(int* __restrict__ table, int k, int B, int chunks, int group,
                                  unsigned base, unsigned* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = warp & (group - 1);
  const bool keyed = k < B;
  const int part = ((chunks + group - 1) / group + 31) & ~31;
  const int lo = min(chunks, sub * part);
  const int hi = min(chunks, lo + part);
  int* row = table + (size_t)(keyed ? k : 0) * chunks;
  unsigned before = 0, total = 0;
  if (group > 1) {
    unsigned s = 0;
    if (keyed) {
      for (int c0 = lo; c0 < hi; c0 += 32 * kRankScanUnroll) {
#pragma unroll
        for (int u = 0; u < kRankScanUnroll; ++u) {
          const int c = c0 + 32 * u + lane;
          s += c < hi ? (unsigned)row[c] : 0u;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
    if (lane == 0) sums[warp] = s;
    __syncthreads();
    for (int g = 0; g < group; ++g) {
      const unsigned v = sums[warp - sub + g];
      total += v;
      if (g < sub) before += v;
    }
  }
  if (!keyed) return 0u;
  const unsigned start = base + before;
  unsigned run = start;
  for (int c0 = lo; c0 < hi; c0 += 32 * kRankScanUnroll) {
    unsigned v[kRankScanUnroll];
#pragma unroll
    for (int u = 0; u < kRankScanUnroll; ++u) {
      const int c = c0 + 32 * u + lane;
      v[u] = c < hi ? (unsigned)row[c] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kRankScanUnroll; ++u) {
      unsigned x = v[u];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x += y;
      }
      const int c = c0 + 32 * u + lane;
      if (c < hi) row[c] = (int)(run + x - v[u]);
      run += __shfl_sync(kFullMask, x, 31);
    }
  }
  return group > 1 ? total : run - start;
}

}  // namespace

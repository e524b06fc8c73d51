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
//                           and the child rules (a tile pass, a scan pass
//                           and a merge-path gather).
// L3 keto_subjects_gather   replaces _list_subjects_impl's expansion: the
//                           same over the full-edge CSR and the rewrite
//                           instructions, with the result mask (L2's tile,
//                           scan and merge-path passes).
// L4 keto_list_pool_compact replaces the packed tail of
//                           list_objects_kernel_packed and
//                           list_subjects_kernel_packed (one launch).
//
// L1 is csrc/keyed_rank.cuh's keyed scan, shared with X1, and its landed
// count csrc/reduce.cuh's last-block sum; L4 is csrc/pool.cuh's
// compaction, shared with X2; the block scans of L2-L4, and L2's and
// L3's tile sums and cause zeroing, come from csrc/scan.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed_rank.cuh"
#include "pool.cuh"
#include "reduce.cuh"
#include "scan.cuh"

namespace {

constexpr int kCauseFrontierOverflow = 2;
constexpr int kCauseIslandHost = 8;
constexpr int kInstrComputed = 1;
constexpr int kInstrTtu = 2;
constexpr int kRinstrComputed = 1;
constexpr int kRinstrTtu = 2;
constexpr int kRinstrPoison = 3;
constexpr int kThreads = 256;

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
// L2 reverse_gather
//
// Bound: bytes: per task its columns and one inverted-instruction row
// (RK x 16 B, a small table that stays in cache); per candidate that
// lands one 16-byte rv_pack row and one objslot_ns entry; five [F]
// columns and the causes written. Task i has S = 1 + RK slots: its
// reverse-edge row (rlen edges when live, depth >= 1 and the relation is
// not the wildcard), then one per inverted entry (COMPUTED of the task's
// namespace 1, TTU rlen when depth >= 1). Candidate j < F belongs to the
// last flat slot whose offset is <= j.
//
// Design: three launches, no memset, no [F, S] array.
// (1) Tile pass: each thread computes its tasks' S counts in registers
// (four strided tasks a round: their live flags, then the other columns
// of the live ones, then their rinstr rows; a dead task counts nothing)
// and writes only each task's total ([F], coalesced) and its POISON flag
// (a warp's ballot, one word a warp); each block writes its tile's sum,
// and the grid zeroes the causes.
// (2) Scan pass: each block sums the tile sums before its own (scan.cuh),
// scans its tile in task order (four contiguous tasks a thread a round,
// one 16-byte load) and writes the exclusive task offsets over the totals
// in place. It raises POISON, and the frontier overflow of a task exactly
// when total > 0 and offset + total > F (a task's slot ends only grow, so
// its last non-empty slot's end is its own end); block 0 writes the
// total. It also writes where each gather block's share of the merged
// sequence starts: task i sits at merged position i + min(offset_i, F),
// so the shares whose start falls in (pos_i, pos_i+1] start after task i
// (usually none or one; a task with more candidates than a share covers
// several, written by its warp 32 at a time), and no block searches the
// offsets in global memory for its start.
// (3) Gather pass, a merge path: block b owns the items [b P, (b + 1) P)
// of the merged sequence of task starts and candidate indices (a task
// start before an equal candidate index), i.e. the tasks [i0, i1) and the
// candidates [b P - i0, (b + 1) P - i1), at most P (256 or 512), one or
// two a thread; a block with no candidate (a run of empty tasks) exits at
// once. It stages the offsets of tasks i0 - 1 .. i1 - 1 in shared memory;
// each candidate finds its task there (the last one whose offset is <= j,
// by a search of at most log2(P + 1) steps in shared memory), recomputes
// the task's slot counts from its row, takes the last slot whose offset
// is <= j (ties of empty tasks and slots go to the last, as the flat
// search's), and gathers; a thread's candidates go through each level of
// dependent loads together. The last flat slot <= j lies in the last task
// whose offset is <= j, so this is the flat search's answer; a j at or
// past the total maps to the last slot of the last task, F*S - 1, and
// carries its columns with valid 0, as the plain version does. Candidates
// are written in order, coalesced. Scratch: O(F + tiles) ints
// (keto_gather_scratch).
// This replaced a count pass that wrote [F, S] counts, a one-block scan of
// the block sums, an offsets pass over [F, S] and a binary search over the
// F*S offsets for each candidate, after a memset of the causes.
// ---------------------------------------------------------------------------

// tasks a tile of L2's tile and scan passes (doubled by scan_tile past
// kMaxTiles tiles); a round of either pass is kRevUnroll tasks a thread
constexpr int kRevTile = 256;
constexpr int kRevUnroll = 4;
// candidates a thread of the gather pass carries through its loads
// together (kMergeUnroll, 1 or 2), and so the merged items (task starts
// and candidates) a gather block owns, its share: 256 items below
// kMergeWideF tasks, where more blocks spread the walk over more SMs, 512
// from there, where two candidates a thread in flight win (timed against
// 1 and 4 a thread, PERF.md §6)
constexpr int kMergeWideF = 1 << 16;

inline int rev_merge_unroll(int F) { return F < kMergeWideF ? 1 : 2; }

// count of the reverse-edge slot 0 of a task
__device__ __forceinline__ int rev_edge_count(bool lv, int d, int r, int wildcard_rel, int rl) {
  return (lv && d >= 1 && r != wildcard_rel) ? rl : 0;
}

// kind of an inverted-entry slot: 1 COMPUTED (one candidate), 2 TTU (the
// task's reverse-edge row), 0 none
__device__ __forceinline__ int rev_entry_kind(int4 e, bool lv, bool has_ri, int d, int ns) {
  const int rik = has_ri ? e.x : 0;
  if (rik == kRinstrComputed && lv && e.w == ns) return 1;
  if (rik == kRinstrTtu && lv && d >= 1) return 2;
  return 0;
}

__device__ __forceinline__ int rev_entry_count(int kind, int rl) {
  return kind == 1 ? 1 : (kind == 2 ? rl : 0);
}

struct RevScratch {
  int* offs;       // [F]: task totals after the tile pass, offsets after the scan pass
  unsigned* pois;  // [ceil(F / 32)]: a task's POISON flag, one bit
  int* tile_sums;  // [kMaxTiles]
  int* splits;     // [n_shares + 1]: the first task of each gather block's share
  int* total;      // [1]
};

inline long long round4(long long n) { return (n + 3) & ~3LL; }

inline int rev_shares(int F, int share) { return (int)((2LL * F + share - 1) / share); }

inline RevScratch rev_scratch(int* base, int F) {
  RevScratch s;
  s.offs = base;
  base += round4(F);
  s.pois = reinterpret_cast<unsigned*>(base);
  base += round4((F + 31) / 32);
  s.tile_sums = base;
  base += kMaxTiles;
  s.splits = base;
  base += round4(rev_shares(F, kThreads) + 1);  // the smallest share's count
  s.total = base;
  return s;
}

// zeroes cause too: the scan pass, one launch later, raises it. A round
// is kRevUnroll strided tasks a thread (coalesced): their live flags, then
// the other columns of the live ones, then their rows.
__global__ void reverse_tile_kernel(
    const int* __restrict__ rel, const int* __restrict__ depth,
    const uint8_t* __restrict__ live, const int* __restrict__ ns_t,
    const int* __restrict__ rlen, const int4* __restrict__ rinstr, int RK, int F, int tile,
    int wildcard_rel, int ncr, int* __restrict__ tot, unsigned* __restrict__ pois,
    int* __restrict__ tile_sums, int* __restrict__ cause, int n_queries) {
  __shared__ unsigned warp_sums[64];
  zero_grid(cause, n_queries);
  const int lo = blockIdx.x * tile;
  const int hi = min(F, lo + tile);
  unsigned s = 0;
  for (int r0 = lo; r0 < hi; r0 += kRevUnroll * (int)blockDim.x) {
    bool lv[kRevUnroll], has_ri[kRevUnroll];
    int d[kRevUnroll], r[kRevUnroll], ns[kRevUnroll], rl[kRevUnroll];
#pragma unroll
    for (int u = 0; u < kRevUnroll; ++u) {
      const int i = r0 + u * (int)blockDim.x + (int)threadIdx.x;
      lv[u] = i < hi && live[i] != 0;
    }
    // a dead task counts nothing: its other columns are not read (the
    // frontier's padding is most of it on a ListObjects walk)
#pragma unroll
    for (int u = 0; u < kRevUnroll; ++u) {
      const int i = r0 + u * (int)blockDim.x + (int)threadIdx.x;
      d[u] = lv[u] ? depth[i] : 0;
      r[u] = lv[u] ? rel[i] : 0;
      ns[u] = lv[u] ? ns_t[i] : 0;
      rl[u] = lv[u] ? rlen[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kRevUnroll; ++u) {
      const int i = r0 + u * (int)blockDim.x + (int)threadIdx.x;
      has_ri[u] = lv[u] && r[u] < ncr;
      const int4* row = rinstr + (size_t)(has_ri[u] ? r[u] : 0) * RK;
      unsigned t = (unsigned)rev_edge_count(lv[u], d[u], r[u], wildcard_rel, rl[u]);
      bool poison = false;
      for (int k = 0; k < RK; ++k) {
        const int4 e = row[k];
        poison |= has_ri[u] && e.x == kRinstrPoison && (e.w == -1 || e.w == ns[u]);
        t += (unsigned)rev_entry_count(rev_entry_kind(e, lv[u], has_ri[u], d[u], ns[u]), rl[u]);
      }
      if (i < hi) tot[i] = (int)t;
      s += t;
      // r0 and blockDim are multiples of 32: a warp's 32 tasks are one word
      const unsigned bits = __ballot_sync(0xFFFFFFFFu, poison);
      if ((threadIdx.x & 31) == 0 && i < hi) pois[i >> 5] = bits;
    }
  }
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = (int)s;
}

// The scan pass of L2 and L3. A round is kRevUnroll contiguous tasks a
// thread: one 16-byte load of their totals and (kPoison, L2 only) one word
// of their POISON bits, one block scan. offs is 16-byte aligned (the
// wrapper's scratch), and so is every i0.
template <bool kPoison>
__device__ __forceinline__ void task_scan(
    const int* __restrict__ q, int F, int tile, const int* __restrict__ tile_sums, int n_tiles,
    const unsigned* __restrict__ pois, int share, int n_shares, int* __restrict__ offs,
    int* __restrict__ splits, int* __restrict__ total, int* __restrict__ cause) {
  __shared__ unsigned warp_sums[64];
  unsigned all;
  unsigned base = tile_base(tile_sums, n_tiles, warp_sums, &all);
  const int lo = blockIdx.x * tile;
  const int hi = min(F, lo + tile);
  for (int r0 = lo; r0 < hi; r0 += kRevUnroll * (int)blockDim.x) {
    const int i0 = r0 + kRevUnroll * (int)threadIdx.x;
    // each task's total, read before its offset overwrites it
    const int4 c4 = load4(offs, i0, hi);
    const unsigned bits = kPoison && i0 < hi ? pois[i0 >> 5] : 0u;
    const unsigned c[kRevUnroll] = {(unsigned)c4.x, (unsigned)c4.y, (unsigned)c4.z,
                                    (unsigned)c4.w};
    unsigned round_total;
    unsigned off = base + block_exclusive_scan(c[0] + c[1] + c[2] + c[3], warp_sums,
                                               &round_total);
    base += round_total;
    int o[kRevUnroll];
#pragma unroll
    for (int e = 0; e < kRevUnroll; ++e) {
      const int i = i0 + e;
      o[e] = (int)off;
      const unsigned end = off + c[e];
      // the shares b with pos_i < b P <= pos_i+1 start after task i (the
      // last share ends at 2F, past every task)
      int b_lo = 1, b_hi = 0;
      if (i < hi) {
        const bool poisoned = kPoison && ((bits >> (i & 31)) & 1u);
        const bool cut = (int)c[e] > 0 && (int)end > F;
        if (poisoned || cut) {
          const int qi = q[i];
          if (poisoned) raise_cause(cause, qi, kCauseIslandHost);
          if (cut) raise_cause(cause, qi, kCauseFrontierOverflow);
        }
        const long long pos = i + (long long)min(off, (unsigned)F);
        b_lo = (int)(pos / share) + 1;
        b_hi = i + 1 < F ? (int)((i + 1 + (long long)min(end, (unsigned)F)) / share) : n_shares;
      }
      // a task's shares are written by its whole warp, 32 at a time: the
      // last task alone starts every share past the total
      unsigned wide = __ballot_sync(0xFFFFFFFFu, b_lo <= b_hi);
      while (wide) {
        const int src = __ffs(wide) - 1;
        wide &= wide - 1;
        const int lo_s = __shfl_sync(0xFFFFFFFFu, b_lo, src);
        const int hi_s = __shfl_sync(0xFFFFFFFFu, b_hi, src);
        const int val = __shfl_sync(0xFFFFFFFFu, i + 1, src);
        for (int b = lo_s + (int)(threadIdx.x & 31); b <= hi_s; b += 32) splits[b] = val;
      }
      off = end;
    }
    if (i0 + 3 < hi) {
      *reinterpret_cast<int4*>(offs + i0) = make_int4(o[0], o[1], o[2], o[3]);
    } else {
      for (int e = 0; e < kRevUnroll && i0 + e < hi; ++e) offs[i0 + e] = o[e];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    splits[0] = 0;
    *total = (int)all;
  }
}

__global__ void reverse_scan_kernel(
    const int* __restrict__ q, int F, int tile, const int* __restrict__ tile_sums, int n_tiles,
    const unsigned* __restrict__ pois, int share, int n_shares, int* __restrict__ offs,
    int* __restrict__ splits, int* __restrict__ total, int* __restrict__ cause) {
  task_scan<true>(q, F, tile, tile_sums, n_tiles, pois, share, n_shares, offs, splits, total,
                  cause);
}

// A block's candidates, at most kMergeUnroll a thread, go through each
// level of dependent loads together: their tasks (shared memory), the
// tasks' columns, their rinstr rows, the rv_pack rows, the namespaces.
template <int kMergeUnroll>
__global__ void __launch_bounds__(kThreads) reverse_merge_kernel(
    const int* __restrict__ offs, const int* __restrict__ splits,
    const int* __restrict__ total, int F, int RK, const int* __restrict__ q,
    const int* __restrict__ obj, const int* __restrict__ rel, const int* __restrict__ depth,
    const uint8_t* __restrict__ live, const int* __restrict__ ns_t,
    const int* __restrict__ rstart, const int* __restrict__ rlen,
    const int4* __restrict__ rinstr, const int4* __restrict__ rv_pack, int n_redges,
    const int* __restrict__ objslot_ns, int n_objslot, int wildcard_rel, int ncr,
    int* __restrict__ c_q, int* __restrict__ c_obj, int* __restrict__ c_rel,
    int* __restrict__ c_depth, uint8_t* __restrict__ c_valid) {
  constexpr int kShare = kMergeUnroll * kThreads;
  __shared__ int s_off[kShare + 1];
  const int b = blockIdx.x;
  const int i0 = splits[b], i1 = splits[b + 1];
  const long long d0 = (long long)b * kShare;
  const long long d1 = min(d0 + kShare, 2LL * F);
  const int k0 = (int)(d0 - i0), k1 = (int)(d1 - i1);
  // the offsets of tasks sb .. i1 - 1: task i0 - 1 owns the share's first
  // candidates when no task starts before them
  if (k0 >= k1) return;  // a share of task starts only (a run of empty tasks)
  const int sb = max(i0 - 1, 0);
  const int n_st = i1 - sb;
  for (int t = threadIdx.x; t < n_st; t += blockDim.x) s_off[t] = offs[sb + t];
  const int in_total = min(*total, F);
  __syncthreads();
  int ti[kMergeUnroll], a[kMergeUnroll];
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const int j = k0 + u * (int)blockDim.x + (int)threadIdx.x;
    // the last staged task whose offset is <= j; task i0 - 1 (or task 0,
    // at offset 0) qualifies, so the search starts past it
    int lo = i0 - sb, hi = n_st;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_off[mid] <= j) lo = mid + 1; else hi = mid;
    }
    ti[u] = j < k1 ? sb + lo - 1 : -1;
    a[u] = s_off[max(lo - 1, 0)];
  }
  bool lv[kMergeUnroll];
  int d[kMergeUnroll], r[kMergeUnroll], ns[kMergeUnroll], rl[kMergeUnroll], rs[kMergeUnroll];
  int tq[kMergeUnroll], to[kMergeUnroll];
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const int t = max(ti[u], 0);
    lv[u] = live[t] != 0;
    d[u] = depth[t];
    r[u] = rel[t];
    ns[u] = ns_t[t];
    rl[u] = rlen[t];
    rs[u] = rstart[t];
    tq[u] = q[t];
    to[u] = obj[t];
  }
  int kind[kMergeUnroll], e_idx[kMergeUnroll];
  int4 e_sel[kMergeUnroll];
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const int j = k0 + u * (int)blockDim.x + (int)threadIdx.x;
    const bool has_ri = lv[u] && r[u] < ncr;
    const int4* row = rinstr + (size_t)(has_ri ? r[u] : 0) * RK;
    // the last slot whose offset is <= j, and its rinstr entry
    int seg_off = a[u];
    kind[u] = 0;
    e_sel[u] = make_int4(0, 0, 0, 0);
    unsigned end = (unsigned)seg_off + (unsigned)rev_edge_count(lv[u], d[u], r[u],
                                                                wildcard_rel, rl[u]);
    for (int k = 0; k < RK; ++k) {
      const int4 e = row[k];
      const int kk = rev_entry_kind(e, lv[u], has_ri, d[u], ns[u]);
      if ((int)end <= j) {
        seg_off = (int)end;
        kind[u] = kk;
        e_sel[u] = e;
      }
      end += (unsigned)rev_entry_count(kk, rl[u]);
    }
    e_idx[u] = min(max(rs[u] + (j - seg_off), 0), max(n_redges - 1, 0));
  }
  int p_obj[kMergeUnroll], p_rel[kMergeUnroll], e_sb[kMergeUnroll];
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    int4 p = make_int4(0, 0, 0, 0);
    if (n_redges > 0 && ti[u] >= 0) p = rv_pack[e_idx[u]];
    p_obj[u] = p.x;
    p_rel[u] = p.y;
    e_sb[u] = p.z;
  }
  int p_ns[kMergeUnroll];
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    p_ns[u] = objslot_ns[min(max(p_obj[u], 0), n_objslot - 1)];
  }
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const int j = k0 + u * (int)blockDim.x + (int)threadIdx.x;
    if (ti[u] < 0) continue;
    // kind 0 (slot 0, or an empty entry slot past the total) takes the
    // reverse edge's own relation; e_sel's relp, relt and ns serve the
    // others
    const bool is_es = kind[u] == 0;
    const bool is_c = kind[u] == 1;
    const bool cond = is_es ? e_sb[u] == r[u]
                            : (is_c || (p_rel[u] == e_sel[u].z && p_ns[u] == e_sel[u].w));
    c_q[j] = tq[u];
    c_obj[j] = is_c ? to[u] : p_obj[u];
    c_rel[j] = is_es ? p_rel[u] : e_sel[u].y;
    c_depth[j] = is_c ? d[u] : d[u] - 1;
    c_valid[j] = j < in_total && cond;
  }
}

// ---------------------------------------------------------------------------
// L3 subjects_gather
//
// Bound: bytes: per task q, obj, depth and live, and for a task that can
// expand (live, depth >= 1) its S spans (8 B each) and K instruction
// lanes; per candidate one 16-byte fe_pack row and one ir or ir2 lane;
// seven [F] columns and the causes written. Task i has S = K + 1 slots:
// its own full-CSR row (the span's length), then one per instruction lane
// (COMPUTED 1, TTU the lane's span length), all empty unless the task is
// live with depth >= 1. Candidate j < F belongs to the last flat slot
// whose offset is <= j.
//
// Design: L2's three launches, no memset, no [F, S] array, over the
// spans and the instruction lanes. (1) Tile pass: each thread computes its
// tasks' slot counts in registers (a task that cannot expand reads no
// span or lane) and writes only each task's total; each block writes its
// tile's sum, and the grid zeroes the causes. (2) L2's scan pass without
// POISON (task_scan<false>): the exclusive task offsets over the totals in
// place, the frontier overflow of a task exactly when total > 0 and
// offset + total > F, the total, and each gather block's first task. (3)
// Merge-path gather, as L2's: each candidate finds its task among the
// staged offsets, recomputes the task's slot counts from its span row and
// lanes, takes the last slot whose offset is <= j, and reads that slot's
// fe_pack row and its ir or ir2 lane; a j at or past the total maps to
// slot F*S - 1 with valid and emit 0, as the plain version does. Scratch:
// L2's, O(F + tiles) ints (keto_gather_scratch). This replaced a count
// pass that wrote [F, S] counts, a one-block scan of the block sums, an
// offsets pass over [F, S] and a binary search over the F*S offsets for
// each candidate, after a memset of the causes.
// ---------------------------------------------------------------------------

// count of slot k (0: the task's own row; kk the lane's instruction kind)
// of a task that can expand
__device__ __forceinline__ int sub_slot_count(int k, int kk, int2 sp) {
  const int len = sp.x < 0 ? 0 : sp.y - sp.x;
  if (k == 0) return len;
  return kk == kInstrComputed ? 1 : (kk == kInstrTtu ? len : 0);
}

// zeroes cause too: the scan pass, one launch later, raises it. A round
// is kRevUnroll strided tasks a thread (coalesced): their live flags and
// depths, then the span rows and lanes of those that can expand.
__global__ void subjects_tile_kernel(
    const int* __restrict__ depth, const uint8_t* __restrict__ live,
    const int2* __restrict__ spans, const int* __restrict__ ik, int K, int F, int tile,
    int* __restrict__ tot, int* __restrict__ tile_sums, int* __restrict__ cause,
    int n_queries) {
  __shared__ unsigned warp_sums[64];
  zero_grid(cause, n_queries);
  const int S = K + 1;
  const int lo = blockIdx.x * tile;
  const int hi = min(F, lo + tile);
  unsigned s = 0;
  for (int r0 = lo; r0 < hi; r0 += kRevUnroll * (int)blockDim.x) {
    bool can[kRevUnroll];
#pragma unroll
    for (int u = 0; u < kRevUnroll; ++u) {
      const int i = r0 + u * (int)blockDim.x + (int)threadIdx.x;
      can[u] = i < hi && live[i] != 0 && depth[i] >= 1;
    }
#pragma unroll
    for (int u = 0; u < kRevUnroll; ++u) {
      const int i = r0 + u * (int)blockDim.x + (int)threadIdx.x;
      unsigned t = 0;
      if (can[u]) {
        const int2* sp = spans + (size_t)i * S;
        const int* kk = ik + (size_t)i * K;
        t = (unsigned)sub_slot_count(0, 0, sp[0]);
        for (int k = 1; k < S; ++k) t += (unsigned)sub_slot_count(k, kk[k - 1], sp[k]);
      }
      if (i < hi) tot[i] = (int)t;
      s += t;
    }
  }
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = (int)s;
}

__global__ void subjects_scan_kernel(
    const int* __restrict__ q, int F, int tile, const int* __restrict__ tile_sums, int n_tiles,
    int share, int n_shares, int* __restrict__ offs, int* __restrict__ splits,
    int* __restrict__ total, int* __restrict__ cause) {
  task_scan<false>(q, F, tile, tile_sums, n_tiles, nullptr, share, n_shares, offs, splits,
                   total, cause);
}

// A block's candidates, at most kMergeUnroll a thread, go through each
// level of dependent loads together: their tasks (shared memory), the
// tasks' columns, their span rows and lanes, the fe_pack rows and lanes.
template <int kMergeUnroll>
__global__ void __launch_bounds__(kThreads) subjects_merge_kernel(
    const int* __restrict__ offs, const int* __restrict__ splits,
    const int* __restrict__ total, int F, int K, const int* __restrict__ q,
    const int* __restrict__ obj, const int* __restrict__ depth,
    const uint8_t* __restrict__ live, const int2* __restrict__ spans,
    const int* __restrict__ ik, const int* __restrict__ ir, const int* __restrict__ ir2,
    const int4* __restrict__ fe_pack, int n_edges, int wildcard_rel, int* __restrict__ c_q,
    int* __restrict__ c_obj, int* __restrict__ c_rel, int* __restrict__ c_depth,
    uint8_t* __restrict__ c_valid, uint8_t* __restrict__ c_emit, int* __restrict__ c_value) {
  constexpr int kShare = kMergeUnroll * kThreads;
  __shared__ int s_off[kShare + 1];
  const int S = K + 1;
  const int b = blockIdx.x;
  const int i0 = splits[b], i1 = splits[b + 1];
  const long long d0 = (long long)b * kShare;
  const long long d1 = min(d0 + kShare, 2LL * F);
  const int k0 = (int)(d0 - i0), k1 = (int)(d1 - i1);
  if (k0 >= k1) return;  // a share of task starts only (a run of empty tasks)
  const int sb = max(i0 - 1, 0);
  const int n_st = i1 - sb;
  for (int t = threadIdx.x; t < n_st; t += blockDim.x) s_off[t] = offs[sb + t];
  const int in_total = min(*total, F);
  __syncthreads();
  int ti[kMergeUnroll], a[kMergeUnroll];
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const int j = k0 + u * (int)blockDim.x + (int)threadIdx.x;
    // the last staged task whose offset is <= j (task i0 - 1, or task 0 at
    // offset 0, qualifies, so the search starts past it)
    int lo = i0 - sb, hi = n_st;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_off[mid] <= j) lo = mid + 1; else hi = mid;
    }
    ti[u] = j < k1 ? sb + lo - 1 : -1;
    a[u] = s_off[max(lo - 1, 0)];
  }
  bool can[kMergeUnroll];
  int d[kMergeUnroll], tq[kMergeUnroll], to[kMergeUnroll];
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const int t = max(ti[u], 0);
    d[u] = depth[t];
    can[u] = live[t] != 0 && d[u] >= 1;
    tq[u] = q[t];
    to[u] = obj[t];
  }
  // the last slot whose offset is <= j: its index, start and lane kind
  int sel[kMergeUnroll], sel_kk[kMergeUnroll], e_idx[kMergeUnroll];
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const int j = k0 + u * (int)blockDim.x + (int)threadIdx.x;
    const int t = max(ti[u], 0);
    const int2* sp = spans + (size_t)t * S;
    const int* kk = ik + (size_t)t * K;
    const int2 sp0 = sp[0];
    int seg_off = a[u], start = sp0.x;
    sel[u] = 0;
    sel_kk[u] = 0;
    unsigned end = (unsigned)seg_off + (unsigned)(can[u] ? sub_slot_count(0, 0, sp0) : 0);
    for (int k = 1; k < S; ++k) {
      const int2 spk = sp[k];
      const int kkk = kk[k - 1];
      if ((int)end <= j) {
        seg_off = (int)end;
        sel[u] = k;
        sel_kk[u] = kkk;
        start = spk.x;
      }
      end += (unsigned)(can[u] ? sub_slot_count(k, kkk, spk) : 0);
    }
    e_idx[u] = min(max(start + (j - seg_off), 0), max(n_edges - 1, 0));
  }
  int4 e[kMergeUnroll];
  int crel[kMergeUnroll];
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const int t = max(ti[u], 0);
    e[u] = n_edges > 0 && ti[u] >= 0 ? fe_pack[e_idx[u]] : make_int4(0, 0, 0, 0);
    crel[u] = 0;
    if (sel[u] > 0 && ti[u] >= 0) {
      const int* lane = sel_kk[u] == kInstrComputed ? ir : ir2;
      crel[u] = lane[(size_t)t * K + sel[u] - 1];
    }
  }
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    const int j = k0 + u * (int)blockDim.x + (int)threadIdx.x;
    if (ti[u] < 0) continue;
    // slot 0 is the task's own row; a lane slot is COMPUTED (one candidate,
    // the task's object) or TTU only when the task can expand
    const int kind = sel[u] == 0 || !can[u] ? 0
                   : (sel_kk[u] == kInstrComputed ? 1 : (sel_kk[u] == kInstrTtu ? 2 : 0));
    const bool is_row = kind == 0;
    const bool is_c = kind == 1;
    const int cd = is_c ? d[u] : d[u] - 1;
    const bool cond = is_row ? (e[u].x == 1 && e[u].z != wildcard_rel) : (is_c || e[u].x == 1);
    const bool in_range = j < in_total;
    c_q[j] = tq[u];
    c_obj[j] = is_c ? to[u] : e[u].y;
    c_rel[j] = is_row ? e[u].z : crel[u];
    c_depth[j] = cd;
    c_valid[j] = in_range && cond && cd >= 1;
    c_emit[j] = in_range && is_row && e[u].x == 0;
    c_value[j] = e[u].y;
  }
}

// ---------------------------------------------------------------------------
// L4 list_pool_compact
//
// csrc/pool.cuh's compaction with one column (X2's body); a query's cause
// is raised by max to CAUSE_FRONTIER_OVERFLOW where its span crosses the
// pool's end.
// ---------------------------------------------------------------------------

struct ListPoolFlags {
  static constexpr int kRows = 1;
  const int* needs_host;
  __device__ int load(int b) const { return __ldg(needs_host + b); }
  __device__ void write(int* flags, int B, int b, int cause, bool over) const {
    flags[b] = max(cause, over ? kCauseFrontierOverflow : 0);
  }
};

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
    int rc = allow_smem((const void*)list_emit_count_kernel<true>, smem);
    if (rc == 0) rc = allow_smem((const void*)list_emit_rank_kernel<true>, smem);
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

// The ints of L2's and L3's scratch for a frontier of F tasks:
// O(F + kMaxTiles).
long long keto_gather_scratch(int F) {
  return F > 0 ? round4(F) + round4((F + 31) / 32) + kMaxTiles +
                   round4(rev_shares(F, kThreads) + 1) + 1
               : 0;
}

// Scratch: keto_gather_scratch(F) ints; every part is written before it
// is read.
int keto_reverse_gather(
    const int* q, const int* obj, const int* rel, const int* depth, const uint8_t* live,
    const int* ns_t, const int* rstart, const int* rlen, const int* rinstr, int RK,
    const int* rv_pack, int n_redges, const int* objslot_ns, int n_objslot, int F, int B,
    int wildcard_rel, int ncr, int* scratch, int* cause, int* c_q, int* c_obj, int* c_rel,
    int* c_depth, uint8_t* c_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F <= 0 || RK <= 0 || n_objslot <= 0) return (int)cudaErrorInvalidValue;
  const RevScratch sc = rev_scratch(scratch, F);
  const int tile = scan_tile(F, kRevTile);
  const int nt = scan_tiles(F, tile);
  const int unroll = rev_merge_unroll(F);
  const int share = unroll * kThreads;
  const int n_shares = rev_shares(F, share);
  reverse_tile_kernel<<<nt, kThreads, 0, st>>>(rel, depth, live, ns_t, rlen,
                                               (const int4*)rinstr, RK, F, tile, wildcard_rel,
                                               ncr, sc.offs, sc.pois, sc.tile_sums, cause, B);
  reverse_scan_kernel<<<nt, kThreads, 0, st>>>(q, F, tile, sc.tile_sums, nt, sc.pois, share,
                                               n_shares, sc.offs, sc.splits, sc.total, cause);
  auto merge = unroll == 1 ? reverse_merge_kernel<1> : reverse_merge_kernel<2>;
  merge<<<n_shares, kThreads, 0, st>>>(
      sc.offs, sc.splits, sc.total, F, RK, q, obj, rel, depth, live, ns_t, rstart, rlen,
      (const int4*)rinstr, (const int4*)rv_pack, n_redges, objslot_ns, n_objslot,
      wildcard_rel, ncr, c_q, c_obj, c_rel, c_depth, c_valid);
  return (int)cudaGetLastError();
}

// Scratch: keto_gather_scratch(F) ints; every part is written before it
// is read (the POISON words are not used).
int keto_subjects_gather(
    const int* q, const int* obj, const int* depth, const uint8_t* live, const int* spans,
    const int* ik, const int* ir, const int* ir2, int K, const int* fe_pack, int n_edges,
    int F, int B, int wildcard_rel, int* scratch, int* cause, int* c_q, int* c_obj,
    int* c_rel, int* c_depth, uint8_t* c_valid, uint8_t* c_emit, int* c_value, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const RevScratch sc = rev_scratch(scratch, F);
  const int tile = scan_tile(F, kRevTile);
  const int nt = scan_tiles(F, tile);
  const int unroll = rev_merge_unroll(F);
  const int share = unroll * kThreads;
  const int n_shares = rev_shares(F, share);
  subjects_tile_kernel<<<nt, kThreads, 0, st>>>(depth, live, (const int2*)spans, ik, K, F,
                                                tile, sc.offs, sc.tile_sums, cause, B);
  subjects_scan_kernel<<<nt, kThreads, 0, st>>>(q, F, tile, sc.tile_sums, nt, share, n_shares,
                                                sc.offs, sc.splits, sc.total, cause);
  auto merge = unroll == 1 ? subjects_merge_kernel<1> : subjects_merge_kernel<2>;
  merge<<<n_shares, kThreads, 0, st>>>(
      sc.offs, sc.splits, sc.total, F, K, q, obj, depth, live, (const int2*)spans, ik, ir, ir2,
      (const int4*)fe_pack, n_edges, wildcard_rel, c_q, c_obj, c_rel, c_depth, c_valid, c_emit,
      c_value);
  return (int)cudaGetLastError();
}

// Scratch: keto_pool_scratch(B) ints (none on the engines' batches).
int keto_list_pool_compact(const int* res, const int* res_count, const int* needs_host,
                           const int* stats, int B, int R, int P, int* scratch, int* out,
                           void* stream) {
  return pool_compact(PoolCols<1>{{res}}, res_count, ListPoolFlags{needs_host}, stats, B, R, P,
                      scratch, out, (cudaStream_t)stream);
}

}  // extern "C"

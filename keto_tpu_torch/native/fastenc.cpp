// Host encoders of the columnar mirror build: a sorted-unique encoding of
// fixed-width byte keys, and the round-based probe-table builder.
//
// keto_unique_encode gives what np.unique(keys, return_index=True) and
// np.searchsorted(uniques, keys) give, bit for bit, without sorting every
// row: dense ids in sorted-unique order (ArrayMap's searchsorted lookups
// need sorted keys) and first-occurrence indices, by
//
//   1. one open-addressing pass that dedupes the n rows into u slots
//      (a chunked fmix64 hash of the row bytes; the first comer claims a
//      slot, so its representative is the first occurrence),
//   2. std::sort of the u unique rows only (objects and subjects repeat
//      across tuples, so u is far below n),
//   3. one pass that maps every row's slot to its sorted rank.
//
// keto_build_probe_table builds the open-addressing tables the kernels
// probe, bit for bit as the numpy rounds of engine/snapshot.py
// (_build_hash_table_plain), without their argsort a round.
//
// A plain C interface for ctypes (keto_tpu_torch/native/__init__.py builds
// it with g++ at first use). Single threaded: the result must not depend
// on a thread count. The same algorithm as the JAX package's
// keto_tpu/native/fastenc.cpp, so both build the same tables.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Chunked 8-bytes-at-a-time hash (memcpy keeps unaligned row starts
// legal; trailing bytes zero-padded into the final chunk, harmless
// because fixed-width rows already hold their \x00 padding in the
// compared bytes). Every chunk goes through a murmur3-style fmix64: a
// plain chunked FNV (one multiply a chunk) does not spread middle-byte
// differences into the table-mask bits, and the probe chains grow long.
inline uint64_t fmix64(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ull;
    x ^= x >> 33;
    return x;
}

inline uint64_t hash_row(const uint8_t* p, int64_t w) {
    uint64_t h = 0x9e3779b97f4a7c15ull ^ static_cast<uint64_t>(w);
    int64_t i = 0;
    for (; i + 8 <= w; i += 8) {
        uint64_t c;
        std::memcpy(&c, p + i, 8);
        h = fmix64(h ^ c) + 0x165667b19e3779f9ull;
    }
    if (i < w) {
        uint64_t c = 0;
        std::memcpy(&c, p + i, static_cast<size_t>(w - i));
        h = fmix64(h ^ c) + 0x165667b19e3779f9ull;
    }
    return fmix64(h);
}

struct Slot {
    uint64_t h;    // the full hash: a probe mismatch resolves without
                   // reading the representative row; equality is still
                   // confirmed by memcmp, so a 64-bit collision never
                   // merges two distinct keys
    int32_t rep;   // the representative row, -1 = empty (n <= 2^30)
};

}  // namespace

extern "C" {

// keys: n rows of w bytes, contiguous.
// out_first_idx: int64[n]; its first n_uniq entries get each unique
//   key's first row, in sorted key order (keys[out_first_idx[:n_uniq]]
//   is the sorted unique set).
// out_codes: int32[n]; every row's rank among the sorted uniques
//   (np.searchsorted(sorted_uniques, keys)).
// Returns n_uniq; -1 when n exceeds 2^30 rows (the int32 slot fields) or
// an allocation fails. No exception leaves this function: one escaping
// an extern "C" entry point would terminate the process.
int64_t keto_unique_encode(const uint8_t* keys, int64_t n, int64_t w,
                           int64_t* out_first_idx, int32_t* out_codes)
try {
    if (n == 0) return 0;
    if (n > (int64_t{1} << 30)) return -1;
    // power-of-two capacity at load <= 0.5
    uint64_t cap = 1;
    while (cap < static_cast<uint64_t>(2 * n)) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<Slot> slots(cap, Slot{0, -1});
    std::vector<int32_t> row_slot(n);

    // software-pipelined probe: hash a block, prefetch its home slots,
    // then probe (the random slot read is the dominant stall)
    constexpr int64_t BLK = 32;
    uint64_t hs[BLK];
    for (int64_t b = 0; b < n; b += BLK) {
        const int64_t e = std::min(b + BLK, n);
        for (int64_t i = b; i < e; ++i) {
            hs[i - b] = hash_row(keys + i * w, w);
            __builtin_prefetch(&slots[hs[i - b] & mask], 1, 1);
        }
        for (int64_t i = b; i < e; ++i) {
            const uint8_t* row = keys + i * w;
            const uint64_t h = hs[i - b];
            uint64_t s = h & mask;
            for (;;) {
                Slot& sl = slots[s];
                if (sl.rep < 0) {
                    sl.h = h;
                    // ascending i: rep is the first occurrence
                    sl.rep = static_cast<int32_t>(i);
                    break;
                }
                if (sl.h == h
                    && std::memcmp(keys + static_cast<int64_t>(sl.rep) * w,
                                   row, w) == 0) {
                    break;
                }
                s = (s + 1) & mask;  // linear probe
            }
            row_slot[i] = static_cast<int32_t>(s);
        }
    }

    // the occupied slots, sorted by their representative rows' bytes
    std::vector<int64_t> occupied;
    occupied.reserve(static_cast<size_t>(n));
    for (uint64_t s = 0; s < cap; ++s) {
        if (slots[s].rep >= 0) occupied.push_back(static_cast<int64_t>(s));
    }
    const int64_t n_uniq = static_cast<int64_t>(occupied.size());
    std::sort(occupied.begin(), occupied.end(),
              [keys, w, &slots](int64_t a, int64_t b) {
                  return std::memcmp(keys + slots[a].rep * w,
                                     keys + slots[b].rep * w, w) < 0;
              });

    // sorted rank per slot, first occurrence per rank
    std::vector<int32_t> slot_rank(cap);
    for (int64_t r = 0; r < n_uniq; ++r) {
        const int64_t s = occupied[static_cast<size_t>(r)];
        slot_rank[static_cast<size_t>(s)] = static_cast<int32_t>(r);
        out_first_idx[r] = slots[static_cast<size_t>(s)].rep;
    }
    for (int64_t i = 0; i < n; ++i) {
        out_codes[i] = slot_rank[static_cast<size_t>(row_slot[i])];
    }
    return n_uniq;
} catch (...) {
    return -1;
}

// Round-based open-addressing construction, bit for bit the numpy rounds
// of engine/snapshot.py: at round r every pending key probes the slot
// snapshot.probe_slot gives, ((h1 + (r / spb) * h2) mod (cap / spb)) * spb
// + r % spb, so a key fills the spb slots of a bucket before it steps to
// the next bucket. Among a round's contenders for a slot that was free at
// the round's start, the lowest index wins; the losers go on to the next
// round. Walking the pending keys in ascending index order and claiming
// a slot on finding it empty gives that rule exactly (the lowest
// contender reaches each slot first), without the per-round argsort of
// the numpy rounds.
//
// No key is compared: duplicate keys each take a slot, as in the numpy
// rounds. The caller computes h1 and h2 with its vectorised hash and
// fills the outputs with `empty` first.
//
// key_cols: [n_cols][n] int32; out_cols: [n_cols][cap] int32.
// Returns the probe limit (>= 1); -1 when a key needs more than 64
// rounds (the caller doubles cap and builds again, as the numpy rounds
// do); -2 for arguments it cannot take (n past 2^30, spb not a power of
// two or larger than cap) or a failed allocation.
int64_t keto_build_probe_table(const uint32_t* h1, const uint32_t* h2,
                               int64_t n, const int32_t* key_cols,
                               int64_t n_cols, const int32_t* values,
                               int32_t* out_cols, int32_t* out_vals,
                               int64_t cap, int32_t empty, int64_t spb)
try {
    if (n == 0) return 1;
    if (n > (int64_t{1} << 30)) return -2;  // int32 pending indices
    if (spb < 1 || (spb & (spb - 1)) != 0 || cap < spb) return -2;
    const uint32_t sh = static_cast<uint32_t>(__builtin_ctzll(
        static_cast<uint64_t>(spb)));
    const uint32_t smask = static_cast<uint32_t>(spb - 1);
    const uint32_t bmask = static_cast<uint32_t>(cap / spb - 1);
    std::vector<int32_t> pending(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) pending[static_cast<size_t>(i)] =
        static_cast<int32_t>(i);
    std::vector<int32_t> lost;
    lost.reserve(pending.size());
    int64_t round = 0;
    while (!pending.empty()) {
        if (round >= 64) return -1;  // the numpy rounds' limit too
        const uint32_t r = static_cast<uint32_t>(round);
        lost.clear();
        for (int32_t i : pending) {
            const uint32_t s =
                ((h1[i] + (r >> sh) * h2[i]) & bmask) * (smask + 1u)
                + (r & smask);
            if (out_vals[s] == empty) {
                out_vals[s] = values[i];
                for (int64_t c = 0; c < n_cols; ++c) {
                    out_cols[c * cap + s] = key_cols[c * n + i];
                }
            } else {
                lost.push_back(i);
            }
        }
        pending.swap(lost);
        ++round;
    }
    return round;
} catch (...) {
    return -2;
}

}  // extern "C"

// The single-pass decoupled look-back shared by B1 (scan_mm.cu), B9
// (seg_scan.cu) and B13 (linrec_scan.cu): one launch scans every row, cut into
// tiles, one CTA a tile.
//
// Order.  A CTA takes its tile from a global atomic counter, not from
// blockIdx, and tiles are numbered row by row, so a CTA only ever waits on
// tiles whose CTAs took their numbers earlier and are therefore running or
// done.  CUDA promises no order of blockIdx, so this is what rules out
// deadlock whatever the grid's size.
//
// State.  Each tile has one 64-bit status word, published with one store:
//
//     bits  0..31  the value (fp32 or int32 bits)
//     bits 32..33  0 = nothing yet, 1 = the tile's aggregate A, 2 = its
//                  inclusive prefix P
//     bit  34      the aggregate's has-flag bit (segmented scans)
//
// The words of all rows and, after them, the counter form the workspace,
// which the C entry point zeroes on the caller's stream (8 B a tile + 8 B).
//
// Pairs.  B13's aggregate is an affine map y -> A*y + B, 64 bits of value, and
// its prefix the scalar state y.  It takes two words a tile, in two arrays
// (all rows' first words, then all rows' second words, then the counter: 16 B
// a tile + 8 B): the first publishes status 1 | A, the second status 1 | B,
// and later the first becomes status 2 | P.  Each word still carries its
// value and is written once with each status, so a reader takes the pair as
// an aggregate only when both words show status 1, and then the two halves are
// the ones written together; a first word with status 2 needs no second word.
// The relaxed loads and stores stay enough.  (A 128-bit word would need the
// PTX ISA to promise single-copy atomicity for 128-bit accesses; two
// self-describing words do not.)
// A word carries its value, and no reader uses anything else its writer
// wrote, so relaxed 64-bit atomic stores and loads at device scope are all
// the ordering the look-back needs: a reader sees a whole word, old or new.
// Release stores would make each publish wait for the writer's earlier
// accesses, and acquire loads would order a poll's windows one after another,
// a round trip to L2 each; the look-back polls all its windows at once.
//
// Determinism.  The exclusive prefix of tile t is the strict left-to-right
// fold of the operator: start from the nearest predecessor k that "closes"
// (it has published P_k, or, for the segmented operator, its aggregate holds
// a flag), then fold A_{k+1} ... A_{t-1} in index order.  Every P_j is itself
// fold(P_{j-1}, A_j), so the result is the same chain of operations whatever
// k the look-back stopped at: bit-equal from run to run.  A textbook
// look-back that sums the aggregates it finds as a tree would not be.  The
// look-back warp reads 32 predecessors a load, up to kLookbackWindows
// windows back; only the fold itself is sequential.
#pragma once

#include "common.cuh"

namespace repro {

constexpr unsigned long long kTileAggregate = 1ull << 32;
constexpr unsigned long long kTileInclusive = 2ull << 32;
constexpr unsigned long long kTileStatus = 3ull << 32;
constexpr unsigned long long kTileFlag = 1ull << 34;
constexpr int kLookbackWindows = 4;
constexpr long long kLookbackPolls = 1LL << 24;

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits_of(int v) { return static_cast<unsigned>(v); }
__device__ __forceinline__ float value_of(unsigned long long w, float) {
    return __uint_as_float(static_cast<unsigned>(w));
}
__device__ __forceinline__ int value_of(unsigned long long w, int) {
    return static_cast<int>(static_cast<unsigned>(w));
}

template <typename A>
__device__ __forceinline__ unsigned long long tile_word(unsigned long long status, A v,
                                                        bool flag = false) {
    return status | (flag ? kTileFlag : 0ull) | bits_of(v);
}

// An operator of the look-back: kPair (two words a tile), ready (the tile has
// published something usable), closes (the fold may start from it) and fold.
// The plain sum: a predecessor closes once it has published its prefix.
template <typename A>
struct SumFold {
    static constexpr bool kPair = false;
    static __device__ bool ready(unsigned long long w, unsigned long long) {
        return (w & kTileStatus) != 0;
    }
    static __device__ bool closes(unsigned long long w) {
        return (w & kTileStatus) == kTileInclusive;
    }
    static __device__ A fold(A c, unsigned long long w, unsigned long long) {
        return c + value_of(w, A(0));
    }
};

// The segmented-pair operator (c ⊕ a) = a.h ? a.v : c + a.v: a predecessor
// also closes when its aggregate holds a flag, since nothing before it counts.
template <typename A>
struct SegFold {
    static constexpr bool kPair = false;
    static __device__ bool ready(unsigned long long w, unsigned long long) {
        return (w & kTileStatus) != 0;
    }
    static __device__ bool closes(unsigned long long w) {
        return (w & kTileStatus) == kTileInclusive ||
               ((w & kTileStatus) == kTileAggregate && (w & kTileFlag));
    }
    static __device__ A fold(A c, unsigned long long w, unsigned long long) {
        const A v = value_of(w, A(0));
        return (w & kTileFlag) ? v : c + v;
    }
};

// The affine operator of B13 on the state: c -> fmaf(A, c, B), the aggregate's
// A in the first word, B in the second.  An aggregate is ready once both words
// show it.
struct AffineFold {
    static constexpr bool kPair = true;
    static __device__ bool ready(unsigned long long w, unsigned long long w2) {
        return (w & kTileStatus) == kTileInclusive ||
               ((w & kTileStatus) == kTileAggregate && (w2 & kTileStatus) == kTileAggregate);
    }
    static __device__ bool closes(unsigned long long w) {
        return (w & kTileStatus) == kTileInclusive;
    }
    static __device__ float fold(float c, unsigned long long w, unsigned long long w2) {
        return fmaf(value_of(w, 0.f), c, value_of(w2, 0.f));
    }
};

// Thread 0 takes the next tile number from the counter; every thread returns
// it.  Ends with a barrier.
__device__ __forceinline__ long long take_tile(unsigned long long* counter,
                                               long long& slot) {
    if (threadIdx.x == 0) slot = static_cast<long long>(atomicAdd(counter, 1ull));
    __syncthreads();
    return slot;
}

// The exclusive prefix of tile j > 0 of a row whose status words start at
// `row` (and, for a pair operator, whose second words start at `row2`), by one
// full warp; every lane returns it.  A word before the row's first tile reads
// as the prefix 0.  Spins until a predecessor within reach closes and every
// tile between has published its aggregate; a wait of more than
// kLookbackPolls polls can only be a fault (a workspace that does not match
// the grid), so it traps, and the launch fails instead of hanging.
template <typename A, typename Op>
__device__ __forceinline__ A lookback_exclusive(const unsigned long long* row,
                                                const unsigned long long* row2, long long j,
                                                int lane) {
    unsigned long long w[kLookbackWindows], w2[kLookbackWindows];
    for (long long polls = 0;; ++polls) {
        if (polls > kLookbackPolls) __trap();
#pragma unroll
        for (int k = 0; k < kLookbackWindows; ++k) {
            const long long idx = j - 1 - 32LL * k - lane;
            w[k] = idx >= 0 ? ld_relaxed(row + idx) : kTileInclusive;
            if constexpr (Op::kPair) w2[k] = idx >= 0 ? ld_relaxed(row2 + idx) : 0ull;
            else w2[k] = 0ull;
        }
        int stop = -1, win = 0;
        bool wait = false;
#pragma unroll
        for (int k = 0; k < kLookbackWindows; ++k) {
            if (stop < 0 && !wait) {
                const unsigned valid = __ballot_sync(kFullMask, Op::ready(w[k], w2[k]));
                const unsigned close = __ballot_sync(kFullMask, Op::closes(w[k]));
                const unsigned nearer = close ? (close & (0u - close)) - 1u : kFullMask;
                if ((valid & nearer) != nearer) {
                    wait = true;
                } else if (close) {
                    stop = __ffs(close) - 1;
                    win = k;
                }
            }
        }
        if (stop >= 0) {
            A c = value_of(__shfl_sync(kFullMask, w[win], stop), A(0));
#pragma unroll
            for (int k = kLookbackWindows - 1; k >= 0; --k) {
                if (k <= win) {
                    for (int i = (k == win ? stop : 32) - 1; i >= 0; --i) {
                        const unsigned long long wi = __shfl_sync(kFullMask, w[k], i);
                        if constexpr (Op::kPair) {
                            c = Op::fold(c, wi, __shfl_sync(kFullMask, w2[k], i));
                        } else {
                            c = Op::fold(c, wi, 0ull);
                        }
                    }
                }
            }
            return c;
        }
    }
}

// Warp-collective carry-in of tile j of a row: publish the aggregate (or, for
// the row's first tile, the prefix), look back, publish the inclusive prefix
// fold(c, aggregate), and return c.  `row` is the row's status words.
template <typename A, typename Op>
__device__ __forceinline__ A lookback_carry(unsigned long long* row, long long j, A agg,
                                            bool agg_flag, int lane) {
    if (j == 0) {
        if (lane == 0) {
            const A p = Op::fold(A(0), tile_word(kTileAggregate, agg, agg_flag), 0ull);
            st_relaxed(row, tile_word(kTileInclusive, p));
        }
        return A(0);
    }
    if (lane == 0) st_relaxed(row + j, tile_word(kTileAggregate, agg, agg_flag));
    const A c = lookback_exclusive<A, Op>(row, nullptr, j, lane);
    if (lane == 0) {
        const A p = Op::fold(c, tile_word(kTileAggregate, agg, agg_flag), 0ull);
        st_relaxed(row + j, tile_word(kTileInclusive, p));
    }
    return c;
}

// The same for B13's affine aggregate (A, B): `row` and `row2` are the row's
// first and second words.  Tile j's state on entry is the strict fold
// y <- fmaf(A_i, y, B_i) from the nearest published P_k over k < i < j, and
// its prefix P_j = fmaf(A, y, B): the chain of links a walk of the row's
// tiles in order makes, whichever k the look-back stopped at.
__device__ __forceinline__ float lookback_affine_carry(unsigned long long* row,
                                                       unsigned long long* row2, long long j,
                                                       float A, float B, int lane) {
    if (j == 0) {
        if (lane == 0) st_relaxed(row, tile_word(kTileInclusive, fmaf(A, 0.f, B)));
        return 0.f;
    }
    if (lane == 0) {
        st_relaxed(row + j, tile_word(kTileAggregate, A));
        st_relaxed(row2 + j, tile_word(kTileAggregate, B));
    }
    const float c = lookback_exclusive<float, AffineFold>(row, row2, j, lane);
    if (lane == 0) st_relaxed(row + j, tile_word(kTileInclusive, fmaf(A, c, B)));
    return c;
}

}  // namespace repro

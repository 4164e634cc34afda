// The segmented scan walk shared by B9 (seg_scan.cu) and B11 (seg_carry.cu),
// through seg_pass.cuh's single pass, and B12 (seg_block_scan.cu).
//
// A segmented scan is a plain scan under the segmented-pair operator on
// (value, flag) pairs,
//
//     (a ⊕ b) = (b.h ? b.v : a.v + b.v,  a.h | b.h),
//
// where h marks an element, or a run of elements, that holds a segment start.
// The operator is associative, so the usual parallel scan applies: each
// thread scans N consecutive elements in registers (kSegItems = 8 for B12, 16
// for B9 and B11), warp shuffles
// carry (v, h) across the lanes, and one warp scans the warp totals.  Rounds
// are linked in order by the same operator on their aggregates: a running
// carry within a CTA's range (B12), or the look-back of lookback.cuh across
// CTAs (B9 and B11, one round a CTA).  The carry of earlier rounds reaches
// only the elements before a round's first flag, which is what the Pallas
// kernels do with their `seen` mask.  Each warp loads and stores its round's
// elements through shared memory, in address order (warp_stage_in,
// warp_store_staged), so its global accesses are whole 16-byte words side by
// side.
//
// Every result is a sum of terms of its own segment only, taken as a tree
// within a round and sequentially across rounds, so fp32 results carry no
// cancellation against earlier segments.  Integer inputs accumulate in int32.
// Flags are bytes (B9, B12) or int32 words (B11's has-flag summaries); any
// nonzero flag starts a segment.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kSegMaxThreads = 1024;
constexpr int kSegItems = 8;

// Threads for a CTA whose range holds `elems` elements, `items` a thread:
// enough warps for one round, at least one and at most `cap`.
inline int seg_threads(long long elems, int cap, int items = kSegItems) {
    long long t = (elems / items + 31) / 32 * 32;
    if (t < 32) t = 32;
    if (t > cap) t = cap;
    return static_cast<int>(t);
}

template <typename A>
struct SegScratch {
    A v[2 * 32 + 1];
    int h[2 * 32 + 1];
};

// Inclusive segmented scan of one pair per lane across a full warp.
template <typename A>
__device__ __forceinline__ void warp_seg_inclusive_scan(A& v, int& h, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const A ov = __shfl_up_sync(kFullMask, v, d);
        const int oh = __shfl_up_sync(kFullMask, h, d);
        if (lane >= d) {
            if (!h) v = ov + v;
            h |= oh;
        }
    }
}

// Block-wide exclusive segmented scan of one pair per thread, in thread order,
// for a block of full warps (at most 32).  (ex_v, ex_h) is the thread's
// exclusive prefix, (tot_v, tot_h) the block's aggregate.  Ends with a barrier,
// so the scratch may be reused at once.
template <typename A>
__device__ __forceinline__ void block_seg_exclusive_scan(A v, int h, SegScratch<A>& sc,
                                                         A& ex_v, int& ex_h, A& tot_v,
                                                         int& tot_h) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    A iv = v;
    int ih = h;
    warp_seg_inclusive_scan(iv, ih, lane);
    if (lane == 31) {
        sc.v[warp] = iv;
        sc.h[warp] = ih;
    }
    __syncthreads();
    if (warp == 0) {
        A wv = lane < nwarps ? sc.v[lane] : A(0);
        int wh = lane < nwarps ? sc.h[lane] : 0;
        warp_seg_inclusive_scan(wv, wh, lane);
        A ev = __shfl_up_sync(kFullMask, wv, 1);
        int eh = __shfl_up_sync(kFullMask, wh, 1);
        if (lane == 0) {
            ev = A(0);
            eh = 0;
        }
        if (lane < nwarps) {
            sc.v[32 + lane] = ev;
            sc.h[32 + lane] = eh;
        }
        if (lane == nwarps - 1) {
            sc.v[64] = wv;
            sc.h[64] = wh;
        }
    }
    __syncthreads();
    A lv = __shfl_up_sync(kFullMask, iv, 1);
    int lh = __shfl_up_sync(kFullMask, ih, 1);
    if (lane == 0) {
        lv = A(0);
        lh = 0;
    }
    ex_v = lh ? lv : sc.v[32 + warp] + lv;
    ex_h = lh | sc.h[32 + warp];
    tot_v = sc.v[64];
    tot_h = sc.h[64];
    __syncthreads();
}

// Bit k set where element k of the N at p starts a segment (a nonzero byte);
// bytes at or past `avail` read as no flag.  One N-byte load when whole and
// aligned.
template <int N>
__device__ __forceinline__ unsigned load_flag_bits(const uint8_t* __restrict__ p,
                                                   long long avail) {
    static_assert(N == 8 || N == 16, "one 8- or 16-byte word of flags a thread");
    unsigned bits = 0;
    if (avail >= N && (reinterpret_cast<uintptr_t>(p) % N) == 0) {
        const typename VecWord<N>::type raw =
            *reinterpret_cast<const typename VecWord<N>::type*>(p);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
        for (int k = 0; k < N; ++k) bits |= b[k] ? 1u << k : 0u;
    } else {
#pragma unroll
        for (int k = 0; k < N; ++k) bits |= (k < avail && p[k] != 0) ? 1u << k : 0u;
    }
    return bits;
}

// The same for int32 flags (nonzero = a segment start): four 16-byte words a
// thread of 16 when whole and aligned.
template <int N>
__device__ __forceinline__ unsigned load_flag_bits(const int* __restrict__ p, long long avail) {
    static_assert(N % 4 == 0, "whole 16-byte words of flags a thread");
    unsigned bits = 0;
    if (avail >= N && (reinterpret_cast<uintptr_t>(p) % 16) == 0) {
#pragma unroll
        for (int c = 0; c < N / 4; ++c) {
            const int4 w = reinterpret_cast<const int4*>(p)[c];
            bits |= (w.x != 0 ? 1u : 0u) << (4 * c);
            bits |= (w.y != 0 ? 2u : 0u) << (4 * c);
            bits |= (w.z != 0 ? 4u : 0u) << (4 * c);
            bits |= (w.w != 0 ? 8u : 0u) << (4 * c);
        }
    } else {
#pragma unroll
        for (int k = 0; k < N; ++k) bits |= (k < avail && p[k] != 0) ? 1u << k : 0u;
    }
    return bits;
}

// One round of a segmented scan, as a thread holds it: its flag bits, its
// exclusive prefix within the round, and the round's aggregate (the same on
// every thread).  Its values stay in the staging area until the store.
template <typename A>
struct SegRound {
    unsigned f;
    A ex_v, tot_v;
    int ex_h, tot_h;
};

// Shared memory a CTA of `threads` stages its rounds' loads and stores in,
// N elements a thread.
template <int N = kSegItems>
inline size_t seg_stage_bytes(int threads) {
    return static_cast<size_t>(threads) * stage_stride<N>();
}

// Load and scan the round that starts at xr[base], N elements a thread: this
// thread's are [i0, i0 + N), i0 = base + threadIdx.x * N, those at or past hi
// read as zero with no flag.  The values come in through `stage`
// (seg_stage_bytes<N>(blockDim.x) bytes), each warp's in address order, and
// stay there for seg_round_store.  Ends with a barrier.
template <typename T, typename A, int N = kSegItems, typename F>
__device__ __forceinline__ void seg_round_scan(const T* __restrict__ xr,
                                               const F* __restrict__ fr, long long base,
                                               long long hi, SegRound<A>& r,
                                               SegScratch<A>& sc, unsigned char* stage) {
    const int lane = threadIdx.x & 31;
    const long long wbase = base + static_cast<long long>(threadIdx.x - lane) * N;
    const long long i0 = wbase + lane * N;
    unsigned char* wstage = stage + (threadIdx.x - lane) * stage_stride<N>();
    warp_stage_in<T, A, N>(xr + wbase, hi - wbase, wstage, lane);
    r.f = load_flag_bits<N>(fr + i0, hi - i0);
    A v[N];
    stage_row(wstage, lane, v);
    A run = A(0);
#pragma unroll
    for (int k = 0; k < N; ++k) run = ((r.f >> k) & 1u) ? v[k] : run + v[k];
    block_seg_exclusive_scan(run, r.f != 0 ? 1 : 0, sc, r.ex_v, r.ex_h, r.tot_v, r.tot_h);
}

// Write the round that starts at orow[base] below hi, seeded with the round's
// carry-in: the seed reaches only the elements before the round's first flag.
// kExclusive writes each element's prefix before it instead of through it.
template <typename A, int N = kSegItems, bool kExclusive = false>
__device__ __forceinline__ void seg_round_store(A* __restrict__ orow, long long base,
                                                long long hi, const SegRound<A>& r, A carry,
                                                unsigned char* stage) {
    const int lane = threadIdx.x & 31;
    const long long wbase = base + static_cast<long long>(threadIdx.x - lane) * N;
    unsigned char* wstage = stage + (threadIdx.x - lane) * stage_stride<N>();
    A v[N];
    stage_row(wstage, lane, v);
    A pre = r.ex_h ? r.ex_v : carry + r.ex_v;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const A before = pre;
        pre = ((r.f >> k) & 1u) ? v[k] : pre + v[k];
        v[k] = kExclusive ? before : pre;
    }
    warp_store_staged<A, N>(orow + wbase, hi - wbase, wstage, lane, v);
}

// The round's carry out, from its carry in.
template <typename A>
__device__ __forceinline__ A seg_round_carry(const SegRound<A>& r, A carry) {
    return r.tot_h ? r.tot_v : carry + r.tot_v;
}

// Segmented inclusive scan of xr[lo, hi) into orow[lo, hi) under the flags
// fr[lo, hi), round after round in order, seeded with `carry`: the seed
// reaches only the elements before the range's first flag.  stage holds
// seg_stage_bytes(blockDim.x) bytes.
template <typename T, typename A>
__device__ __forceinline__ void seg_scan_range(const T* __restrict__ xr,
                                               const uint8_t* __restrict__ fr,
                                               A* __restrict__ orow, long long lo, long long hi,
                                               A carry, SegScratch<A>& sc,
                                               unsigned char* stage) {
    const long long round = static_cast<long long>(blockDim.x) * kSegItems;
    for (long long base = lo; base < hi; base += round) {
        SegRound<A> r;
        seg_round_scan<T, A>(xr, fr, base, hi, r, sc, stage);
        seg_round_store(orow, base, hi, r, carry, stage);
        carry = seg_round_carry(r, carry);
    }
}

}  // namespace repro

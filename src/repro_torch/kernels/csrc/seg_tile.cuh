// The segmented scan walk shared by B9 (seg_scan.cu), B11 (seg_carry.cu) and
// B12 (seg_block_scan.cu).
//
// A segmented scan is a plain scan under the segmented-pair operator on
// (value, flag) pairs,
//
//     (a ⊕ b) = (b.h ? b.v : a.v + b.v,  a.h | b.h),
//
// where h marks an element, or a run of elements, that holds a segment start.
// The operator is associative, so the usual parallel scan applies: each
// thread scans kSegItems consecutive elements in registers, warp shuffles
// carry (v, h) across the lanes, one warp scans the warp totals, and a
// running carry links the rounds of a CTA's range in order.  The carry of
// earlier rounds reaches only the elements before a round's first flag, which
// is what the Pallas kernels do with their `seen` mask.
//
// Every result is a sum of terms of its own segment only, taken as a tree
// within a round and sequentially across rounds, so fp32 results carry no
// cancellation against earlier segments.  Integer inputs accumulate in int32.
// Flags are bytes; any nonzero byte starts a segment.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kSegMaxThreads = 1024;
constexpr int kSegItems = 8;

// Threads for a CTA whose range holds `elems` elements: enough warps for one
// round, at least one and at most `cap`.
inline int seg_threads(long long elems, int cap) {
    long long t = (elems / kSegItems + 31) / 32 * 32;
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

// Segmented inclusive scan of xr[lo, hi) into orow[lo, hi) under the flags
// fr[lo, hi), seeded with `carry`: the seed reaches only the elements before
// the range's first flag.  Returns the carry out.
template <typename T, typename A>
__device__ __forceinline__ A seg_scan_range(const T* __restrict__ xr,
                                            const uint8_t* __restrict__ fr,
                                            A* __restrict__ orow, long long lo, long long hi,
                                            A carry, SegScratch<A>& sc) {
    const long long round = static_cast<long long>(blockDim.x) * kSegItems;
    for (long long base = lo; base < hi; base += round) {
        const long long i0 = base + static_cast<long long>(threadIdx.x) * kSegItems;
        A v[kSegItems];
        int f[kSegItems];
        A run = A(0);
        int h = 0;
#pragma unroll
        for (int k = 0; k < kSegItems; ++k) {
            const long long i = i0 + k;
            const bool in = i < hi;
            v[k] = in ? to_acc(xr[i], A(0)) : A(0);
            f[k] = in && fr[i] != 0;
            run = f[k] ? v[k] : run + v[k];
            h |= f[k];
        }
        A ex_v, tot_v;
        int ex_h, tot_h;
        block_seg_exclusive_scan(run, h, sc, ex_v, ex_h, tot_v, tot_h);
        A pre = ex_h ? ex_v : carry + ex_v;
#pragma unroll
        for (int k = 0; k < kSegItems; ++k) {
            pre = f[k] ? v[k] : pre + v[k];
            if (i0 + k < hi) orow[i0 + k] = pre;
        }
        carry = tot_h ? tot_v : carry + tot_v;
    }
    return carry;
}

}  // namespace repro

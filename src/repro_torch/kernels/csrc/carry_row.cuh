// The row walk of B3 (carry_scan.cu), shared with the fused block sums of
// block_sums.cu: the exclusive prefix of one row of nb block sums.
//
// Order.  The walk takes the row in chunks of kCarryChunk = 4096 values, as
// kCarryLanes = 1024 virtual threads of kCarryItems = 4 consecutive values:
// each virtual thread sums its 4 in order, a block-wide exclusive scan in
// virtual-thread order places it (a Hillis-Steele scan within each virtual
// warp, then one over the 32 virtual warps' totals), and a running carry
// links the chunks in order.  A CTA of kThreads real threads (a multiple of
// 32 dividing 1024) plays the 1024 virtual ones, each real warp taking the
// virtual warps w, w + kThreads / 32, ...; every add is the one a CTA of 1024
// would do, on the same operands, so B3's own CTA of 1024 and the 256-thread
// CTAs of the fused launch give the same bits.
//
// Loads.  A thread issues all its loads of a chunk before it adds, 16 bytes
// at a time where a row's sums are 16-byte aligned (nb a multiple of 4).  B3
// reads sums written by an earlier launch; the fused launch reads sums other
// CTAs of the same launch wrote, so kCoherent reads them through L2
// (ld.global.cg), never through the non-coherent L1 path.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kCarryLanes = 1024;
constexpr int kCarryWarps = kCarryLanes / 32;
constexpr int kCarryItems = 4;
constexpr int kCarryChunk = kCarryLanes * kCarryItems;
// values of shared memory the walk needs
constexpr int kCarryScratch = 2 * kCarryWarps + 1;

template <typename A> struct CarryVec;
template <> struct CarryVec<float> { using type = float4; };
template <> struct CarryVec<int> { using type = int4; };

// v = p[0 .. 4), the elements at or past `avail` as zero; one 16-byte load
// when all four are there and p is 16-byte aligned.
template <bool kCoherent, typename A>
__device__ __forceinline__ void carry_load4(const A* p, long long avail, A (&v)[kCarryItems]) {
    using V = typename CarryVec<A>::type;
    if (avail >= kCarryItems && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        V w;
        if constexpr (kCoherent) {
            w = __ldcg(reinterpret_cast<const V*>(p));
        } else {
            w = *reinterpret_cast<const V*>(p);
        }
        v[0] = w.x;
        v[1] = w.y;
        v[2] = w.z;
        v[3] = w.w;
        return;
    }
#pragma unroll
    for (int k = 0; k < kCarryItems; ++k) {
        if constexpr (kCoherent) {
            v[k] = k < avail ? __ldcg(p + k) : A(0);
        } else {
            v[k] = k < avail ? p[k] : A(0);
        }
    }
}

// Writes out[i] = sums[0] + ... + sums[i-1] (out[0] = 0) for i < nb.  Every
// thread of the CTA calls it; scratch holds kCarryScratch values.
template <typename A, int kThreads, bool kCoherent>
__device__ void carry_row(const A* in, A* out, long long nb, A* scratch) {
    static_assert(kThreads % 32 == 0 && kCarryLanes % kThreads == 0, "whole warps");
    constexpr int kReal = kThreads / 32;           // real warps
    constexpr int kPlay = kCarryWarps / kReal;     // virtual warps a real warp plays
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    A carry = A(0);
    for (long long base = 0; base < nb; base += kCarryChunk) {
        A v[kPlay][kCarryItems];
        A incl[kPlay];
#pragma unroll
        for (int j = 0; j < kPlay; ++j) {     // every load first, so all are in flight
            const long long i0 =
                base + static_cast<long long>((warp + j * kReal) * 32 + lane) * kCarryItems;
            carry_load4<kCoherent>(in + i0, nb - i0, v[j]);
        }
#pragma unroll
        for (int j = 0; j < kPlay; ++j) {
            A run = A(0);
#pragma unroll
            for (int k = 0; k < kCarryItems; ++k) run = run + v[j][k];
            incl[j] = run;
        }
        // warp_inclusive_scan of each virtual warp, the kPlay scans interleaved
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            A o[kPlay];
#pragma unroll
            for (int j = 0; j < kPlay; ++j) o[j] = __shfl_up_sync(kFullMask, incl[j], d);
#pragma unroll
            for (int j = 0; j < kPlay; ++j) {
                if (lane >= d) incl[j] = incl[j] + o[j];
            }
        }
#pragma unroll
        for (int j = 0; j < kPlay; ++j) {
            if (lane == 31) scratch[warp + j * kReal] = incl[j];
        }
        __syncthreads();
        if (warp == 0) {
            const A w = scratch[lane];
            const A wi = warp_inclusive_scan(w, lane);
            A we = __shfl_up_sync(kFullMask, wi, 1);
            if (lane == 0) we = A(0);
            scratch[kCarryWarps + lane] = we;
            if (lane == kCarryWarps - 1) scratch[2 * kCarryWarps] = wi;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kPlay; ++j) {
            const int vw = warp + j * kReal;
            const long long i0 = base + static_cast<long long>(vw * 32 + lane) * kCarryItems;
            A lane_ex = __shfl_up_sync(kFullMask, incl[j], 1);
            if (lane == 0) lane_ex = A(0);
            A ex = carry + (scratch[kCarryWarps + vw] + lane_ex);
#pragma unroll
            for (int k = 0; k < kCarryItems; ++k) {
                if (i0 + k < nb) out[i0 + k] = ex;
                ex = ex + v[j][k];
            }
        }
        carry = carry + scratch[2 * kCarryWarps];
        __syncthreads();
    }
}

}  // namespace repro

// The carry walk of B15 (linrec_carry.cu), shared with the fused summaries of
// linrec_summaries.cu: the exclusive affine scan of one row of nb block
// summaries (prods, lasts), the state entering each block.
//
// Order.  B15 runs V = lin_threads(nb) threads on a row, in rounds of
// V·kLinItems pairs: each thread folds its kLinItems consecutive pairs in
// order (none at or past nb), a Hillis-Steele scan composes the folds within
// each warp, one warp scans the V/32 warp aggregates (the identity past them),
// a thread's entering composite is (earlier warps) o (earlier lanes), and the
// thread walks its pairs from the state that composite gives; a running state
// links the rounds in order.  A CTA of T real threads plays the V virtual
// ones: real warp w takes virtual warps w, w + T/32, ...  Where it takes one
// it holds that warp's pairs between the two halves of the round; where it
// takes more it folds and scans each twice (once for the warp aggregates,
// once to walk), holding nothing; where it takes none (T > V) it waits at the
// barriers.  Every product and fmaf is the one B15's own CTA takes, on the
// same operands, so the carries have B15's bits whatever T: NaN and ±inf land
// where B15 puts them (no identity pair is composed that B15 does not
// compose: at A = ±inf, (1, 0) o (A, B) is not exact).
//
// Loads and stores.  Straight from global memory, a warp's 256 values as two
// contiguous 512-byte spans where they are whole and aligned, put in place by
// one exchange of words between lanes; no staging, so the fused launch needs
// no dynamic shared memory.  B15 reads summaries an earlier launch wrote; the
// fused launch reads summaries other CTAs of the same launch wrote, so
// kCoherent reads them through L2 (ld.global.cg), never through the
// non-coherent path.
#pragma once

#include "affine_tile.cuh"

namespace repro {

template <bool kCoherent>
__device__ __forceinline__ float4 carry_ld4(const float4* p) {
    if constexpr (kCoherent) {
        return __ldcg(p);
    } else {
        return __ldg(p);
    }
}

template <bool kCoherent>
__device__ __forceinline__ float carry_ld(const float* p) {
    if constexpr (kCoherent) {
        return __ldcg(p);
    } else {
        return __ldg(p);
    }
}

// A warp's 32·kLinItems consecutive values at p into v (lane l's are
// p[8l .. 8l + 8)), those at or past `avail` as zero.  Where all are there and
// p is 16-byte aligned: two 16-byte loads a lane, each warp-wide load one
// contiguous 512-byte span, and one exchange of a word between lanes l and
// l ^ 16 puts every lane's values in place.  Else each lane loads its own.
template <bool kCoherent>
__device__ __forceinline__ void warp_load8(const float* p, long long avail, int lane,
                                           float (&v)[kLinItems]) {
    static_assert(kLinItems == 8, "two 16-byte words a lane");
    if (avail >= 32 * kLinItems && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        const float4* q = reinterpret_cast<const float4*>(p);
        const bool lo = lane < 16;
        const int h = lane & 15;
        // lane h < 16 reads its first word (2h) and lane h + 16's second (33 + 2h);
        // lane h + 16 reads lane h's second (2h + 1) and its own first (32 + 2h)
        const float4 x = carry_ld4<kCoherent>(q + (lo ? 2 * h : 2 * h + 1));
        const float4 y = carry_ld4<kCoherent>(q + (lo ? 33 + 2 * h : 32 + 2 * h));
        const float4 mine = lo ? x : y;
        const float4 give = lo ? y : x;
        v[0] = mine.x; v[1] = mine.y; v[2] = mine.z; v[3] = mine.w;
        v[4] = __shfl_xor_sync(kFullMask, give.x, 16);
        v[5] = __shfl_xor_sync(kFullMask, give.y, 16);
        v[6] = __shfl_xor_sync(kFullMask, give.z, 16);
        v[7] = __shfl_xor_sync(kFullMask, give.w, 16);
        return;
    }
    const long long i0 = static_cast<long long>(lane) * kLinItems;
#pragma unroll
    for (int k = 0; k < kLinItems; ++k) {
        v[k] = i0 + k < avail ? carry_ld<kCoherent>(p + i0 + k) : 0.f;
    }
}

// The converse: lane l's v to p[8l .. 8l + 8), none at or past `avail`.
__device__ __forceinline__ void warp_store8(float* p, long long avail, int lane,
                                            const float (&v)[kLinItems]) {
    if (avail >= 32 * kLinItems && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        float4* q = reinterpret_cast<float4*>(p);
        const bool lo = lane < 16;
        const int h = lane & 15;
        const float4 first = make_float4(v[0], v[1], v[2], v[3]);
        const float4 got = make_float4(__shfl_xor_sync(kFullMask, v[4], 16),
                                       __shfl_xor_sync(kFullMask, v[5], 16),
                                       __shfl_xor_sync(kFullMask, v[6], 16),
                                       __shfl_xor_sync(kFullMask, v[7], 16));
        // words 0..31, then 32..63: each lane's first, and its partner's second
        q[lo ? 2 * h : 2 * h + 1] = lo ? first : got;
        q[lo ? 33 + 2 * h : 32 + 2 * h] = lo ? got : first;
        return;
    }
    const long long i0 = static_cast<long long>(lane) * kLinItems;
#pragma unroll
    for (int k = 0; k < kLinItems; ++k) {
        if (i0 + k < avail) p[i0 + k] = v[k];
    }
}

// A virtual warp's pairs from wbase, a lane's from i0 = wbase + 8·lane (those
// below nb folded in order), then the inclusive scan across the virtual warp:
// (iA, iB) composes lanes 0..lane.
template <bool kCoherent>
__device__ __forceinline__ void carry_fold_scan(const float* prods, const float* lasts,
                                                long long wbase, long long nb,
                                                float (&av)[kLinItems], float (&bv)[kLinItems],
                                                float& iA, float& iB, int lane) {
    warp_load8<kCoherent>(prods + wbase, nb - wbase, lane, av);
    warp_load8<kCoherent>(lasts + wbase, nb - wbase, lane, bv);
    const long long i0 = wbase + static_cast<long long>(lane) * kLinItems;
    iA = 1.f;
    iB = 0.f;
#pragma unroll
    for (int k = 0; k < kLinItems; ++k) {
        if (i0 + k < nb) {
            iB = fmaf(av[k], iB, bv[k]);
            iA = iA * av[k];
        }
    }
    warp_affine_inclusive_scan(iA, iB, lane);
}

// Writes carries[c], the state entering block c, for c < nb, as a CTA of
// `vthreads` (B15's lin_threads(nb)) would.  Every thread of the CTA calls it;
// blockDim.x and vthreads are whole warps.  Ends with a barrier.
template <bool kCoherent>
__device__ void linrec_carry_row(const float* prods, const float* lasts, float* carries,
                                 long long nb, int vthreads, AffineScratch& sc) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int real = blockDim.x >> 5;
    const int vwarps = vthreads >> 5;
    const int play = warp < vwarps ? (vwarps - warp + real - 1) / real : 0;
    const long long round = static_cast<long long>(vthreads) * kLinItems;
    float y = 0.f;
    for (long long base = 0; base < nb; base += round) {
        float av[kLinItems], bv[kLinItems], iA = 1.f, iB = 0.f;
        for (int j = 0; j < play; ++j) {
            const int vw = warp + j * real;
            const long long wbase = base + static_cast<long long>(vw) * 32 * kLinItems;
            carry_fold_scan<kCoherent>(prods, lasts, wbase, nb, av, bv, iA, iB, lane);
            if (lane == 31) {
                sc.a[vw] = iA;
                sc.b[vw] = iB;
            }
        }
        __syncthreads();
        if (warp == 0) {                      // block_affine_exclusive_scan's warp 0, V/32 warps
            float wA = lane < vwarps ? sc.a[lane] : 1.f;
            float wB = lane < vwarps ? sc.b[lane] : 0.f;
            warp_affine_inclusive_scan(wA, wB, lane);
            float eA = __shfl_up_sync(kFullMask, wA, 1);
            float eB = __shfl_up_sync(kFullMask, wB, 1);
            if (lane == 0) {
                eA = 1.f;
                eB = 0.f;
            }
            if (lane < vwarps) {
                sc.a[32 + lane] = eA;
                sc.b[32 + lane] = eB;
            }
            if (lane == vwarps - 1) {
                sc.a[64] = wA;
                sc.b[64] = wB;
            }
        }
        __syncthreads();
        for (int j = 0; j < play; ++j) {
            const int vw = warp + j * real;
            const long long wbase = base + static_cast<long long>(vw) * 32 * kLinItems;
            if (play > 1) {
                carry_fold_scan<kCoherent>(prods, lasts, wbase, nb, av, bv, iA, iB, lane);
            }
            float lA = __shfl_up_sync(kFullMask, iA, 1);
            float lB = __shfl_up_sync(kFullMask, iB, 1);
            if (lane == 0) {
                lA = 1.f;
                lB = 0.f;
            }
            const float exA = sc.a[32 + vw] * lA;     // (earlier warps) o (earlier lanes)
            const float exB = fmaf(lA, sc.b[32 + vw], lB);
            float st = fmaf(exA, y, exB), v[kLinItems];
#pragma unroll
            for (int k = 0; k < kLinItems; ++k) {     // the state entering each pair
                v[k] = st;
                st = fmaf(av[k], st, bv[k]);
            }
            warp_store8(carries + wbase, nb - wbase, lane, v);
        }
        y = fmaf(sc.a[64], y, sc.b[64]);
        __syncthreads();
    }
}

}  // namespace repro

// The affine-pair walk shared by B13 (linrec_scan.cu), B14 (linrec_summaries.cu),
// B15 (linrec_carry.cu) and B16 (linrec_block_scan.cu).
//
// The linear recurrence y_t = a_t * y_{t-1} + b_t is a scan under the
// affine-pair operator on the maps y -> A*y + B,
//
//     (A_l, B_l) o (A_r, B_r) = (A_l * A_r,  A_r * B_l + B_r),
//
// "left, then right".  It is associative and does not commute, so every
// composition below keeps the order of the elements.  As in the segmented
// walk of seg_tile.cuh, each thread folds kLinItems consecutive pairs in
// registers, warp shuffles compose (A, B) across lanes, one warp composes the
// warp aggregates, and a running state y links the rounds of a range in order.
// The state entering a thread's first element is A_ex * y_in + B_ex, where
// (A_ex, B_ex) composes every earlier element of the round; from there the
// thread walks its own elements with y = fma(a, y, b).  A CTA-wide round
// (affine_round_scan / affine_round_store: B13's tiles, and B15's and B16's
// ranges through block_linrec_range) moves its pairs and its results through
// shared memory, each warp's in address order (16-byte cp.async copies in,
// warp_store_staged out), so its global accesses are whole 16-byte words side
// by side; the warp walk (rows of at most kLinWarpMax) and B14 load straight
// from global memory.
//
// What this does about the Pallas design.  The TPU kernels build a weighted
// triangle W[i, j] = p_i / p_j from exponent-normalized cumulative products
// and mask every window that straddles a zero of a (a cummax of the last
// zero).  Here no cumulative product is divided: a composite that spans a
// zero has A = 0 exactly, so 0 * y_in resets the state exactly with no mask.
// Products of |a| > 1 can overflow to inf, and inf * 0 = NaN then, as the
// Pallas kernels' plain cumulative products do at tile scale (ROADMAP Queue C
// records where the two put NaN and inf differently).
//
// fp32 only: the Python wrappers cast, as linear_scan does.  Subnormals are
// kept (no -ftz), so deep decays flush to zero gradually, never to NaN.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace repro {

constexpr int kLinMaxThreads = 1024;
constexpr int kLinItems = 8;
// rows (or blocks) of at most this many elements are walked by one warp each,
// kLinRowsPerCta of them to a CTA: the SSD's 16-long rows would leave a
// CTA-wide walk with one busy warp in 32
constexpr long long kLinWarpMax = 2048;
constexpr int kLinRowsPerCta = 8;

// Threads for a CTA whose range holds `elems` elements, `items` a thread:
// enough warps for one round, at least one and at most `cap`.
inline int lin_threads(long long elems, int cap, int items = kLinItems) {
    long long t = (elems / items + 31) / 32 * 32;
    if (t < 32) t = 32;
    if (t > cap) t = cap;
    return static_cast<int>(t);
}

struct AffineScratch {
    float a[2 * 32 + 1];
    float b[2 * 32 + 1];
};

// Inclusive scan of one pair per lane across a full warp: lane i ends with the
// composite of lanes 0..i.
__device__ __forceinline__ void warp_affine_inclusive_scan(float& A, float& B, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const float oa = __shfl_up_sync(kFullMask, A, d);
        const float ob = __shfl_up_sync(kFullMask, B, d);
        if (lane >= d) {                  // (oa, ob) o (A, B)
            B = fmaf(A, ob, B);
            A = oa * A;
        }
    }
}

// Block-wide exclusive scan of one pair per thread, in thread order, for a
// block of full warps (at most 32).  (exA, exB) composes the threads before
// this one, (totA, totB) the whole block.  Ends with a barrier, so the
// scratch may be reused at once.
__device__ __forceinline__ void block_affine_exclusive_scan(float A, float B, AffineScratch& sc,
                                                            float& exA, float& exB,
                                                            float& totA, float& totB) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    float iA = A, iB = B;
    warp_affine_inclusive_scan(iA, iB, lane);
    if (lane == 31) {
        sc.a[warp] = iA;
        sc.b[warp] = iB;
    }
    __syncthreads();
    if (warp == 0) {
        float wA = lane < nwarps ? sc.a[lane] : 1.f;
        float wB = lane < nwarps ? sc.b[lane] : 0.f;
        warp_affine_inclusive_scan(wA, wB, lane);
        float eA = __shfl_up_sync(kFullMask, wA, 1);
        float eB = __shfl_up_sync(kFullMask, wB, 1);
        if (lane == 0) {
            eA = 1.f;
            eB = 0.f;
        }
        if (lane < nwarps) {
            sc.a[32 + lane] = eA;
            sc.b[32 + lane] = eB;
        }
        if (lane == nwarps - 1) {
            sc.a[64] = wA;
            sc.b[64] = wB;
        }
    }
    __syncthreads();
    float lA = __shfl_up_sync(kFullMask, iA, 1);
    float lB = __shfl_up_sync(kFullMask, iB, 1);
    if (lane == 0) {
        lA = 1.f;
        lB = 0.f;
    }
    const float wA = sc.a[32 + warp];     // (earlier warps) o (earlier lanes)
    const float wB = sc.b[32 + warp];
    exA = wA * lA;
    exB = fmaf(lA, wB, lB);
    totA = sc.a[64];
    totB = sc.b[64];
    __syncthreads();
}

// Load kLinItems pairs from i0 (the identity (1, 0) at or past hi) and fold
// them in order into (A, B).
__device__ __forceinline__ void load_fold(const float* __restrict__ a,
                                          const float* __restrict__ b, long long i0,
                                          long long hi, float (&av)[kLinItems],
                                          float (&bv)[kLinItems], float& A, float& B) {
    A = 1.f;
    B = 0.f;
#pragma unroll
    for (int k = 0; k < kLinItems; ++k) {
        const long long i = i0 + k;
        const bool in = i < hi;
        av[k] = in ? a[i] : 1.f;
        bv[k] = in ? b[i] : 0.f;
        B = fmaf(av[k], B, bv[k]);
        A = A * av[k];
    }
}

// Walk a thread's kLinItems elements from the state s entering the first one,
// storing the inclusive (or, kExclusive, the entering) state of each.
template <bool kExclusive>
__device__ __forceinline__ void walk_store(const float (&av)[kLinItems],
                                           const float (&bv)[kLinItems], float s,
                                           float* __restrict__ out, long long i0,
                                           long long hi) {
#pragma unroll
    for (int k = 0; k < kLinItems; ++k) {
        const bool in = i0 + k < hi;
        if (kExclusive && in) out[i0 + k] = s;
        s = fmaf(av[k], s, bv[k]);
        if (!kExclusive && in) out[i0 + k] = s;
    }
}

// Shared memory a CTA of `threads` stages its rounds in, N pairs a thread:
// a's lane rows, then b's.
template <int N = kLinItems>
inline size_t affine_stage_bytes(int threads) {
    return 2 * static_cast<size_t>(threads) * stage_stride<N>();
}

// Starts copying a warp's 32·N consecutive fp32 elements at p into its lane
// rows in `stage` (lane l's row holds p[l·N .. l·N + N)): 16-byte cp.async
// copies in address order when the range is whole and aligned, else element
// by element, zero at or past `avail`.  The caller commits, waits and syncs,
// so a's and b's copies are all in flight at once (common.cuh's warp_stage_in
// waits for each load before its store to shared memory).
template <int N>
__device__ __forceinline__ void warp_stage_async(const float* __restrict__ p, long long avail,
                                                 unsigned char* stage, int lane) {
    static_assert(N % 4 == 0, "16-byte lane rows");
    constexpr int kStride = stage_stride<N>();
    if (avail >= 32 * N && (reinterpret_cast<uintptr_t>(p) % 16) == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
            const int first = 4 * (lane + 32 * i);
            __pipeline_memcpy_async(stage + (first / N) * kStride + (first % N) * 4, p + first,
                                    16);
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const int e = lane + 32 * i;
            reinterpret_cast<float*>(stage + (e / N) * kStride)[e % N] = e < avail ? p[e] : 0.f;
        }
    }
}

// A CTA-wide round as a thread holds it: the composite of the round's earlier
// elements and of the whole round.  Its pairs stay in the staging area.
struct AffineRound {
    float exA, exB, totA, totB;
};

// Load and scan the round of blockDim.x·N pairs that starts at base: this
// thread's are [i0, i0 + N), i0 = base + threadIdx.x·N, and it folds those
// below hi in order (the rest are the identity).  The pairs come in through
// `stage` (affine_stage_bytes<N>(blockDim.x) bytes) and stay there for
// affine_round_store.  Ends with a barrier.
template <int N>
__device__ __forceinline__ void affine_round_scan(const float* __restrict__ a,
                                                  const float* __restrict__ b, long long base,
                                                  long long hi, AffineRound& r,
                                                  AffineScratch& sc, unsigned char* stage) {
    const int lane = threadIdx.x & 31;
    const long long wbase = base + static_cast<long long>(threadIdx.x - lane) * N;
    unsigned char* sa = stage + (threadIdx.x - lane) * stage_stride<N>();
    unsigned char* sb = sa + blockDim.x * stage_stride<N>();
    warp_stage_async<N>(a + wbase, hi - wbase, sa, lane);
    warp_stage_async<N>(b + wbase, hi - wbase, sb, lane);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    float av[N], bv[N];
    stage_row(sa, lane, av);
    stage_row(sb, lane, bv);
    const long long i0 = wbase + lane * N;
    float A = 1.f, B = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        if (i0 + k < hi) {
            B = fmaf(av[k], B, bv[k]);
            A = A * av[k];
        }
    }
    block_affine_exclusive_scan(A, B, sc, r.exA, r.exB, r.totA, r.totB);
}

// Write the round that starts at base below hi, from the state y entering it:
// each element's inclusive (or, kExclusive, entering) state.
template <bool kExclusive, int N>
__device__ __forceinline__ void affine_round_store(float* __restrict__ out, long long base,
                                                   long long hi, const AffineRound& r, float y,
                                                   unsigned char* stage) {
    const int lane = threadIdx.x & 31;
    const long long wbase = base + static_cast<long long>(threadIdx.x - lane) * N;
    unsigned char* sa = stage + (threadIdx.x - lane) * stage_stride<N>();
    float av[N], bv[N], v[N];
    stage_row(sa, lane, av);
    stage_row(sa + blockDim.x * stage_stride<N>(), lane, bv);
    float s = fmaf(r.exA, y, r.exB);
#pragma unroll
    for (int k = 0; k < N; ++k) {
        if (kExclusive) v[k] = s;
        s = fmaf(av[k], s, bv[k]);
        if (!kExclusive) v[k] = s;
    }
    warp_store_staged<float, N>(out + wbase, hi - wbase, sa, lane, v);
}

// The recurrence over [lo, hi) of one row, walked by the whole CTA round after
// round and seeded with the state y; returns the state leaving hi.  `stage`
// holds affine_stage_bytes(blockDim.x) bytes.
template <bool kExclusive>
__device__ __forceinline__ float block_linrec_range(const float* __restrict__ a,
                                                    const float* __restrict__ b,
                                                    float* __restrict__ out, long long lo,
                                                    long long hi, float y, AffineScratch& sc,
                                                    unsigned char* stage) {
    const long long round = static_cast<long long>(blockDim.x) * kLinItems;
    for (long long base = lo; base < hi; base += round) {
        AffineRound r;
        affine_round_scan<kLinItems>(a, b, base, hi, r, sc, stage);
        affine_round_store<kExclusive, kLinItems>(out, base, hi, r, y, stage);
        y = fmaf(r.totA, y, r.totB);
    }
    return y;
}

// The same walk by one warp (every lane of it must call this).
__device__ __forceinline__ float warp_linrec_range(const float* __restrict__ a,
                                                   const float* __restrict__ b,
                                                   float* __restrict__ out, long long lo,
                                                   long long hi, float y, int lane) {
    const long long round = 32LL * kLinItems;
    for (long long base = lo; base < hi; base += round) {
        const long long i0 = base + static_cast<long long>(lane) * kLinItems;
        float av[kLinItems], bv[kLinItems], A, B;
        load_fold(a, b, i0, hi, av, bv, A, B);
        float iA = A, iB = B;
        warp_affine_inclusive_scan(iA, iB, lane);
        float exA = __shfl_up_sync(kFullMask, iA, 1);
        float exB = __shfl_up_sync(kFullMask, iB, 1);
        if (lane == 0) {
            exA = 1.f;
            exB = 0.f;
        }
        const float totA = __shfl_sync(kFullMask, iA, 31);
        const float totB = __shfl_sync(kFullMask, iB, 31);
        walk_store<false>(av, bv, fmaf(exA, y, exB), out, i0, hi);
        y = fmaf(totA, y, totB);
    }
    return y;
}

}  // namespace repro

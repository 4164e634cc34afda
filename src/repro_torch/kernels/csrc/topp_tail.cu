// B8 — the fused top-p (nucleus) sampling tail.
//
// Replaces the Pallas TPU kernel src/repro/kernels/split_mm.py::_topp_kernel
// (launched by topp_mask_sample_tiles).  Per row of probabilities sorted in
// descending order, with one uniform u per row:
//
//     cum  = cumsum(sp);  cut = (cum - sp) > p;  masked = cut ? 0 : sp
//     cdf  = cumsum(masked);  theta = u * cdf[n-1]
//     j    = min(#(cdf < theta), n-1)
//
// and only the int32 j leaves the kernel.
//
// Design.  One CTA per row.  The row is walked in chunks of 4096 (1024
// threads x 4 consecutive elements): each thread sums its 4 in order, a
// warp-shuffle scan and a scan over the 32 warp totals give the block prefix,
// and a running carry links the chunks in order.  Both prefix sums are taken
// this way.  theta needs cdf[n-1], the end of the second prefix, so the row is
// walked twice: the first sweep finds cdf[n-1] (as the element's own value,
// not a separately summed total), the second recomputes the identical sums and
// counts cdf < theta.  Nothing but the count is written.
//
// Rounding band.  The sums are fp32 and taken in another order than
// torch.cumsum's (or jnp.cumsum's).  A prefix here passes through at most
// 3 + 5 + 5 + 2 + ceil(n / 4096) roundings, each off by at most u = 2^-24 of
// the row's mass S, i.e. 47 u S at n = 128256; a blocked CUDA scan of the same
// length (torch.cumsum on the card) has the same shape of bound.  So the
// kernel and its plain version pick the same j whenever theta lies farther
// than BAND = 2^-16 S from every cdf value and every (cum - sp) lies farther
// than BAND from p; within that band the cut or the sample may move, but only
// across the tokens whose fp64 cut or CDF value lies inside the band.  The
// checks hold the kernel's index on every row to that window of tokens, and
// to the one right index where the window holds one.
//
// Bound.  Each probability is read once (twice in fact; the second sweep hits
// L2), 4 B per element, so the kernel is bound by bytes.  At the sampler's
// batch of 4 only 4 SMs work; splitting a row over CTAs is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;

__global__ void __launch_bounds__(kThreads)
topp_tail_kernel(const float* __restrict__ sp, const float* __restrict__ u,
                 int* __restrict__ out, long long n, float p) {
    __shared__ float scratch[2 * kWarps + 1];
    __shared__ float last_cdf;
    __shared__ int warp_count[kWarps];
    const long long row = blockIdx.x;
    const float* s = sp + row * n;
    float theta = 0.0f;
    int count = 0;

    for (int sweep = 0; sweep < 2; ++sweep) {
        float carry_cum = 0.0f;
        float carry_cdf = 0.0f;
        for (long long base = 0; base < n; base += kChunk) {
            const long long i0 = base + static_cast<long long>(threadIdx.x) * kItems;
            float v[kItems];
            float l[kItems];
#pragma unroll
            for (int k = 0; k < kItems; ++k) v[k] = i0 + k < n ? s[i0 + k] : 0.0f;

            // cum = cumsum(sp); the llama3 cut (cum - sp) > p
            float run = 0.0f;
#pragma unroll
            for (int k = 0; k < kItems; ++k) {
                run = run + v[k];
                l[k] = run;
            }
            float tot_cum;
            const float ex_cum =
                repro::block_exclusive_scan<float, kWarps>(run, scratch, tot_cum);
            float m[kItems];
#pragma unroll
            for (int k = 0; k < kItems; ++k) {
                const float cum = (ex_cum + l[k]) + carry_cum;
                m[k] = (cum - v[k]) > p ? 0.0f : v[k];
            }

            // cdf = cumsum(masked)
            run = 0.0f;
#pragma unroll
            for (int k = 0; k < kItems; ++k) {
                run = run + m[k];
                l[k] = run;
            }
            float tot_cdf;
            const float ex_cdf =
                repro::block_exclusive_scan<float, kWarps>(run, scratch, tot_cdf);
#pragma unroll
            for (int k = 0; k < kItems; ++k) {
                const float cdf = (ex_cdf + l[k]) + carry_cdf;
                if (sweep == 0) {
                    if (i0 + k == n - 1) last_cdf = cdf;
                } else if (i0 + k < n && cdf < theta) {
                    ++count;
                }
            }
            carry_cum = carry_cum + tot_cum;
            carry_cdf = carry_cdf + tot_cdf;
        }
        if (sweep == 0) {
            __syncthreads();
            theta = u[row] * last_cdf;
        }
    }

    // j = #(cdf < theta), clipped to [0, n - 1]
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wc = __reduce_add_sync(repro::kFullMask, count);
    if (lane == 0) warp_count[warp] = wc;
    __syncthreads();
    if (warp == 0) {
        const int tot = __reduce_add_sync(repro::kFullMask, warp_count[lane]);
        if (lane == 0) {
            const long long j = tot < n - 1 ? tot : n - 1;
            out[row] = static_cast<int>(j < 0 ? 0 : j);
        }
    }
}

}  // namespace

// sorted_p: (b, n) fp32, descending; u: (b,) fp32; out: (b,) int32.
extern "C" int repro_topp_tail(const void* sorted_p, const void* u, void* out, int b,
                               long long n, float p, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    topp_tail_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sorted_p), static_cast<const float*>(u),
        static_cast<int*>(out), n, p);
    return static_cast<int>(cudaGetLastError());
}

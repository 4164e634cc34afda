// B14 — the block summaries of the linear-recurrence §4 pipeline (phase 1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/linrec_mm.py::_summary_kernel
// (launched by linrec_block_summaries): for each block of block_len
// consecutive pairs of a row, the affine map it applies to an incoming
// state, y_out = prods * y_in + lasts, with prods = Π a over the block and
// lasts the block's recurrence from a zero state, (rows, n) -> two (rows, nb).
// The Pallas kernel forms both from suffix products (Π a after each element)
// and dot products.
//
// Design.  One CTA per (row, block) on a flat grid.x of rows * nb CTAs (nb can
// pass grid.y's 65535).  An ordered reduction of the block's pairs under the
// affine-pair operator of affine_tile.cuh: each thread folds 8 consecutive
// pairs, the block composes the thread aggregates in thread order, and the
// rounds are composed in order.  The operator does not commute, so no
// atomics.  The ragged end of a row is the identity (1, 0).
//
// Bound.  It reads a and b once and writes 8 B per block: 8 B per element,
// bound by bytes (0.160 ms at (4, 2^24) at 3.35 TB/s).
#include "affine_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::kLinMaxThreads)
linrec_summaries_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ prods, float* __restrict__ lasts, long long n,
                        int nb, long long block_len) {
    __shared__ repro::AffineScratch sc;
    const long long cta = blockIdx.x;
    const long long row = cta / nb;
    const long long lo = (cta - row * nb) * block_len;
    const long long hi = min(n, lo + block_len);
    const float* ar = a + row * n;
    const float* br = b + row * n;
    float P = 1.f, L = 0.f;
    const long long round = static_cast<long long>(blockDim.x) * repro::kLinItems;
    for (long long base = lo; base < hi; base += round) {
        float av[repro::kLinItems], bv[repro::kLinItems], A, B;
        repro::load_fold(ar, br, base + static_cast<long long>(threadIdx.x) * repro::kLinItems,
                         hi, av, bv, A, B);
        float exA, exB, totA, totB;
        repro::block_affine_exclusive_scan(A, B, sc, exA, exB, totA, totB);
        L = fmaf(totA, L, totB);              // (P, L) o (totA, totB)
        P = P * totA;
    }
    if (threadIdx.x == 0) {
        prods[cta] = P;
        lasts[cta] = L;
    }
}

}  // namespace

// a, b: (rows, n) contiguous fp32; prods, lasts: (rows, nb) fp32,
// nb = ceil(n / block_len).
extern "C" int repro_linrec_summaries(const void* a, const void* b, void* prods, void* lasts,
                                      int rows, long long n, int nb, long long block_len,
                                      void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (block_len < 1 || nb != (n + block_len - 1) / block_len ||
        static_cast<long long>(rows) * nb > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    linrec_summaries_kernel<<<static_cast<unsigned>(rows) * nb,
                              repro::lin_threads(block_len, repro::kLinMaxThreads), 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(prods),
        static_cast<float*>(lasts), n, nb, block_len);
    return static_cast<int>(cudaGetLastError());
}

// B16 — the fused block recurrence plus carry of the linear-recurrence §4
// pipeline (phases 1 and 3).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/linrec_mm.py::_block_carry_kernel (launched by
// linrec_block_scan_carry): each block of block_len consecutive pairs of a
// row runs the recurrence from the state carries[row, block] (from B15),
// (rows, n) -> (rows, n).  The Pallas kernel forms the block-local recurrence
// with weighted-triangle contractions and folds the carry in as
// out + mult * carry, mult being the block's cumulative products.
//
// Design.  One CTA per (row, block) on a flat grid.x of rows * nb CTAs (nb can
// pass grid.y's 65535), walking its block in order with the affine-pair walk
// of affine_tile.cuh (block_linrec_range: rounds of 512 threads x 8 pairs, each
// staged through shared memory in address order) seeded with the block's
// carry, so the carry reaches each element through the recurrence itself and
// stops exactly at a zero of a.
// Blocks of at most kLinWarpMax elements are walked by one warp each, eight to
// a CTA.  A short axis that is not the last and is one block (the SSD's
// cross-chunk states) is walked where it lies, one thread a column, with a
// zero carry (linrec_columns.cuh, repro_linrec_block_scan_columns).  The ragged
// end of a row is masked here, so the wrapper pads nothing.
//
// Bound.  Each element is read once (a and b) and written once, plus 4 B of
// carry per block: 12 B per element, bound by bytes (0.240 ms at (4, 2^24) at
// 3.35 TB/s).
#include "affine_tile.cuh"
#include "linrec_columns.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
linrec_block_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         const float* __restrict__ carries, float* __restrict__ out,
                         long long n, int nb, long long block_len) {
    extern __shared__ __align__(16) unsigned char stage[];
    __shared__ repro::AffineScratch sc;
    const long long cta = blockIdx.x;
    const long long row = cta / nb;
    const long long lo = (cta - row * nb) * block_len;
    const long long hi = min(n, lo + block_len);
    repro::block_linrec_range(a + row * n, b + row * n, out + row * n, lo, hi, carries[cta],
                              sc, stage);
}

__global__ void __launch_bounds__(32 * repro::kLinRowsPerCta)
linrec_block_scan_warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              const float* __restrict__ carries, float* __restrict__ out,
                              long long n, int nb, long long block_len, long long blocks) {
    const long long w =
        static_cast<long long>(blockIdx.x) * repro::kLinRowsPerCta + (threadIdx.x >> 5);
    if (w >= blocks) return;                  // whole warps leave together
    const long long row = w / nb;
    const long long lo = (w - row * nb) * block_len;
    const long long hi = min(n, lo + block_len);
    repro::warp_linrec_range(a + row * n, b + row * n, out + row * n, lo, hi, carries[w],
                             threadIdx.x & 31);
}

}  // namespace

// a, b, out: (rows, n) contiguous fp32; carries: (rows, nb) fp32,
// nb = ceil(n / block_len).  rows is a C int (the wrapper refuses more).
extern "C" int repro_linrec_block_scan(const void* a, const void* b, const void* carries,
                                       void* out, int rows, long long n, int nb,
                                       long long block_len, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    const long long blocks = static_cast<long long>(rows) * nb;
    if (block_len < 1 || nb != (n + block_len - 1) / block_len || blocks > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* af = static_cast<const float*>(a);
    const float* bf = static_cast<const float*>(b);
    const float* cf = static_cast<const float*>(carries);
    float* of = static_cast<float*>(out);
    if (block_len <= repro::kLinWarpMax) {
        const unsigned ctas = static_cast<unsigned>(
            (blocks + repro::kLinRowsPerCta - 1) / repro::kLinRowsPerCta);
        linrec_block_scan_warp_kernel<<<ctas, 32 * repro::kLinRowsPerCta, 0, st>>>(
            af, bf, cf, of, n, nb, block_len, blocks);
    } else {
        const int threads = repro::lin_threads(block_len, kThreads);
        const size_t stage = repro::affine_stage_bytes(threads);
        const cudaError_t err = cudaFuncSetAttribute(
            linrec_block_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(stage));
        if (err != cudaSuccess) return static_cast<int>(err);
        linrec_block_scan_kernel<<<static_cast<unsigned>(blocks), threads, stage, st>>>(
            af, bf, cf, of, n, nb, block_len);
    }
    return static_cast<int>(cudaGetLastError());
}

// The column walk of linrec_columns.cuh (launch_columns' geometry): one launch
// of B16 for a short scan axis that is not the last, one block long.
extern "C" int repro_linrec_block_scan_columns(const void* a, const void* b, const void* init,
                                               void* out, const long long* geom,
                                               void* stream) {
    return repro::launch_columns(a, b, init, out, geom, stream);
}

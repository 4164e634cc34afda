// B13 — the linear-recurrence tile scan.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linrec_mm.py::_tile_kernel
// (launched by linrec_scan_tiles): y_t = a_t * y_{t-1} + b_t along each row
// of the (rows, n) fp32 pairs, from a zero state, (rows, n) -> (rows, n).  The
// Pallas kernel pads each row to whole s*s tiles with the identity (a = 1,
// b = 0), walks the tiles in order on the TPU's sequential grid axis, scans
// each one with weighted-triangle contractions W @ b built from
// exponent-normalized cumulative products, and carries the scalar state in
// SMEM.
//
// Design.  A CUDA grid has no ordered axis, so one CTA owns one row and walks
// it in order with the affine-pair walk of affine_tile.cuh: per round, each
// thread folds 8 consecutive pairs, warp shuffles compose (A, B) across
// lanes, and a running state links the rounds.  No triangle, no quotient and
// no zero mask: a zero of a resets the state exactly under composition.
// Rows of at most kLinWarpMax elements (the SSD's cross-chunk rows are 16
// long, a million of them at zamba2's prefill) are walked by one warp each,
// eight rows to a CTA.  The ragged end of a row is masked here, so nothing is
// padded: a 16-long row stays 16 long where the Pallas kernel pads it to 256.
// The tile side s of the Pallas kernel and the plain version is not read.
//
// Bound.  Each row reads a and b once and writes y once: 12 B per element,
// bound by bytes (0.240 ms at (4, 2^24) at 3.35 TB/s).  One CTA per long row
// leaves most SMs idle at small batches, as in B1; the pipeline (B14-B16)
// spreads a row over CTAs.
#include "affine_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::kLinMaxThreads)
linrec_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, long long n) {
    __shared__ repro::AffineScratch sc;
    const long long off = static_cast<long long>(blockIdx.x) * n;
    repro::block_linrec_range<false>(a + off, b + off, out + off, 0, n, 0.f, sc);
}

__global__ void __launch_bounds__(32 * repro::kLinRowsPerCta)
linrec_scan_warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ out, long long rows, long long n) {
    const long long row =
        static_cast<long long>(blockIdx.x) * repro::kLinRowsPerCta + (threadIdx.x >> 5);
    if (row >= rows) return;                  // whole warps leave together
    const long long off = row * n;
    repro::warp_linrec_range(a + off, b + off, out + off, 0, n, 0.f, threadIdx.x & 31);
}

}  // namespace

// a, b, out: (rows, n) contiguous fp32.  rows is a C int: the wrapper refuses
// more than 2^31 - 1 (the SSD's 2^20 rows at zamba2's prefill fit).
extern "C" int repro_linrec_scan(const void* a, const void* b, void* out, int rows, long long n,
                                 void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* af = static_cast<const float*>(a);
    const float* bf = static_cast<const float*>(b);
    float* of = static_cast<float*>(out);
    if (n <= repro::kLinWarpMax) {
        const unsigned ctas = static_cast<unsigned>(
            (static_cast<long long>(rows) + repro::kLinRowsPerCta - 1) / repro::kLinRowsPerCta);
        linrec_scan_warp_kernel<<<ctas, 32 * repro::kLinRowsPerCta, 0, st>>>(af, bf, of, rows,
                                                                            n);
    } else {
        linrec_scan_kernel<<<rows, repro::lin_threads(n, repro::kLinMaxThreads), 0, st>>>(
            af, bf, of, n);
    }
    return static_cast<int>(cudaGetLastError());
}

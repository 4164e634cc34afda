// B15 — the affine carry scan of the linear-recurrence §4 pipeline (phase 2).
//
// Replaces the Pallas TPU kernel src/repro/kernels/linrec_mm.py::_carry_kernel
// (launched by linrec_carry_scan): the exclusive scan of each row of the
// (rows, nb) block summaries (prods, lasts) under affine composition, the
// state entering each block,
//     carry[c] = Σ_{q<c} lasts[q] * Π_{r=q+1..c-1} prods[r],
// (rows, nb) -> (rows, nb).  The Pallas kernel runs the chunked W @ b scan of
// core/linrec.py over the summaries in one grid step per row.
//
// Design.  As B3 (carry_scan.cu) and B11 (seg_carry.cu): one CTA per row walks
// its nb summaries in rounds of 1024 threads x 8 with the affine-pair walk of
// affine_tile.cuh (block_linrec_range, staged through shared memory), storing
// the state before each element (exclusive); a running state links the rounds
// in order.
//
// Bound.  It moves 12 B per block (a few KB at the pipeline's usual nb), so
// it is bound by its launch and its one CTA per row, not by bytes.
#include "affine_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::kLinMaxThreads)
linrec_carry_kernel(const float* __restrict__ prods, const float* __restrict__ lasts,
                    float* __restrict__ carries, long long nb) {
    extern __shared__ __align__(16) unsigned char stage[];
    __shared__ repro::AffineScratch sc;
    const long long off = static_cast<long long>(blockIdx.x) * nb;
    repro::block_linrec_range<true>(prods + off, lasts + off, carries + off, 0, nb, 0.f, sc,
                                    stage);
}

}  // namespace

// prods, lasts, carries: (rows, nb) contiguous fp32.
extern "C" int repro_linrec_carry(const void* prods, const void* lasts, void* carries, int rows,
                                  long long nb, void* stream) {
    if (rows <= 0 || nb <= 0) return 0;
    const int threads = repro::lin_threads(nb, repro::kLinMaxThreads);
    const size_t stage = repro::affine_stage_bytes(threads);
    const cudaError_t err = cudaFuncSetAttribute(
        linrec_carry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(stage));
    if (err != cudaSuccess) return static_cast<int>(err);
    linrec_carry_kernel<<<rows, threads, stage, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(prods), static_cast<const float*>(lasts),
        static_cast<float*>(carries), nb);
    return static_cast<int>(cudaGetLastError());
}

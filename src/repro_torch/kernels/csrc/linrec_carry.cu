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
// its nb summaries in rounds of lin_threads(nb) threads x 8 (up to 1024 x 8)
// with the affine-pair operator, storing the state before each element
// (exclusive); a running state links the rounds in order.  The walk is
// linrec_carry_row.cuh's, which linrec_summaries.cu's fused entry
// (repro_linrec_summaries_carries) also runs, so the pipeline gets these
// carries, bit for bit, without this launch; this entry stays for
// linrec_carry_scan called on its own.
//
// Bound.  It moves 12 B per block (a few KB at the pipeline's usual nb), so
// it is bound by its launch and its one CTA per row, not by bytes.
#include "linrec_carry_row.cuh"

namespace {

__global__ void __launch_bounds__(repro::kLinMaxThreads)
linrec_carry_kernel(const float* __restrict__ prods, const float* __restrict__ lasts,
                    float* __restrict__ carries, long long nb) {
    __shared__ repro::AffineScratch sc;
    const long long off = static_cast<long long>(blockIdx.x) * nb;
    repro::linrec_carry_row<false>(prods + off, lasts + off, carries + off, nb, blockDim.x, sc);
}

}  // namespace

// prods, lasts, carries: (rows, nb) contiguous fp32.
extern "C" int repro_linrec_carry(const void* prods, const void* lasts, void* carries, int rows,
                                  long long nb, void* stream) {
    if (rows <= 0 || nb <= 0) return 0;
    linrec_carry_kernel<<<rows, repro::lin_threads(nb, repro::kLinMaxThreads), 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(prods), static_cast<const float*>(lasts),
        static_cast<float*>(carries), nb);
    return static_cast<int>(cudaGetLastError());
}

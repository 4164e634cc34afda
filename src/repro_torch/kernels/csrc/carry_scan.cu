// B3 — the carry scan of the §4 blocked scan pipeline (phase 2).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/scan_pipeline.py::_carry_scan_kernel (launched by
// carry_scan): the exclusive prefix of each row of the (b, nb) block sums,
// (b, nb) -> (b, nb), in the sums' dtype (int32 or fp32).
//
// Design.  One CTA of 1024 threads per row walks its nb sums in chunks of
// 4096 (1024 threads x 4 consecutive values): each thread sums its 4 in order,
// a block-wide exclusive scan (warp shuffles, then one warp over the warp
// totals) places the thread, and a running carry links the chunks in order,
// since nb can be in the hundreds of thousands.  The walk is carry_row.cuh's,
// which block_sums.cu's fused entry (repro_block_sums_carries) also runs, so
// the blocked pipeline gets these carries, bit for bit, without this launch;
// this entry stays for carry_scan called on its own.  Integer carries are exact
// (int32 adds wrap as the JAX cumsum does); fp32 carries are summed in another
// order than jnp.cumsum's.
//
// Bound.  It moves 8 B per block (a few KB at the pipeline's usual nb), so it
// is bound by its launch and its one CTA per row, not by bytes.
#include "carry_row.cuh"

namespace {

template <typename A>
__global__ void __launch_bounds__(repro::kCarryLanes)
carry_scan_kernel(const A* __restrict__ sums, A* __restrict__ carries, long long nb) {
    __shared__ A scratch[repro::kCarryScratch];
    const long long row = blockIdx.x;
    repro::carry_row<A, repro::kCarryLanes, false>(sums + row * nb, carries + row * nb, nb,
                                                   scratch);
}

template <typename A>
int launch(const void* sums, void* carries, int b, long long nb, cudaStream_t stream) {
    carry_scan_kernel<A><<<b, repro::kCarryLanes, 0, stream>>>(
        static_cast<const A*>(sums), static_cast<A*>(carries), nb);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sums, carries: (b, nb) contiguous.  acc: 0 fp32, 1 int32.
extern "C" int repro_carry_scan(const void* sums, void* carries, int b, long long nb,
                                int acc, void* stream) {
    if (b <= 0 || nb <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (acc) {
        case 0: return launch<float>(sums, carries, b, nb, st);
        case 1: return launch<int>(sums, carries, b, nb, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

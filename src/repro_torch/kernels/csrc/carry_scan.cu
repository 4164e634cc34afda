// B3 — the carry scan of the §4 blocked scan pipeline (phase 2).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/scan_pipeline.py::_carry_scan_kernel (launched by
// carry_scan): the exclusive prefix of each row of the (b, nb) block sums,
// (b, nb) -> (b, nb), in the sums' dtype (int32 or fp32).
//
// Design.  One CTA per row walks its nb sums in chunks of 4096 (1024 threads
// x 4 consecutive values): each thread sums its 4 in order, a block-wide
// exclusive scan (warp shuffles, then one warp over the warp totals) places
// the thread, and a running carry links the chunks in order, since nb can be
// in the hundreds of thousands.  Integer carries are exact (int32 adds wrap as
// the JAX cumsum does); fp32 carries are summed in another order than
// jnp.cumsum's.
//
// Bound.  It moves 8 B per block (a few KB at the pipeline's usual nb), so it
// is bound by its launch and its one CTA per row, not by bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;

template <typename A>
__global__ void __launch_bounds__(kThreads)
carry_scan_kernel(const A* __restrict__ sums, A* __restrict__ carries, long long nb) {
    __shared__ A scratch[2 * kWarps + 1];
    const long long row = blockIdx.x;
    const A* in = sums + row * nb;
    A* out = carries + row * nb;
    A carry = A(0);
    for (long long base = 0; base < nb; base += kChunk) {
        const long long i0 = base + static_cast<long long>(threadIdx.x) * kItems;
        A v[kItems];
        A run = A(0);
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            v[k] = i0 + k < nb ? in[i0 + k] : A(0);
            run = run + v[k];
        }
        A total;
        A ex = repro::block_exclusive_scan<A, kWarps>(run, scratch, total);
        ex = carry + ex;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            if (i0 + k < nb) out[i0 + k] = ex;
            ex = ex + v[k];
        }
        carry = carry + total;
    }
}

template <typename A>
int launch(const void* sums, void* carries, int b, long long nb, cudaStream_t stream) {
    carry_scan_kernel<A><<<b, kThreads, 0, stream>>>(static_cast<const A*>(sums),
                                                     static_cast<A*>(carries), nb);
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

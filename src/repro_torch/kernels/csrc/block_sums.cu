// B2 — the block sums of the §4 blocked scan pipeline (phase 1, "vector
// recompute").
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/scan_pipeline.py::_block_sums_kernel (launched by
// block_partial_sums): the sum of each block of `block_len` consecutive
// elements of a row, in the accumulation dtype, (b, n) -> (b, nb).
//
// Design.  One CTA per (row, block) on a flat grid.x of b * nb CTAs (nb can
// pass grid.y's 65535 limit: s = 8, block_tiles = 1 at n = 2^24 gives
// nb = 262144).  Each thread sums a strided slice of the block, then a warp
// shuffle and one warp over the warp totals reduce the block.  It reads the
// raw input, as the paper's recompute does, and never reads B4's output.  The
// ragged end of a row is masked here: elements at or past n count as zero.
// Integer sums wrap in int32 like the JAX reduction; fp32 sums are taken in
// another order than XLA's.
//
// Bound.  Each input element is read once and one value per block written, so
// it is bound by bytes: 4 B per fp32 element, 1 B per int8 element.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
block_sums_kernel(const T* __restrict__ x, A* __restrict__ sums, long long n, int nb,
                  long long block_len) {
    __shared__ A warp_sum[kThreads / 32];
    const long long cta = blockIdx.x;
    const long long row = cta / nb;
    const long long lo = (cta - row * nb) * block_len;
    const long long hi = min(n, lo + block_len);
    const T* xr = x + row * n;
    A acc = A(0);
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        acc = acc + repro::to_acc(xr[i], A(0));
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc = acc + __shfl_down_sync(repro::kFullMask, acc, d);
    if (lane == 0) warp_sum[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        A v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sum[lane] : A(0);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v = v + __shfl_down_sync(repro::kFullMask, v, d);
        if (lane == 0) sums[cta] = v;
    }
}

template <typename T, typename A>
int launch(const void* x, void* sums, int b, long long n, int nb, long long block_len,
           cudaStream_t stream) {
    // a small block gets fewer threads (each still sums at least 8 elements)
    long long threads = (block_len / 8 + 31) / 32 * 32;
    if (threads < 32) threads = 32;
    if (threads > kThreads) threads = kThreads;
    block_sums_kernel<T, A><<<static_cast<unsigned>(b) * nb, static_cast<int>(threads), 0,
                              stream>>>(static_cast<const T*>(x), static_cast<A*>(sums), n,
                                        nb, block_len);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, n) contiguous input; sums: (b, nb) contiguous, nb = ceil(n / block_len).
// dtype: 0 fp32, 1 bf16, 2 fp16 (fp32 sums); 3 int8, 4 uint8, 5 int16, 6 int32
// (int32 sums).
extern "C" int repro_block_sums(const void* x, void* sums, int b, long long n, int nb,
                                long long block_len, int dtype, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (block_len < 1 || nb != (n + block_len - 1) / block_len ||
        static_cast<long long>(b) * nb > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float, float>(x, sums, b, n, nb, block_len, st);
        case 1: return launch<__nv_bfloat16, float>(x, sums, b, n, nb, block_len, st);
        case 2: return launch<__half, float>(x, sums, b, n, nb, block_len, st);
        case 3: return launch<int8_t, int>(x, sums, b, n, nb, block_len, st);
        case 4: return launch<uint8_t, int>(x, sums, b, n, nb, block_len, st);
        case 5: return launch<int16_t, int>(x, sums, b, n, nb, block_len, st);
        case 6: return launch<int32_t, int>(x, sums, b, n, nb, block_len, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

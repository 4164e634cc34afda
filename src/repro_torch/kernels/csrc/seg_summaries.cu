// B10 — the block summaries of the segmented §4 pipeline (phase 1).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/segscan_mm.py::_seg_summary_kernel (launched by
// seg_block_summaries): for each block of block_len consecutive elements of a
// row, the sum of the elements at or after the block's last flag (the whole
// block if it has none), in the accumulation dtype, and whether the block
// holds a flag, (b, n) -> two (b, nb).  Together they are the block's value
// under the segmented-pair operator that B11 scans.
//
// Design.  One CTA per (row, block) on a flat grid.x of b * nb CTAs (nb can
// pass grid.y's 65535).  Two sweeps of the block: a max-reduction of the
// positions of its flags finds the last one, then a sum-reduction of the
// values from there to the block end (warp shuffles, then one warp over the
// warp totals).  Flags are bytes, nonzero = a segment start; the has-flag
// output is 0 or 1.  The ragged end of a row is masked here.  Integer sums
// are exact in int32; fp32 sums are taken in tree order.
//
// Bound.  It reads every flag byte of the block and the values of the
// trailing segment only, and writes 8 B per block: at most 5 B per fp32
// element, bound by bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
seg_summaries_kernel(const T* __restrict__ x, const uint8_t* __restrict__ f,
                     long long fstride, A* __restrict__ ts, int* __restrict__ hb, long long n,
                     int nb, long long block_len) {
    __shared__ long long last_sh[kThreads / 32];
    __shared__ A sum_sh[kThreads / 32];
    const long long cta = blockIdx.x;
    const long long row = cta / nb;
    const long long lo = (cta - row * nb) * block_len;
    const long long hi = min(n, lo + block_len);
    const T* xr = x + row * n;
    const uint8_t* fr = f + row * fstride;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;

    // 1. the block's last flag (-1 if none)
    long long last = -1;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        if (fr[i]) last = i;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) last = max(last, __shfl_down_sync(repro::kFullMask, last, d));
    if (lane == 0) last_sh[warp] = last;
    __syncthreads();
    long long blk_last = -1;
    for (int w = 0; w < nwarps; ++w) blk_last = max(blk_last, last_sh[w]);

    // 2. the sum from there (or from the block start) to the block end
    A acc = A(0);
    for (long long i = (blk_last >= 0 ? blk_last : lo) + threadIdx.x; i < hi; i += blockDim.x) {
        acc = acc + repro::to_acc(xr[i], A(0));
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc = acc + __shfl_down_sync(repro::kFullMask, acc, d);
    if (lane == 0) sum_sh[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        A v = lane < nwarps ? sum_sh[lane] : A(0);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v = v + __shfl_down_sync(repro::kFullMask, v, d);
        if (lane == 0) {
            ts[cta] = v;
            hb[cta] = blk_last >= 0 ? 1 : 0;
        }
    }
}

template <typename T, typename A>
int launch(const void* x, const void* f, long long fstride, void* ts, void* hb, int b,
           long long n, int nb, long long block_len, cudaStream_t stream) {
    // a small block gets fewer threads (each still reads at least 8 elements)
    long long threads = (block_len / 8 + 31) / 32 * 32;
    if (threads < 32) threads = 32;
    if (threads > kThreads) threads = kThreads;
    seg_summaries_kernel<T, A><<<static_cast<unsigned>(b) * nb, static_cast<int>(threads), 0,
                                 stream>>>(static_cast<const T*>(x),
                                           static_cast<const uint8_t*>(f), fstride,
                                           static_cast<A*>(ts), static_cast<int*>(hb), n, nb,
                                           block_len);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, n) contiguous values; f: flag bytes, row r at f + r * fstride
// (fstride 0 or n); ts: (b, nb) in the accumulation dtype; hb: (b, nb) int32;
// nb = ceil(n / block_len).  dtype: 0 fp32, 1 bf16, 2 fp16 (fp32 sums);
// 3 int8, 4 uint8, 5 int16, 6 int32 (int32 sums).
extern "C" int repro_seg_summaries(const void* x, const void* f, long long fstride, void* ts,
                                   void* hb, int b, long long n, int nb, long long block_len,
                                   int dtype, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if ((fstride != 0 && fstride != n) || block_len < 1 ||
        nb != (n + block_len - 1) / block_len ||
        static_cast<long long>(b) * nb > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float, float>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 1:
            return launch<__nv_bfloat16, float>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 2: return launch<__half, float>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 3: return launch<int8_t, int>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 4: return launch<uint8_t, int>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 5: return launch<int16_t, int>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 6: return launch<int32_t, int>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// B9 — the segmented tile scan.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segscan_mm.py::_seg_kernel
// (launched by seg_scan_tiles): the scan of each row of the (b, n) values
// that restarts at every flagged element, (b, n) -> (b, n) in the
// accumulation dtype.  The Pallas kernel walks a row's s x s tiles in order
// on the TPU's sequential grid axis, scans each tile with the flag-masked
// A @ U_s contraction and segmented row carries, and keeps a scalar carry in
// SMEM that reaches only the elements before the tile's first flag (`seen`).
//
// Design.  A CUDA grid has no ordered axis, so one CTA owns one row and walks
// it in order with the segmented-pair scan of seg_tile.cuh: per round, each
// thread scans 8 consecutive elements, warp shuffles carry (value, flag)
// across lanes, and a running carry links the rounds.  The flag mask of the
// Pallas kernel becomes the flag half of the pair; no triangle is formed.
// Flags are bytes (nonzero = a segment start) with a row stride that is 0
// when one row of flags serves every row (the sampler's one-hot scans).  The
// ragged end of a row is masked here, so the wrapper pads nothing.
//
// Bound.  Each element is read once and written once, plus one flag byte:
// 9 B per fp32 element, 6 B per int8 element, bound by bytes.  One CTA per
// row leaves most SMs idle at small batches, as in B1; spreading a row over
// CTAs with a look-back carry is later work.
#include "seg_tile.cuh"

namespace {

template <typename T, typename A>
__global__ void __launch_bounds__(repro::kSegMaxThreads)
seg_scan_kernel(const T* __restrict__ x, const uint8_t* __restrict__ f, long long fstride,
                A* __restrict__ out, long long n) {
    __shared__ repro::SegScratch<A> sc;
    const long long row = blockIdx.x;
    repro::seg_scan_range<T, A>(x + row * n, f + row * fstride, out + row * n, 0, n, A(0),
                                sc);
}

template <typename T, typename A>
int launch(const void* x, const void* f, long long fstride, void* out, int b, long long n,
           cudaStream_t stream) {
    seg_scan_kernel<T, A><<<b, repro::seg_threads(n, repro::kSegMaxThreads), 0, stream>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(f), fstride,
        static_cast<A*>(out), n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, n) contiguous values; f: flag bytes, row r at f + r * fstride
// (fstride 0 or n); out: (b, n) contiguous.  dtype: 0 fp32, 1 bf16, 2 fp16
// (fp32 out); 3 int8, 4 uint8, 5 int16, 6 int32 (int32 out).
extern "C" int repro_seg_scan(const void* x, const void* f, long long fstride, void* out,
                              int b, long long n, int dtype, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (fstride != 0 && fstride != n) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float, float>(x, f, fstride, out, b, n, st);
        case 1: return launch<__nv_bfloat16, float>(x, f, fstride, out, b, n, st);
        case 2: return launch<__half, float>(x, f, fstride, out, b, n, st);
        case 3: return launch<int8_t, int>(x, f, fstride, out, b, n, st);
        case 4: return launch<uint8_t, int>(x, f, fstride, out, b, n, st);
        case 5: return launch<int16_t, int>(x, f, fstride, out, b, n, st);
        case 6: return launch<int32_t, int>(x, f, fstride, out, b, n, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// B12 — the fused block scan plus gated carry of the segmented §4 pipeline
// (phases 1 and 3).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/segscan_mm.py::_seg_block_carry_kernel (launched by
// seg_block_scan_carry): each block of block_len consecutive elements of a
// row is scanned with the carry reset at every flag, and the block's carry
// (from B11) is added where no flag has been seen since the block start,
// (b, n) -> (b, n) in the accumulation dtype.  The Pallas kernel forms the
// block-local scan in its gather form, full - exclusive[start], which
// subtracts two partial sums.
//
// Design.  One CTA per (row, block) on a flat grid.x of b * nb CTAs (nb can
// pass grid.y's 65535).  The CTA walks its block in order, round after round
// of seg_tile.cuh's segmented scan (B9's round), seeded with the block's
// carry, so the seed stops at the block's first flag without a separate
// `seen` mask.  The walk sums each
// segment's own terms directly, with no subtraction, so random fp32 results
// round differently from the gather form's (and closer to the fp64 scan).
// The ragged end of a row is masked here, so the wrapper pads nothing.
//
// Bound.  Each element is read once and written once, plus one flag byte:
// 9 B per fp32 element, bound by bytes.
#include "seg_tile.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T, typename A>
__global__ void __launch_bounds__(repro::kSegMaxThreads)
seg_block_scan_kernel(const T* __restrict__ x, const uint8_t* __restrict__ f,
                      long long fstride, const A* __restrict__ carries,
                      A* __restrict__ out, long long n, int nb, long long block_len) {
    extern __shared__ __align__(16) unsigned char stage[];
    __shared__ repro::SegScratch<A> sc;
    const long long cta = blockIdx.x;
    const long long row = cta / nb;
    const long long lo = (cta - row * nb) * block_len;
    const long long hi = min(n, lo + block_len);
    repro::seg_scan_range<T, A>(x + row * n, f + row * fstride, out + row * n, lo, hi,
                                carries[cta], sc, stage);
}

template <typename T, typename A>
int launch(const void* x, const void* f, long long fstride, const void* carries, void* out,
           int b, long long n, int nb, long long block_len, cudaStream_t stream) {
    const int threads = repro::seg_threads(block_len, kThreads);
    seg_block_scan_kernel<T, A>
        <<<static_cast<unsigned>(b) * nb, threads, repro::seg_stage_bytes(threads), stream>>>(
            static_cast<const T*>(x), static_cast<const uint8_t*>(f), fstride,
            static_cast<const A*>(carries), static_cast<A*>(out), n, nb, block_len);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, n) contiguous values; f: flag bytes, row r at f + r * fstride
// (fstride 0 or n); carries: (b, nb) in the accumulation dtype,
// nb = ceil(n / block_len); out: (b, n) contiguous.  dtype as in
// repro_seg_scan.
extern "C" int repro_seg_block_scan(const void* x, const void* f, long long fstride,
                                    const void* carries, void* out, int b, long long n,
                                    int nb, long long block_len, int dtype, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if ((fstride != 0 && fstride != n) || block_len < 1 ||
        nb != (n + block_len - 1) / block_len ||
        static_cast<long long>(b) * nb > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float, float>(x, f, fstride, carries, out, b, n, nb, block_len, st);
        case 1:
            return launch<__nv_bfloat16, float>(x, f, fstride, carries, out, b, n, nb,
                                                block_len, st);
        case 2:
            return launch<__half, float>(x, f, fstride, carries, out, b, n, nb, block_len, st);
        case 3: return launch<int8_t, int>(x, f, fstride, carries, out, b, n, nb, block_len, st);
        case 4: return launch<uint8_t, int>(x, f, fstride, carries, out, b, n, nb, block_len, st);
        case 5: return launch<int16_t, int>(x, f, fstride, carries, out, b, n, nb, block_len, st);
        case 6: return launch<int32_t, int>(x, f, fstride, carries, out, b, n, nb, block_len, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

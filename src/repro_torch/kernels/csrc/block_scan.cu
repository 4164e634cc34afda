// B4 — the fused block scan plus carry of the §4 blocked scan pipeline
// (phases 1 and 3).
//
// Replaces the Pallas TPU kernels
// src/repro/kernels/scan_pipeline.py::_block_scan_scanu_kernel and
// ::_block_scan_scanul1_kernel (launched by block_scan_carry): each block of
// block_len = m * s consecutive elements of a row, viewed as an (m, s)
// row-major matrix, is scanned as A @ U_s plus the exclusive prefix of its
// row sums, and the block's carry (from B3) is added on top, (b, n) -> (b, n)
// in the accumulation dtype.
//
// Design.  One CTA per (row, block) on a flat grid.x of b * nb CTAs, so a
// batch of four 2^24-element rows at the default block of 8 tiles of 128 x 128
// gives 512 CTAs, enough to fill the card (B1 runs one CTA per row).  A block
// of m x s = 1024 x 128 fp32 is 512 KB, more than one SM's 227 KB of shared
// memory, so the CTA walks the block's tiles in order with B1's tile walk
// (scan_tile.cuh), seeded with the block's carry instead of zero.  Its row
// prefix therefore runs per tile plus the tile carry, where the JAX kernel
// takes it over the block's m rows: the same sums in another fp32 order,
// still ScanU's cumsum of the row sums or ScanUL1's L⁻ @ (A @ 1_s) within a
// tile.  The ragged end of a row is masked here, so the wrapper pads nothing.
//
// Bound.  Each element is read once and written once (8 B per fp32 element,
// 5 B per int8 element), so it is bound by bytes.  The triangle products run
// on the CUDA cores; tensor cores are later work.
#include "scan_tile.cuh"

namespace {

template <typename T, typename A, bool kUL1>
__global__ void __launch_bounds__(repro::kScanThreads)
block_scan_kernel(const T* __restrict__ x, const A* __restrict__ carries,
                  A* __restrict__ out, long long n, int nb, long long block_len, int s,
                  int g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ A carry_sh;
    const long long cta = blockIdx.x;
    const long long row = cta / nb;
    const long long lo = (cta - row * nb) * block_len;
    const long long hi = min(n, lo + block_len);
    repro::scan_tiles_range<T, A, kUL1>(x + row * n, out + row * n, lo, hi, s, g,
                                        carries[cta], smem_raw, carry_sh);
}

template <typename T, typename A>
int launch(const void* x, const void* carries, void* out, int b, long long n, int nb,
           long long block_len, int s, int variant, cudaStream_t stream) {
    const long long ell = static_cast<long long>(s) * s;
    const int g = repro::super_tiles(s, block_len / ell);
    const size_t smem = repro::scan_smem_bytes<A>(s, g);
    auto kern = variant == 1 ? block_scan_kernel<T, A, true> : block_scan_kernel<T, A, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<static_cast<unsigned>(b) * nb, repro::scan_threads(g * ell), smem, stream>>>(
        static_cast<const T*>(x), static_cast<const A*>(carries), static_cast<A*>(out), n, nb,
        block_len, s, g);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, n) contiguous input; carries: (b, nb) exclusive block prefixes in the
// accumulation dtype, nb = ceil(n / block_len); out: (b, n) contiguous.
// block_len is a whole number of s x s tiles.  variant: 1 = ScanUL1, 0 = ScanU.
// dtype: 0 fp32, 1 bf16, 2 fp16 (fp32 out); 3 int8, 4 uint8, 5 int16, 6 int32
// (int32 out).  1 <= s <= 128.
extern "C" int repro_block_scan(const void* x, const void* carries, void* out, int b,
                                long long n, int nb, long long block_len, int s,
                                int variant, int dtype, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (s < 1 || s > 128 || block_len < 1 || block_len % (static_cast<long long>(s) * s) ||
        nb != (n + block_len - 1) / block_len ||
        static_cast<long long>(b) * nb > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float, float>(x, carries, out, b, n, nb, block_len, s, variant, st);
        case 1:
            return launch<__nv_bfloat16, float>(x, carries, out, b, n, nb, block_len, s,
                                                variant, st);
        case 2:
            return launch<__half, float>(x, carries, out, b, n, nb, block_len, s, variant, st);
        case 3: return launch<int8_t, int>(x, carries, out, b, n, nb, block_len, s, variant, st);
        case 4: return launch<uint8_t, int>(x, carries, out, b, n, nb, block_len, s, variant, st);
        case 5: return launch<int16_t, int>(x, carries, out, b, n, nb, block_len, s, variant, st);
        case 6: return launch<int32_t, int>(x, carries, out, b, n, nb, block_len, s, variant, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

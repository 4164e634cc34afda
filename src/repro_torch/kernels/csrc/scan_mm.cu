// B1 — the ScanU / ScanUL1 tile scan (paper Alg. 1 / Alg. 2, Eq. 1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scan_mm.py::_kernel
// (launched by scan_mm_kernel / scan_tiles).  Each row of the (b, n) input is
// scanned as a sequence of s x s row-major tiles:
//
//     local = A @ U_s (+ L⁻_s @ (A @ 1_s) for ScanUL1, or the cumsum of the
//             row sums minus the row sum for ScanU)
//     out   = local + carry;  carry = out[s-1][s-1]
//
// Design.  The TPU walks grid axis 1 in order and keeps `carry` in SMEM.  A
// CUDA grid has no ordered axis, so one CTA owns one batch row and walks its
// tiles in order in a loop, with the carry in shared memory.  The tile walk
// (super-tiles, triangles never loaded, exact integer accumulation) is
// scan_tile.cuh's, which B4 shares.
//
// Bound.  A scan moves each element once in and once out, so at the card's
// 3.35 TB/s it is bound by bytes (8 B per fp32 element).  This first version
// runs one CTA per row, which leaves most SMs idle for small batches, and
// evaluates the triangle products on the CUDA cores.  Spreading a row over
// many CTAs with a look-back carry, and int8/bf16 tiles on the tensor cores,
// are later work; PERF.md records its time beside the bound.
#include "scan_tile.cuh"

namespace {

template <typename T, typename A, bool kUL1>
__global__ void __launch_bounds__(repro::kScanThreads)
scan_tiles_kernel(const T* __restrict__ x, A* __restrict__ out, long long n,
                  int s, int g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ A carry_sh;
    const long long row = blockIdx.x;
    repro::scan_tiles_range<T, A, kUL1>(x + row * n, out + row * n, 0, n, s, g, A(0),
                                        smem_raw, carry_sh);
}

template <typename T, typename A>
int launch(const void* x, void* out, int b, long long n, int s, int variant,
           cudaStream_t stream) {
    const long long ell = static_cast<long long>(s) * s;
    const int g = repro::super_tiles(s, (n + ell - 1) / ell);
    const size_t smem = repro::scan_smem_bytes<A>(s, g);
    auto kern = variant == 1 ? scan_tiles_kernel<T, A, true> : scan_tiles_kernel<T, A, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<b, repro::kScanThreads, smem, stream>>>(static_cast<const T*>(x),
                                                   static_cast<A*>(out), n, s, g);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, n) contiguous input; out: (b, n) contiguous accumulator output.
// variant: 1 = ScanUL1, 0 = ScanU.  dtype: 0 fp32, 1 bf16, 2 fp16 (fp32 out);
// 3 int8, 4 uint8, 5 int16, 6 int32 (int32 out).  1 <= s <= 128.
extern "C" int repro_scan_tiles(const void* x, void* out, int b, long long n, int s,
                                int variant, int dtype, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (s < 1 || s > 128) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float, float>(x, out, b, n, s, variant, st);
        case 1: return launch<__nv_bfloat16, float>(x, out, b, n, s, variant, st);
        case 2: return launch<__half, float>(x, out, b, n, s, variant, st);
        case 3: return launch<int8_t, int>(x, out, b, n, s, variant, st);
        case 4: return launch<uint8_t, int>(x, out, b, n, s, variant, st);
        case 5: return launch<int16_t, int>(x, out, b, n, s, variant, st);
        case 6: return launch<int32_t, int>(x, out, b, n, s, variant, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

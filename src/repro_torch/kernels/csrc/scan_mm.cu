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
// tiles in order in a loop, with the carry in shared memory.  Small tiles are
// walked several at a time ("super-tiles" of up to 16384 elements) so that
// tile_s = 8 or 16 does not pay one round of barriers per 64-element tile.
//
// The triangles are never loaded.  U_s[k][j] = (k <= j), so column j of
// A @ U_s is column j-1 plus the one term k = j: thread r evaluates row r of
// the product in column order, carrying the previous column's dot product.
// That is the same sum as the dot product taken in k order, at one add per
// element instead of s.  L⁻_s[i][k] = (k < i) likewise makes L⁻_s @ (A @ 1_s)
// the exclusive prefix of the row sums, which one warp per tile forms.
// Integer inputs (int8/uint8/int16/int32) accumulate in int32 and are exact;
// fp32 stays IEEE fp32 (no TF32, no tensor cores); bf16/fp16 accumulate in
// fp32.
//
// Bound.  A scan moves each element once in and once out, so at the card's
// 3.35 TB/s it is bound by bytes (8 B per fp32 element).  This first version
// runs one CTA per row, which leaves most SMs idle for small batches, and
// evaluates the triangle products on the CUDA cores.  Spreading a row over
// many CTAs with a look-back carry, and int8/bf16 tiles on the tensor cores,
// are later work; PERF.md records its time beside the bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSuperElems = 16384;  // elements per super-tile (s = 128: one tile)
constexpr int kMaxRows = 2048;      // tile rows per super-tile

template <typename T, typename A, bool kUL1>
__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(const T* __restrict__ x, A* __restrict__ out, long long n,
                  int s, int g) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ A carry_sh;
    const int ld = s + 1;                    // odd row stride: conflict-free row walks
    const int rows = g * s;
    A* tile = reinterpret_cast<A*>(smem_raw);
    A* pre = tile + static_cast<size_t>(rows) * ld;  // row sums, then row prefixes
    A* cin = pre + rows;                     // tile totals, then tile carry-ins

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const T* xr = x + static_cast<long long>(blockIdx.x) * n;
    A* orow = out + static_cast<long long>(blockIdx.x) * n;
    const int super_elems = g * s * s;
    const int q = (s + 31) / 32;             // tile rows per lane in the row-prefix scan

    if (threadIdx.x == 0) carry_sh = A(0);
    for (long long base = 0; base < n; base += super_elems) {
        // 1. load the super-tile; element e sits in tile row e / s, column e % s
        for (int e = threadIdx.x; e < super_elems; e += blockDim.x) {
            const long long gi = base + e;
            const int r = e / s;
            tile[r * ld + (e - r * s)] = gi < n ? repro::to_acc(xr[gi], A(0)) : A(0);
        }
        __syncthreads();

        // 2. A @ U_s, one tile row per thread, in column order
        for (int r = threadIdx.x; r < rows; r += blockDim.x) {
            A* tr = tile + r * ld;
            A run = A(0);
            for (int j = 0; j < s; ++j) {
                run = run + tr[j];
                tr[j] = run;
            }
            pre[r] = run;                    // (A @ 1_s)[r], the row sum
        }
        __syncthreads();

        // 3. row prefixes, one warp per tile: ScanUL1 adds L⁻_s @ (A @ 1_s),
        //    the exclusive prefix; ScanU adds cumsum(row sums) - row sum
        for (int t = warp; t < g; t += nwarps) {
            A* rs = pre + t * s;
            const int r0 = min(lane * q, s);
            const int r1 = min(r0 + q, s);
            A loc = A(0);
            for (int r = r0; r < r1; ++r) loc = loc + rs[r];
            const A incl = repro::warp_inclusive_scan(loc, lane);
            A run = __shfl_up_sync(repro::kFullMask, incl, 1);
            if (lane == 0) run = A(0);
            for (int r = r0; r < r1; ++r) {
                const A v = rs[r];
                const A before = run;
                run = run + v;
                rs[r] = kUL1 ? before : run - v;
            }
            if (r0 < s && r1 == s) {         // the lane holding the tile's last row
                cin[t] = tile[(t * s + s - 1) * ld + s - 1] + rs[s - 1];
            }
        }
        __syncthreads();

        // 4. the ordered carry across tiles: out = local + carry, carry = out[-1][-1]
        if (threadIdx.x == 0) {
            A c = carry_sh;
            for (int t = 0; t < g; ++t) {
                const A local_last = cin[t];
                cin[t] = c;
                c = local_last + c;
            }
            carry_sh = c;
        }
        __syncthreads();

        // 5. write out = (A @ U_s + row prefix) + carry
        for (int e = threadIdx.x; e < super_elems; e += blockDim.x) {
            const long long gi = base + e;
            if (gi < n) {
                const int r = e / s;
                orow[gi] = (tile[r * ld + (e - r * s)] + pre[r]) + cin[r / s];
            }
        }
        __syncthreads();
    }
}

template <typename T, typename A>
int launch(const void* x, void* out, int b, long long n, int s, int variant,
           cudaStream_t stream) {
    const long long ell = static_cast<long long>(s) * s;
    const long long nt = (n + ell - 1) / ell;
    int g = min(kSuperElems / (s * s), kMaxRows / s);
    if (g < 1) g = 1;
    if (g > nt) g = static_cast<int>(nt);
    const int rows = g * s;
    const size_t smem = (static_cast<size_t>(rows) * (s + 1) + rows + g) * sizeof(A);
    auto kern = variant == 1 ? scan_tiles_kernel<T, A, true> : scan_tiles_kernel<T, A, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<b, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<A*>(out), n,
                                        s, g);
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

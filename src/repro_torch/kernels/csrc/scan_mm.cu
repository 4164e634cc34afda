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
// Design.  The TPU walks grid axis 1 in order and keeps `carry` in SMEM.  Here
// one launch runs a single pass over many CTAs a row: a row is cut into
// groups of g tiles (scan_tile.cuh's geometry: 16384 elements, one tile, at
// s = 128; g = 64 tiles at s = 16), one CTA a group over every row.  A CTA
// holds its group in registers, 32 elements a thread, walks each tile row in
// column order (A @ U_s; a shuffle joins the segments of a row wider than
// 32), forms the row prefixes and the tile totals, and scans the totals into
// each tile's offset E_i in the group and the group's total A_k.  Its first
// warp then takes the group's carry-in P_{k-1} from the decoupled look-back
// of lookback.cuh: the strict left-to-right fold P_{k-1} = P_{k-2} + A_{k-1}
// ... from the nearest group that has published its prefix, which it
// publishes in turn as P_k = P_{k-1} + A_k.  A tile's carry is P_{k-1} + E_i.
// Every prefix is defined by that one chain of adds, so the result does not
// depend on which group had published when: bit-equal from run to run.  At
// g = 1 (s = 128) the chain is the one-CTA walk's carry = local_last + carry.
// The ragged end of a row is masked here, so the wrapper pads nothing; it
// passes the look-back's workspace, 8 B a group + 8 B, which this entry point
// zeroes on the stream.
//
// Bound.  A scan moves each element once in and once out, so at the card's
// 3.35 TB/s it is bound by bytes (8 B per fp32 element, 5 B per int8
// element).  The group walk is one add an element plus a few shuffles and
// four barriers a CTA; the triangle products stay on the CUDA cores (int8
// tiles on the tensor cores are later work).
#include "lookback.cuh"
#include "scan_tile.cuh"

namespace {

// The look-back as scan_group's carry-in: group j of a row.
template <typename A>
struct LookbackCarry {
    unsigned long long* row;
    long long j;
    __device__ A operator()(A total, int lane) const {
        return repro::lookback_carry<A, repro::SumFold<A>>(row, j, total, false, lane);
    }
};

template <typename T, typename A, bool kUL1>
__global__ void __launch_bounds__(repro::kScanThreads, 2)
scan_tiles_kernel(const T* __restrict__ x, A* __restrict__ out, long long n,
                  repro::ScanGeom G, long long groups, unsigned long long* __restrict__ status,
                  unsigned long long* __restrict__ counter) {
    extern __shared__ __align__(16) unsigned char stage[];
    __shared__ repro::ScanSmem<A> sm;
    const long long id = repro::take_tile(counter, sm.slot);
    const long long row = id / groups;
    const long long j = id - row * groups;
    repro::scan_group<T, A, kUL1>(x + row * n, out + row * n, j * G.elems, n, G, sm, stage,
                                  LookbackCarry<A>{status + row * groups, j});
}

template <typename T, typename A>
int launch(const void* x, void* out, int b, long long n, const repro::ScanGeom& G,
           long long groups, int variant, unsigned long long* ws, cudaStream_t stream) {
    const long long total = static_cast<long long>(b) * groups;
    cudaError_t err = cudaMemsetAsync(ws, 0, (total + 1) * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto kern = variant == 1 ? scan_tiles_kernel<T, A, true> : scan_tiles_kernel<T, A, false>;
    const size_t stage = repro::scan_stage_bytes(G);
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(stage));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<static_cast<unsigned>(total), G.threads, stage, stream>>>(
        static_cast<const T*>(x), static_cast<A*>(out), n, G, groups, ws, ws + total);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, n) contiguous input; out: (b, n) contiguous accumulator output.
// variant: 1 = ScanUL1, 0 = ScanU.  dtype: 0 fp32, 1 bf16, 2 fp16 (fp32 out);
// 3 int8, 4 uint8, 5 int16, 6 int32 (int32 out).  1 <= s <= 128.  ws: the
// look-back's workspace of ws_bytes >= 8 * (b * groups + 1), where a row is
// groups = ceil(n / (g * s * s)) groups of scan_geom's g tiles; it is zeroed
// here.
extern "C" int repro_scan_tiles(const void* x, void* out, int b, long long n, int s,
                                int variant, int dtype, void* ws, long long ws_bytes,
                                void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (s < 1 || s > 128) return static_cast<int>(cudaErrorInvalidValue);
    const long long ell = static_cast<long long>(s) * s;
    const repro::ScanGeom G = repro::scan_geom(s, (n + ell - 1) / ell);
    const long long groups = (n + G.elems - 1) / G.elems;
    if (b * groups > 0x7fffffffLL ||
        ws_bytes < (b * groups + 1) * static_cast<long long>(sizeof(unsigned long long))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* w = static_cast<unsigned long long*>(ws);
    switch (dtype) {
        case 0: return launch<float, float>(x, out, b, n, G, groups, variant, w, st);
        case 1: return launch<__nv_bfloat16, float>(x, out, b, n, G, groups, variant, w, st);
        case 2: return launch<__half, float>(x, out, b, n, G, groups, variant, w, st);
        case 3: return launch<int8_t, int>(x, out, b, n, G, groups, variant, w, st);
        case 4: return launch<uint8_t, int>(x, out, b, n, G, groups, variant, w, st);
        case 5: return launch<int16_t, int>(x, out, b, n, G, groups, variant, w, st);
        case 6: return launch<int32_t, int>(x, out, b, n, G, groups, variant, w, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

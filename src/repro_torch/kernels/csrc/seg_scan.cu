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
// Design.  A single pass over many CTAs a row: seg_pass.cuh's, inclusive, over
// flag bytes.  A row is cut into tiles of seg_threads(n, 512, 16) threads x 16
// elements (8192 for rows of 8192 or more), one CTA a tile; each CTA scans its
// tile and takes its carry-in from the decoupled look-back of lookback.cuh, the
// strict left-to-right fold of the earlier tiles' aggregates, so the results
// are the same bits on every run.  The carry reaches only the elements before
// the tile's first flag, which is what the Pallas kernel's `seen` mask does.
// Flags are bytes (nonzero = a segment start) with a row stride that is 0 when
// one row of flags serves every row (the sampler's one-hot scans).  The wrapper
// pads nothing; it passes the look-back's workspace (8 B a tile and 8 B for the
// counter), which this entry point zeroes on the stream, and reads the counter
// back as the number of CTAs that ran.
//
// Bound.  Each element is read once and written once, plus one flag byte:
// 9 B per fp32 element, 6 B per int8 element, bound by bytes.  The look-back
// adds 8 B of state a tile (one word per 8192 elements).  What holds a tile
// back from the bound is its fixed cost (seg_pass.cuh).
#include "seg_pass.cuh"

namespace {

template <typename T, typename A>
int launch(const void* x, const void* f, long long fstride, void* out, int b, long long n,
           void* ws, long long ws_bytes, cudaStream_t stream) {
    return repro::seg_pass_launch<T, A, uint8_t, false>(x, f, fstride, out, b, n, ws, ws_bytes,
                                                         false, stream);
}

}  // namespace

// x: (b, n) contiguous values; f: flag bytes, row r at f + r * fstride
// (fstride 0 or n); out: (b, n) contiguous.  dtype: 0 fp32, 1 bf16, 2 fp16
// (fp32 out); 3 int8, 4 uint8, 5 int16, 6 int32 (int32 out).  ws: the
// look-back's workspace of ws_bytes >= 8 * (b * tiles + 1), where a row is
// tiles = ceil(n / (seg_threads(n, 512, 16) * 16)) tiles; it is zeroed here.
extern "C" int repro_seg_scan(const void* x, const void* f, long long fstride, void* out,
                              int b, long long n, int dtype, void* ws, long long ws_bytes,
                              void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (fstride != 0 && fstride != n) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float, float>(x, f, fstride, out, b, n, ws, ws_bytes, st);
        case 1: return launch<__nv_bfloat16, float>(x, f, fstride, out, b, n, ws, ws_bytes, st);
        case 2: return launch<__half, float>(x, f, fstride, out, b, n, ws, ws_bytes, st);
        case 3: return launch<int8_t, int>(x, f, fstride, out, b, n, ws, ws_bytes, st);
        case 4: return launch<uint8_t, int>(x, f, fstride, out, b, n, ws, ws_bytes, st);
        case 5: return launch<int16_t, int>(x, f, fstride, out, b, n, ws, ws_bytes, st);
        case 6: return launch<int32_t, int>(x, f, fstride, out, b, n, ws, ws_bytes, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

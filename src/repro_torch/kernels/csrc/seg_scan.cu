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
// Design.  A single pass over many CTAs a row.  A row is cut into tiles of one
// round of the segmented-pair scan of seg_tile.cuh, seg_threads(n, 512, 16)
// threads x 16 elements (8192 for rows of 8192 or more), and one launch runs
// one CTA a tile over every row.  A CTA loads its tile through shared memory
// (each warp's 512 elements as whole 16-byte words in address order), scans 16
// elements a thread in registers, carries (value, flag) across the lanes and
// warps, and so has its aggregate (the sum from the tile's last flag on, and
// whether it holds a flag).  Its first warp then takes the carry-in from the
// decoupled look-back of lookback.cuh under the operator c = a.h ? a.v : c +
// a.v: the strict left-to-right fold of the earlier tiles' aggregates from the
// nearest one that has published its prefix or holds a flag.  That is the carry
// a walk of the row's rounds in order would pass from round to round, so the
// results are the same bits on every run, whichever tiles had published when.
// The carry reaches only the elements before the tile's first flag, which is
// what the Pallas kernel's `seen` mask does.  Flags are bytes (nonzero = a
// segment start) with a row stride that is 0 when one row of flags serves every
// row (the sampler's one-hot scans).  The ragged end of a row is masked here,
// so the wrapper pads nothing; it passes the look-back's workspace (8 B a tile
// and 8 B for the counter), which this entry point zeroes on the stream.
//
// Bound.  Each element is read once and written once, plus one flag byte:
// 9 B per fp32 element, 6 B per int8 element, bound by bytes.  The look-back
// adds 8 B of state a tile (one word per 8192 elements).  What holds a tile
// back from the bound is its fixed cost: the ticket, five barriers and the
// look-back's round trips to L2; 512-thread CTAs with 16 elements a thread
// (four an SM) hide it better than 1024 threads with 8 (two an SM).
#include "lookback.cuh"
#include "seg_tile.cuh"

namespace {

// A round: at most kThreads threads, kItems elements a thread (8192 elements
// for rows of 8192 or more), four CTAs an SM.
constexpr int kThreads = 512;
constexpr int kItems = 16;

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads, 4)
seg_scan_kernel(const T* __restrict__ x, const uint8_t* __restrict__ f, long long fstride,
                A* __restrict__ out, long long n, long long tiles,
                unsigned long long* __restrict__ status,
                unsigned long long* __restrict__ counter) {
    extern __shared__ __align__(16) unsigned char stage[];
    __shared__ repro::SegScratch<A> sc;
    __shared__ long long slot;
    __shared__ A carry_sh;
    const long long tile = repro::take_tile(counter, slot);
    const long long row = tile / tiles;
    const long long j = tile - row * tiles;
    const long long base = j * blockDim.x * kItems;
    repro::SegRound<A> r;
    repro::seg_round_scan<T, A, kItems>(x + row * n, f + row * fstride, base, n, r, sc, stage);
    if (threadIdx.x < 32) {
        const A c = repro::lookback_carry<A, repro::SegFold<A>>(
            status + row * tiles, j, r.tot_v, r.tot_h != 0, threadIdx.x);
        if (threadIdx.x == 0) carry_sh = c;
    }
    __syncthreads();
    repro::seg_round_store<A, kItems>(out + row * n, base, n, r, carry_sh, stage);
}

template <typename T, typename A>
int launch(const void* x, const void* f, long long fstride, void* out, int b, long long n,
           long long tiles, int threads, unsigned long long* ws, cudaStream_t stream) {
    const long long total = static_cast<long long>(b) * tiles;
    cudaError_t err = cudaMemsetAsync(ws, 0, (total + 1) * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t stage = repro::seg_stage_bytes<kItems>(threads);
    err = cudaFuncSetAttribute(seg_scan_kernel<T, A>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(stage));
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_scan_kernel<T, A><<<static_cast<unsigned>(total), threads, stage, stream>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(f), fstride,
        static_cast<A*>(out), n, tiles, ws, ws + total);
    return static_cast<int>(cudaGetLastError());
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
    const int threads = repro::seg_threads(n, kThreads, kItems);
    const long long round = static_cast<long long>(threads) * kItems;
    const long long tiles = (n + round - 1) / round;
    if ((fstride != 0 && fstride != n) || b * tiles > 0x7fffffffLL ||
        ws_bytes < (b * tiles + 1) * static_cast<long long>(sizeof(unsigned long long))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* w = static_cast<unsigned long long*>(ws);
    switch (dtype) {
        case 0: return launch<float, float>(x, f, fstride, out, b, n, tiles, threads, w, st);
        case 1:
            return launch<__nv_bfloat16, float>(x, f, fstride, out, b, n, tiles, threads, w, st);
        case 2: return launch<__half, float>(x, f, fstride, out, b, n, tiles, threads, w, st);
        case 3: return launch<int8_t, int>(x, f, fstride, out, b, n, tiles, threads, w, st);
        case 4: return launch<uint8_t, int>(x, f, fstride, out, b, n, tiles, threads, w, st);
        case 5: return launch<int16_t, int>(x, f, fstride, out, b, n, tiles, threads, w, st);
        case 6: return launch<int32_t, int>(x, f, fstride, out, b, n, tiles, threads, w, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

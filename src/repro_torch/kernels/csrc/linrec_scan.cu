// B13 — the linear-recurrence tile scan.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linrec_mm.py::_tile_kernel
// (launched by linrec_scan_tiles): y_t = a_t * y_{t-1} + b_t along each row
// of the (rows, n) fp32 pairs, from a zero state, (rows, n) -> (rows, n).  The
// Pallas kernel pads each row to whole s*s tiles with the identity (a = 1,
// b = 0), walks the tiles in order on the TPU's sequential grid axis, scans
// each one with weighted-triangle contractions W @ b built from
// exponent-normalized cumulative products, and carries the scalar state in
// SMEM.
//
// Design.  A single pass over many CTAs a row.  A row longer than
// kLinWarpMax is cut into tiles of one round of the affine-pair walk of
// affine_tile.cuh, lin_threads(n, kThreads, kItems) threads x kItems pairs
// (512 x 16 = 8192 for rows of 8192 or more), and one launch runs one CTA a
// tile over every row.  A CTA takes its tile from lookback.cuh's atomic ticket
// (tiles numbered row by row, so it only ever waits on running CTAs), loads
// the tile's pairs through shared memory (each warp's in address order,
// 16-byte cp.async copies), folds kItems pairs a thread in order and composes
// (A, B) across the lanes and warps, which gives the tile's aggregate, the
// affine map the tile applies to the state entering it.  Its first warp then takes that state
// from the decoupled look-back under the affine operator: the strict
// left-to-right fold y <- fmaf(A_i, y, B_i) from the nearest tile k that has
// published its state P_k, and publishes P_j = fmaf(A_j, y, B_j).  That is the
// chain of links a walk of the row's rounds in order makes from round to round,
// so the results are the same bits on every run, whichever tiles had published
// when.  (With the round of the one-CTA-a-row walk this kernel replaced,
// 1024 x 8, they are that walk's bits too, but that tile is slower: a
// 1024-thread CTA that needs more than 32 registers a thread fits once an SM.
// 512 x 16 folds each thread's 16 pairs in order and composes over 512
// threads, another tree, within the same ulp of fp64.)  An aggregate is two
// fp32 values, so a tile has two status words (lookback.cuh, "Pairs"); the
// wrapper passes that workspace (16 B a tile and 8 B for the counter), which
// this entry point zeroes on the stream.  No triangle, no quotient and no zero mask: a zero of a
// resets the state exactly under composition.  Rows of at most kLinWarpMax
// elements are walked by one warp each, eight rows to a CTA, with no
// look-back.  A short axis that is not the last (at most LINREC_COLUMN_MAX
// pairs: the SSD's cross-chunk states) is walked where it lies, one thread a
// column (linrec_columns.cuh, repro_linrec_scan_columns).  The ragged end of a
// row is masked here, so nothing is padded: a
// 16-long row stays 16 long where the Pallas kernel pads it to 256.  The tile
// side s of the Pallas kernel and the plain version is not read.
//
// Bound.  Each row reads a and b once and writes y once: 12 B per element,
// bound by bytes (0.240 ms at (4, 2^24) at 3.35 TB/s).  The look-back adds
// 16 B of state a tile.  What holds a tile back from the bound is its fixed
// cost: the ticket, the barriers of the block scan and the look-back's round
// trips to L2.
#include "affine_tile.cuh"
#include "linrec_columns.cuh"
#include "lookback.cuh"

namespace {

// A tile: at most kThreads threads, kItems pairs a thread (8192 pairs for rows
// of 8192 or more; linrec_mm mirrors both to size the workspace), two CTAs an
// SM (80 KB of staging each).
constexpr int kThreads = 512;
constexpr int kItems = 16;

__global__ void __launch_bounds__(kThreads, 2)
linrec_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, long long n, long long tiles,
                   unsigned long long* __restrict__ first,
                   unsigned long long* __restrict__ second,
                   unsigned long long* __restrict__ counter) {
    extern __shared__ __align__(16) unsigned char stage[];
    __shared__ repro::AffineScratch sc;
    __shared__ long long slot;
    __shared__ float carry_sh;
    const long long tile = repro::take_tile(counter, slot);
    const long long row = tile / tiles;
    const long long j = tile - row * tiles;
    const long long base = j * blockDim.x * kItems;
    repro::AffineRound r;
    repro::affine_round_scan<kItems>(a + row * n, b + row * n, base, n, r, sc, stage);
    if (threadIdx.x < 32) {
        const float c = repro::lookback_affine_carry(first + row * tiles, second + row * tiles,
                                                     j, r.totA, r.totB, threadIdx.x);
        if (threadIdx.x == 0) carry_sh = c;
    }
    __syncthreads();
    repro::affine_round_store<kItems>(out + row * n, base, n, r, carry_sh, stage);
}

__global__ void __launch_bounds__(32 * repro::kLinRowsPerCta)
linrec_scan_warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ out, long long rows, long long n) {
    const long long row =
        static_cast<long long>(blockIdx.x) * repro::kLinRowsPerCta + (threadIdx.x >> 5);
    if (row >= rows) return;                  // whole warps leave together
    const long long off = row * n;
    repro::warp_linrec_range(a + off, b + off, out + off, 0, n, 0.f, threadIdx.x & 31);
}

}  // namespace

// a, b, out: (rows, n) contiguous fp32.  rows is a C int: the wrapper refuses
// more than 2^31 - 1 (the SSD's 2^20 rows at zamba2's prefill fit).  ws: for
// n > kLinWarpMax the look-back's workspace of ws_bytes >= 8 * (2 * rows *
// tiles + 1), where a row is tiles = ceil(n / (lin_threads(n, 512, 16) * 16))
// tiles; it is zeroed here.  Rows of at most kLinWarpMax read no workspace.
extern "C" int repro_linrec_scan(const void* a, const void* b, void* out, int rows, long long n,
                                 void* ws, long long ws_bytes, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* af = static_cast<const float*>(a);
    const float* bf = static_cast<const float*>(b);
    float* of = static_cast<float*>(out);
    if (n <= repro::kLinWarpMax) {
        const unsigned ctas = static_cast<unsigned>(
            (static_cast<long long>(rows) + repro::kLinRowsPerCta - 1) / repro::kLinRowsPerCta);
        linrec_scan_warp_kernel<<<ctas, 32 * repro::kLinRowsPerCta, 0, st>>>(af, bf, of, rows,
                                                                            n);
        return static_cast<int>(cudaGetLastError());
    }
    const int threads = repro::lin_threads(n, kThreads, kItems);
    const long long round = static_cast<long long>(threads) * kItems;
    const long long tiles = (n + round - 1) / round;
    const long long total = static_cast<long long>(rows) * tiles;
    if (ws == nullptr || total > 0x7fffffffLL ||
        ws_bytes < (2 * total + 1) * static_cast<long long>(sizeof(unsigned long long))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* w = static_cast<unsigned long long*>(ws);
    cudaError_t err =
        cudaMemsetAsync(w, 0, (2 * total + 1) * sizeof(unsigned long long), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t stage = repro::affine_stage_bytes<kItems>(threads);
    err = cudaFuncSetAttribute(linrec_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(stage));
    if (err != cudaSuccess) return static_cast<int>(err);
    linrec_scan_kernel<<<static_cast<unsigned>(total), threads, stage, st>>>(
        af, bf, of, n, tiles, w, w + total, w + 2 * total);
    return static_cast<int>(cudaGetLastError());
}

// The column walk of linrec_columns.cuh (launch_columns' geometry): one launch
// of B13 for a short scan axis that is not the last.
extern "C" int repro_linrec_scan_columns(const void* a, const void* b, const void* init,
                                         void* out, const long long* geom, void* stream) {
    return repro::launch_columns(a, b, init, out, geom, stream);
}

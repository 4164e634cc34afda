// The ScanU / ScanUL1 tile walk shared by B1 (scan_mm.cu) and B4
// (block_scan.cu): one CTA scans a range of a row as s x s row-major tiles,
// walked in order with a running carry.
//
//     local = A @ U_s (+ L⁻_s @ (A @ 1_s) for ScanUL1, or the cumsum of the
//             row sums minus the row sum for ScanU)
//     out   = local + carry;  carry = out[s-1][s-1]
//
// Small tiles are walked several at a time ("super-tiles" of up to 16384
// elements) so that tile_s = 8 or 16 does not pay one round of barriers per
// 64-element tile.
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
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kScanThreads = 512;
constexpr int kSuperElems = 16384;  // elements per super-tile (s = 128: one tile)
constexpr int kMaxRows = 2048;      // tile rows per super-tile

// Tiles per super-tile for tile side s, when the range holds `tiles` tiles.
inline int super_tiles(int s, long long tiles) {
    int g = kSuperElems / (s * s);
    if (g > kMaxRows / s) g = kMaxRows / s;
    if (g < 1) g = 1;
    if (g > tiles) g = static_cast<int>(tiles);
    return g;
}

// Dynamic shared memory of one super-tile: the tile rows at an odd stride,
// the row sums and the tile totals.
template <typename A>
inline size_t scan_smem_bytes(int s, int g) {
    const size_t rows = static_cast<size_t>(g) * s;
    return (rows * (s + 1) + rows + g) * sizeof(A);
}

// Threads for a CTA whose super-tile holds `elems` elements: 512, or fewer
// (at least two warps) for small blocks, so that more CTAs share an SM.
inline int scan_threads(long long elems) {
    long long t = (elems / 32 + 31) / 32 * 32;
    if (t < 64) t = 64;
    if (t > kScanThreads) t = kScanThreads;
    return static_cast<int>(t);
}

// Inclusive scan of xr[lo, hi) into orow[lo, hi), starting from `carry0`.
// Tiles start at lo; elements at or past hi read as zero and are not written.
// smem_raw holds scan_smem_bytes<A>(s, g) bytes; carry_sh is one shared A.
template <typename T, typename A, bool kUL1>
__device__ __forceinline__ void scan_tiles_range(const T* __restrict__ xr,
                                                 A* __restrict__ orow, long long lo,
                                                 long long hi, int s, int g, A carry0,
                                                 unsigned char* smem_raw, A& carry_sh) {
    const int ld = s + 1;                    // odd row stride: conflict-free row walks
    const int rows = g * s;
    A* tile = reinterpret_cast<A*>(smem_raw);
    A* pre = tile + static_cast<size_t>(rows) * ld;  // row sums, then row prefixes
    A* cin = pre + rows;                     // tile totals, then tile carry-ins

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int super_elems = g * s * s;
    const int q = (s + 31) / 32;             // tile rows per lane in the row-prefix scan

    if (threadIdx.x == 0) carry_sh = carry0;
    for (long long base = lo; base < hi; base += super_elems) {
        // 1. load the super-tile; element e sits in tile row e / s, column e % s
        for (int e = threadIdx.x; e < super_elems; e += blockDim.x) {
            const long long gi = base + e;
            const int r = e / s;
            tile[r * ld + (e - r * s)] = gi < hi ? to_acc(xr[gi], A(0)) : A(0);
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
            const A incl = warp_inclusive_scan(loc, lane);
            A run = __shfl_up_sync(kFullMask, incl, 1);
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
            if (gi < hi) {
                const int r = e / s;
                orow[gi] = (tile[r * ld + (e - r * s)] + pre[r]) + cin[r / s];
            }
        }
        __syncthreads();
    }
}

}  // namespace repro

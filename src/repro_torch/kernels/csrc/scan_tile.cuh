// The ScanU / ScanUL1 tile walk shared by B1 (scan_mm.cu) and B4
// (block_scan.cu).  A row is scanned as s x s row-major tiles:
//
//     local = A @ U_s (+ L⁻_s @ (A @ 1_s) for ScanUL1, or the cumsum of the
//             row sums minus the row sum for ScanU)
//     out   = local + carry
//
// A CTA holds g tiles at once (a "group", up to 16384 elements), in registers:
// each thread owns one contiguous span of at most kScanItems elements, either
// k whole tile rows (s <= 32; k the largest power of two with k | s and
// k * s <= 32) or one of the q = ceil(s / 32) segments of a row.  Per group:
//
// 1. each thread loads its span and walks it in column order: A @ U_s, one
//    add an element, since U_s[k][j] = (k <= j) makes column j column j - 1
//    plus one term; the triangles are never formed.  Where q > 1 a shuffle among the row's q
//    lanes adds each segment's offset, the exclusive prefix of the segment
//    sums, and the lane with the row's last segment records the row sum;
// 2. one warp a tile forms the row prefix: ScanUL1's L⁻_s @ (A @ 1_s), the
//    exclusive prefix of the row sums, or ScanU's cumsum of the row sums minus
//    the row sum; the tile's total is its last row sum plus that row's prefix;
// 3. one warp scans the g tile totals into each tile's offset E_i within the
//    group and the group's total A, asks the caller for the group's carry-in
//    c, and sets each tile's carry to c + E_i;
// 4. every thread writes (local + row prefix) + carry.
//
// Where the spans tile a whole group in thread order (s = 8, 16, 32, 64 or
// 128 and g at its most: "dense"), each warp loads and stores its 1024
// elements in address order through shared memory (warp_stage_in /
// warp_store_staged), so every access of the warp is whole 16-byte words
// side by side; other geometries load and store each span directly.
//
// Integer inputs (int8/uint8/int16/int32) accumulate in int32 and are exact;
// fp32 stays IEEE fp32 (no TF32, no tensor cores); bf16/fp16 accumulate in
// fp32.  Every sum is taken in an order fixed by the geometry alone.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kScanThreads = 512;
constexpr int kScanItems = 32;      // elements a thread holds at most
constexpr int kScanMaxRows = 2048;  // tile rows a group holds at most (g * s)

// How a CTA cuts a group of g s x s tiles over its threads.
struct ScanGeom {
    int s;        // tile side
    int q;        // segments a row (threads a row when s > 32)
    int qp;       // q rounded up to a power of two: lanes a row
    int seg;      // columns a segment
    int k;        // rows a thread when q == 1
    int per_tile; // threads a tile, a power of two
    int g;        // tiles a group
    int threads;  // threads a CTA, whole warps
    int dense;    // 1: thread t's span is the group's elements [32 t, 32 t + 32)
    long long elems;  // elements a group, g * s * s
};

inline int pow2_at_least(int v) {
    int p = 1;
    while (p < v) p <<= 1;
    return p;
}

// The geometry for tile side s (1..128) on a range of `tiles` tiles.
inline ScanGeom scan_geom(int s, long long tiles) {
    ScanGeom G;
    G.s = s;
    G.q = (s + 31) / 32;
    G.qp = pow2_at_least(G.q);
    G.seg = (s + G.q - 1) / G.q;
    G.k = 1;
    if (G.q == 1) {
        while (s % (2 * G.k) == 0 && 2 * G.k * s <= kScanItems) G.k *= 2;
    }
    G.per_tile = pow2_at_least(G.q == 1 ? s / G.k : s * G.qp);
    long long g = kScanThreads / G.per_tile;
    if (g > tiles) g = tiles;
    if (g < 1) g = 1;
    G.g = static_cast<int>(g);
    G.threads = (G.g * G.per_tile + 31) / 32 * 32;  // whole warps
    G.elems = static_cast<long long>(G.g) * s * s;
    G.dense = G.elems == static_cast<long long>(G.threads) * kScanItems &&
              (G.q == 1 ? G.k * s == kScanItems && G.per_tile * G.k == s
                        : G.seg == kScanItems && G.qp == G.q);
    return G;
}

// Dynamic shared memory of a CTA: a dense geometry stages its loads and
// stores through a row of stage_stride<kScanItems>() bytes a thread.
inline size_t scan_stage_bytes(const ScanGeom& G) {
    return G.dense ? static_cast<size_t>(G.threads) * stage_stride<kScanItems>() : 0;
}

template <typename A>
struct ScanSmem {
    A rows[kScanMaxRows];          // row sums, then row prefixes
    A tiles[kScanThreads];         // tile totals, then tile carries
    long long slot;                // a tile number handed to the CTA
};

// Scan the group of G.g tiles that starts at xr[base] into orow; elements at or
// past hi read as zero and are not written.  carry_in(total, lane) is called
// by all of warp 0 with the group's total and returns the group's carry-in on
// every lane.  stage holds scan_stage_bytes(G) bytes.  Ends with a barrier,
// so sm and stage may be reused at once.
template <typename T, typename A, bool kUL1, typename CarryIn>
__device__ __forceinline__ void scan_group(const T* __restrict__ xr, A* __restrict__ orow,
                                           long long base, long long hi, const ScanGeom& G,
                                           ScanSmem<A>& sm, unsigned char* stage,
                                           CarryIn carry_in) {
    const int s = G.s;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nwarps = blockDim.x >> 5;
    const int tile = t / G.per_tile;
    const int w = t & (G.per_tile - 1);

    // this thread's span: rows [r0, r0 + k) of its tile, or columns [c0, c1)
    // of row r0
    int r0, c0 = 0, c1 = s, cnt = 0;
    if (G.q == 1) {
        r0 = w * G.k;
        if (tile < G.g && r0 < s) cnt = G.k * s;
    } else {
        r0 = w / G.qp;
        const int p = w & (G.qp - 1);
        c0 = p * G.seg;
        c1 = min(c0 + G.seg, s);
        if (tile < G.g && r0 < s && p < G.q) cnt = c1 - c0;
    }
    const long long off = base + static_cast<long long>(tile) * s * s +
                          static_cast<long long>(r0) * s + c0;
    const int row0 = tile * s + r0;  // the span's first row in the group

    // 1. load and walk the span in column order
    A v[kScanItems];
    const long long wbase = base + static_cast<long long>(warp) * 32 * kScanItems;
    unsigned char* wstage = stage + warp * 32 * stage_stride<kScanItems>();
    if (G.dense) {
        warp_stage_in<T, A, kScanItems>(xr + wbase, hi - wbase, wstage, lane);
        stage_row(wstage, lane, v);
    } else {
        load_items<T, A, kScanItems>(xr + off, cnt, hi - off, v);
    }
    A run = A(0);
    {
        int col = 0, r = row0;
#pragma unroll
        for (int j = 0; j < kScanItems; ++j) {
            if (j < cnt) {
                run = col == 0 ? v[j] : run + v[j];
                v[j] = run;
                if (++col == s) {          // a whole row ends in this span (q == 1)
                    sm.rows[r++] = run;
                    col = 0;
                }
            }
        }
    }
    if (G.q > 1) {
        // the segment offsets: an exclusive scan of the segment sums over the
        // row's lanes; the lane with the row's last segment has the row sum
        const int p = w & (G.qp - 1);
        A inc = run;
        for (int d = 1; d < G.qp; d <<= 1) {
            const A o = __shfl_up_sync(kFullMask, inc, d, G.qp);
            if (p >= d) inc = o + inc;
        }
        A seg_off = __shfl_up_sync(kFullMask, inc, 1, G.qp);
        if (p == 0) seg_off = A(0);
#pragma unroll
        for (int j = 0; j < kScanItems; ++j) v[j] = seg_off + v[j];
        if (cnt > 0 && c1 == s) sm.rows[row0] = seg_off + run;  // = v[cnt - 1]
    }
    __syncthreads();

    // 2. row prefixes, one warp a tile
    const int rq = (s + 31) / 32;  // rows a lane
    for (int ti = warp; ti < G.g; ti += nwarps) {
        A* rs = sm.rows + ti * s;
        const int a0 = min(lane * rq, s);
        const int a1 = min(a0 + rq, s);
        A loc = A(0);
        for (int r = a0; r < a1; ++r) loc = loc + rs[r];
        const A incl = warp_inclusive_scan(loc, lane);
        A pre = __shfl_up_sync(kFullMask, incl, 1);
        if (lane == 0) pre = A(0);
        A last = A(0), last_pre = A(0);
        for (int r = a0; r < a1; ++r) {
            const A sum = rs[r];
            const A before = pre;
            pre = pre + sum;
            last = sum;
            last_pre = kUL1 ? before : pre - sum;
            rs[r] = last_pre;
        }
        if (a0 < s && a1 == s) sm.tiles[ti] = last + last_pre;  // the tile's last element
    }
    __syncthreads();

    // 3. the tiles' offsets in the group, and the group's carry-in
    if (warp == 0) {
        const int tq = (G.g + 31) / 32;
        const int b0 = min(lane * tq, G.g);
        const int b1 = min(b0 + tq, G.g);
        A loc = A(0);
        for (int i = b0; i < b1; ++i) loc = loc + sm.tiles[i];
        const A incl = warp_inclusive_scan(loc, lane);
        A e = __shfl_up_sync(kFullMask, incl, 1);
        if (lane == 0) e = A(0);
        const A c = carry_in(__shfl_sync(kFullMask, incl, 31), lane);
        for (int i = b0; i < b1; ++i) {
            const A tot = sm.tiles[i];
            sm.tiles[i] = c + e;
            e = e + tot;
        }
    }
    __syncthreads();

    // 4. out = (local + row prefix) + carry
    if (cnt > 0) {
        const A carry = sm.tiles[tile];
        int col = 0, r = row0;
        A pre = sm.rows[r];
#pragma unroll
        for (int j = 0; j < kScanItems; ++j) {
            if (j < cnt) {
                v[j] = (v[j] + pre) + carry;
                if (++col == s && j + 1 < cnt) {
                    col = 0;
                    pre = sm.rows[++r];
                }
            }
        }
    }
    if (G.dense) {
        warp_store_staged<A, kScanItems>(orow + wbase, hi - wbase, wstage, lane, v);
    } else {
        store_items<A, kScanItems>(orow + off, cnt, hi - off, v);
    }
    __syncthreads();
}

}  // namespace repro

// The single pass of the segmented scan, shared by B9 (seg_scan.cu) and B11
// (seg_carry.cu).
//
// One launch scans every row under the segmented-pair operator
// (a ⊕ b) = (b.h ? b.v : a.v + b.v, a.h | b.h).  A row is cut into tiles of
// one round of seg_tile.cuh's scan, seg_threads(n, 512, 16) threads x 16
// elements (8192 for rows of 8192 or more), one CTA a tile.  A CTA loads its
// tile through shared memory (each warp's 512 values as whole 16-byte words in
// address order), reads its flags (bytes for B9, int32 words for B11, each
// thread's as 16-byte words where aligned), scans 16 elements a thread in
// registers, carries (value, flag) across the lanes and warps, and so has its
// aggregate: the sum from the tile's last flag on, and whether it holds a
// flag.  Its first warp then takes the carry-in from the decoupled look-back of
// lookback.cuh under c = a.h ? a.v : c + a.v: the strict left-to-right fold of
// the earlier tiles' aggregates from the nearest one that has published its
// prefix or holds a flag, which is the carry a walk of the row's rounds in
// order would pass on, so the results are the same bits on every run.  The
// carry reaches only the elements before the tile's first flag.  The output is
// inclusive (B9) or exclusive (B11: element i gets the fold of 0 ... i-1, and
// the row's first element zero).  A row of one tile needs no look-back: with
// `direct` the launcher then runs one CTA a row straight from blockIdx, with
// no ticket and no workspace, so the call is one kernel on the stream and
// nothing else (B11; B9 keeps its ticket, whose count of CTAs its checks read).
// The ragged end of a row is masked here, so nothing is padded.
//
// Bound.  Each value is read once and written once, plus its flag; the
// look-back adds 8 B of state a tile.  What holds a tile back from the bound
// is its fixed cost: the ticket, five barriers and the look-back's round trips
// to L2; 512-thread CTAs with 16 elements a thread (four an SM) hide it better
// than 1024 threads with 8 (two an SM).
#pragma once

#include "lookback.cuh"
#include "seg_tile.cuh"

namespace repro {

constexpr int kSegPassThreads = 512;
constexpr int kSegPassItems = 16;

// counter == nullptr: one tile a row, CTA blockIdx.x is row blockIdx.x, no
// look-back.
template <typename T, typename A, typename F, bool kExclusive>
__global__ void __launch_bounds__(kSegPassThreads, 4)
seg_pass_kernel(const T* __restrict__ x, const F* __restrict__ f, long long fstride,
                A* __restrict__ out, long long n, long long tiles,
                unsigned long long* __restrict__ status,
                unsigned long long* __restrict__ counter) {
    extern __shared__ __align__(16) unsigned char stage[];
    __shared__ SegScratch<A> sc;
    __shared__ long long slot;
    __shared__ A carry_sh;
    const long long tile = counter ? take_tile(counter, slot) : static_cast<long long>(blockIdx.x);
    const long long row = tile / tiles;
    const long long j = tile - row * tiles;
    const long long base = j * blockDim.x * kSegPassItems;
    SegRound<A> r;
    seg_round_scan<T, A, kSegPassItems>(x + row * n, f + row * fstride, base, n, r, sc, stage);
    A carry = A(0);
    if (counter) {
        if (threadIdx.x < 32) {
            const A c = lookback_carry<A, SegFold<A>>(status + row * tiles, j, r.tot_v,
                                                      r.tot_h != 0, threadIdx.x);
            if (threadIdx.x == 0) carry_sh = c;
        }
        __syncthreads();
        carry = carry_sh;
    }
    seg_round_store<A, kSegPassItems, kExclusive>(out + row * n, base, n, r, carry, stage);
}

// Threads a CTA and tiles a row for rows of n.
inline int seg_pass_threads(long long n) { return seg_threads(n, kSegPassThreads, kSegPassItems); }

inline long long seg_pass_tiles(long long n) {
    const long long round = static_cast<long long>(seg_pass_threads(n)) * kSegPassItems;
    return (n + round - 1) / round;
}

// One launch over b rows of n.  ws: the look-back's workspace, 8 B a tile of
// every row and 8 B for the counter, zeroed here on the stream; with `direct`
// and rows of one tile it is not read and may be null.
template <typename T, typename A, typename F, bool kExclusive>
int seg_pass_launch(const void* x, const void* f, long long fstride, void* out, int b,
                    long long n, void* ws, long long ws_bytes, bool direct,
                    cudaStream_t stream) {
    const int threads = seg_pass_threads(n);
    const long long tiles = seg_pass_tiles(n);
    const long long total = static_cast<long long>(b) * tiles;
    const bool ticket = !(direct && tiles == 1);
    if (total > 0x7fffffffLL ||
        (ticket && ws_bytes < (total + 1) * static_cast<long long>(sizeof(unsigned long long)))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* w = static_cast<unsigned long long*>(ws);
    cudaError_t err;
    if (ticket) {
        err = cudaMemsetAsync(w, 0, (total + 1) * sizeof(unsigned long long), stream);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t stage = seg_stage_bytes<kSegPassItems>(threads);
    err = cudaFuncSetAttribute(seg_pass_kernel<T, A, F, kExclusive>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(stage));
    if (err != cudaSuccess) return static_cast<int>(err);
    seg_pass_kernel<T, A, F, kExclusive><<<static_cast<unsigned>(total), threads, stage, stream>>>(
        static_cast<const T*>(x), static_cast<const F*>(f), fstride, static_cast<A*>(out), n,
        tiles, ticket ? w : nullptr, ticket ? w + total : nullptr);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// One stable LSB radix-2^k pass (k = bits <= 8) over raw key words as a
// many-CTA tile split, shared by B7 (radix_pass.cu) and B7h (radix_pass_hist.cu).
//
// digit d = (w >> shift) & (2^k - 1); a stable 2^k-way split of each (b, n)
// row by d; the keys and the int32 permutation scattered to base[d] + rank.
//
// Design.  The Pallas kernels hold a whole row in VMEM.  The sampler's row
// (128256 bf16 keys plus the int32 permutation, 770 KB) does not fit one SM's
// 227 KB of shared memory, and one CTA a row leaves 128 of the card's 132 SMs
// idle at the batch of 4.  So each row is cut into T = ceil(n / kTile) tiles
// and a pass is three kernels on the caller's stream, R = 2^k:
//
//   1. upsweep, grid (T, b): a CTA copies its tile into shared memory (16-byte
//      cp.async copies, all in flight at once) and counts its digits into
//      per-warp counters with shared-memory atomics.  The tile's counts go out
//      bucket-major to scratch (b, R, T).
//   2. scan, grid (R, b): a CTA takes one bucket of one row and scans its T
//      tile counts in place into exclusive prefixes; their sum is the row's
//      bucket total (B7h's histogram).  R·b CTAs share the (b, R, T) counts,
//      so no CTA walks all R·T of a row.
//   3. downsweep, grid (T, b): a CTA reloads its tile, ranks each key among
//      the tile's earlier keys of its digit (k + 1 ballots give each lane the
//      lanes of its digit in a round of 32, per-warp running counters carry
//      the rounds, then an exclusive scan across the warps per digit), and
//      stages keys and permutation in shared memory in digit order; the
//      permutation's loads are in flight while it scans.  The exclusive scan
//      of the row's R bucket totals plus the tile's prefix from 2 is where the
//      tile's run of each bucket starts; consecutive threads then write
//      consecutive addresses of each run.
//
// Tile t's keys of bucket d land after those of every earlier tile (the
// exclusive prefix over tiles) and in tile order among themselves (warp w
// ranks keys [w·kWarpKeys, (w+1)·kWarpKeys) in rounds of 32 lanes), so the
// split is stable.  The ragged end of a row is masked: a lane past n carries
// no digit, counts nothing and writes nothing, so nothing is padded and the
// totals count the row's own keys.  Keys travel as raw 8/16/32-bit words; a
// pass never compares keys.  No kernel uses global atomics, so a pass is
// bit-reproducible from run to run; the three-kernel reduce-then-scan form
// was taken over a one-kernel decoupled look-back (Onesweep) because a pass
// that stands alone needs the row's bucket totals before any tile can place
// its keys, which costs a counting launch either way.
//
// The caller passes scratch of b·R·T ints for the tile counts, plus b·R for
// the totals when it exports none (split_mm.radix_pass_multibit allocates it
// from kTile, which it passes back for checking); the pass allocates nothing.
//
// Bound.  A pass moves each key and permutation entry once in and once out
// (12 B per 16-bit key, 16 B per 32-bit key), so it is bound by bytes.  This
// design reads the keys twice (the upsweep's read: 1.25x the bound's bytes for
// 32-bit keys) and moves 4·R·T B of counts.  Its key loads are 16-byte cp.async
// copies, its permutation loads 128 B a warp, and the staging turns the
// scatter into runs of ~kTile/R consecutive keys, so neither end is scattered.
// What is left bounds it: at (4, 2^22) a pass takes about twice its bytes'
// time, and a count of the downsweep's code gives ~700 instructions a thread
// (the k + 1 ballots of each key's rank, the staging, the scans); at the
// sampler's (4, 128256) a pass is one wave of CTAs and three launches, so
// latency bounds it (PERF.md has both).
//
// The tile machinery (tile_load, warp_rank, warp_offsets, scan_kernel) and the
// upsweep do not depend on how a digit is made: the upsweep takes the digit as
// a functor (RadixDigit here).  B6 (multi_split.cu) runs the upsweep and the
// scan as they are on its slot digits, with a downsweep of its own.
#pragma once

#include <cuda_pipeline.h>

#include <algorithm>

#include "common.cuh"

namespace repro {
namespace radix {

constexpr int kTile = 4096;                   // keys a tile; split_mm.RADIX_TILE
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = kTile / kWarps;     // a warp's contiguous share of a tile
constexpr int kItems = kWarpKeys / 32;        // rounds of 32 lanes a warp
constexpr int kDownBlocks = 2;                // downsweep CTAs an SM (registers)
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kMaxGridY = 65535;              // rows a launch
constexpr int kStaticSmem = 48 * 1024;        // above it, dynamic smem needs an opt-in
constexpr unsigned kNoDigit = 0xffffffffu;    // a lane past the row's end
static_assert(kThreads >= 256, "a thread a digit of R <= 256");
static_assert(kWarpKeys % 32 == 0, "whole rounds of 32 lanes a warp");

// ---------------------------------------------------------------------------
// tile machinery
// ---------------------------------------------------------------------------

// Starts copying count elements from global src to 16-byte aligned shared
// dst: asynchronous 16-byte copies (cp.async) where src is 16-byte aligned,
// all in flight at once, then element by element (the tail, or all of it
// where src is not aligned).  The caller waits with __pipeline_wait_prior(0)
// and a barrier.
template <typename T>
__device__ __forceinline__ void tile_load(const T* __restrict__ src, T* dst, int count) {
    constexpr int kVec = 16 / sizeof(T);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
        const int nv = count / kVec;
        for (int i = threadIdx.x; i < nv; i += blockDim.x) {
            __pipeline_memcpy_async(dst + i * kVec, src + i * kVec, 16);
        }
        done = nv * kVec;
    }
    __pipeline_commit();
    for (int i = done + threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// Index in the tile of this lane's key of round j: warp w owns keys
// [w·kWarpKeys, (w+1)·kWarpKeys), taken 32 at a time in order.
__device__ __forceinline__ int item_index(int j) {
    return (threadIdx.x >> 5) * kWarpKeys + j * 32 + (threadIdx.x & 31);
}

// The lanes of the warp whose digit (bits wide) equals this lane's, among the
// lanes that carry one: the lane's row of the one-hot digit mask, from one
// ballot a digit bit and one for the row's end (k + 1 ballots, in place of
// __match_any_sync).
__device__ __forceinline__ unsigned match_digit(unsigned d, int bits) {
    const bool valid = d != kNoDigit;
    const unsigned any = __ballot_sync(kFullMask, valid);
    unsigned peers = valid ? any : ~any;
    for (int b = 0; b < bits; ++b) {
        const bool set = (d >> b) & 1u;
        const unsigned lanes = __ballot_sync(kFullMask, set);
        peers &= set ? lanes : ~lanes;
    }
    return peers;
}

// Stable ranks within each warp's share of a tile.  digit[j] is the digit of
// this lane's key of round j (kNoDigit past the tile's end); my is the warp's
// R counters, zeroed.  On return my holds the warp's digit counts and rank[j]
// the number of the warp's earlier keys of digit[j]: the exclusive scan of
// the digit's one-hot mask, from popc(peers & lanes below) within a round and
// the running counter across rounds.
__device__ __forceinline__ void warp_rank(const unsigned (&digit)[kItems], int bits, int* my,
                                          int (&rank)[kItems]) {
    const unsigned lanes_below = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const unsigned d = digit[j];
        const unsigned peers = match_digit(d, bits);
        const bool valid = d != kNoDigit;
        rank[j] = valid ? my[d] + __popc(peers & lanes_below) : 0;
        __syncwarp();
        if (valid && (peers & lanes_below) == 0) my[d] += __popc(peers);
        __syncwarp();
    }
}

// Turns the kWarps x R counters into each warp's exclusive offset per digit
// and returns to thread d < R the tile's count of digit d (0 to the others).
__device__ __forceinline__ int warp_offsets(int* cnt, int radix) {
    int run = 0;
    if (static_cast<int>(threadIdx.x) < radix) {
        for (int w = 0; w < kWarps; ++w) {
            const int c = cnt[w * radix + threadIdx.x];
            cnt[w * radix + threadIdx.x] = run;
            run += c;
        }
    }
    return run;
}

// Phase 2: the bucket-major exclusive scan.  CTA (d, row) scans the T tile
// counts of bucket d in place and writes their sum to totals[row][d].
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ tile_counts, int* __restrict__ totals, int tiles, int radix) {
    __shared__ int scratch[2 * kScanWarps + 1];
    const long long slot = static_cast<long long>(blockIdx.y) * radix + blockIdx.x;
    int* c = tile_counts + slot * tiles;
    int carry = 0;
    for (int base = 0; base < tiles; base += kScanThreads) {
        const int i = base + threadIdx.x;
        const int v = i < tiles ? c[i] : 0;
        int sum;
        const int ex = block_exclusive_scan<int, kScanWarps>(v, scratch, sum);
        if (i < tiles) c[i] = carry + ex;
        carry += sum;
    }
    if (threadIdx.x == 0) totals[slot] = carry;
}

// digit[j]: the digit of this lane's key of round j, kNoDigit past the tile's end.
template <typename W, typename Digit>
__device__ __forceinline__ void tile_digits(const W* stage, int tile_n, Digit digit_of,
                                            unsigned (&digit)[kItems]) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int i = item_index(j);
        digit[j] = i < tile_n ? digit_of(stage[i]) : kNoDigit;
    }
}

// Shared memory of the upsweep: the tile's words, then the per-warp counters.
template <typename W>
inline size_t upsweep_smem(int radix) {
    return kTile * sizeof(W) + static_cast<size_t>(kWarps) * radix * sizeof(int);
}

// Phase 1: CTA (t, row) writes its tile's digit counts to tile_counts[row][d][t],
// d < radix; digit_of(w) gives a word's digit, in [0, radix).
template <typename W, typename Digit>
__global__ void __launch_bounds__(kThreads)
upsweep_kernel(const W* __restrict__ keys, int* __restrict__ tile_counts, long long n,
               int tiles, Digit digit_of, int radix) {
    extern __shared__ __align__(16) unsigned char smem[];
    W* stage = reinterpret_cast<W*>(smem);                       // [kTile] keys
    int* cnt = reinterpret_cast<int*>(smem + kTile * sizeof(W)); // [kWarps][R]
    const long long row = blockIdx.y;
    const long long lo = static_cast<long long>(blockIdx.x) * kTile;
    const int tile_n = static_cast<int>(min(static_cast<long long>(kTile), n - lo));

    tile_load(keys + row * n + lo, stage, tile_n);
    for (int i = threadIdx.x; i < kWarps * radix; i += kThreads) cnt[i] = 0;
    __pipeline_wait_prior(0);
    __syncthreads();
    // counts need no order: one shared-memory atomic a key into the warp's
    // counters (integer adds, so the counts do not depend on their order)
    int* my = cnt + (threadIdx.x >> 5) * radix;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int i = item_index(j);
        if (i < tile_n) atomicAdd(my + digit_of(stage[i]), 1);
    }
    __syncthreads();
    for (int d = threadIdx.x; d < radix; d += kThreads) {
        int c = 0;
        for (int w = 0; w < kWarps; ++w) c += cnt[w * radix + d];
        tile_counts[(row * radix + d) * tiles + blockIdx.x] = c;
    }
}

// ---------------------------------------------------------------------------
// the radix pass
// ---------------------------------------------------------------------------

// Bits [shift, shift + k) of a raw key word.
template <typename W>
struct RadixDigit {
    int shift;
    unsigned mask;
    __device__ __forceinline__ unsigned operator()(W w) const {
        return (static_cast<unsigned>(w) >> shift) & mask;
    }
};

// Phase 3: CTA (t, row) ranks its tile stably, stages it in digit order and
// writes each bucket's run at the run's start in the row.  tile_counts holds
// the scan's exclusive prefixes and totals the (b, R) bucket totals.
template <typename W>
__global__ void __launch_bounds__(kThreads, kDownBlocks)
downsweep_kernel(const W* __restrict__ keys, const int* __restrict__ perm,
                 W* __restrict__ keys_out, int* __restrict__ perm_out,
                 const int* __restrict__ tile_counts, const int* __restrict__ totals,
                 long long n, int tiles, int shift, int bits) {
    extern __shared__ __align__(16) unsigned char smem[];
    W* in_k = reinterpret_cast<W*>(smem);                                   // [kTile]
    W* stage_k = in_k + kTile;                                              // [kTile]
    int* stage_p = reinterpret_cast<int*>(stage_k + kTile);                 // [kTile]
    int* cnt = stage_p + kTile;                                             // [kWarps][R]
    const int radix = 1 << bits;
    int* gbase = cnt + kWarps * radix;                                      // [R]
    long long* scratch = reinterpret_cast<long long*>(gbase + radix);      // [2·kWarps+1]
    const RadixDigit<W> digit_of{shift, (1u << bits) - 1u};
    const int warp = threadIdx.x >> 5;
    const long long row = blockIdx.y;
    const long long lo = static_cast<long long>(blockIdx.x) * kTile;
    const int tile_n = static_cast<int>(min(static_cast<long long>(kTile), n - lo));

    tile_load(keys + row * n + lo, in_k, tile_n);
    for (int i = threadIdx.x; i < kWarps * radix; i += kThreads) cnt[i] = 0;
    __pipeline_wait_prior(0);
    __syncthreads();

    // stable ranks within each warp's share; the permutation's loads are in
    // flight while the CTA works out where each digit's run goes
    int rank[kItems];
    {
        unsigned digit[kItems];
        tile_digits(in_k, tile_n, digit_of, digit);
        warp_rank(digit, bits, cnt + warp * radix, rank);
    }
    int p[kItems];
    const int* my_perm = perm + row * n + lo;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int i = item_index(j);
        p[j] = i < tile_n ? my_perm[i] : 0;
    }
    // digit d's count in the tiles before this one and in the row, from the scan
    const int d = threadIdx.x;
    int prefix = 0, total = 0;
    if (d < radix) {
        prefix = tile_counts[(row * radix + d) * tiles + blockIdx.x];
        total = totals[row * radix + d];
    }
    __syncthreads();                                 // every warp's counters are in

    // tile_start[d]: where digit d's run starts in the staged tile; gbase[d]:
    // the run's start in the row (row's bucket base + the tiles before this
    // one), less tile_start[d], so staged slot i goes to gbase[d] + i
    // (one scan of both: the row's total in the high word, the tile's count,
    // at most kTile, in the low)
    const int c = warp_offsets(cnt, radix);
    long long sum;
    const long long both = block_exclusive_scan<long long, kWarps>(
        (static_cast<long long>(total) << 32) | c, scratch, sum);
    const int tile_start = static_cast<int>(both & 0xffffffffLL);
    const int row_start = static_cast<int>(both >> 32);
    if (d < radix) {
        gbase[d] = row_start + prefix - tile_start;
        for (int w = 0; w < kWarps; ++w) cnt[w * radix + d] += tile_start;
    }
    __syncthreads();

    // stage in digit order
    const int* my = cnt + warp * radix;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int i = item_index(j);
        if (i < tile_n) {
            const W w = in_k[i];
            const int s = my[digit_of(w)] + rank[j];
            stage_k[s] = w;
            stage_p[s] = p[j];
        }
    }
    __syncthreads();

    // consecutive threads write consecutive addresses of each bucket's run
    keys_out += row * n;
    perm_out += row * n;
    for (int i = threadIdx.x; i < tile_n; i += kThreads) {
        const W w = stage_k[i];
        const int dest = gbase[digit_of(w)] + i;
        keys_out[dest] = w;
        perm_out[dest] = stage_p[i];
    }
}

template <typename W>
int launch_typed(const void* keys, const void* perm, void* keys_out, void* perm_out,
                 int* counts, int* scratch, int b, long long n, int shift, int bits,
                 cudaStream_t stream) {
    const int radix = 1 << bits;
    const int tiles = static_cast<int>((n + kTile - 1) / kTile);
    const long long per_row = static_cast<long long>(radix) * tiles;
    int* totals = counts != nullptr ? counts : scratch + b * per_row;
    const size_t up_smem = upsweep_smem<W>(radix);
    const size_t down_smem = kTile * (2 * sizeof(W) + sizeof(int))
                             + (kWarps * radix + radix) * sizeof(int)
                             + (2 * kWarps + 1) * sizeof(long long);
    if (down_smem > kStaticSmem) {
        const cudaError_t e = cudaFuncSetAttribute(
            downsweep_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(down_smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const W* k = static_cast<const W*>(keys);
    const int* p = static_cast<const int*>(perm);
    W* ko = static_cast<W*>(keys_out);
    int* po = static_cast<int*>(perm_out);
    for (long long r0 = 0; r0 < b; r0 += kMaxGridY) {
        const int rows = static_cast<int>(std::min<long long>(kMaxGridY, b - r0));
        const long long off = r0 * n;
        int* tc = scratch + r0 * per_row;
        int* tot = totals + r0 * radix;
        upsweep_kernel<W, RadixDigit<W>><<<dim3(tiles, rows), kThreads, up_smem, stream>>>(
            k + off, tc, n, tiles, RadixDigit<W>{shift, (1u << bits) - 1u}, radix);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        scan_kernel<<<dim3(radix, rows), kScanThreads, 0, stream>>>(tc, tot, tiles, radix);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        downsweep_kernel<W><<<dim3(tiles, rows), kThreads, down_smem, stream>>>(
            k + off, p + off, ko + off, po + off, tc, tot, n, tiles, shift, bits);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

// keys/keys_out: (b, n) raw unsigned words of word_bytes (1, 2 or 4) bytes;
// perm/perm_out: (b, n) int32; counts: (b, 2^bits) int32 or nullptr;
// scratch: b·2^bits·(ceil(n / tile) + 1) int32, tile == kTile.
// Retires bits [shift, shift + bits), bits <= 8.
inline int launch(const void* keys, const void* perm, void* keys_out, void* perm_out,
                  int* counts, void* scratch, int b, long long n, int shift, int bits,
                  int word_bytes, int tile, void* stream) {
    if (tile != kTile || scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (b <= 0 || n <= 0) return 0;
    if (bits < 1 || bits > 8 || shift < 0 || shift + bits > 8 * word_bytes ||
        n >= (1LL << 31)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int* s = static_cast<int*>(scratch);
    switch (word_bytes) {
        case 1:
            return launch_typed<uint8_t>(keys, perm, keys_out, perm_out, counts, s, b, n,
                                         shift, bits, st);
        case 2:
            return launch_typed<uint16_t>(keys, perm, keys_out, perm_out, counts, s, b, n,
                                          shift, bits, st);
        case 4:
            return launch_typed<uint32_t>(keys, perm, keys_out, perm_out, counts, s, b, n,
                                          shift, bits, st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace radix
}  // namespace repro

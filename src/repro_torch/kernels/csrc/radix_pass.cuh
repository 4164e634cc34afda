// The two sweeps of one stable LSB radix-2^k pass (k = bits <= 8) over raw key
// words, shared by B7 (radix_pass.cu) and B7h (radix_pass_hist.cu).
//
// digit d = (w >> shift) & (2^k - 1); a stable 2^k-way split of the row by d
// from the one-hot digit mask scans; the keys and the int32 permutation
// scattered to base[d] + rank.
//
// Design.  The Pallas kernels hold a whole row in VMEM.  The sampler's row
// (128256 bf16 keys plus the int32 permutation, 770 KB) does not fit one SM's
// 227 KB of shared memory, so here one CTA streams its row twice:
//
//   1. histogram sweep: the row is cut into one contiguous chunk per warp;
//      each warp counts the digits of its chunk (R = 2^k counters per warp);
//      the column sums are the row's bucket totals (B7h writes them out), and
//      the counters then become bucket-major exclusive offsets
//      base[d] + sum of the counts of d in the chunks before this one.
//   2. ordered sweep: each warp walks its chunk in order, 32 keys at a time.
//      The within-bucket rank of a key is the exclusive scan of its bucket's
//      one-hot mask over those 32 lanes: __match_any_sync gives the mask row
//      of the key's bucket and popc(mask & lanes-below) its exclusive scan.
//      Adding the warp's running counter of that bucket gives the stable
//      destination; keys and permutation are scattered there.
//
// Both sweeps mask the ragged end of a row (lanes past n count nothing and
// write nothing), so no row is padded and every bucket total counts only the
// row's own elements.  Keys travel as raw 8/16/32-bit words; a pass never
// compares keys.
//
// Bound.  The pass moves each key and permutation entry once in and once out
// (12 B per 16-bit key, 16 B per 32-bit key), so it is bound by bytes.  One
// CTA per row leaves most SMs idle at a batch of 4, and the second sweep
// re-reads the keys (from L2).  The multi-CTA version (per-tile histograms, a
// bucket-major scan across CTAs, then the scatter) is later work; PERF.md has
// its time.
#pragma once

#include "common.cuh"

namespace repro {
namespace radix {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// counts: (b, 2^bits) int32 bucket totals, or nullptr to export nothing.
template <typename W>
__global__ void __launch_bounds__(kThreads)
radix_pass_kernel(const W* __restrict__ keys, const int* __restrict__ perm,
                  W* __restrict__ keys_out, int* __restrict__ perm_out,
                  int* __restrict__ counts, long long n, int shift, int bits) {
    extern __shared__ int cnt[];             // [kWarps][R] counters, then [R] totals
    const int radix = 1 << bits;
    int* total = cnt + kWarps * radix;
    const unsigned dmask = (1u << bits) - 1u;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned lanes_below = (1u << lane) - 1u;
    const long long off = static_cast<long long>(blockIdx.x) * n;
    keys += off;
    perm += off;
    keys_out += off;
    perm_out += off;

    // each warp owns one contiguous chunk of the row, a multiple of 32 long
    const long long per = ((n + kWarps - 1) / kWarps + 31) / 32 * 32;
    const long long lo = warp * per;
    const long long hi = min(n, lo + per);

    for (int i = threadIdx.x; i < kWarps * radix; i += blockDim.x) cnt[i] = 0;
    __syncthreads();

    // 1. histogram sweep: per-warp digit counts
    int* my = cnt + warp * radix;
    for (long long base = lo; base < hi; base += 32) {
        const long long i = base + lane;
        const bool valid = i < hi;
        const unsigned d = valid ? (static_cast<unsigned>(keys[i]) >> shift) & dmask : 0xffffffffu;
        const unsigned peers = __match_any_sync(kFullMask, d);
        if (valid && (peers & lanes_below) == 0) my[d] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();

    // bucket totals (exported by B7h), then their exclusive bases, then
    // bucket-major offsets
    for (int r = threadIdx.x; r < radix; r += blockDim.x) {
        int t = 0;
        for (int w = 0; w < kWarps; ++w) t += cnt[w * radix + r];
        total[r] = t;
        if (counts != nullptr) counts[static_cast<long long>(blockIdx.x) * radix + r] = t;
    }
    __syncthreads();
    if (warp == 0) {
        const int q = (radix + 31) / 32;
        const int r0 = min(lane * q, radix);
        const int r1 = min(r0 + q, radix);
        int loc = 0;
        for (int r = r0; r < r1; ++r) loc += total[r];
        const int incl = warp_inclusive_scan(loc, lane);
        int run = incl - loc;
        for (int r = r0; r < r1; ++r) {
            const int v = total[r];
            total[r] = run;                  // exclusive bucket base
            run += v;
        }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < radix; r += blockDim.x) {
        int run = total[r];
        for (int w = 0; w < kWarps; ++w) {
            const int c = cnt[w * radix + r];
            cnt[w * radix + r] = run;
            run += c;
        }
    }
    __syncthreads();

    // 2. ordered sweep: stable ranks from the one-hot mask scans, then scatter
    for (long long base = lo; base < hi; base += 32) {
        const long long i = base + lane;
        const bool valid = i < hi;
        W k = 0;
        int p = 0;
        unsigned d = 0xffffffffu;
        if (valid) {
            k = keys[i];
            p = perm[i];
            d = (static_cast<unsigned>(k) >> shift) & dmask;
        }
        const unsigned peers = __match_any_sync(kFullMask, d);
        int dest = 0;
        if (valid) dest = my[d] + __popc(peers & lanes_below);
        __syncwarp();
        if (valid && (peers & lanes_below) == 0) my[d] += __popc(peers);
        __syncwarp();
        if (valid) {
            keys_out[dest] = k;
            perm_out[dest] = p;
        }
    }
}

template <typename W>
int launch_typed(const void* keys, const void* perm, void* keys_out, void* perm_out,
                 int* counts, int b, long long n, int shift, int bits, cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(kWarps + 1) * (1u << bits) * sizeof(int);
    radix_pass_kernel<W><<<b, kThreads, smem, stream>>>(
        static_cast<const W*>(keys), static_cast<const int*>(perm), static_cast<W*>(keys_out),
        static_cast<int*>(perm_out), counts, n, shift, bits);
    return static_cast<int>(cudaGetLastError());
}

// keys/keys_out: (b, n) raw unsigned words of word_bytes (1, 2 or 4) bytes;
// perm/perm_out: (b, n) int32; counts: (b, 2^bits) int32 or nullptr.
// Retires bits [shift, shift + bits), bits <= 8.
inline int launch(const void* keys, const void* perm, void* keys_out, void* perm_out,
                  int* counts, int b, long long n, int shift, int bits, int word_bytes,
                  void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (bits < 1 || bits > 8 || shift < 0 || shift + bits > 8 * word_bytes) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (word_bytes) {
        case 1:
            return launch_typed<uint8_t>(keys, perm, keys_out, perm_out, counts, b, n, shift,
                                         bits, st);
        case 2:
            return launch_typed<uint16_t>(keys, perm, keys_out, perm_out, counts, b, n, shift,
                                          bits, st);
        case 4:
            return launch_typed<uint32_t>(keys, perm, keys_out, perm_out, counts, b, n, shift,
                                          bits, st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace radix
}  // namespace repro

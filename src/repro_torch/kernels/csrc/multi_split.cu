// B6 — the stable multi-way split of a row by its digits (radix-2^k SplitInd).
//
// Replaces the Pallas TPU kernel src/repro/kernels/split_mm.py::_multi_split_kernel
// (body _multisplit_body, launched by multi_split_tiles): per row, the payload
// and its original index grouped by an int32 digit in [0, R), buckets in
// ascending order and the original order kept inside each, with the (R,)
// bucket counts.  The Pallas kernel scans the (rows, R, s) one-hot digit
// masks with one batched A @ U_s contraction and pads the row with digit
// R - 1, then subtracts the padding from the last count.
//
// Design.  B7's (radix_pass.cu) with the digit read instead of extracted and
// any R >= 1: one CTA per row, the row cut into one contiguous chunk per warp
// and streamed twice.
//
//   1. histogram sweep: each warp counts the digits of its chunk (R + 1
//      counters a warp); the bucket totals are the counts, and the counters
//      become bucket-major exclusive offsets;
//   2. ordered sweep: each warp walks its chunk in order, 32 elements at a
//      time; __match_any_sync gives the lanes of a key's bucket and
//      popc(peers & lanes-below) its rank among them, which with the warp's
//      running counter is the stable destination.
//
// The ragged end of a row is masked here, so the counts are exact with no
// padding.  A digit outside [0, R) goes to an extra bucket R after all the
// others, in order, and is not counted: the outputs stay a permutation and
// nothing is written out of bounds.  (The Pallas kernel gives such a digit
// no bucket, so its element lands on index 0.)  Payloads move as raw words of
// their element size (1, 2, 4 or 8 bytes).  The counters take
// (warps + 1)(R + 1) ints of shared memory: 32 warps up to R = 1760, fewer
// for larger R, down to one warp at R = 29055, the largest R taken.
//
// Bound.  Each element is read (payload and digit) and written (payload and
// index) once: 16 B per element for fp32 payloads, bound by bytes; the second
// sweep re-reads the digits (8 B more).  One CTA per row leaves most SMs idle
// at small batch, as B5 and B7 do; a multi-CTA split is later work.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;
constexpr int kMaxSmem = 232448;              // 227 KB, the most a block may use

template <typename W>
__global__ void __launch_bounds__(32 * kMaxWarps)
multi_split_kernel(const W* __restrict__ x, const int* __restrict__ digits,
                   W* __restrict__ z, int* __restrict__ ind, int* __restrict__ counts,
                   long long n, int radix) {
    extern __shared__ int cnt[];             // [warps][radix + 1] counters, then totals
    const int warps = blockDim.x >> 5;
    const int slots = radix + 1;             // slot radix: digits outside [0, radix)
    int* total = cnt + warps * slots;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned lanes_below = (1u << lane) - 1u;
    const long long row = blockIdx.x;
    x += row * n;
    digits += row * n;
    z += row * n;
    ind += row * n;

    // each warp owns one contiguous chunk of the row, a multiple of 32 long
    const long long per = ((n + warps - 1) / warps + 31) / 32 * 32;
    const long long lo = warp * per;
    const long long hi = min(n, lo + per);

    for (int i = threadIdx.x; i < warps * slots; i += blockDim.x) cnt[i] = 0;
    __syncthreads();

    // 1. histogram sweep: per-warp bucket counts
    int* my = cnt + warp * slots;
    for (long long base = lo; base < hi; base += 32) {
        const long long i = base + lane;
        const bool valid = i < hi;
        unsigned d = 0xffffffffu;
        if (valid) {
            const int v = digits[i];
            d = (v >= 0 && v < radix) ? static_cast<unsigned>(v) : static_cast<unsigned>(radix);
        }
        const unsigned peers = __match_any_sync(repro::kFullMask, d);
        if (valid && (peers & lanes_below) == 0) my[d] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();

    // bucket totals (the counts), then their exclusive bases, then
    // bucket-major offsets for each warp's chunk
    for (int r = threadIdx.x; r < slots; r += blockDim.x) {
        int t = 0;
        for (int w = 0; w < warps; ++w) t += cnt[w * slots + r];
        total[r] = t;
        if (r < radix) counts[row * radix + r] = t;
    }
    __syncthreads();
    if (warp == 0) {
        const int q = (slots + 31) / 32;
        const int r0 = min(lane * q, slots);
        const int r1 = min(r0 + q, slots);
        int loc = 0;
        for (int r = r0; r < r1; ++r) loc += total[r];
        const int incl = repro::warp_inclusive_scan(loc, lane);
        int run = incl - loc;
        for (int r = r0; r < r1; ++r) {
            const int v = total[r];
            total[r] = run;                  // exclusive bucket base
            run += v;
        }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < slots; r += blockDim.x) {
        int run = total[r];
        for (int w = 0; w < warps; ++w) {
            const int c = cnt[w * slots + r];
            cnt[w * slots + r] = run;
            run += c;
        }
    }
    __syncthreads();

    // 2. ordered sweep: stable ranks from the bucket peers, then scatter
    for (long long base = lo; base < hi; base += 32) {
        const long long i = base + lane;
        const bool valid = i < hi;
        W v = 0;
        unsigned d = 0xffffffffu;
        if (valid) {
            v = x[i];
            const int dv = digits[i];
            d = (dv >= 0 && dv < radix) ? static_cast<unsigned>(dv) : static_cast<unsigned>(radix);
        }
        const unsigned peers = __match_any_sync(repro::kFullMask, d);
        int dest = 0;
        if (valid) dest = my[d] + __popc(peers & lanes_below);
        __syncwarp();
        if (valid && (peers & lanes_below) == 0) my[d] += __popc(peers);
        __syncwarp();
        if (valid) {
            z[dest] = v;
            ind[dest] = static_cast<int>(i);
        }
    }
}

template <typename W>
int launch(const void* x, const void* digits, void* z, void* ind, void* counts, int b,
           long long n, int radix, cudaStream_t stream) {
    const int slots = radix + 1;
    const int warps = min(kMaxWarps, kMaxSmem / (4 * slots) - 1);
    if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(warps + 1) * slots * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(multi_split_kernel<W>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    multi_split_kernel<W><<<b, 32 * warps, smem, stream>>>(
        static_cast<const W*>(x), static_cast<const int*>(digits), static_cast<W*>(z),
        static_cast<int*>(ind), static_cast<int*>(counts), n, radix);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, z: (b, n) payload words of word_bytes (1, 2, 4 or 8) bytes; digits, ind:
// (b, n) int32; counts: (b, radix) int32.  n < 2^31, 1 <= radix <= 29055.
extern "C" int repro_multi_split(const void* x, const void* digits, void* z, void* ind,
                                 void* counts, int b, long long n, int radix, int word_bytes,
                                 void* stream) {
    if (radix < 1 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    if (b <= 0 || n <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (word_bytes) {
        case 1: return launch<uint8_t>(x, digits, z, ind, counts, b, n, radix, st);
        case 2: return launch<uint16_t>(x, digits, z, ind, counts, b, n, radix, st);
        case 4: return launch<uint32_t>(x, digits, z, ind, counts, b, n, radix, st);
        case 8: return launch<unsigned long long>(x, digits, z, ind, counts, b, n, radix, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// B5 — SplitInd, the stable two-way split of a row by a mask (paper §5).
//
// Replaces the Pallas TPU kernel src/repro/kernels/split_mm.py::_split_kernel
// (body _splitind_body, launched by split_tiles): per row, the exclusive scan
// ex of the 0/1 flags, n_true = the number of flagged elements, and the
// payload and its original index scattered to
//
//     dest = ex              for a flagged element (trues first, in order)
//     dest = n_true + i - ex for an unflagged one (falses after, in order)
//
// with n_true written out.
//
// Design.  The Pallas kernel holds the whole row in VMEM; a 2^24-element row
// does not fit one SM.  This is B7's design (radix_pass.cu) with two buckets:
// one CTA per row cuts the row into one contiguous chunk per warp and streams
// it twice.
//
//   1. counting sweep: each warp counts the flags of its chunk, 32 at a time
//      (__ballot_sync + popc); one warp scans the 32 chunk counts into each
//      chunk's trues-before and the row's n_true.
//   2. ordered sweep: each warp walks its chunk in order, 32 elements at a
//      time.  popc(ballot & lanes-below) is the exclusive scan of the mask over
//      those 32 lanes; with the warp's running count of trues it gives ex, and
//      the payload and the int32 index are scattered to dest.
//
// The mask scan is integer and exact.  Payloads move as raw words of their
// element size (1, 2, 4 or 8 bytes), so every dtype works.  Flags are bytes
// read as true where non-zero (the wrapper passes torch.bool).  The ragged
// end of a row is masked here; nothing is padded.
//
// Bound.  Each flag and payload element is read once and each payload element
// and index written once: 13 B per element for fp32 payloads and bool flags,
// so it is bound by bytes.  One CTA per row leaves most SMs idle at small
// batch, and the second sweep re-reads the flags; a multi-CTA split (chunk
// counts scanned across CTAs, then the scatter) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <typename W>
__global__ void __launch_bounds__(kThreads)
split_kernel(const W* __restrict__ x, const uint8_t* __restrict__ flags, W* __restrict__ z,
             int* __restrict__ ind, int* __restrict__ n_true_out, long long n) {
    __shared__ int chunk_base[kWarps];      // trues in the chunks before each warp's
    __shared__ int n_true_sh;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned lanes_below = (1u << lane) - 1u;
    const long long row = blockIdx.x;
    x += row * n;
    flags += row * n;
    z += row * n;
    ind += row * n;

    // each warp owns one contiguous chunk of the row, a multiple of 32 long
    const long long per = ((n + kWarps - 1) / kWarps + 31) / 32 * 32;
    const long long lo = warp * per;
    const long long hi = min(n, lo + per);

    // 1. counting sweep
    int count = 0;
    for (long long base = lo; base < hi; base += 32) {
        const long long i = base + lane;
        const bool f = i < hi && flags[i] != 0;
        count += __popc(__ballot_sync(repro::kFullMask, f));
    }
    if (lane == 0) chunk_base[warp] = count;
    __syncthreads();
    if (warp == 0) {
        const int c = chunk_base[lane];
        const int incl = repro::warp_inclusive_scan(c, lane);
        chunk_base[lane] = incl - c;
        if (lane == kWarps - 1) n_true_sh = incl;
    }
    __syncthreads();
    const long long n_true = n_true_sh;

    // 2. ordered sweep: ex from the ballot's exclusive scan, then the scatter
    long long trues = chunk_base[warp];
    for (long long base = lo; base < hi; base += 32) {
        const long long i = base + lane;
        const bool valid = i < hi;
        const bool f = valid && flags[i] != 0;
        const unsigned bal = __ballot_sync(repro::kFullMask, f);
        if (valid) {
            const long long ex = trues + __popc(bal & lanes_below);
            const long long dest = f ? ex : n_true + i - ex;
            z[dest] = x[i];
            ind[dest] = static_cast<int>(i);
        }
        trues += __popc(bal);
    }
    if (threadIdx.x == 0) n_true_out[row] = static_cast<int>(n_true);
}

template <typename W>
int launch(const void* x, const void* flags, void* z, void* ind, void* n_true, int b,
           long long n, cudaStream_t stream) {
    split_kernel<W><<<b, kThreads, 0, stream>>>(
        static_cast<const W*>(x), static_cast<const uint8_t*>(flags), static_cast<W*>(z),
        static_cast<int*>(ind), static_cast<int*>(n_true), n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, z: (b, n) payload words of word_bytes (1, 2, 4 or 8) bytes; flags: (b, n)
// bytes, true where non-zero; ind: (b, n) int32; n_true: (b,) int32.
// n < 2^31.
extern "C" int repro_split(const void* x, const void* flags, void* z, void* ind,
                           void* n_true, int b, long long n, int word_bytes, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (word_bytes) {
        case 1: return launch<uint8_t>(x, flags, z, ind, n_true, b, n, st);
        case 2: return launch<uint16_t>(x, flags, z, ind, n_true, b, n, st);
        case 4: return launch<uint32_t>(x, flags, z, ind, n_true, b, n, st);
        case 8: return launch<unsigned long long>(x, flags, z, ind, n_true, b, n, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

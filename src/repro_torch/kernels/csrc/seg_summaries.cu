// B10 — the block summaries of the segmented §4 pipeline (phase 1).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/segscan_mm.py::_seg_summary_kernel (launched by
// seg_block_summaries): for each block of block_len consecutive elements of a
// row, the sum of the elements at or after the block's last flag (the whole
// block if it has none), in the accumulation dtype, and whether the block
// holds a flag, (b, n) -> two (b, nb).  Together they are the block's value
// under the segmented-pair operator that B11 scans,
//
//     (a ⊕ b) = (b.h ? b.v : a.v + b.v,  a.h | b.h)        (seg_tile.cuh)
//
// Design.  One CTA per (row, block) on a flat grid.x of b * nb CTAs (nb can
// pass grid.y's 65535), walking the block backwards from its end in rounds
// of kThreads runs and stopping after the round that holds the block's last
// flag: nothing before that round can lie in the trailing segment.  A thread
// takes one run of kRun = 16 consecutive elements a round: one 16-byte load
// of their flag bytes, then the 16-byte loads of their values (four for
// fp32, two for 16-bit types, one for 8-bit) that hold an element at or
// after the run's last flag; words before it are neither loaded nor added.
// The next round's loads are issued before the current round is folded, so a
// round's loads are in flight across the barrier that decides whether to
// stop.  The run folds in registers to (sum from its last flag on,
// has-flag); a warp's 32 runs combine under ⊕ by shuffles in a fixed tree
// (lane l takes lane l + d as its right operand, d = 1, 2, .., 16); the
// warps' pairs combine in warp order into the round's pair; and the walk
// puts each round on the left of what it has, acc = round ⊕ acc.  The order
// never changes and a stop changes no bit (once acc holds a flag, round ⊕ acc
// = acc), so integers (int32) are exact and fp32 gives the same bits on every
// call.  Flags are bytes, nonzero = a segment start; the has-flag output is
// 0 or 1.  The ragged end of a row, and a row whose start is not 16-byte
// aligned, take element loads here; nothing is padded or copied.
//
// Bound.  Both outputs depend only on the block's trailing segment, its last
// flag and what follows it (the whole block if it has none), so the function
// needs that segment's flag bytes and values and writes 8 B a block: 5 B a
// trailing fp32 element plus 8 B a block, bound by bytes (chip_smoke.py counts
// this run's trailing elements).  The walk reads whole rounds from the block's
// end down to the one that holds the last flag, and one round more (the
// prefetch): at most two rounds' flags and values past the bound a block.  A
// forward sweep would read every flag byte of the block and every value after
// each run's last flag, whatever the layout of the flags.  The walk, the 256
// threads a CTA and the skip of values before a run's last flag were chosen
// by timing the options on an H100 (repro_seg_summaries_design below, timed by
// chip_smoke.py's time_seg; PERF.md §6): the walk beat the sweep where blocks
// hold flags and matched it where they hold none (its barrier a round hides
// behind the next round's loads); 128 and 512 threads were slower; the skip
// measured within the spread between runs on every layout of flags.
#include "seg_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                      // elements a thread a round

template <typename A>
struct Pair {
    A v;
    int h;
};

template <typename A>
__device__ __forceinline__ Pair<A> seg_op(Pair<A> a, Pair<A> b) {
    return {b.h ? b.v : a.v + b.v, a.h | b.h};
}

// The run's values at p, avail of them in range, in the accumulator type:
// zero before `first` (its last flag, 0 if none) and at or past avail.  One
// 16-byte load a word that holds an element at or after `first` when the run
// is whole and aligned, else element by element.
template <typename T, typename A>
__device__ __forceinline__ void load_run(const T* __restrict__ p, long long avail, int first,
                                         A (&v)[kRun]) {
    constexpr int kPer = 16 / sizeof(T);      // elements a 16-byte word
    if (avail >= kRun && (reinterpret_cast<uintptr_t>(p) % 16) == 0) {
#pragma unroll
        for (int c = 0; c < kRun / kPer; ++c) {
            uint4 raw = make_uint4(0u, 0u, 0u, 0u);
            if ((c + 1) * kPer > first) raw = reinterpret_cast<const uint4*>(p)[c];
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int u = 0; u < kPer; ++u) v[c * kPer + u] = repro::to_acc(e[u], A(0));
        }
    } else {
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
            v[k] = (k >= first && k < avail) ? repro::to_acc(p[k], A(0)) : A(0);
        }
    }
}

// The 32 lanes' pairs folded in lane order; the result is lane 0's.
template <typename A>
__device__ __forceinline__ Pair<A> warp_fold(Pair<A> p, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Pair<A> o{__shfl_down_sync(repro::kFullMask, p.v, d),
                        __shfl_down_sync(repro::kFullMask, p.h, d)};
        if (lane + d < 32) p = seg_op(p, o);
    }
    return p;
}

// A thread's run of a round: its flag bits and its values from its last flag on.
template <typename A>
struct Run {
    unsigned bits;
    A v[kRun];
};

template <bool kSkip, typename T, typename A>
__device__ __forceinline__ void load_round(const T* __restrict__ xr,
                                           const uint8_t* __restrict__ fr, long long i0,
                                           long long hi, Run<A>& r) {
    r.bits = repro::load_flag_bits<kRun>(fr + i0, hi - i0);
    load_run<T, A>(xr + i0, hi - i0, kSkip && r.bits ? 31 - __clz(r.bits) : 0, r.v);
}

// The design's options, kept so that the comparison which chose them can be run
// again (repro_seg_summaries_design): kMax threads a CTA at most; kFromEnd walks
// the block from its end and stops after the round of its last flag, else one
// forward sweep folds every round; kSkip loads no value word before a run's
// last flag.
template <typename T, typename A, int kMax = kThreads, bool kFromEnd = true, bool kSkip = true>
__global__ void __launch_bounds__(kMax)
seg_summaries_kernel(const T* __restrict__ x, const uint8_t* __restrict__ f,
                     long long fstride, A* __restrict__ ts, int* __restrict__ hb, long long n,
                     int nb, long long block_len) {
    __shared__ A v_sh[2][kMax / 32];               // the warps' pairs, two rounds apart
    __shared__ int h_sh[2][kMax / 32];
    const long long cta = blockIdx.x;
    const long long row = cta / nb;
    const long long lo = (cta - row * nb) * block_len;
    const long long hi = min(n, lo + block_len);
    const T* xr = x + row * n;
    const uint8_t* fr = f + row * fstride;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const long long round = static_cast<long long>(blockDim.x) * kRun;
    const long long mine = lo + static_cast<long long>(threadIdx.x) * kRun;

    Pair<A> acc{A(0), 0};
    const long long last = (hi - lo + round - 1) / round - 1;
    long long k = kFromEnd ? last : 0;
    Run<A> cur;
    load_round<kSkip, T, A>(xr, fr, mine + k * round, hi, cur);
    for (int buf = 0;; buf ^= 1) {
        const bool more = kFromEnd ? k > 0 : k < last;
        const long long k_next = kFromEnd ? k - 1 : k + 1;
        Run<A> next;
        if (more) load_round<kSkip, T, A>(xr, fr, mine + k_next * round, hi, next);
        A run = A(0);
#pragma unroll
        for (int j = 0; j < kRun; ++j) run = ((cur.bits >> j) & 1u) ? cur.v[j] : run + cur.v[j];
        const Pair<A> wp = warp_fold(Pair<A>{run, cur.bits != 0 ? 1 : 0}, lane);
        if (lane == 0) {
            v_sh[buf][warp] = wp.v;
            h_sh[buf][warp] = wp.h;
        }
        __syncthreads();
        Pair<A> rp{A(0), 0};
        for (int w = 0; w < nwarps; ++w) rp = seg_op(rp, Pair<A>{v_sh[buf][w], h_sh[buf][w]});
        acc = kFromEnd ? seg_op(rp, acc) : seg_op(acc, rp);
        if ((kFromEnd && acc.h) || !more) break;        // the same on every thread
        cur = next;
        k = k_next;
    }
    if (threadIdx.x == 0) {
        ts[cta] = acc.v;
        hb[cta] = acc.h;
    }
}

// Threads for a block of block_len: a run a thread, whole warps, at most kMax
// (segscan_mm.seg_summaries_geometry mirrors it for kThreads).
int threads_for(long long block_len, int kMax) {
    long long t = ((block_len + kRun - 1) / kRun + 31) / 32 * 32;
    return static_cast<int>(t < kMax ? t : kMax);
}

template <typename T, typename A, int kMax = kThreads, bool kFromEnd = true, bool kSkip = true>
int launch(const void* x, const void* f, long long fstride, void* ts, void* hb, int b,
           long long n, int nb, long long block_len, cudaStream_t stream) {
    seg_summaries_kernel<T, A, kMax, kFromEnd, kSkip>
        <<<static_cast<unsigned>(b) * nb, threads_for(block_len, kMax), 0, stream>>>(
            static_cast<const T*>(x), static_cast<const uint8_t*>(f), fstride,
            static_cast<A*>(ts), static_cast<int*>(hb), n, nb, block_len);
    return static_cast<int>(cudaGetLastError());
}

bool valid(int b, long long n, long long fstride, int nb, long long block_len) {
    return (fstride == 0 || fstride == n) && block_len >= 1 &&
           nb == (n + block_len - 1) / block_len &&
           static_cast<long long>(b) * nb <= 0x7fffffffLL;
}

}  // namespace

// x: (b, n) contiguous values; f: flag bytes, row r at f + r * fstride
// (fstride 0 or n); ts: (b, nb) in the accumulation dtype; hb: (b, nb) int32;
// nb = ceil(n / block_len).  dtype: 0 fp32, 1 bf16, 2 fp16 (fp32 sums);
// 3 int8, 4 uint8, 5 int16, 6 int32 (int32 sums).
extern "C" int repro_seg_summaries(const void* x, const void* f, long long fstride, void* ts,
                                   void* hb, int b, long long n, int nb, long long block_len,
                                   int dtype, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (!valid(b, n, fstride, nb, block_len)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float, float>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 1:
            return launch<__nv_bfloat16, float>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 2: return launch<__half, float>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 3: return launch<int8_t, int>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 4: return launch<uint8_t, int>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 5: return launch<int16_t, int>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        case 6: return launch<int32_t, int>(x, f, fstride, ts, hb, b, n, nb, block_len, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The same function on fp32 values with the design's options changed, so that
// they can be compared on the card (chip_smoke.py's time_seg): threads (128,
// 256 or 512) a CTA at most; from_end 0 sweeps every round forwards; skip 0
// loads every value word.  threads 256, from_end 1, skip 1 is
// repro_seg_summaries itself.
extern "C" int repro_seg_summaries_design(const void* x, const void* f, long long fstride,
                                          void* ts, void* hb, int b, long long n, int nb,
                                          long long block_len, int threads, int from_end,
                                          int skip, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (!valid(b, n, fstride, nb, block_len) || ((from_end | skip) & ~1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int key = threads * 4 + from_end * 2 + skip;
    switch (key) {
        case 128 * 4 + 3: return launch<float, float, 128>(x, f, fstride, ts, hb, b, n, nb,
                                                           block_len, st);
        case 256 * 4 + 3: return launch<float, float, 256>(x, f, fstride, ts, hb, b, n, nb,
                                                           block_len, st);
        case 512 * 4 + 3: return launch<float, float, 512>(x, f, fstride, ts, hb, b, n, nb,
                                                           block_len, st);
        case 256 * 4 + 1: return launch<float, float, 256, false>(x, f, fstride, ts, hb, b, n,
                                                                  nb, block_len, st);
        case 512 * 4 + 1: return launch<float, float, 512, false>(x, f, fstride, ts, hb, b, n,
                                                                  nb, block_len, st);
        case 256 * 4 + 2: return launch<float, float, 256, true, false>(x, f, fstride, ts, hb,
                                                                        b, n, nb, block_len,
                                                                        st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

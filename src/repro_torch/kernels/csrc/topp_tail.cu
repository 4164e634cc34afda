// B8 — the fused top-p (nucleus) sampling tail, one thread-block cluster a row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/split_mm.py::_topp_kernel
// (launched by topp_mask_sample_tiles).  Per row of probabilities sorted in
// descending order, with one uniform u per row:
//
//     cum  = cumsum(sp);  cut = (cum - sp) > p;  masked = cut ? 0 : sp
//     cdf  = cumsum(masked);  theta = u * cdf[n-1]
//     j    = min(#(cdf < theta), n-1)
//
// and only the int32 j leaves the kernel.  The rows need not be sorted: j stays
// a count, as in the Pallas kernel.
//
// Design.  A row is one cluster of kCluster CTAs (Hopper's thread-block
// clusters: the CTAs of a cluster run at once on neighbouring SMs, read each
// other's shared memory and meet at one barrier).  The row is cut into slices
// of `slice` elements (ceil(n / kCluster) rounded up to 4), rank r of the
// cluster owning slice r, so every CTA holds its slice in shared memory and
// the row is read from device memory once: cp.async copies of 16 bytes, the
// head and tail of a slice that is off 16-byte alignment in 4-byte copies
// (nothing is padded or copied by the wrapper, which passes the row stride).
// Each CTA then scans its slice in a fixed tree: a thread's run of `items`
// consecutive elements in order (an odd count, so the runs' reads from shared
// memory hit distinct banks), the threads' totals across the lanes by warp
// shuffles, and the warps' totals by a second shuffle scan in every warp.  A
// CTA has the fewest of 256, 512 and 1024 threads whose runs stay within
// kMaxItems elements (256 at n = 128256, runs of 63): fewer threads meet at
// their barriers sooner (measured by the design entry point below), and the
// cap bounds the rounding count stated below.
// That gives the slice's sum S_r; after a cluster barrier each CTA folds
// S_0 ... S_{r-1}, read from its peers' shared memory, left to right into its
// prefix of cum.  It masks its slice in place, scans the masked values the
// same way, and after a second barrier has its prefix of cdf.  The CTA that
// owns element n-1 publishes that element's own cdf value; after a third
// barrier every CTA forms theta, counts cdf < theta over its slice with the
// same arithmetic, and adds its count into rank 0's shared memory; after a
// fourth, rank 0 writes the clipped count.  Rows whose slices would not fit
// a CTA's shared memory (more than kCluster x kMaxSlice elements) are walked
// in rounds of kCluster slices of kMaxSlice, twice, as the Pallas kernel's
// grid would: the first walk finds cdf[n-1], the second recomputes the same
// sums and counts; the prefixes pass from round to round in the same
// left-to-right fold.  Every call makes the same operations in the same
// order, so it returns the same index.  split_mm._topp_tail_cluster repeats
// the arithmetic in PyTorch, operation for operation.
//
// Rounding band.  The sums are fp32 and taken in another order than
// torch.cumsum's (or jnp.cumsum's).  A prefix here passes through at most
// (items - 1) + 5 + 5 + (slices - 1) + 2 roundings (a thread's run, the lane
// and warp shuffle scans, the fold of the slices before it, and the two adds
// that join them), each off by at most u = 2^-24 of the row's mass S: 81 u S
// at n = 128256 (items 63, 8 slices) and at most that on any row of one round,
// 89 u S at n = 2^20 (items 55, 24 slices); the one-CTA walk this replaces
// took 47 u S at n = 128256.  So the kernel and its plain
// version pick the same j whenever theta lies farther than BAND = 2^-16 S =
// 256 u S from every cdf value and every (cum - sp) lies farther than BAND
// from p; within that band the cut or the sample may move, but only across the
// tokens whose fp64 cut or CDF value lies inside the band.  The checks hold
// the kernel's index on every row to that window of tokens, and to the one
// right index where the window holds one.
//
// Bound.  Each probability is read once, 4 B per element: 2 MB at the
// sampler's (4, 128256), 0.6 us at 3.35 TB/s.  What bounds the kernel is
// latency: one launch, one 64 KB copy a CTA and four cluster barriers, on 32
// SMs at the sampler's batch of 4 (the one-CTA walk used 4 SMs and 64
// dependent chunk steps).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;            // CTAs a row (the portable cluster size)
constexpr int kMaxItems = 63;          // a thread's run, where 1024 threads allow it
constexpr long long kMaxSlice = 55296; // elements a CTA holds (216 KB of shared memory)

struct TailShared {
    float warp_tot[2][32];             // the warps' totals of the cum and cdf scans
    float slice_sum;                   // S_r
    float masked_sum;                  // M_r
    float last_cdf;                    // cdf[n-1], on the rank that owns it
    unsigned count;                    // rank 0: the cluster's count
};

// Elements of a slice, and the rounds of kCluster slices, for rows of n.
struct Geometry {
    long long slice, rounds;
};

Geometry geometry(long long n, int cluster) {
    long long per = (n + cluster - 1) / cluster;
    per = (per + 3) / 4 * 4;
    const long long slice = per < kMaxSlice ? per : kMaxSlice;
    return {slice, (n + cluster * slice - 1) / (cluster * slice)};
}

// Threads a CTA for slices of `slice`: the fewest of 256, 512 and 1024 whose
// runs (ceil(slice / threads), made odd) hold at most kMaxItems elements.
int threads_for(long long slice) {
    for (int t = 256; t < 1024; t *= 2) {
        if (((slice + t - 1) / t | 1) <= kMaxItems) return t;
    }
    return 1024;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}

// Copy g[0, len) into shared memory, whole aligned 16-byte words as such and
// the ragged head and tail element by element.  Element j lands at
// buf[shift + j]; returns shift (the elements before g in its 16-byte word).
// Ends with a barrier.
__device__ __forceinline__ int load_slice(float* buf, const float* g, long long len) {
    const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
    float* dst = buf + shift;
    long long head = (4 - shift) & 3;
    if (head > len) head = len;
    const long long words = (len - head) / 4;
    const long long tail = head + 4 * words;
    for (long long w = threadIdx.x; w < words; w += blockDim.x) {
        cp_async16(dst + head + 4 * w, g + head + 4 * w);
    }
    if (threadIdx.x < head) cp_async4(dst + threadIdx.x, g + threadIdx.x);
    if (tail + threadIdx.x < len) cp_async4(dst + tail + threadIdx.x, g + tail + threadIdx.x);
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_all;" ::: "memory");
    __syncthreads();
    return shift;
}

// The thread's place in its slice's fixed tree: from the thread's run total,
// its exclusive prefix across the lanes (lex) and its warp's exclusive prefix
// across the warps (pw), and the slice's total.  One barrier, after the warps'
// totals are written; every warp scans them itself.
__device__ __forceinline__ void slice_tree(float run, float* warp_tot, float& pw, float& lex,
                                           float& total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const float inc = repro::warp_inclusive_scan(run, lane);
    lex = __shfl_up_sync(repro::kFullMask, inc, 1);
    if (lane == 0) lex = 0.0f;
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    const float winc = repro::warp_inclusive_scan(lane < nwarps ? warp_tot[lane] : 0.0f, lane);
    pw = __shfl_sync(repro::kFullMask, winc, warp > 0 ? warp - 1 : 0);
    if (warp == 0) pw = 0.0f;
    total = __shfl_sync(repro::kFullMask, winc, nwarps - 1);
}

// The strict left-to-right fold of the slices before this rank's in the round,
// onto carry (the fold of every earlier round's slices): the rank's prefix;
// carry becomes the fold of the whole round.  `field` selects S or M in the
// peers' shared memory.  Every lane of every warp computes the same chain.
__device__ __forceinline__ float fold_peers(cg::cluster_group& cluster, TailShared& sh,
                                            float TailShared::*field, float& carry) {
    const int lane = threadIdx.x & 31;
    const int ranks = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const float mine = lane < ranks ? cluster.map_shared_rank(&sh, lane)->*field : 0.0f;
    float prefix = carry;
    for (int q = 0; q < ranks; ++q) {
        if (q == rank) prefix = carry;
        carry = carry + __shfl_sync(repro::kFullMask, mine, q);
    }
    return prefix;
}

template <int kT>
__global__ void __launch_bounds__(kT)
topp_tail_kernel(const float* __restrict__ sp, long long stride, const float* __restrict__ u,
                 int* __restrict__ out, long long n, float p, long long slice,
                 long long rounds) {
    extern __shared__ __align__(16) float buf[];       // slice + 4 elements
    __shared__ TailShared sh;
    cg::cluster_group cluster = cg::this_cluster();
    const int ranks = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const long long row = blockIdx.x / ranks;
    const float* s = sp + row * stride;
    long long items = (slice + kT - 1) / kT;
    items |= 1;
    const long long r0 = static_cast<long long>(threadIdx.x) * items;
    const bool fit = rounds == 1;
    // the rank and thread whose run ends the row
    const int last_rank = static_cast<int>(((n - 1) / slice) % ranks);
    const long long last_j = (n - 1) % slice;
    if (rank == 0 && threadIdx.x == 0) sh.count = 0u;

    float theta = 0.0f;
    float base2 = 0.0f;                                 // the thread's cdf base
    int shift = 0;
    unsigned count = 0;
    for (int walk = 0; walk < 2; ++walk) {
        float carry_cum = 0.0f, carry_cdf = 0.0f;
        for (long long k = 0; k < rounds; ++k) {
            const long long lo = (k * ranks + rank) * slice;
            long long len = n - lo;
            len = len < 0 ? 0 : (len > slice ? slice : len);
            const long long hi = r0 + items < len ? r0 + items : len;
            if (walk == 0 || !fit) {
                if (k > 0) __syncthreads();             // the last round's reads are done
                shift = load_slice(buf, s + lo, len);
                float* v = buf + shift;
                // cum: the thread's run, then the tree and the fold of the slices
                float run = 0.0f;
                for (long long j = r0; j < hi; ++j) run = run + v[j];
                float pw, lex, tot;
                slice_tree(run, sh.warp_tot[0], pw, lex, tot);
                if (threadIdx.x == 0) sh.slice_sum = tot;
                cluster.sync();
                const float pre = fold_peers(cluster, sh, &TailShared::slice_sum, carry_cum);
                const float base = (pre + pw) + lex;
                // the cut, in place, and the masked run
                float l = 0.0f, mrun = 0.0f;
                for (long long j = r0; j < hi; ++j) {
                    const float x = v[j];
                    l = l + x;
                    const float m = ((base + l) - x) > p ? 0.0f : x;
                    v[j] = m;
                    mrun = mrun + m;
                }
                slice_tree(mrun, sh.warp_tot[1], pw, lex, tot);
                if (threadIdx.x == 0) sh.masked_sum = tot;
                cluster.sync();
                const float mpre = fold_peers(cluster, sh, &TailShared::masked_sum, carry_cdf);
                base2 = (mpre + pw) + lex;
                if (walk == 0 && k == rounds - 1 && rank == last_rank && r0 <= last_j &&
                    last_j < r0 + items) {
                    sh.last_cdf = base2 + mrun;         // cdf[n-1], the element's own value
                }
            }
            if (walk == 1) {
                const float* v = buf + shift;
                float l = 0.0f;
                for (long long j = r0; j < hi; ++j) {
                    l = l + v[j];
                    count += (base2 + l) < theta ? 1u : 0u;
                }
            }
        }
        if (walk == 0) {
            cluster.sync();
            theta = u[row] * cluster.map_shared_rank(&sh, last_rank)->last_cdf;
        }
    }

    // j = #(cdf < theta), clipped to [0, n - 1], summed in rank 0's shared memory
    const unsigned wc = __reduce_add_sync(repro::kFullMask, count);
    if ((threadIdx.x & 31) == 0 && wc) atomicAdd(cluster.map_shared_rank(&sh.count, 0), wc);
    cluster.sync();
    if (rank == 0 && threadIdx.x == 0) {
        const long long tot = sh.count;
        out[row] = static_cast<int>(tot < n - 1 ? tot : n - 1);
    }
}

template <int kT>
int launch(const void* sp, long long stride, const void* u, void* out, int b, long long n,
           float p, int cluster, cudaStream_t stream) {
    const Geometry g = geometry(n, cluster);
    constexpr int kMaxBytes = static_cast<int>((kMaxSlice + 4) * sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        topp_tail_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(b) * cluster));
    cfg.blockDim = dim3(kT);
    cfg.dynamicSmemBytes = static_cast<size_t>((g.slice + 4) * sizeof(float));
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, topp_tail_kernel<kT>, static_cast<const float*>(sp), stride,
                             static_cast<const float*>(u), static_cast<int*>(out), n, p,
                             g.slice, g.rounds);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* sp, long long stride, const void* u, void* out, int b, long long n,
             float p, int threads, int cluster, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (cluster < 1 || cluster > 8 || stride < 0 ||
        static_cast<long long>(b) * cluster > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (threads) {
        case 256: return launch<256>(sp, stride, u, out, b, n, p, cluster, st);
        case 512: return launch<512>(sp, stride, u, out, b, n, p, cluster, st);
        case 1024: return launch<1024>(sp, stride, u, out, b, n, p, cluster, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// sorted_p: (b, n) fp32, row r at sorted_p + r * stride elements (unit element
// stride; any 4-byte alignment); u: (b,) fp32; out: (b,) int32.
extern "C" int repro_topp_tail(const void* sorted_p, long long stride, const void* u,
                               void* out, int b, long long n, float p, void* stream) {
    if (n <= 0) return 0;
    return dispatch(sorted_p, stride, u, out, b, n, p, threads_for(geometry(n, kCluster).slice),
                    kCluster, stream);
}

// The same with the design's options: threads a CTA (256, 512 or 1024) and
// CTAs a cluster (1 to 8).  The shipped kernel is (threads_for(slice), kCluster).
extern "C" int repro_topp_tail_design(const void* sorted_p, long long stride, const void* u,
                                      void* out, int b, long long n, float p, int threads,
                                      int cluster, void* stream) {
    return dispatch(sorted_p, stride, u, out, b, n, p, threads, cluster, stream);
}

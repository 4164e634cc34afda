// B2 — the block sums of the §4 blocked scan pipeline (phase 1, "vector
// recompute"), and, through a second entry point, B3's carry scan run inside
// the same launch.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/scan_pipeline.py::_block_sums_kernel (launched by
// block_partial_sums): the sum of each block of `block_len` consecutive
// elements of a row, in the accumulation dtype, (b, n) -> (b, nb).
//
// Bound.  Each input element is read once and one value per block written, so
// it is bound by bytes: 4 B per fp32 element, 1 B per int8 element.  To keep
// HBM busy a thread needs many bytes in flight, which scalar loads of 1 byte
// (int8) or 4 (fp32) never give.
//
// Design.  A block is summed by a team of L lanes, L the least power of two
// (at most 256) whose kUnroll 16-byte words a lane cover the block's bytes: a
// block of 256 B (int8 at s = 16, one tile a block) is 4 lanes, one of 2 KB a
// warp, one of 512 KB (the default geometry's fp32 block) the whole CTA.  A
// CTA of 256 threads holds 256 / L teams on consecutive (row, block) pairs of
// a flat grid (nb can pass grid.y's 65535 limit: s = 16, one tile a block at
// n = 2^24 gives nb = 65536), so a short block costs a few lanes, not a warp
// or a CTA of its own.  The block's bytes from its first 16-byte boundary to
// its last are read as 16-byte words through the read-only path
// (ld.global.nc.v4), kUnroll = 4 independent words a lane a round, 64 B a
// thread in flight; its head before that boundary and its tail after the last
// are read as scalars, so a row whose start is not 16-byte aligned (n odd,
// say) needs no copy.  Words are summed by type: int8/uint8 by __dp4a against
// 0x01010101 into int32, int16 in pairs, bf16/fp16 widened by the intrinsics,
// int32/fp32 as they are.  A lane keeps one sum a word slot; shuffles within
// the team's lanes, then the team's warps in order, reduce them.  Every sum is
// so taken in one fixed order, and repeated calls give the same bits.  Integer
// sums wrap in int32 like the JAX reduction; fp32 sums are taken in another
// order than XLA's.  The ragged end of a row is masked here: elements at or
// past n count as zero.
//
// Fused carries (repro_block_sums_carries).  After writing its block sums a
// CTA takes, for each row it touched (one thread a row), tickets from that
// row's int32 counter with an acquire-release atomic, as many as the blocks it
// summed there.  The CTA that takes a row's last ticket reads the row's nb
// sums through L2 and runs B3's walk over them (carry_row.cuh), in B3's
// chunking, so the carries are bit for bit carry_scan's of the same sums
// whichever CTA comes last.  The counters are the caller's scratch, zeroed
// here on the launch's stream.
#include "carry_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                     // 16-byte words a lane has in flight

// acc plus the sum of the elements of T packed in one 16-byte word
__device__ __forceinline__ float add_word(float acc, uint4 w, float) {
    return acc + ((__uint_as_float(w.x) + __uint_as_float(w.y)) +
                  (__uint_as_float(w.z) + __uint_as_float(w.w)));
}
__device__ __forceinline__ float bf16_pair(unsigned u) {
    return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu))) +
           __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u >> 16)));
}
__device__ __forceinline__ float add_word(float acc, uint4 w, __nv_bfloat16) {
    return acc + ((bf16_pair(w.x) + bf16_pair(w.y)) + (bf16_pair(w.z) + bf16_pair(w.w)));
}
__device__ __forceinline__ float f16_pair(unsigned u) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(u & 0xffffu))) +
           __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
}
__device__ __forceinline__ float add_word(float acc, uint4 w, __half) {
    return acc + ((f16_pair(w.x) + f16_pair(w.y)) + (f16_pair(w.z) + f16_pair(w.w)));
}
__device__ __forceinline__ int add_word(int acc, uint4 w, int8_t) {
    constexpr int kOnes = 0x01010101;
    acc = __dp4a(static_cast<int>(w.x), kOnes, acc);
    acc = __dp4a(static_cast<int>(w.y), kOnes, acc);
    acc = __dp4a(static_cast<int>(w.z), kOnes, acc);
    return __dp4a(static_cast<int>(w.w), kOnes, acc);
}
__device__ __forceinline__ int add_word(int acc, uint4 w, uint8_t) {
    constexpr unsigned kOnes = 0x01010101u;
    unsigned a = static_cast<unsigned>(acc);
    a = __dp4a(w.x, kOnes, a);
    a = __dp4a(w.y, kOnes, a);
    a = __dp4a(w.z, kOnes, a);
    return static_cast<int>(__dp4a(w.w, kOnes, a));
}
__device__ __forceinline__ int i16_pair(unsigned u) {
    return static_cast<int>(static_cast<short>(u & 0xffffu)) + (static_cast<int>(u) >> 16);
}
__device__ __forceinline__ int add_word(int acc, uint4 w, int16_t) {
    return acc + ((i16_pair(w.x) + i16_pair(w.y)) + (i16_pair(w.z) + i16_pair(w.w)));
}
__device__ __forceinline__ int add_word(int acc, uint4 w, int32_t) {
    return acc + ((static_cast<int>(w.x) + static_cast<int>(w.y)) +
                  (static_cast<int>(w.z) + static_cast<int>(w.w)));
}

// This thread's share of x[e0, e1): a strided slice of the 16-byte words
// (kUnroll at a time) plus a strided slice of the scalar head and tail.
template <typename T, typename A>
__device__ __forceinline__ A team_share(const T* __restrict__ x, long long e0, long long e1,
                                        int tid, int nthreads) {
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(x + e0);
    const uintptr_t a1 = reinterpret_cast<uintptr_t>(x + e1);
    const uintptr_t w0 = (a0 + 15) & ~static_cast<uintptr_t>(15);
    const uintptr_t w1 = a1 & ~static_cast<uintptr_t>(15);
    long long head_end = e1, tail_begin = e1, words = 0;
    if (w0 < w1) {
        head_end = e0 + static_cast<long long>((w0 - a0) / sizeof(T));
        tail_begin = e0 + static_cast<long long>((w1 - a0) / sizeof(T));
        words = static_cast<long long>((w1 - w0) / 16);
    }
    const uint4* wp = reinterpret_cast<const uint4*>(w0);
    A part[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) part[k] = A(0);
    long long i = tid;
    for (; i + (kUnroll - 1) * static_cast<long long>(nthreads) < words;
         i += kUnroll * static_cast<long long>(nthreads)) {
        uint4 w[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) w[k] = __ldg(wp + i + k * nthreads);
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) part[k] = add_word(part[k], w[k], T());
    }
    for (; i < words; i += nthreads) part[0] = add_word(part[0], __ldg(wp + i), T());
    A acc = part[0];
#pragma unroll
    for (int k = 1; k < kUnroll; ++k) acc = acc + part[k];
    for (long long e = e0 + tid; e < head_end; e += nthreads) {
        acc = acc + repro::to_acc(x[e], A(0));
    }
    for (long long e = tail_begin + tid; e < e1; e += nthreads) {
        acc = acc + repro::to_acc(x[e], A(0));
    }
    return acc;
}

// *p += v at device scope, returning the old value.  Release: the CTA's sums,
// ordered before this thread by the barrier, are visible to whoever takes a
// later ticket; acquire: the sums of the CTAs that took earlier ones are
// visible to this CTA after the next barrier (the walk reads them from L2).
__device__ __forceinline__ int ticket(int* p, int v) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
                 : "=r"(old) : "l"(p), "r"(v) : "memory");
    return old;
}

template <typename T, typename A, bool kCarries>
__global__ void __launch_bounds__(kThreads)
block_sums_kernel(const T* __restrict__ x, A* sums, A* carries, int* tickets, long long n,
                  int nb, long long block_len, int log_team, int teams) {
    __shared__ A warp_sum[kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int team_threads = 1 << log_team;
    const int per_cta = kThreads >> log_team;
    const int slot = threadIdx.x >> log_team;
    const int tid = threadIdx.x & (team_threads - 1);
    // b * nb < 2^31 (the entry checks it), so 32-bit index arithmetic
    const unsigned t0 = blockIdx.x * static_cast<unsigned>(per_cta);
    const unsigned t = t0 + slot;
    A acc = A(0);
    if (t < static_cast<unsigned>(teams)) {
        const unsigned row = t / static_cast<unsigned>(nb);
        const long long lo = static_cast<long long>(t - row * nb) * block_len;
        const long long hi = min(n, lo + block_len);
        acc = team_share<T, A>(x, row * n + lo, row * n + hi, tid, team_threads);
    }
    // within a warp, lanes t and t ^ d of one team; then the team's warps in order
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        if (d < team_threads) acc = acc + __shfl_xor_sync(repro::kFullMask, acc, d);
    }
    if (team_threads > 32) {
        if (lane == 0) warp_sum[warp] = acc;
        __syncthreads();
        if (tid == 0) {
            for (int k = 1; k < (team_threads >> 5); ++k) acc = acc + warp_sum[warp + k];
        }
    }
    if (tid == 0 && t < static_cast<unsigned>(teams)) sums[t] = acc;
    if constexpr (kCarries) {
        // a thread a row this CTA touched takes that row's tickets, one a block
        // summed here; the CTA with a row's last ticket walks the row
        __shared__ unsigned char last[kThreads];
        __shared__ A scratch[repro::kCarryScratch];
        const unsigned t1 = min(static_cast<unsigned>(teams), t0 + per_cta);
        const unsigned r0 = t0 / static_cast<unsigned>(nb);
        const int rows = static_cast<int>((t1 - 1) / static_cast<unsigned>(nb) - r0) + 1;
        __syncthreads();
        if (threadIdx.x < rows) {
            const unsigned r = r0 + threadIdx.x;
            const unsigned lo = max(t0, r * nb), hi = min(t1, (r + 1) * nb);
            const int cnt = static_cast<int>(hi - lo);
            last[threadIdx.x] = ticket(tickets + r, cnt) + cnt == nb;
        }
        __syncthreads();
        for (int k = 0; k < rows; ++k) {
            if (last[k]) {
                const long long r = r0 + k;
                repro::carry_row<A, kThreads, true>(sums + r * nb, carries + r * nb, nb,
                                                    scratch);
            }
        }
    }
}

template <typename T, typename A, bool kCarries>
int launch(const void* x, void* sums, void* carries, int* tickets, int b, long long n,
           int nb, long long block_len, cudaStream_t stream) {
    // the least team, in lanes, whose kUnroll words a lane cover the block
    const long long words = (block_len * static_cast<long long>(sizeof(T)) + 15) / 16;
    int log_team = 0;
    while ((1 << log_team) < kThreads && (static_cast<long long>(kUnroll) << log_team) < words) {
        ++log_team;
    }
    const long long teams = static_cast<long long>(b) * nb;
    const int per_cta = kThreads >> log_team;
    const long long grid = (teams + per_cta - 1) / per_cta;
    if (kCarries) {
        const cudaError_t e = cudaMemsetAsync(tickets, 0, sizeof(int) * b, stream);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    block_sums_kernel<T, A, kCarries><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<A*>(sums), static_cast<A*>(carries), tickets,
        n, nb, block_len, log_team, static_cast<int>(teams));
    return static_cast<int>(cudaGetLastError());
}

template <bool kCarries>
int dispatch(const void* x, void* sums, void* carries, int* tickets, int b, long long n,
             int nb, long long block_len, int dtype, cudaStream_t st) {
    switch (dtype) {
        case 0: return launch<float, float, kCarries>(x, sums, carries, tickets, b, n, nb,
                                                      block_len, st);
        case 1: return launch<__nv_bfloat16, float, kCarries>(x, sums, carries, tickets, b, n,
                                                              nb, block_len, st);
        case 2: return launch<__half, float, kCarries>(x, sums, carries, tickets, b, n, nb,
                                                       block_len, st);
        case 3: return launch<int8_t, int, kCarries>(x, sums, carries, tickets, b, n, nb,
                                                     block_len, st);
        case 4: return launch<uint8_t, int, kCarries>(x, sums, carries, tickets, b, n, nb,
                                                      block_len, st);
        case 5: return launch<int16_t, int, kCarries>(x, sums, carries, tickets, b, n, nb,
                                                      block_len, st);
        case 6: return launch<int32_t, int, kCarries>(x, sums, carries, tickets, b, n, nb,
                                                      block_len, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

bool bad_geometry(int b, long long n, int nb, long long block_len) {
    return block_len < 1 || nb != (n + block_len - 1) / block_len ||
           static_cast<long long>(b) * nb > 0x7fffffffLL;
}

}  // namespace

// x: (b, n) contiguous input; sums: (b, nb) contiguous, nb = ceil(n / block_len).
// dtype: 0 fp32, 1 bf16, 2 fp16 (fp32 sums); 3 int8, 4 uint8, 5 int16, 6 int32
// (int32 sums).
extern "C" int repro_block_sums(const void* x, void* sums, int b, long long n, int nb,
                                long long block_len, int dtype, void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (bad_geometry(b, n, nb, block_len)) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<false>(x, sums, nullptr, nullptr, b, n, nb, block_len, dtype,
                           static_cast<cudaStream_t>(stream));
}

// As repro_block_sums, and carries: (b, nb) contiguous gets the exclusive
// prefix of each row of sums, as repro_carry_scan computes it.  tickets: the
// caller's scratch of at least b int32 counters (tickets_bytes), zeroed here.
extern "C" int repro_block_sums_carries(const void* x, void* sums, void* carries,
                                        void* tickets, long long tickets_bytes, int b,
                                        long long n, int nb, long long block_len, int dtype,
                                        void* stream) {
    if (b <= 0 || n <= 0) return 0;
    if (bad_geometry(b, n, nb, block_len) ||
        tickets_bytes < static_cast<long long>(sizeof(int)) * b) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return dispatch<true>(x, sums, carries, static_cast<int*>(tickets), b, n, nb, block_len,
                          dtype, static_cast<cudaStream_t>(stream));
}

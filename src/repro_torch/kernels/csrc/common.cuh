// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is a plain C interface built by nvcc into its own
// shared object and loaded with ctypes (no PyTorch headers).  Each entry point
// launches on the stream it is given and returns cudaGetLastError() as an int;
// the Python wrapper raises when it is not 0, using repro_error_string().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// Element -> accumulator conversions (int8/int16/uint8/int32 -> int32,
// bf16/fp16/fp32 -> fp32), spelled with the intrinsics.
__device__ __forceinline__ float to_acc(float v, float) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v, float) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(__half v, float) { return __half2float(v); }
__device__ __forceinline__ int to_acc(int8_t v, int) { return static_cast<int>(v); }
__device__ __forceinline__ int to_acc(uint8_t v, int) { return static_cast<int>(v); }
__device__ __forceinline__ int to_acc(int16_t v, int) { return static_cast<int>(v); }
__device__ __forceinline__ int to_acc(int32_t v, int) { return v; }

// Inclusive scan of one value per lane across a full warp (Hillis-Steele).
template <typename A>
__device__ __forceinline__ A warp_inclusive_scan(A v, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        A o = __shfl_up_sync(kFullMask, v, d);
        if (lane >= d) v = v + o;
    }
    return v;
}

// Block-wide exclusive scan of one value per thread, in thread order, for a
// block of kWarps full warps.  scratch holds 2 * kWarps + 1 values; total gets
// the block's sum.  Ends with a barrier, so scratch may be reused at once.
template <typename A, int kWarps>
__device__ __forceinline__ A block_exclusive_scan(A v, A* scratch, A& total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const A incl = warp_inclusive_scan(v, lane);
    if (lane == 31) scratch[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const A w = lane < kWarps ? scratch[lane] : A(0);
        const A wi = warp_inclusive_scan(w, lane);
        A we = __shfl_up_sync(kFullMask, wi, 1);
        if (lane == 0) we = A(0);
        if (lane < kWarps) scratch[kWarps + lane] = we;
        if (lane == kWarps - 1) scratch[2 * kWarps] = wi;
    }
    __syncthreads();
    A lane_ex = __shfl_up_sync(kFullMask, incl, 1);
    if (lane == 0) lane_ex = A(0);
    const A ex = scratch[kWarps + warp] + lane_ex;
    total = scratch[2 * kWarps];
    __syncthreads();
    return ex;
}

// Vector words of the loads below.
template <int B> struct VecWord;
template <> struct VecWord<16> { using type = uint4; };
template <> struct VecWord<8> { using type = uint2; };

// v[j] = p[j] for j < min(cnt, avail), else 0, in the accumulator type.  When
// all N are wanted and p is aligned, as 16-byte (or N * sizeof(T)-byte) loads.
template <typename T, typename A, int N>
__device__ __forceinline__ void load_items(const T* __restrict__ p, int cnt, long long avail,
                                           A (&v)[N]) {
    constexpr int kBytes = N * sizeof(T) < 16 ? N * sizeof(T) : 16;
    constexpr int kPer = kBytes / sizeof(T);
    using W = typename VecWord<kBytes>::type;
    if (cnt == N && avail >= N && (reinterpret_cast<uintptr_t>(p) % kBytes) == 0) {
#pragma unroll
        for (int c = 0; c < N / kPer; ++c) {
            const W raw = reinterpret_cast<const W*>(p)[c];
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int u = 0; u < kPer; ++u) v[c * kPer + u] = to_acc(e[u], A(0));
        }
    } else {
#pragma unroll
        for (int j = 0; j < N; ++j) v[j] = (j < cnt && j < avail) ? to_acc(p[j], A(0)) : A(0);
    }
}

// p[j] = v[j] for j < min(cnt, avail); 16-byte stores when whole and aligned.
template <typename A, int N>
__device__ __forceinline__ void store_items(A* __restrict__ p, int cnt, long long avail,
                                            const A (&v)[N]) {
    constexpr int kPer = 16 / sizeof(A);
    if (N % kPer == 0 && cnt == N && avail >= N &&
        (reinterpret_cast<uintptr_t>(p) % 16) == 0) {
#pragma unroll
        for (int c = 0; c < N / kPer; ++c) {
            uint4 raw;
            A* e = reinterpret_cast<A*>(&raw);
#pragma unroll
            for (int u = 0; u < kPer; ++u) e[u] = v[c * kPer + u];
            reinterpret_cast<uint4*>(p)[c] = raw;
        }
    } else {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            if (j < cnt && j < avail) p[j] = v[j];
        }
    }
}

// Bytes of shared memory a lane stages N elements in (4-byte accumulators;
// 16 bytes of padding keep a warp's 16-byte accesses free of bank conflicts).
template <int N>
__host__ __device__ constexpr int stage_stride() {
    return N * 4 + 16;
}

// Coalesced load of a warp's 32 * N consecutive elements at p into `stage`
// (32 * stage_stride<N>() bytes of shared memory), converted to the
// accumulator type: lane l's row holds p[l * N .. l * N + N).  Elements at or
// past `avail` (counted from p) read as zero.  The warp reads whole 16-byte
// (or N * sizeof(T)-byte) words in address order when the range is whole and
// aligned, else one element a lane at a time, still in address order.
template <typename T, typename A, int N>
__device__ __forceinline__ void warp_stage_in(const T* __restrict__ p, long long avail,
                                              unsigned char* stage, int lane) {
    static_assert(sizeof(A) == 4 && N % 4 == 0, "4-byte accumulators, 16-byte lane rows");
    constexpr int kStride = stage_stride<N>();
    constexpr int kBytes = N * sizeof(T) < 16 ? N * sizeof(T) : 16;
    constexpr int kPer = kBytes / sizeof(T);  // elements a word
    using W = typename VecWord<kBytes>::type;
    if (avail >= 32 * N && (reinterpret_cast<uintptr_t>(p) % kBytes) == 0) {
#pragma unroll
        for (int i = 0; i < N / kPer; ++i) {
            const int c = lane + 32 * i;
            const W raw = reinterpret_cast<const W*>(p)[c];
            const T* e = reinterpret_cast<const T*>(&raw);
            const int first = c * kPer;
            A* dst = reinterpret_cast<A*>(stage + (first / N) * kStride) + first % N;
#pragma unroll
            for (int u = 0; u < kPer; u += 4) {
                uint4 out;
                A* o = reinterpret_cast<A*>(&out);
#pragma unroll
                for (int w = 0; w < 4; ++w) o[w] = to_acc(e[u + w], A(0));
                *reinterpret_cast<uint4*>(dst + u) = out;
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const int e = lane + 32 * i;
            reinterpret_cast<A*>(stage + (e / N) * kStride)[e % N] =
                e < avail ? to_acc(p[e], A(0)) : A(0);
        }
    }
    __syncwarp();
}

// Lane `lane`'s row of the staging area into v.
template <typename A, int N>
__device__ __forceinline__ void stage_row(const unsigned char* stage, int lane, A (&v)[N]) {
    const A* mine = reinterpret_cast<const A*>(stage + lane * stage_stride<N>());
#pragma unroll
    for (int j = 0; j < N; j += 4) {
        const uint4 raw = *reinterpret_cast<const uint4*>(mine + j);
        const A* e = reinterpret_cast<const A*>(&raw);
#pragma unroll
        for (int w = 0; w < 4; ++w) v[j + w] = e[w];
    }
}

// The converse: lane l's v goes to p[l * N .. l * N + N), elements at or past
// `avail` are not written; the warp writes in address order.
template <typename A, int N>
__device__ __forceinline__ void warp_store_staged(A* __restrict__ p, long long avail,
                                                  unsigned char* stage, int lane,
                                                  const A (&v)[N]) {
    static_assert(sizeof(A) == 4 && N % 4 == 0, "4-byte accumulators, 16-byte lane rows");
    constexpr int kStride = stage_stride<N>();
    A* mine = reinterpret_cast<A*>(stage + lane * kStride);
#pragma unroll
    for (int j = 0; j < N; j += 4) {
        uint4 raw;
        A* e = reinterpret_cast<A*>(&raw);
#pragma unroll
        for (int w = 0; w < 4; ++w) e[w] = v[j + w];
        *reinterpret_cast<uint4*>(mine + j) = raw;
    }
    __syncwarp();
    if (avail >= 32 * N && (reinterpret_cast<uintptr_t>(p) % 16) == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
            const int c = lane + 32 * i;
            const int first = 4 * c;
            reinterpret_cast<uint4*>(p)[c] = *reinterpret_cast<const uint4*>(
                reinterpret_cast<const A*>(stage + (first / N) * kStride) + first % N);
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const int e = lane + 32 * i;
            if (e < avail) p[e] = reinterpret_cast<const A*>(stage + (e / N) * kStride)[e % N];
        }
    }
    __syncwarp();
}

}  // namespace repro

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

}  // namespace repro

// The column walk shared by B13 (linrec_scan.cu) and B16 (linrec_block_scan.cu):
// the linear recurrence y_t = a_t * y_{t-1} + b_t along a short scan axis that
// is not the last, walked where it lies.
//
// Moving such an axis last to scan rows costs more than the scan: for the
// SSD's cross-chunk states, (4, 16, 64, 64, 64) along axis 1 with a decay
// shared by each (64, 64) state, it transposes b, writes the broadcast a at
// full size and transposes y back, ~190 MB of copies around a walk that reads
// and writes 128 MB, and a 16-long row leaves all but 2 lanes of a warp idle.
//
// Here the operands are an (outer, n, inner) view with the inner axes
// contiguous: element (o, s, i) of b is b[o * b_so + s * b_sn + i], of a
// a[o * a_so + s * a_sn + (i / group) * a_sg] (a decay shared by `group`
// consecutive inner elements, as the SSD's is over its (N, P) state, is read
// unbroadcast, and a_sn = 0 reads one decay for the whole axis), and y is
// written in the caller's layout, out[(o * n + s) * inner + i].  One thread
// walks one (o, i) column, its n pairs in order (from the end when reversed)
// with fmaf: at each step a warp's loads and stores are 32 neighbouring
// elements, 128 contiguous bytes.  The loads of eight steps are issued before
// their fmaf's.  The walk is the recurrence itself, so integer-valued pairs
// are exact, a zero of a resets the state exactly, and fp32 rounds once a step.
// An initial state init[o * i_so + i * i_si] enters as linear_scan folds it,
// b_0 + a_0 * init, rounded twice; `exclusive` stores the state entering each
// step (init, or 0, first).
//
// Bound: b read and y written once, 8 B an element, and a once: 0.040 ms for
// the SSD's 2^24 elements at 3.35 TB/s.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kColumnThreads = 256;
constexpr int kColumnSteps = 8;               // steps whose loads are in flight together

struct ColumnWalk {
    const float* a;
    const float* b;
    const float* init;                        // null: a zero state
    float* out;
    long long outer, inner, group;
    long long a_so, a_sn, a_sg, b_so, b_sn, i_so, i_si;
    int n, reverse, exclusive;
};

__device__ __forceinline__ void walk_column(const ColumnWalk& w, long long col) {
    const long long o = col / w.inner, i = col - o * w.inner;
    const float* ap = w.a + o * w.a_so + (i / w.group) * w.a_sg;
    const float* bp = w.b + o * w.b_so + i;
    float* op = w.out + o * w.n * w.inner + i;
    float y = w.init != nullptr ? w.init[o * w.i_so + i * w.i_si] : 0.f;
    for (int s0 = 0; s0 < w.n; s0 += kColumnSteps) {
        float av[kColumnSteps], bv[kColumnSteps];
#pragma unroll
        for (int k = 0; k < kColumnSteps; ++k) {
            const int s = s0 + k;
            const long long tt = w.reverse ? w.n - 1 - s : s;
            av[k] = s < w.n ? ap[tt * w.a_sn] : 0.f;
            bv[k] = s < w.n ? bp[tt * w.b_sn] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kColumnSteps; ++k) {
            const int s = s0 + k;
            if (s >= w.n) break;
            const long long tt = w.reverse ? w.n - 1 - s : s;
            const float next = s == 0 && w.init != nullptr
                                   ? __fadd_rn(bv[k], __fmul_rn(av[k], y))
                                   : fmaf(av[k], y, bv[k]);
            op[tt * w.inner] = w.exclusive ? y : next;
            y = next;
        }
    }
}

__global__ void __launch_bounds__(kColumnThreads) column_walk_kernel(const ColumnWalk w) {
    const long long col = static_cast<long long>(blockIdx.x) * kColumnThreads + threadIdx.x;
    if (col < w.outer * w.inner) walk_column(w, col);
}

// The C entry points' body: geom = {outer, n, inner, group, a_so, a_sn, a_sg,
// b_so, b_sn, i_so, i_si, reverse, exclusive}; init may be null.
inline int launch_columns(const void* a, const void* b, const void* init, void* out,
                          const long long* geom, void* stream) {
    ColumnWalk w;
    w.a = static_cast<const float*>(a);
    w.b = static_cast<const float*>(b);
    w.init = static_cast<const float*>(init);
    w.out = static_cast<float*>(out);
    w.outer = geom[0];
    w.inner = geom[2];
    w.group = geom[3];
    w.a_so = geom[4];
    w.a_sn = geom[5];
    w.a_sg = geom[6];
    w.b_so = geom[7];
    w.b_sn = geom[8];
    w.i_so = geom[9];
    w.i_si = geom[10];
    w.reverse = geom[11] != 0;
    w.exclusive = geom[12] != 0;
    if (geom[1] < 1 || geom[1] > 0x7fffffffLL || w.outer < 0 || w.inner < 1 || w.group < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    w.n = static_cast<int>(geom[1]);
    const long long blocks = (w.outer * w.inner + kColumnThreads - 1) / kColumnThreads;
    if (blocks == 0) return 0;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    column_walk_kernel<<<static_cast<unsigned>(blocks), kColumnThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(w);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

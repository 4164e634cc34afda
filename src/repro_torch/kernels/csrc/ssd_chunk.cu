// B17 — the chunked SSD scan (the gated linear recurrence of a Mamba2 layer).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk.py::_kernel
// (launched by ssd_chunk_scan).  For each (batch, head) the sequence is cut
// into chunks of Q tokens, walked in order with an (N, P) fp32 state:
//
//     cs      = a @ U_Q                         (cumsum of the log decays)
//     G       = (C B^T) ∘ L,  L[i, j] = exp(cs_i - cs_j) for j <= i, else 0
//     y       = G X + (C ∘ exp(cs)) state
//     state  <- exp(cs_Q) state + (B ∘ exp(cs_Q - cs))^T X
//
// x (B, S, H, P), a (B, S, H), b and c (B, S, H, N) are fp32; y (B, S, H, P)
// is written contiguous.  The inputs are read through their strides (the last
// axis unit-stride), so the head axis is never moved next to the batch as the
// Pallas wrapper does with moveaxis and pad.
//
// Design.  The Pallas grid (B*H, nc) walks the chunks on the TPU's ordered
// axis with the state in VMEM scratch.  A CUDA grid has no ordered axis, so
// one CTA owns one (batch, head) and walks its chunks in a loop, the state
// held in shared memory across the walk: nothing crosses CTAs.  Per chunk:
//
//   1. X, B, C and a are loaded into shared memory, rows past the sequence
//      end (a ragged last chunk, S < Q) and the padding to multiples of 4 set
//      to zero: a zero decay and a zero input leave the state unchanged, so
//      nothing is padded in device memory;
//   2. warp 0 forms cs in fp64 (each lane sums its run of a, a warp scan
//      links the runs), exp(cs) and exp(cs_Q - cs);
//   3. G on the causal half only: 4x4 register tiles of C B^T over the
//      lower-triangular tiles; the exponential is taken only for j <= i and
//      the entries above the diagonal are written as 0.  (cs falls by ~2e3
//      in a chunk under zamba2's decays, so exp(cs_i - cs_j) above the
//      diagonal is inf, and a 0/1 mask would turn inf * 0 into NaN.)
//   4. the rows of C are scaled by exp(cs) and those of B by exp(cs_Q - cs),
//      as the Pallas kernel scales them before its products;
//   5. y = G X + C' state in 4x4 register tiles, G X over j <= i only;
//   6. state = exp(cs_Q) state + B'^T X in 4x4 register tiles.
//
// Every product is true fp32 on the CUDA cores (fma), summed in order along
// the contraction: no TF32, no tensor cores.  The cumsum cs alone is kept in
// fp64: under zamba2's decays |cs| reaches ~2e3 within a chunk, where one
// fp32 ulp is 1.2e-4, and cs_i - cs_j of two such values would carry that
// into exp(cs_i - cs_j) as a relative error (the Pallas kernel's fp32 a @ U_Q
// does).  In fp64 the difference is exact to fp32 before the exponential; it
// costs Q adds and Q^2/2 subtractions a chunk.  With a_log <= 0 (decays in
// (0, 1], as Mamba2 gives) every exponential lies in [0, 1].  The kernel does
// nothing special with a positive a_log: it computes the Pallas kernel's
// formulas, so growing exponentials overflow to inf and give inf or NaN in y
// where the Pallas kernel's would; only the entries above the diagonal, which
// JAX discards with jnp.where, are never computed.
//
// Bound.  At zamba2's forward shape (B 4, S 2048, H 64, P = N = 64, Q 128) the
// kernel moves 539 MB (x, b, c, y 134 MB each, a 2 MB: 0.161 ms at
// 3.35 TB/s) and does about 2.1M multiply-adds a chunk (Q^2 N/2 + Q^2 P/2 +
// 2 Q N P), 17 GFLOP over 4096 chunks: 0.26 ms at the card's 67 TFLOP/s fp32.
// So it is bound by fp32 operations.  This first version runs one CTA of 256
// threads per (batch, head) (256 CTAs at that shape, one resident per SM for
// its ~190 KB of shared memory) with shared-memory operands; tensor-core
// tiles are not used, to keep fp32.  PERF.md has its time.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;              // 227 KB, the most a block may use

struct Dims {
    int heads, seq, p, n, q;                  // q: chunk length
    int qp, np, pp;                           // q, n, p rounded up to multiples of 4
    int ldq, ldn, ldp;                        // shared-memory row strides (padded + 4)
    long long xs[3], as[3], bs[3], cs[3];     // element strides of the b, s, h axes
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// bytes of shared memory: cs in fp64 (qp), then in fp32 X, B, C (qp rows),
// G (qp x qp), the state (np rows), exp(cs) and exp(cs_Q - cs)
__host__ inline size_t smem_bytes(const Dims& d) {
    return 8 * static_cast<size_t>(d.qp) +
           4 * (static_cast<size_t>(d.qp) * (d.ldp + 2 * d.ldn + d.ldq) +
                static_cast<size_t>(d.np) * d.ldp + 2 * static_cast<size_t>(d.qp));
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[r][c] += sum over k of a[r].k * b[k].c: four steps of a 4x4 register tile
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], const float4 (&a)[4],
                                         const float4 (&b)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float ar = comp(a[r], k);
            acc[r][0] = fmaf(ar, b[k].x, acc[r][0]);
            acc[r][1] = fmaf(ar, b[k].y, acc[r][1]);
            acc[r][2] = fmaf(ar, b[k].z, acc[r][2]);
            acc[r][3] = fmaf(ar, b[k].w, acc[r][3]);
        }
    }
}

// rows [t0, t0 + qp) of one (batch, head) slice of a (B, S, H, F) tensor into a
// [qp][ld] shared tile, zero past the sequence end, the chunk and the width f
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride_s,
                                          long long t0, int q, int seq, int f, int fp,
                                          int ld, int qp) {
    for (int i = threadIdx.x; i < qp * fp; i += kThreads) {
        const int r = i / fp, col = i - r * fp;
        const long long t = t0 + r;
        dst[r * ld + col] = (r < q && t < seq && col < f) ? src[t * stride_s + col] : 0.f;
    }
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 float* __restrict__ y, const Dims d) {
    extern __shared__ float4 smem4[];
    double* cs = reinterpret_cast<double*>(smem4);  // [qp] (qp % 4 == 0: X stays aligned)
    float* X = reinterpret_cast<float*>(cs + d.qp);  // [qp][ldp]
    float* Bs = X + d.qp * d.ldp;                 // [qp][ldn]
    float* Cs = Bs + d.qp * d.ldn;                // [qp][ldn]
    float* G = Cs + d.qp * d.ldn;                 // [qp][ldq]
    float* St = G + d.qp * d.ldq;                 // [np][ldp]
    float* ecs = St + d.np * d.ldp;               // exp(cs_i)
    float* dte = ecs + d.qp;                      // exp(cs_Q - cs_j)

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int bi = blockIdx.x / d.heads, hh = blockIdx.x - bi * d.heads;
    const float* xb = x + bi * d.xs[0] + hh * d.xs[2];
    const float* ab = a + bi * d.as[0] + hh * d.as[2];
    const float* bb = bm + bi * d.bs[0] + hh * d.bs[2];
    const float* cb = cm + bi * d.cs[0] + hh * d.cs[2];
    float* yb = y + (static_cast<long long>(bi) * d.seq * d.heads + hh) * d.p;
    const long long ys = static_cast<long long>(d.heads) * d.p;

    const int tq = d.qp / 4, tn = d.np / 4, tp = d.pp / 4;
    for (int i = tid; i < d.np * d.ldp; i += kThreads) St[i] = 0.f;

    const int nc = (d.seq + d.q - 1) / d.q;
    for (int c = 0; c < nc; ++c) {
        const long long t0 = static_cast<long long>(c) * d.q;
        // 1. the chunk's operands
        load_rows(X, xb, d.xs[1], t0, d.q, d.seq, d.p, d.pp, d.ldp, d.qp);
        load_rows(Bs, bb, d.bs[1], t0, d.q, d.seq, d.n, d.np, d.ldn, d.qp);
        load_rows(Cs, cb, d.cs[1], t0, d.q, d.seq, d.n, d.np, d.ldn, d.qp);
        for (int r = tid; r < d.qp; r += kThreads) {
            const long long t = t0 + r;
            cs[r] = (r < d.q && t < d.seq) ? ab[t * d.as[1]] : 0.0;
        }
        __syncthreads();

        // 2. cs = inclusive cumsum of a (fp64); exp(cs) and exp(cs_Q - cs)
        if (tid < 32) {
            const int per = (d.qp + 31) / 32;
            const int lo = min(lane * per, d.qp), hi = min(lo + per, d.qp);
            double run = 0.0;
            for (int i = lo; i < hi; ++i) run += cs[i];
            const double incl = repro::warp_inclusive_scan(run, lane);
            double acc = __shfl_up_sync(repro::kFullMask, incl, 1);
            if (lane == 0) acc = 0.0;
            for (int i = lo; i < hi; ++i) {
                acc += cs[i];
                cs[i] = acc;
            }
            __syncwarp();
            const double total = cs[d.q - 1];     // padding rows add zero decay
            for (int i = lane; i < d.qp; i += 32) {
                ecs[i] = expf(static_cast<float>(cs[i]));
                dte[i] = expf(static_cast<float>(total - cs[i]));
            }
        }
        __syncthreads();

        // 3. G = (C B^T) ∘ L on the lower-triangular 4x4 tiles
        for (int t = tid; t < tq * (tq + 1) / 2; t += kThreads) {
            int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
            while (ti * (ti + 1) / 2 > t) --ti;
            while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
            const int tj = t - ti * (ti + 1) / 2;
            const int i0 = 4 * ti, j0 = 4 * tj;
            float acc[4][4] = {};
            for (int k = 0; k < d.np; k += 4) {
                float4 cr[4], br[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    cr[r] = ld4(Cs + (i0 + r) * d.ldn + k);
                    br[r] = ld4(Bs + (j0 + r) * d.ldn + k);
                }
                // acc[r][s] += sum over the four k of C[i0 + r][k] * B[j0 + s][k]
#pragma unroll
                for (int r = 0; r < 4; ++r) {
#pragma unroll
                    for (int s = 0; s < 4; ++s) {
                        float v = acc[r][s];
                        v = fmaf(cr[r].x, br[s].x, v);
                        v = fmaf(cr[r].y, br[s].y, v);
                        v = fmaf(cr[r].z, br[s].z, v);
                        v = fmaf(cr[r].w, br[s].w, v);
                        acc[r][s] = v;
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = i0 + r;
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                    const int j = j0 + s;
                    G[i * d.ldq + j] =
                        j <= i ? acc[r][s] * expf(static_cast<float>(cs[i] - cs[j])) : 0.f;
                }
            }
        }
        __syncthreads();

        // 4. C <- C ∘ exp(cs), B <- B ∘ exp(cs_Q - cs), row by row
        for (int i = tid; i < d.qp * d.np; i += kThreads) {
            const int r = i / d.np, col = i - r * d.np;
            Cs[r * d.ldn + col] *= ecs[r];
            Bs[r * d.ldn + col] *= dte[r];
        }
        __syncthreads();

        // 5. y = G X + C state on 4x4 tiles of (rows, p)
        for (int t = tid; t < tq * tp; t += kThreads) {
            const int ti = t / tp, pj = t - ti * tp;
            const int i0 = 4 * ti, p0 = 4 * pj;
            float acc[4][4] = {}, acs[4][4] = {};
            for (int j = 0; j < i0 + 4; j += 4) {     // G is zero past the diagonal
                float4 gr[4], xr[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    gr[r] = ld4(G + (i0 + r) * d.ldq + j);
                    xr[r] = ld4(X + (j + r) * d.ldp + p0);
                }
                tile_fma(acc, gr, xr);
            }
            for (int k = 0; k < d.np; k += 4) {
                float4 cr[4], sr[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    cr[r] = ld4(Cs + (i0 + r) * d.ldn + k);
                    sr[r] = ld4(St + (k + r) * d.ldp + p0);
                }
                tile_fma(acs, cr, sr);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const long long tt = t0 + i0 + r;
                if (i0 + r >= d.q || tt >= d.seq) continue;
                float* yr = yb + tt * ys;
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                    if (p0 + s < d.p) yr[p0 + s] = acc[r][s] + acs[r][s];
                }
            }
        }
        __syncthreads();

        // 6. state = exp(cs_Q) state + B'^T X on 4x4 tiles of (n, p)
        const float decay = expf(static_cast<float>(cs[d.q - 1]));
        for (int t = tid; t < tn * tp; t += kThreads) {
            const int ni = t / tp, pj = t - ni * tp;
            const int n0 = 4 * ni, p0 = 4 * pj;
            float acc[4][4] = {};
            for (int j = 0; j < d.qp; ++j) {
                const float4 bv = ld4(Bs + j * d.ldn + n0);
                const float4 xv = ld4(X + j * d.ldp + p0);
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float br = comp(bv, r);
                    acc[r][0] = fmaf(br, xv.x, acc[r][0]);
                    acc[r][1] = fmaf(br, xv.y, acc[r][1]);
                    acc[r][2] = fmaf(br, xv.z, acc[r][2]);
                    acc[r][3] = fmaf(br, xv.w, acc[r][3]);
                }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                float* sr = St + (n0 + r) * d.ldp + p0;
#pragma unroll
                for (int s = 0; s < 4; ++s) sr[s] = decay * sr[s] + acc[r][s];
            }
        }
        __syncthreads();
    }
}

}  // namespace

// x: (B, S, H, P), a: (B, S, H), bm and cm: (B, S, H, N), all fp32 with the
// last axis unit-stride; strides holds the element strides of the b, s and h
// axes of x, a, bm and cm, in that order (12 values).  y: (B, S, H, P)
// contiguous.  q is the chunk length (1 <= q <= S).  Returns
// cudaErrorInvalidValue for sizes whose shared memory exceeds 227 KB.
extern "C" int repro_ssd_chunk(const void* x, const void* a, const void* bm, const void* cm,
                               void* y, int bsz, int seq, int heads, int p, int n, int q,
                               const long long* strides, void* stream) {
    if (bsz <= 0 || seq <= 0 || heads <= 0 || p <= 0 || n <= 0) return 0;
    if (q < 1 || q > seq) return static_cast<int>(cudaErrorInvalidValue);
    Dims d;
    d.heads = heads;
    d.seq = seq;
    d.p = p;
    d.n = n;
    d.q = q;
    d.qp = round4(q);
    d.np = round4(n);
    d.pp = round4(p);
    d.ldq = d.qp + 4;
    d.ldn = d.np + 4;
    d.ldp = d.pp + 4;
    for (int k = 0; k < 3; ++k) {
        d.xs[k] = strides[k];
        d.as[k] = strides[3 + k];
        d.bs[k] = strides[6 + k];
        d.cs[k] = strides[9 + k];
    }
    const size_t smem = smem_bytes(d);
    if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned ctas = static_cast<unsigned>(bsz) * static_cast<unsigned>(heads);
    ssd_chunk_kernel<<<ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(a),
        static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<float*>(y),
        d);
    return static_cast<int>(cudaGetLastError());
}

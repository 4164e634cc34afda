// B17 — the chunked SSD scan (the gated linear recurrence of a Mamba2 layer).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk.py::_kernel
// (launched by ssd_chunk_scan).  For each (batch, head) the sequence is cut
// into chunks of Q tokens, linked by an (N, P) fp32 state:
//
//     cs      = a @ U_Q                         (cumsum of the log decays)
//     G       = (C B^T) ∘ L,  L[i, j] = exp(cs_i - cs_j) for j <= i, else 0
//     y       = G X + (C ∘ exp(cs)) h_c
//     h_{c+1} = exp(cs_Q) h_c + S_c,  S_c = (B ∘ exp(cs_Q - cs))^T X
//
// x (B, S, H, P), a (B, S, H), b and c (B, S, H, N) are fp32; y (B, S, H, P)
// is written contiguous.  The inputs are read through their strides (the last
// axis unit-stride), so the head axis is never moved next to the batch as the
// Pallas wrapper does with moveaxis and pad.
//
// Design.  The Pallas grid (B*H, nc) walks the chunks on the TPU's ordered
// axis with the state in VMEM scratch.  Here every chunk has a CTA of its own
// (B*H*nc CTAs, 4096 at zamba2's forward shape), and only the state crosses
// chunks, through a depth-1 chained look-back:
//
//   1. a CTA takes its tile from lookback.cuh's atomic ticket in chunk-major
//      order (ticket t -> chunk t / (B*H), head t % (B*H)), so the chunk before
//      it took its ticket B*H tickets earlier, about one wave: it has started,
//      which gives forward progress whatever the grid, and has usually
//      finished, which hides the hand-off;
//   2. with no state yet, it stages X, B and C by 16-byte cp.async (rows past
//      the sequence end, a ragged last chunk or S < Q, and the padding of Q and
//      N to multiples of 16 and of P to 8 are zero: a zero decay and a zero
//      input leave everything unchanged), forms cs in fp64 (a warp scan a
//      32-row run, the runs linked in order), and computes
//      y_diag = G X and the chunk's own state S_c;
//   3. it waits for chunk c - 1's flag, reads that chunk's published state h_c
//      from the workspace (through L2), publishes h_{c+1} = fmaf(exp(cs_Q),
//      h_c, S_c) and raises its own flag (a barrier, then one thread's fence and
//      release store, as a grid barrier signals), then
//      adds exp(cs_i) (C h_c) to y and stores y.  The state reaches each chunk
//      through the same chain of fmaf's on every call, so y is the same bits
//      on every run, whatever order the CTAs ran in.
//
// The work of a CTA: 8 warps, each owning a 16-row strip of y (64 columns,
// the mma accumulator layout: lane (g, t) holds rows g and g + 8, columns
// 2t and 2t + 1 of each 8-column block) and up to two 16 x 32 tiles of S_c.
// G is never held whole: a warp forms its strip's G 16 x 16 block by block on
// the causal half only (the exponential taken only for j <= i: under zamba2's
// decays cs falls by ~2e3 in a chunk, so exp(cs_i - cs_j) above the diagonal is
// inf, and a 0/1 mask would turn inf * 0 into NaN), and feeds each block to
// y_diag from registers by warp shuffles.  Shared memory holds X, B and C
// (and, once X is spent, the entering state): 105 KB at Q = 128, N = P = 64,
// so two CTAs share an SM (16 warps).  Strip r of the causal half costs r + 1
// blocks, so strips are paired, r with S - 1 - r: the light strip's warp also
// takes the heavy strip's first blocks and leaves that partial sum in y for the
// heavy strip's warp to add (4 or 5 blocks a warp at Q = 128, not 1 to 8).
//
// Products.  Tensor cores by mma.sync m16n8k8 TF32 in the 3xTF32 split: each
// fp32 operand is big + small, both TF32 (split on the FP32 pipe), and a
// product is small*big + big*small + big*big (the small*small term, ~2^-22 of
// the product, is dropped), two k-steps summed in a fragment of their own and
// added to the fp32 accumulator, which keeps fp32's accuracy; a single TF32
// product (2^-11) would not.
// The cumsum cs alone is kept in fp64: under zamba2's decays |cs| reaches
// ~2e3 within a chunk, where one fp32 ulp is 1.2e-4, and cs_i - cs_j of two
// such values would carry that into exp(cs_i - cs_j) as a relative error (the
// Pallas kernel's fp32 a @ U_Q does).  With a_log <= 0 (decays in (0, 1], as
// Mamba2 gives) every exponential lies in [0, 1]; the kernel does nothing
// special with a positive a_log, so growing exponentials overflow to inf and
// give inf or NaN in y where the Pallas kernel's would.
//
// Bound.  At zamba2's forward shape (B 4, S 2048, H 64, P = N = 64, Q 128) the
// kernel moves 539 MB (x, b, c, y 134 MB each, a 2 MB: 0.161 ms at
// 3.35 TB/s), plus the workspace's states written and read once (63 MB), and
// does about 2.1M multiply-adds a chunk (Q^2 N/2 + Q^2 P/2 + 2 Q N P), 17 GFLOP
// over 4096 chunks: 0.256 ms at the card's 67 TFLOP/s fp32, 0.104 ms as three
// TF32 products at 495 TFLOP/s.
#include <cuda_pipeline.h>

#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStripBlocks = 8;               // 8-column blocks of a warp's y strip
constexpr int kStateTiles = 2;                // 16 x 32 tiles of S_c a warp holds
constexpr int kMaxSmem = 232448;              // 227 KB, the most a block may use

struct Dims {
    int heads, seq, p, n, q, nc, bh;          // q: chunk length; bh = B * H
    int qp, np, pp;                           // q, n rounded up to 16; p to 8
    int ldx, ldb;                             // shared row strides: X (and h_c), B and C
    int groups, ptiles;                       // 64-column groups of y; 32-column groups of S_c
    long long xs[3], as[3], bs[3], cs[3];     // element strides of the b, s, h axes
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// bytes of dynamic shared memory: cs in fp64 (qp), then in fp32 X (max(qp, np)
// rows: the entering state takes its place), B and C
__host__ inline size_t smem_bytes(const Dims& d) {
    return 8 * static_cast<size_t>(d.qp) +
           4 * (static_cast<size_t>(d.qp > d.np ? d.qp : d.np) * d.ldx +
                2 * static_cast<size_t>(d.qp) * d.ldb);
}

// ---- the 3xTF32 tensor-core step ----

// v rounded to nearest with 11 significant bits, a TF32 value: Veltkamp's split
// with 2^13 + 1 (fp32's 24 bits less TF32's 11), on the FP32 pipe rather than
// the conversion unit cvt.rna.tf32 runs on; the _rn intrinsics keep nvcc from
// contracting it into an fma
__device__ __forceinline__ float tf32_round(float v) {
    const float c = __fmul_rn(v, 8193.0f);
    return __fsub_rn(c, __fsub_rn(c, v));
}

struct FragA {
    unsigned big[4], small[4];
};
struct FragB {
    unsigned big[2], small[2];
};

// v = big + small, each v's part rounded to nearest TF32: big is v rounded,
// small the rest (exact in fp32) rounded, so the split is within 2^-22 of v.
// (Passing the rest whole, for the tensor core to cut to its top 19 bits,
// saves three instructions an operand but doubles that error: the fp32 SMOKE
// zamba2 forward of tests/test_torch_cuda.py then moved 3.2e-5 from the one on
// B17's plain version, past that test's 2e-5.)
__device__ __forceinline__ void split(float v, unsigned& big, unsigned& small) {
    const float hi = tf32_round(v);
    big = __float_as_uint(hi);
    small = __float_as_uint(tf32_round(__fsub_rn(v, hi)));
}

// A's fragment: a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
    FragA f;
    split(a0, f.big[0], f.small[0]);
    split(a1, f.big[1], f.small[1]);
    split(a2, f.big[2], f.small[2]);
    split(a3, f.big[3], f.small[3]);
    return f;
}

// B's fragment: b0 = (k = t, column g), b1 = (k = t + 4, column g)
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
    FragB f;
    split(b0, f.big[0], f.small[0]);
    split(b1, f.big[1], f.small[1]);
    return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a0 b0 + a1 b1 (two k-steps) in fp32 accuracy: each step's two cross
// terms, then its big * big, summed in a fragment of their own and added to c
// in fp32 (the tensor core truncates as it accumulates, so c's running sum
// never passes through it)
__device__ __forceinline__ void mma3x2(float (&c)[4], const FragA& a0, const FragB& b0,
                                       const FragA& a1, const FragB& b1) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(d, a0.small, b0.big);
    mma_tf32(d, a0.big, b0.small);
    mma_tf32(d, a0.big, b0.big);
    mma_tf32(d, a1.small, b1.big);
    mma_tf32(d, a1.big, b1.small);
    mma_tf32(d, a1.big, b1.big);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// acc (a 16-row strip of NB 8-column blocks, the first nb of them live, in the
// accumulator layout) += A B over k in [0, K), K a multiple of 16:
// A(r, k) = fa(r, k) for r < 16, B(k, col) = fb(k, col).  nb is warp-uniform.
template <int NB, class FA, class FB>
__device__ __forceinline__ void strip_product(float (&acc)[NB][4], int nb, int K, FA fa,
                                              FB fb) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int k = 0; k < K; k += 16) {
        const FragA a0 = frag_a(fa(g, k + t), fa(g + 8, k + t), fa(g, k + t + 4),
                                fa(g + 8, k + t + 4));
        const FragA a1 = frag_a(fa(g, k + 8 + t), fa(g + 8, k + 8 + t),
                                fa(g, k + 12 + t), fa(g + 8, k + 12 + t));
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            if (j < nb) {
                mma3x2(acc[j], a0, frag_b(fb(k + t, 8 * j + g), fb(k + t + 4, 8 * j + g)),
                       a1, frag_b(fb(k + 8 + t, 8 * j + g), fb(k + 12 + t, 8 * j + g)));
            }
        }
    }
}

// y (a strip's nb live blocks) += G X over one 16 x 16 block of G held in the
// accumulator layout gm (its two 8-column blocks); x: X's row j0 at the strip's
// first column.  The A operand comes from the lanes that hold it by shuffles:
// column k of a block sits in lane (g, (k & 7) / 2), element k & 1 (row g) or
// 2 + (k & 1) (row g + 8).
__device__ __forceinline__ void g_times_x(float (&acc)[kStripBlocks][4], const float (&gm)[2][4],
                                          int nb, const float* x, int ldx) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int src0 = (g << 2) | (t >> 1), src1 = src0 + 2;   // columns t and t + 4
    const bool odd = t & 1;
    FragA a[2];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
        float v[4], w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            v[e] = __shfl_sync(repro::kFullMask, gm[kb][e], src0);
            w[e] = __shfl_sync(repro::kFullMask, gm[kb][e], src1);
        }
        a[kb] = frag_a(odd ? v[1] : v[0], odd ? v[3] : v[2], odd ? w[1] : w[0],
                       odd ? w[3] : w[2]);
    }
    const float* x0 = x + t * ldx;                  // rows t, t + 4, t + 8 and t + 12
#pragma unroll
    for (int j = 0; j < kStripBlocks; ++j) {
        if (j < nb) {
            const float* xc = x0 + 8 * j + g;
            mma3x2(acc[j], a[0], frag_b(xc[0], xc[4 * ldx]), a[1],
                   frag_b(xc[8 * ldx], xc[12 * ldx]));
        }
    }
}

// Rows [0, qp) of one (batch, head) slice of a (B, S, H, F) tensor from src
// (its row 0) into a [qp][ld] shared tile: by 16-byte cp.async when F, the
// row stride and src allow, else element by element; zero at or past `rows`
// and past F up to fp.  The caller commits and waits.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long stride,
                                           int rows, int f, int fp, int ld, int qp) {
    const bool vec = f % 4 == 0 && stride % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(src) % 16 == 0;
    const int f4 = fp / 4;
    for (int i = threadIdx.x; i < qp * f4; i += kThreads) {
        const int r = i / f4, col = 4 * (i - r * f4);
        float* s = dst + r * ld + col;
        if (r < rows && col < f) {
            const float* gp = src + r * stride + col;
            if (vec) {
                __pipeline_memcpy_async(s, gp, 16);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) s[e] = col + e < f ? gp[e] : 0.f;
            }
        } else {
            *reinterpret_cast<float4*>(s) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
}

// y_diag of one 16 x 16 block: G's rows i0.. and columns j0 = 16 jb.. from C and
// B, masked to the causal half with exp(cs_i - cs_j) taken only for j <= i,
// then times X's rows j0.. into the strip's y
__device__ __forceinline__ void diag_block(float (&yacc)[kStripBlocks][4], const double* cs,
                                           const float* Cs, const float* Bs, const float* X,
                                           const Dims& d, int i0, int jb, int p0, int nb) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int j0 = 16 * jb;
    float gm[2][4] = {};
    strip_product<2>(
        gm, 2, d.np, [&](int r, int k) { return Cs[(i0 + r) * d.ldb + k]; },
        [&](int k, int col) { return Bs[(j0 + col) * d.ldb + k]; });
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + 8 * (e >> 1), j = j0 + 8 * jj + 2 * t + (e & 1);
            gm[jj][e] = j <= i ? gm[jj][e] * expf(static_cast<float>(cs[i] - cs[j])) : 0.f;
        }
    }
    g_times_x(yacc, gm, nb, X + j0 * d.ldx + p0, d.ldx);
}

// A strip's y (rows i0.. below qv, its nb column blocks from p0, below p) into
// yb (row stride ys), plus what yb holds there already when `add`
__device__ __forceinline__ void store_strip(const float (&acc)[kStripBlocks][4], float* yb,
                                            long long ys, int i0, int qv, int p0, int nb, int p,
                                            bool add) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
        const int i = i0 + g + 8 * h2;
        if (i >= qv) continue;
        float* yr = yb + i * ys;
#pragma unroll
        for (int j = 0; j < kStripBlocks; ++j) {
            const int col = p0 + 8 * j + 2 * t;
            if (j >= nb || col >= p) continue;
            float v0 = acc[j][2 * h2], v1 = acc[j][2 * h2 + 1];
            if (p % 2 == 0) {
                if (add) {
                    const float2 o = __ldcg(reinterpret_cast<const float2*>(yr + col));
                    v0 += o.x;
                    v1 += o.y;
                }
                *reinterpret_cast<float2*>(yr + col) = make_float2(v0, v1);
            } else {
                yr[col] = add ? v0 + __ldcg(yr + col) : v0;
                if (col + 1 < p) yr[col + 1] = add ? v1 + __ldcg(yr + col + 1) : v1;
            }
        }
    }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 float* __restrict__ y, const Dims d, unsigned long long* __restrict__ counter,
                 unsigned* __restrict__ flags, float* __restrict__ states) {
    extern __shared__ float4 smem4[];
    double* cs = reinterpret_cast<double*>(smem4);   // [qp] (qp % 16 == 0: X stays aligned)
    float* X = reinterpret_cast<float*>(cs + d.qp);   // [max(qp, np)][ldx]; then h_c
    float* Bs = X + (d.qp > d.np ? d.qp : d.np) * d.ldx;   // [qp][ldb]
    float* Cs = Bs + d.qp * d.ldb;                    // [qp][ldb]
    __shared__ long long slot;
    __shared__ double run_sum[4];                     // qp <= 128: four 32-row runs
    __shared__ float dte[128];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const long long tile = repro::take_tile(counter, slot);
    const int c = static_cast<int>(tile / d.bh);
    const int bh = static_cast<int>(tile - static_cast<long long>(c) * d.bh);
    const int bi = bh / d.heads, hh = bh - bi * d.heads;
    const long long t0 = static_cast<long long>(c) * d.q;
    const int qv = static_cast<int>(min(static_cast<long long>(d.q), d.seq - t0));

    // 1. the chunk's operands, and its log decays (as fp64) into cs
    stage_rows(X, x + bi * d.xs[0] + hh * d.xs[2] + t0 * d.xs[1], d.xs[1], qv, d.p, d.pp,
               d.ldx, d.qp);
    stage_rows(Bs, bm + bi * d.bs[0] + hh * d.bs[2] + t0 * d.bs[1], d.bs[1], qv, d.n, d.np,
               d.ldb, d.qp);
    stage_rows(Cs, cm + bi * d.cs[0] + hh * d.cs[2] + t0 * d.cs[1], d.cs[1], qv, d.n, d.np,
               d.ldb, d.qp);
    const float* ab = a + bi * d.as[0] + hh * d.as[2] + t0 * d.as[1];
    for (int r = tid; r < d.qp; r += kThreads) cs[r] = r < qv ? ab[r * d.as[1]] : 0.0;
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    // 2. cs = inclusive cumsum of a in fp64: a warp scans each 32-row run, then
    //    every row adds the totals of the runs before it, in order
    if (warp < (d.qp + 31) / 32) {
        const int i = 32 * warp + lane;
        double v = repro::warp_inclusive_scan(i < d.qp ? cs[i] : 0.0, lane);
        if (i < d.qp) cs[i] = v;
        if (lane == 31) run_sum[warp] = v;
    }
    __syncthreads();
    for (int i = 32 + tid; i < d.qp; i += kThreads) {
        double off = run_sum[0];
        for (int w = 1; w < i / 32; ++w) off += run_sum[w];
        cs[i] += off;
    }
    __syncthreads();
    const double total = cs[d.qp - 1];            // padding rows add zero decay

    // exp(cs_Q - cs_j), the decay from row j to the chunk's end: S_c's row scale
    for (int r = tid; r < d.qp; r += kThreads) dte[r] = expf(static_cast<float>(total - cs[r]));

    // 3. y_diag, block by block of G on the causal half.  A warp owns the y of
    //    its home strip.  With one column group the strips are paired, r with
    //    S - 1 - r: the light strip's warp also takes the heavy one's first
    //    blocks and leaves that partial sum in y, which the heavy strip's warp
    //    adds as it stores (at Q = 128, 4 or 5 blocks a warp in place of 1 to 8)
    const int strips = d.qp / 16;
    const bool has_strip = warp < strips * d.groups;
    const int home = warp / d.groups, partner = strips - 1 - home;
    const int p0 = 8 * kStripBlocks * (warp - home * d.groups);
    const int nb = min(kStripBlocks, (d.pp - p0) / 8);
    const bool paired = d.groups == 1 && partner != home;
    const int lent = paired ? (strips - 2 * min(home, partner) - 1) / 2 : 0;
    const long long ys = static_cast<long long>(d.heads) * d.p;
    float* yb = y + ((static_cast<long long>(bi) * d.seq + t0) * d.heads + hh) * d.p;
    float yacc[kStripBlocks][4] = {};
    if (has_strip) {
        if (paired && home < partner && lent > 0) {
            for (int jb = 0; jb < lent; ++jb) {
                diag_block(yacc, cs, Cs, Bs, X, d, 16 * partner, jb, p0, nb);
            }
            store_strip(yacc, yb, ys, 16 * partner, qv, p0, nb, d.p, false);
#pragma unroll
            for (int j = 0; j < kStripBlocks; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
            }
        }
        for (int jb = paired && home > partner ? lent : 0; jb <= home; ++jb) {
            diag_block(yacc, cs, Cs, Bs, X, d, 16 * home, jb, p0, nb);
        }
    }
    __syncthreads();

    // 4. S_c = (B ∘ exp(cs_Q - cs))^T X, B's rows scaled as they are read: up to
    //    two 16 x 32 tiles a warp
    const int stiles = (d.np / 16) * d.ptiles;
    float sacc[kStateTiles][4][4] = {};
#pragma unroll
    for (int u = 0; u < kStateTiles; ++u) {
        const int st = warp + kWarps * u;
        if (st < stiles) {
            const int n0 = 16 * (st / d.ptiles), q0 = 32 * (st % d.ptiles);
            strip_product<4>(
                sacc[u], min(4, (d.pp - q0) / 8), d.qp,
                [&](int r, int k) { return Bs[k * d.ldb + n0 + r] * dte[k]; },
                [&](int k, int col) { return X[k * d.ldx + q0 + col]; });
        }
    }
    __syncthreads();                              // X is spent: h_c takes its place

    // 5. the hand-off: wait for h_c, publish h_{c+1}
    float* H = X;
    if (c > 0) {
        if (tid == 0) {
            const unsigned* f = flags + static_cast<long long>(bh) * d.nc + c - 1;
            for (long long polls = 0; ld_acquire(f) == 0; ++polls) {
                if (polls > repro::kLookbackPolls) __trap();
                __nanosleep(32);
            }
        }
        __syncthreads();
        const float* src = states + (static_cast<long long>(bh) * (d.nc - 1) + c - 1) * d.n * d.p;
        const int p4 = d.pp / 4;                  // 16 bytes at a time where p allows
        for (int i = tid; i < d.np * p4; i += kThreads) {
            const int r = i / p4, col = 4 * (i - r * p4);
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < d.n && d.p % 4 == 0 && col < d.p) {
                v = __ldcg(reinterpret_cast<const float4*>(src + r * d.p + col));
            } else if (r < d.n) {
                float* ve = reinterpret_cast<float*>(&v);
#pragma unroll
                for (int e = 0; e < 4; ++e) ve[e] = col + e < d.p ? __ldcg(src + r * d.p + col + e) : 0.f;
            }
            *reinterpret_cast<float4*>(H + r * d.ldx + col) = v;
        }
        __syncthreads();
    }
    if (c + 1 < d.nc) {
        const float decay = expf(static_cast<float>(total));
        float* dst = states + (static_cast<long long>(bh) * (d.nc - 1) + c) * d.n * d.p;
#pragma unroll
        for (int u = 0; u < kStateTiles; ++u) {
            const int st = warp + kWarps * u;
            if (st >= stiles) continue;
            const int n0 = 16 * (st / d.ptiles), q0 = 32 * (st % d.ptiles);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = n0 + g + 8 * (e >> 1), col = q0 + 8 * j + 2 * t + (e & 1);
                    if (r < d.n && col < d.p) {
                        dst[r * d.p + col] =
                            c > 0 ? fmaf(decay, H[r * d.ldx + col], sacc[u][j][e]) : sacc[u][j][e];
                    }
                }
            }
        }
        __syncthreads();                          // every thread's part of h_{c+1} is out
        if (tid == 0) {
            __threadfence();                      // ... and, through the barrier, visible
            st_release(flags + static_cast<long long>(bh) * d.nc + c, 1u);
        }
    }

    // 6. y = y_diag + exp(cs_i) (C h_c), plus the partial sum a paired warp left
    if (!has_strip) return;
    const int i0 = 16 * home;
    if (c > 0) {
        float yo[kStripBlocks][4] = {};
        strip_product<kStripBlocks>(
            yo, nb, d.np, [&](int r, int k) { return Cs[(i0 + r) * d.ldb + k]; },
            [&](int k, int col) { return H[k * d.ldx + p0 + col]; });
        const float e0 = expf(static_cast<float>(cs[i0 + g]));
        const float e1 = expf(static_cast<float>(cs[i0 + g + 8]));
#pragma unroll
        for (int j = 0; j < kStripBlocks; ++j) {
            yacc[j][0] = fmaf(e0, yo[j][0], yacc[j][0]);
            yacc[j][1] = fmaf(e0, yo[j][1], yacc[j][1]);
            yacc[j][2] = fmaf(e1, yo[j][2], yacc[j][2]);
            yacc[j][3] = fmaf(e1, yo[j][3], yacc[j][3]);
        }
    }
    store_strip(yacc, yb, ys, i0, qv, p0, nb, d.p, paired && home > partner && lent > 0);
}

}  // namespace

// x: (B, S, H, P), a: (B, S, H), bm and cm: (B, S, H, N), all fp32 with the
// last axis unit-stride; strides holds the element strides of the b, s and h
// axes of x, a, bm and cm, in that order (12 values).  y: (B, S, H, P)
// contiguous, 8-byte aligned.  q is the chunk length (1 <= q <= S).  ws: the
// 16-byte aligned workspace of ws_bytes >= 16 * ceil((8 + 4 * B*H*nc) / 16) +
// 4 * B*H*(nc - 1)*N*P (nc = ceil(S / q)): the ticket counter, a flag a chunk,
// then the states the chunks hand on; the counter and the flags are zeroed here,
// on the stream, and after the launch the counter holds the number of CTAs that
// ran.  Returns
// cudaErrorInvalidValue for shapes a CTA cannot hold: more than 8 strips of
// y (ceil(q/16) * ceil(P/64)), more than 16 tiles of the state
// (ceil(N/16) * ceil(P/32)), or more than 227 KB of shared memory.
extern "C" int repro_ssd_chunk(const void* x, const void* a, const void* bm, const void* cm,
                               void* y, int bsz, int seq, int heads, int p, int n, int q,
                               const long long* strides, void* ws, long long ws_bytes, void* stream) {
    if (bsz <= 0 || seq <= 0 || heads <= 0 || p <= 0 || n <= 0) return 0;
    if (q < 1 || q > seq) return static_cast<int>(cudaErrorInvalidValue);
    Dims d;
    d.heads = heads;
    d.seq = seq;
    d.p = p;
    d.n = n;
    d.q = q;
    d.nc = (seq + q - 1) / q;
    d.qp = round_up(q, 16);
    d.np = round_up(n, 16);
    d.pp = round_up(p, 8);
    d.ldx = d.pp % 16 == 0 ? d.pp + 8 : d.pp;   // 8 (mod 16): B-operand fragments hit 32 banks
    d.ldb = d.np + 4;                           // 4 (mod 8): A-operand fragments hit 32 banks
    d.groups = (d.pp + 8 * kStripBlocks - 1) / (8 * kStripBlocks);
    d.ptiles = (d.pp + 31) / 32;
    for (int k = 0; k < 3; ++k) {
        d.xs[k] = strides[k];
        d.as[k] = strides[3 + k];
        d.bs[k] = strides[6 + k];
        d.cs[k] = strides[9 + k];
    }
    const long long bh = static_cast<long long>(bsz) * heads;
    const long long tiles = bh * d.nc;
    const size_t smem = smem_bytes(d);
    if ((d.qp / 16) * d.groups > kWarps || (d.np / 16) * d.ptiles > kWarps * kStateTiles ||
        smem > static_cast<size_t>(kMaxSmem) || tiles > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    d.bh = static_cast<int>(bh);
    const long long head = (8 + 4 * tiles + 15) / 16 * 16;   // the states start 16-byte aligned
    const long long need = head + 4 * bh * (d.nc - 1) * n * p;
    if (ws == nullptr || ws_bytes < need || reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* counter = static_cast<unsigned long long*>(ws);
    auto* flags = reinterpret_cast<unsigned*>(counter + 1);
    auto* states = reinterpret_cast<float*>(static_cast<char*>(ws) + head);
    cudaError_t err = cudaMemsetAsync(counter, 0, 8 + 4 * tiles, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_kernel<<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(a),
        static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<float*>(y), d,
        counter, flags, states);
    return static_cast<int>(cudaGetLastError());
}

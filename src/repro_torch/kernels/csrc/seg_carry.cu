// B11 — the segmented carry scan of the segmented §4 pipeline (phase 2).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segscan_mm.py::_seg_carry_kernel
// (launched by seg_carry_scan): the exclusive scan of each row of the (b, nb)
// block summaries (ts, h) under the segmented-pair operator
// (a ⊕ b) = b.h ? b.ts : a.ts + b.ts, (b, nb) -> (b, nb) in the sums' dtype.
// The carry into block i is the sum of ts from the last block before i that
// holds a flag (the first block if none) up to block i-1.  The Pallas kernel
// forms it as one masked (nb, nb) triangular contraction; at nb = 65536 that
// matrix alone would be 16 GB.
//
// Design.  As B3 (carry_scan.cu): one CTA per row walks its nb summaries in
// rounds of 1024 threads x 8 values with the segmented walk of seg_tile.cuh,
// and a running carry links the rounds in order.  Integer carries are exact
// (int32 adds wrap as the JAX contraction does); fp32 carries are direct sums
// of one segment's terms.
//
// Bound.  It moves 12 B per block (a few KB at the pipeline's usual nb), so
// it is bound by its launch and its one CTA per row, not by bytes.
#include "seg_tile.cuh"

namespace {

template <typename A>
__global__ void __launch_bounds__(repro::kSegMaxThreads)
seg_carry_kernel(const A* __restrict__ ts, const int* __restrict__ hb, A* __restrict__ out,
                 long long nb) {
    __shared__ repro::SegScratch<A> sc;
    const long long row = blockIdx.x;
    const A* in = ts + row * nb;
    const int* hin = hb + row * nb;
    A* o = out + row * nb;
    A carry = A(0);
    const long long round = static_cast<long long>(blockDim.x) * repro::kSegItems;
    for (long long base = 0; base < nb; base += round) {
        const long long i0 = base + static_cast<long long>(threadIdx.x) * repro::kSegItems;
        A v[repro::kSegItems];
        int f[repro::kSegItems];
        A run = A(0);
        int h = 0;
#pragma unroll
        for (int k = 0; k < repro::kSegItems; ++k) {
            const long long i = i0 + k;
            const bool ok = i < nb;
            v[k] = ok ? in[i] : A(0);
            f[k] = ok && hin[i] != 0;
            run = f[k] ? v[k] : run + v[k];
            h |= f[k];
        }
        A ex_v, tot_v;
        int ex_h, tot_h;
        repro::block_seg_exclusive_scan(run, h, sc, ex_v, ex_h, tot_v, tot_h);
        A pre = ex_h ? ex_v : carry + ex_v;
#pragma unroll
        for (int k = 0; k < repro::kSegItems; ++k) {
            if (i0 + k < nb) o[i0 + k] = pre;       // exclusive: before block i0 + k
            pre = f[k] ? v[k] : pre + v[k];
        }
        carry = tot_h ? tot_v : carry + tot_v;
    }
}

template <typename A>
int launch(const void* ts, const void* hb, void* out, int b, long long nb,
           cudaStream_t stream) {
    seg_carry_kernel<A><<<b, repro::seg_threads(nb, repro::kSegMaxThreads), 0, stream>>>(
        static_cast<const A*>(ts), static_cast<const int*>(hb), static_cast<A*>(out), nb);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ts, out: (b, nb) contiguous in the accumulation dtype; hb: (b, nb) int32
// has-boundary (nonzero = the block holds a flag).  acc: 0 fp32, 1 int32.
extern "C" int repro_seg_carry(const void* ts, const void* hb, void* out, int b, long long nb,
                               int acc, void* stream) {
    if (b <= 0 || nb <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (acc) {
        case 0: return launch<float>(ts, hb, out, b, nb, st);
        case 1: return launch<int>(ts, hb, out, b, nb, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

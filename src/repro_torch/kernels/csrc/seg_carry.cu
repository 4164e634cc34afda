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
// Design.  B9's single pass (seg_pass.cuh), exclusive, with the summaries as
// the values and the has-flag words as the flags: B9's tile aggregate, the sum
// from the tile's last flag on and whether the tile holds one, is this
// operator's, so the same pass computes it.  Rows of summaries are cut into
// B9's tiles, seg_threads(nb, 512, 16) threads x 16 summaries (8192 for rows
// of 8192 or more).  A row of one tile -- the pipeline's nb = 128 and every
// nb <= 8192 -- is one CTA with no look-back and no workspace, so the call is
// one kernel on the stream.  Longer rows take one CTA a tile and the
// deterministic look-back of lookback.cuh, whose workspace the wrapper passes
// and this entry point zeroes.  Integer carries are exact (int32 adds wrap as
// the JAX contraction does); fp32 carries are direct sums of one segment's
// terms, in a fixed tree, the same bits on every call.
//
// Bound.  It moves 12 B a block (4 B of ts and 4 B of h in, 4 B out): 0.015 ms
// at (4, 2^20).  At the pipeline's usual nb (a few KB) it is bound by its one
// launch.
#include "seg_pass.cuh"

namespace {

template <typename A>
int launch(const void* ts, const void* hb, void* out, int b, long long nb, void* ws,
           long long ws_bytes, cudaStream_t stream) {
    return repro::seg_pass_launch<A, A, int, true>(ts, hb, nb, out, b, nb, ws, ws_bytes, true,
                                                    stream);
}

}  // namespace

// ts, out: (b, nb) contiguous in the accumulation dtype; hb: (b, nb) int32
// has-boundary (nonzero = the block holds a flag).  acc: 0 fp32, 1 int32.  ws:
// the look-back's workspace of ws_bytes >= 8 * (b * tiles + 1) where a row is
// more than one tile (tiles = ceil(nb / (seg_threads(nb, 512, 16) * 16))),
// zeroed here; unread, and may be null, where a row is one tile.
extern "C" int repro_seg_carry(const void* ts, const void* hb, void* out, int b, long long nb,
                               int acc, void* ws, long long ws_bytes, void* stream) {
    if (b <= 0 || nb <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (acc) {
        case 0: return launch<float>(ts, hb, out, b, nb, ws, ws_bytes, st);
        case 1: return launch<int>(ts, hb, out, b, nb, ws, ws_bytes, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

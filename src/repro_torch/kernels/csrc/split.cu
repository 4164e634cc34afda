// B5 — SplitInd, the stable two-way split of a row by a mask (paper §5).
//
// Replaces the Pallas TPU kernel src/repro/kernels/split_mm.py::_split_kernel
// (body _splitind_body, launched by split_tiles): per row, the exclusive scan
// ex of the 0/1 flags, n_true = the number of flagged elements, and the
// payload and its original index scattered to
//
//     dest = ex              for a flagged element (trues first, in order)
//     dest = n_true + i - ex for an unflagged one (falses after, in order)
//
// with n_true written out.
//
// Design.  The Pallas kernel holds the whole row in VMEM; a 2^24-element row
// does not fit one SM, and one CTA a row runs on 4 of the card's 132 SMs at
// batch 4.  So this is B6's many-CTA tile split (multi_split.cu, on the
// machinery of radix_pass.cuh) on two slots, the flag as the digit (slot 0
// for a true, 1 for a false).  Each row is cut into T = ceil(n / kTile)
// tiles of 4096 and three kernels run on the caller's stream:
//
//   1. upsweep, grid (T, b): radix_pass.cuh's upsweep_kernel with the flag's
//      slot as the digit (FlagSlot), radix 2: it stages the tile's flag bytes
//      by 16-byte cp.async and counts them by shared-memory atomics into
//      (trues, falses), written slot-major to scratch (b, 2, T).
//   2. scan, grid (2, b): radix_pass.cuh's scan_kernel as it is: each slot's
//      exclusive prefix over the tiles and the row's slot totals (slot 0's is
//      n_true).
//   3. downsweep, grid (T, b): the tile's flags come in by 16-byte cp.async
//      and its payload words into registers (coalesced rounds of 32); one
//      ballot a round of 32 ranks each element among the warp's earlier
//      elements of its slot, the warps' counts give each warp's offsets, and
//      the payload and the generated index (lo + i, never read) are staged in
//      shared memory in destination order: the tile's trues, then its falses.
//      Consecutive threads then write consecutive addresses of the two runs,
//      the trues' at the slot-0 prefix and the falses' at n_true plus the
//      slot-1 prefix (= n_true + i - ex).
//
// Tile t's elements of a slot land after those of every earlier tile and in
// order among themselves, so the split is stable.  The mask scan is integer
// and exact, and no kernel uses global atomics, so every call gives the same
// bits.  Payloads move as raw words of their element size (1, 2, 4 or 8
// bytes), so every dtype works.  Flags are bytes, true where nonzero (the
// wrapper passes torch.bool).  The ragged end of a row is masked in all three
// kernels; nothing is padded.
//
// Bound.  The function reads each flag and payload element once and writes
// each payload element and index once: 13 B per element for fp32 payloads
// and bool flags, bound by bytes.  This design also reads the flags a second
// time (the upsweep's read: 14 B an element) and moves 16 B of counts a tile;
// both ends of the downsweep are whole runs of consecutive addresses.  At the
// vocab shape (4, 128256) a split is one wave of CTAs and three launches, so
// latency bounds it.
#include "radix_pass.cuh"

namespace {

using repro::radix::kItems;
using repro::radix::kThreads;
using repro::radix::kTile;
using repro::radix::kWarps;

// The flag's slot: 0 for a true (any nonzero byte), 1 for a false.
struct FlagSlot {
    __device__ __forceinline__ unsigned operator()(uint8_t f) const { return f ? 0u : 1u; }
};

template <typename W>
size_t downsweep_smem() {
    return kTile * (sizeof(W) + sizeof(int) + sizeof(uint8_t));
}

// Phase 3: CTA (t, row) ranks its tile stably by flag, stages it in
// destination order and writes its two runs.  tile_counts holds the scan's
// exclusive prefixes and totals the (b, 2) slot totals; the row's first tile
// writes n_true.
template <typename W>
__global__ void __launch_bounds__(kThreads, repro::radix::kDownBlocks)
split_downsweep_kernel(const W* __restrict__ x, const uint8_t* __restrict__ flags,
                       W* __restrict__ z, int* __restrict__ ind, int* __restrict__ n_true_out,
                       const int* __restrict__ tile_counts, const int* __restrict__ totals,
                       long long n, int tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    W* stage_x = reinterpret_cast<W*>(smem);                             // [kTile]
    int* stage_i = reinterpret_cast<int*>(stage_x + kTile);              // [kTile]
    uint8_t* in_f = reinterpret_cast<uint8_t*>(stage_i + kTile);         // [kTile]
    __shared__ int warp_t[kWarps], warp_f[kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned lanes_below = (1u << lane) - 1u;
    const long long row = blockIdx.y;
    const long long lo = static_cast<long long>(blockIdx.x) * kTile;
    const int tile_n = static_cast<int>(min(static_cast<long long>(kTile), n - lo));

    repro::radix::tile_load(flags + row * n + lo, in_f, tile_n);
    // the payload's loads, and the tile's prefixes from the scan, are in flight
    // while the flags arrive
    W p[kItems];
    const W* my_x = x + row * n + lo;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int i = repro::radix::item_index(j);
        p[j] = i < tile_n ? my_x[i] : W(0);
    }
    const int n_true = totals[row * 2];
    const int pre_t = tile_counts[(row * 2) * tiles + blockIdx.x];
    const int pre_f = tile_counts[(row * 2 + 1) * tiles + blockIdx.x];
    __pipeline_wait_prior(0);
    __syncthreads();

    // stable ranks within the warp's share, one ballot of the flag a round
    // (the valid lanes of a round are a prefix of the warp)
    int rank[kItems];
    unsigned flagged = 0;                         // bit j: this lane's element of round j
    int run_t = 0, run_f = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int i = repro::radix::item_index(j);
        const bool valid = i < tile_n;
        const bool f = valid && in_f[i] != 0;
        const unsigned bt = __ballot_sync(repro::kFullMask, f);
        const unsigned bf = __ballot_sync(repro::kFullMask, valid) & ~bt;
        rank[j] = f ? run_t + __popc(bt & lanes_below) : run_f + __popc(bf & lanes_below);
        flagged |= f ? 1u << j : 0u;
        run_t += __popc(bt);
        run_f += __popc(bf);
    }
    if (lane == 0) {
        warp_t[warp] = run_t;
        warp_f[warp] = run_f;
    }
    __syncthreads();
    int tile_t = 0, before_t = 0, before_f = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const int t = warp_t[w];
        tile_t += t;
        if (w < warp) {
            before_t += t;
            before_f += warp_f[w];
        }
    }

    // stage in destination order: the tile's trues, then its falses
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int i = repro::radix::item_index(j);
        if (i < tile_n) {
            const int s = ((flagged >> j) & 1u) ? before_t + rank[j]
                                                : tile_t + before_f + rank[j];
            stage_x[s] = p[j];
            stage_i[s] = static_cast<int>(lo) + i;
        }
    }
    __syncthreads();

    // consecutive threads write consecutive addresses of each run: staged slot
    // i < tile_t goes to pre_t + i, the others to n_true + pre_f + (i - tile_t)
    z += row * n;
    ind += row * n;
    const int base_f = n_true + pre_f - tile_t;
    for (int i = threadIdx.x; i < tile_n; i += kThreads) {
        const int dest = i < tile_t ? pre_t + i : base_f + i;
        z[dest] = stage_x[i];
        ind[dest] = stage_i[i];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) n_true_out[row] = n_true;
}

template <typename W>
int launch(const void* x, const void* flags, void* z, void* ind, void* n_true, int* scratch,
           int b, long long n, cudaStream_t stream) {
    const int tiles = static_cast<int>((n + kTile - 1) / kTile);
    const long long per_row = 2LL * tiles;
    int* totals = scratch + b * per_row;
    const size_t up_smem = repro::radix::upsweep_smem<uint8_t>(2);
    const size_t down_smem = downsweep_smem<W>();
    cudaError_t e;
    if (down_smem > repro::radix::kStaticSmem) {
        e = cudaFuncSetAttribute(split_downsweep_kernel<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(down_smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const W* xp = static_cast<const W*>(x);
    const uint8_t* fp = static_cast<const uint8_t*>(flags);
    W* zp = static_cast<W*>(z);
    int* ip = static_cast<int*>(ind);
    int* np = static_cast<int*>(n_true);
    for (long long r0 = 0; r0 < b; r0 += repro::radix::kMaxGridY) {
        const int rows = static_cast<int>(std::min<long long>(repro::radix::kMaxGridY, b - r0));
        const long long off = r0 * n;
        int* tc = scratch + r0 * per_row;
        int* tot = totals + r0 * 2;
        repro::radix::upsweep_kernel<uint8_t, FlagSlot>
            <<<dim3(tiles, rows), kThreads, up_smem, stream>>>(fp + off, tc, n, tiles,
                                                               FlagSlot{}, 2);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        repro::radix::scan_kernel<<<dim3(2, rows), repro::radix::kScanThreads, 0, stream>>>(
            tc, tot, tiles, 2);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        split_downsweep_kernel<W><<<dim3(tiles, rows), kThreads, down_smem, stream>>>(
            xp + off, fp + off, zp + off, ip + off, np + r0, tc, tot, n, tiles);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

}  // namespace

// x, z: (b, n) payload words of word_bytes (1, 2, 4 or 8) bytes; flags: (b, n)
// bytes, true where non-zero; ind: (b, n) int32; n_true: (b,) int32;
// scratch: b·2·(ceil(n / tile) + 1) int32 with tile == 4096 (kTile).
// n < 2^31.
extern "C" int repro_split(const void* x, const void* flags, void* z, void* ind,
                           void* n_true, void* scratch, int b, long long n, int word_bytes,
                           int tile, void* stream) {
    if (tile != kTile || scratch == nullptr || n > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (b <= 0 || n <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int* s = static_cast<int*>(scratch);
    switch (word_bytes) {
        case 1: return launch<uint8_t>(x, flags, z, ind, n_true, s, b, n, st);
        case 2: return launch<uint16_t>(x, flags, z, ind, n_true, s, b, n, st);
        case 4: return launch<uint32_t>(x, flags, z, ind, n_true, s, b, n, st);
        case 8: return launch<unsigned long long>(x, flags, z, ind, n_true, s, b, n, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

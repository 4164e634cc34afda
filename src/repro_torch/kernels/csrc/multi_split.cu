// B6 — the stable multi-way split of a row by its digits (radix-2^k SplitInd).
//
// Replaces the Pallas TPU kernel src/repro/kernels/split_mm.py::_multi_split_kernel
// (body _multisplit_body, launched by multi_split_tiles): per row, the payload
// and its original index grouped by an int32 digit in [0, R), buckets in
// ascending order and the original order kept inside each, with the (R,)
// bucket counts.  The Pallas kernel scans the (rows, R, s) one-hot digit
// masks with one batched A @ U_s contraction and pads the row with digit
// R - 1, then subtracts the padding from the last count.
//
// Slots.  A digit outside [0, R) goes to an extra slot R after all the
// others, in order, and is not counted: the outputs stay a permutation and
// nothing is written out of bounds.  (The Pallas kernel gives such a digit no
// bucket, so its element lands on index 0.)  Payloads move as raw words of
// their element size (1, 2, 4 or 8 bytes).  The ragged end of a row is masked,
// so nothing is padded and the counts count the row's own elements.
//
// Design, chosen by R alone (split_mm.multi_split_tiles passes scratch exactly
// when R <= kTileMaxBuckets):
//
// * R <= kTileMaxBuckets = 511: B7's many-CTA tile split (radix_pass.cuh) on
//   R + 1 slots.  Each row is cut into T = ceil(n / kTile) tiles of 4096
//   digits, and three kernels run on the caller's stream:
//     1. upsweep, grid (T, b): radix_pass.cuh's upsweep_kernel with the slot as
//        its digit: the tile's int32 digits come in by 16-byte cp.async, the
//        slots are counted into per-warp counters, and the counts go out
//        bucket-major to scratch (b, R + 1, T);
//     2. scan, grid (R + 1, b): scan_kernel as it is, the exclusive prefix of
//        each slot over the tiles and the row's slot totals; the totals of
//        slots 0..R-1 are the counts (written by the downsweep's first tile);
//     3. downsweep, grid (T, b), below: reloads the digits and reads the
//        payload words, ranks each element stably within the tile (warp_rank:
//        ceil(log2(R + 1)) ballots a round of 32, 5 at R = 16, 9 at R = 511),
//        stages the payload and the element's tile position in slot order in
//        shared memory (the index, lo + j, is generated, never read), and
//        consecutive threads write consecutive addresses of each slot's run.
//   No kernel uses a global atomic, so a split is the same bits on every run.
//   The ceiling: the downsweep scans the slots one thread a slot (512
//   threads), so R + 1 <= 512.  Shared memory allows it at the two downsweep
//   CTAs an SM that the design wants (kDownBlocks): with 8-byte payloads a
//   downsweep CTA takes 4096 × (4 + 8 + 4) B of digits, staged payload and
//   staged positions plus 17·(R + 1) ints of counters, 98 KB at R = 511; the
//   upsweep 48 KB.  Scratch is b·(R + 1)·(T + 1) ints.
//
// * R > kTileMaxBuckets, up to 29055 (split_mm.MULTI_SPLIT_MAX_BUCKETS): one
//   CTA a row, the row cut into one contiguous chunk a warp and streamed
//   twice: a histogram sweep into (R + 1) counters a warp, then an ordered
//   sweep in which __match_any_sync gives the lanes of a key's bucket and
//   popc(peers & lanes-below) its rank.  Its counters take (warps + 1)(R + 1)
//   ints of shared memory: 32 warps up to R = 1760, fewer above, down to one
//   warp at R = 29055.  One CTA a row leaves most SMs idle at small batch.
//
// Bound.  Each element is read (payload and digit) and written (payload and
// index) once: 16 B per element for fp32 payloads, bound by bytes.  The tile
// split also reads the digits a second time (the upsweep's) and moves
// 4·(R + 1)·T B of counts; both kernels' writes are runs of consecutive
// addresses (about kTile / (R + 1) elements a run in the tile split).
#include "radix_pass.cuh"

namespace {

using repro::radix::kItems;
using repro::radix::kThreads;
using repro::radix::kTile;
using repro::radix::kWarps;

constexpr int kTileMaxBuckets = kThreads - 1;   // split_mm.MULTI_SPLIT_TILE_MAX_BUCKETS

// A digit's slot: itself in [0, R), R outside.
struct SlotDigit {
    int buckets;
    __device__ __forceinline__ unsigned operator()(int d) const {
        return static_cast<unsigned>(d) < static_cast<unsigned>(buckets)
                   ? static_cast<unsigned>(d)
                   : static_cast<unsigned>(buckets);
    }
};

template <typename P>
size_t downsweep_smem(int slots) {
    return kTile * (2 * sizeof(int) + sizeof(P)) + (2 * kWarps + 1) * sizeof(long long) +
           static_cast<size_t>(kWarps + 1) * slots * sizeof(int);
}

// Phase 3 of the tile split: CTA (t, row) ranks its tile stably by slot, stages
// it in slot order and writes each slot's run at the run's start in the row.
// tile_counts holds the scan's exclusive prefixes, totals the (b, R + 1) slot
// totals; the row's first tile writes the (b, R) counts.
template <typename P>
__global__ void __launch_bounds__(kThreads, repro::radix::kDownBlocks)
split_downsweep_kernel(const P* __restrict__ x, const int* __restrict__ digits,
                       P* __restrict__ z, int* __restrict__ ind, int* __restrict__ counts,
                       const int* __restrict__ tile_counts, const int* __restrict__ totals,
                       long long n, int tiles, int buckets, int bits) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* in_d = reinterpret_cast<int*>(smem);                              // [kTile]
    P* stage_x = reinterpret_cast<P*>(in_d + kTile);                       // [kTile]
    int* stage_s = reinterpret_cast<int*>(stage_x + kTile);                // [kTile]
    long long* scratch = reinterpret_cast<long long*>(stage_s + kTile);    // [2·kWarps+1]
    int* cnt = reinterpret_cast<int*>(scratch + 2 * kWarps + 1);           // [kWarps][R+1]
    const int slots = buckets + 1;
    int* gbase = cnt + kWarps * slots;                                     // [R+1]
    const SlotDigit slot_of{buckets};
    const int warp = threadIdx.x >> 5;
    const long long row = blockIdx.y;
    const long long lo = static_cast<long long>(blockIdx.x) * kTile;
    const int tile_n = static_cast<int>(min(static_cast<long long>(kTile), n - lo));

    repro::radix::tile_load(digits + row * n + lo, in_d, tile_n);
    // the payload's loads, and the slot's prefix and total from the scan, are in
    // flight while the CTA ranks the digits
    P p[kItems];
    const P* my_x = x + row * n + lo;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int i = repro::radix::item_index(j);
        p[j] = i < tile_n ? my_x[i] : P(0);
    }
    const int d = threadIdx.x;
    int prefix = 0, total = 0;
    if (d < slots) {
        prefix = tile_counts[(row * slots + d) * tiles + blockIdx.x];
        total = totals[row * slots + d];
    }
    for (int i = threadIdx.x; i < kWarps * slots; i += kThreads) cnt[i] = 0;
    __pipeline_wait_prior(0);
    __syncthreads();

    // stable ranks within each warp's share
    int rank[kItems];
    {
        unsigned slot[kItems];
        repro::radix::tile_digits(in_d, tile_n, slot_of, slot);
        repro::radix::warp_rank(slot, bits, cnt + warp * slots, rank);
    }
    if (blockIdx.x == 0 && d < buckets) counts[row * buckets + d] = total;
    __syncthreads();                                 // every warp's counters are in

    // as in radix_pass.cuh's downsweep: one scan of the row's slot totals (high
    // word) and the tile's slot counts (low word) gives each slot's run start in
    // the row and in the staged tile
    const int c = repro::radix::warp_offsets(cnt, slots);
    long long sum;
    const long long both = repro::block_exclusive_scan<long long, kWarps>(
        (static_cast<long long>(total) << 32) | c, scratch, sum);
    const int tile_start = static_cast<int>(both & 0xffffffffLL);
    const int row_start = static_cast<int>(both >> 32);
    if (d < slots) {
        gbase[d] = row_start + prefix - tile_start;
        for (int w = 0; w < kWarps; ++w) cnt[w * slots + d] += tile_start;
    }
    __syncthreads();

    // stage in slot order: the payload word, and the element's tile position
    // (high 16 bits) with its slot (low 16)
    const int* my = cnt + warp * slots;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int i = repro::radix::item_index(j);
        if (i < tile_n) {
            const unsigned sl = slot_of(in_d[i]);
            const int s = my[sl] + rank[j];
            stage_x[s] = p[j];
            stage_s[s] = (i << 16) | static_cast<int>(sl);
        }
    }
    __syncthreads();

    // consecutive threads write consecutive addresses of each slot's run
    z += row * n;
    ind += row * n;
    for (int i = threadIdx.x; i < tile_n; i += kThreads) {
        const int v = stage_s[i];
        const int dest = gbase[v & 0xffff] + i;
        z[dest] = stage_x[i];
        ind[dest] = static_cast<int>(lo) + (v >> 16);
    }
}

template <typename P>
int launch_tiles(const void* x, const void* digits, void* z, void* ind, int* counts,
                 int* scratch, int b, long long n, int buckets, cudaStream_t stream) {
    const int slots = buckets + 1;
    int bits = 1;
    while ((1 << bits) < slots) ++bits;
    const int tiles = static_cast<int>((n + kTile - 1) / kTile);
    const long long per_row = static_cast<long long>(slots) * tiles;
    int* totals = scratch + b * per_row;
    const size_t up_smem = repro::radix::upsweep_smem<int>(slots);
    const size_t down_smem = downsweep_smem<P>(slots);
    cudaError_t e;
    if (up_smem > repro::radix::kStaticSmem) {
        e = cudaFuncSetAttribute(repro::radix::upsweep_kernel<int, SlotDigit>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(up_smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    if (down_smem > repro::radix::kStaticSmem) {
        e = cudaFuncSetAttribute(split_downsweep_kernel<P>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(down_smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const P* xp = static_cast<const P*>(x);
    const int* dp = static_cast<const int*>(digits);
    P* zp = static_cast<P*>(z);
    int* ip = static_cast<int*>(ind);
    for (long long r0 = 0; r0 < b; r0 += repro::radix::kMaxGridY) {
        const int rows = static_cast<int>(std::min<long long>(repro::radix::kMaxGridY, b - r0));
        const long long off = r0 * n;
        int* tc = scratch + r0 * per_row;
        int* tot = totals + r0 * slots;
        repro::radix::upsweep_kernel<int, SlotDigit>
            <<<dim3(tiles, rows), kThreads, up_smem, stream>>>(dp + off, tc, n, tiles,
                                                               SlotDigit{buckets}, slots);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        repro::radix::scan_kernel<<<dim3(slots, rows), repro::radix::kScanThreads, 0, stream>>>(
            tc, tot, tiles, slots);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        split_downsweep_kernel<P><<<dim3(tiles, rows), kThreads, down_smem, stream>>>(
            xp + off, dp + off, zp + off, ip + off, counts + r0 * buckets, tc, tot, n, tiles,
            buckets, bits);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// R > kTileMaxBuckets: one CTA a row
// ---------------------------------------------------------------------------

constexpr int kMaxWarps = 32;
constexpr int kMaxSmem = 232448;              // 227 KB, the most a block may use

template <typename W>
__global__ void __launch_bounds__(32 * kMaxWarps)
row_split_kernel(const W* __restrict__ x, const int* __restrict__ digits,
                 W* __restrict__ z, int* __restrict__ ind, int* __restrict__ counts,
                 long long n, int radix) {
    extern __shared__ int cnt[];             // [warps][radix + 1] counters, then totals
    const int warps = blockDim.x >> 5;
    const int slots = radix + 1;             // slot radix: digits outside [0, radix)
    int* total = cnt + warps * slots;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned lanes_below = (1u << lane) - 1u;
    const long long row = blockIdx.x;
    x += row * n;
    digits += row * n;
    z += row * n;
    ind += row * n;

    // each warp owns one contiguous chunk of the row, a multiple of 32 long
    const long long per = ((n + warps - 1) / warps + 31) / 32 * 32;
    const long long lo = warp * per;
    const long long hi = min(n, lo + per);

    for (int i = threadIdx.x; i < warps * slots; i += blockDim.x) cnt[i] = 0;
    __syncthreads();

    // 1. histogram sweep: per-warp bucket counts
    int* my = cnt + warp * slots;
    for (long long base = lo; base < hi; base += 32) {
        const long long i = base + lane;
        const bool valid = i < hi;
        unsigned d = 0xffffffffu;
        if (valid) {
            const int v = digits[i];
            d = (v >= 0 && v < radix) ? static_cast<unsigned>(v) : static_cast<unsigned>(radix);
        }
        const unsigned peers = __match_any_sync(repro::kFullMask, d);
        if (valid && (peers & lanes_below) == 0) my[d] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();

    // bucket totals (the counts), then their exclusive bases, then
    // bucket-major offsets for each warp's chunk
    for (int r = threadIdx.x; r < slots; r += blockDim.x) {
        int t = 0;
        for (int w = 0; w < warps; ++w) t += cnt[w * slots + r];
        total[r] = t;
        if (r < radix) counts[row * radix + r] = t;
    }
    __syncthreads();
    if (warp == 0) {
        const int q = (slots + 31) / 32;
        const int r0 = min(lane * q, slots);
        const int r1 = min(r0 + q, slots);
        int loc = 0;
        for (int r = r0; r < r1; ++r) loc += total[r];
        const int incl = repro::warp_inclusive_scan(loc, lane);
        int run = incl - loc;
        for (int r = r0; r < r1; ++r) {
            const int v = total[r];
            total[r] = run;                  // exclusive bucket base
            run += v;
        }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < slots; r += blockDim.x) {
        int run = total[r];
        for (int w = 0; w < warps; ++w) {
            const int c = cnt[w * slots + r];
            cnt[w * slots + r] = run;
            run += c;
        }
    }
    __syncthreads();

    // 2. ordered sweep: stable ranks from the bucket peers, then scatter
    for (long long base = lo; base < hi; base += 32) {
        const long long i = base + lane;
        const bool valid = i < hi;
        W v = 0;
        unsigned d = 0xffffffffu;
        if (valid) {
            v = x[i];
            const int dv = digits[i];
            d = (dv >= 0 && dv < radix) ? static_cast<unsigned>(dv) : static_cast<unsigned>(radix);
        }
        const unsigned peers = __match_any_sync(repro::kFullMask, d);
        int dest = 0;
        if (valid) dest = my[d] + __popc(peers & lanes_below);
        __syncwarp();
        if (valid && (peers & lanes_below) == 0) my[d] += __popc(peers);
        __syncwarp();
        if (valid) {
            z[dest] = v;
            ind[dest] = static_cast<int>(i);
        }
    }
}

template <typename W>
int launch_rows(const void* x, const void* digits, void* z, void* ind, int* counts, int b,
                long long n, int radix, cudaStream_t stream) {
    const int slots = radix + 1;
    const int warps = min(kMaxWarps, kMaxSmem / (4 * slots) - 1);
    if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(warps + 1) * slots * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(row_split_kernel<W>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    row_split_kernel<W><<<b, 32 * warps, smem, stream>>>(
        static_cast<const W*>(x), static_cast<const int*>(digits), static_cast<W*>(z),
        static_cast<int*>(ind), counts, n, radix);
    return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch(const void* x, const void* digits, void* z, void* ind, int* counts, int* scratch,
           int b, long long n, int radix, cudaStream_t stream) {
    return radix <= kTileMaxBuckets
               ? launch_tiles<W>(x, digits, z, ind, counts, scratch, b, n, radix, stream)
               : launch_rows<W>(x, digits, z, ind, counts, b, n, radix, stream);
}

}  // namespace

// x, z: (b, n) payload words of word_bytes (1, 2, 4 or 8) bytes; digits, ind:
// (b, n) int32; counts: (b, radix) int32.  n < 2^31, 1 <= radix <= 29055.
// scratch: for radix <= 511 (the tile split) b·(radix + 1)·(ceil(n / tile) + 1)
// int32 with tile == 4096 (kTile); for larger radix nullptr (the row kernel).
extern "C" int repro_multi_split(const void* x, const void* digits, void* z, void* ind,
                                 void* counts, void* scratch, int b, long long n, int radix,
                                 int word_bytes, int tile, void* stream) {
    if (radix < 1 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    if ((radix <= kTileMaxBuckets) != (scratch != nullptr) ||
        (scratch != nullptr && tile != kTile)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (b <= 0 || n <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int* c = static_cast<int*>(counts);
    int* s = static_cast<int*>(scratch);
    switch (word_bytes) {
        case 1: return launch<uint8_t>(x, digits, z, ind, c, s, b, n, radix, st);
        case 2: return launch<uint16_t>(x, digits, z, ind, c, s, b, n, radix, st);
        case 4: return launch<uint32_t>(x, digits, z, ind, c, s, b, n, radix, st);
        case 8: return launch<unsigned long long>(x, digits, z, ind, c, s, b, n, radix, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

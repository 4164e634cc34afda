// B14 — the block summaries of the linear-recurrence §4 pipeline (phase 1),
// and, through a second entry point, B15's carry scan run inside the same
// launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linrec_mm.py::_summary_kernel
// (launched by linrec_block_summaries): for each block of block_len
// consecutive pairs of a row, the affine map it applies to an incoming
// state, y_out = prods * y_in + lasts, with prods = Π a over the block and
// lasts the block's recurrence from a zero state, (rows, n) -> two (rows, nb).
// The Pallas kernel forms both from suffix products (Π a after each element)
// and dot products.
//
// Design.  One CTA per (row, block) on a flat grid.x of rows * nb CTAs (nb can
// pass grid.y's 65535).  An ordered reduction of the block's pairs under the
// affine-pair operator of affine_tile.cuh: each thread folds 8 consecutive
// pairs, the block composes the thread aggregates in thread order, and the
// rounds are composed in order.  The operator does not commute, so no
// atomics.  The ragged end of a row is the identity (1, 0).
//
// Fused carries (repro_linrec_summaries_carries).  After thread 0 writes its
// block's summary it takes a ticket from its row's int32 counter with an
// acquire-release atomic.  The CTA that takes a row's last ticket reads the
// row's nb summaries through L2 and runs B15's walk over them
// (linrec_carry_row.cuh), playing B15's lin_threads(nb) threads with its own
// lin_threads(block_len), so the carries are bit for bit linrec_carry's of the
// same summaries whichever CTA comes last.  The walk loads straight from L2,
// so the CTAs take no dynamic shared memory.  The counters are the caller's
// scratch, zeroed here on the launch's stream.
//
// Bound.  It reads a and b once and writes 8 B per block: 8 B per element,
// bound by bytes (0.160 ms at (4, 2^24) at 3.35 TB/s).
#include "linrec_carry_row.cuh"

namespace {

// two CTAs of 1024 an SM, 32 registers a thread, as B14 alone: the walk's
// registers must not halve the occupancy of every CTA for the one that walks
template <bool kCarries>
__global__ void __launch_bounds__(repro::kLinMaxThreads, 2)
linrec_summaries_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        float* prods, float* lasts, float* carries, int* tickets, long long n,
                        int nb, long long block_len, int carry_threads) {
    __shared__ repro::AffineScratch sc;
    const long long cta = blockIdx.x;
    const long long row = cta / nb;
    const long long lo = (cta - row * nb) * block_len;
    const long long hi = min(n, lo + block_len);
    const float* ar = a + row * n;
    const float* br = b + row * n;
    float P = 1.f, L = 0.f;
    const long long round = static_cast<long long>(blockDim.x) * repro::kLinItems;
    for (long long base = lo; base < hi; base += round) {
        float av[repro::kLinItems], bv[repro::kLinItems], A, B;
        repro::load_fold(ar, br, base + static_cast<long long>(threadIdx.x) * repro::kLinItems,
                         hi, av, bv, A, B);
        float exA, exB, totA, totB;
        repro::block_affine_exclusive_scan(A, B, sc, exA, exB, totA, totB);
        L = fmaf(totA, L, totB);              // (P, L) o (totA, totB)
        P = P * totA;
    }
    if constexpr (kCarries) {
        // thread 0 writes the summary and takes the row's ticket (release covers
        // its own stores); the CTA with the row's last ticket walks the row
        __shared__ int last;
        if (threadIdx.x == 0) {
            prods[cta] = P;
            lasts[cta] = L;
            last = repro::ticket(tickets + row, 1) == nb - 1;
        }
        __syncthreads();
        if (last) {
            const long long off = row * nb;
            repro::linrec_carry_row<true>(prods + off, lasts + off, carries + off, nb,
                                          carry_threads, sc);
        }
    } else if (threadIdx.x == 0) {
        prods[cta] = P;
        lasts[cta] = L;
    }
}

bool bad_geometry(int rows, long long n, int nb, long long block_len) {
    return block_len < 1 || nb != (n + block_len - 1) / block_len ||
           static_cast<long long>(rows) * nb > 0x7fffffffLL;
}

template <bool kCarries>
int launch(const void* a, const void* b, void* prods, void* lasts, void* carries, int* tickets,
           int rows, long long n, int nb, long long block_len, cudaStream_t stream) {
    if (kCarries) {
        const cudaError_t e = cudaMemsetAsync(tickets, 0, sizeof(int) * rows, stream);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    linrec_summaries_kernel<kCarries><<<static_cast<unsigned>(rows) * nb,
                                        repro::lin_threads(block_len, repro::kLinMaxThreads), 0,
                                        stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(prods),
        static_cast<float*>(lasts), static_cast<float*>(carries), tickets, n, nb, block_len,
        repro::lin_threads(nb, repro::kLinMaxThreads));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b: (rows, n) contiguous fp32; prods, lasts: (rows, nb) fp32,
// nb = ceil(n / block_len).
extern "C" int repro_linrec_summaries(const void* a, const void* b, void* prods, void* lasts,
                                      int rows, long long n, int nb, long long block_len,
                                      void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (bad_geometry(rows, n, nb, block_len)) return static_cast<int>(cudaErrorInvalidValue);
    return launch<false>(a, b, prods, lasts, nullptr, nullptr, rows, n, nb, block_len,
                         static_cast<cudaStream_t>(stream));
}

// As repro_linrec_summaries, and carries: (rows, nb) fp32 gets the state entering
// each block, as repro_linrec_carry computes it from prods and lasts.  tickets:
// the caller's scratch of at least rows int32 counters (tickets_bytes), zeroed
// here.
extern "C" int repro_linrec_summaries_carries(const void* a, const void* b, void* prods,
                                              void* lasts, void* carries, void* tickets,
                                              long long tickets_bytes, int rows, long long n,
                                              int nb, long long block_len, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (bad_geometry(rows, n, nb, block_len) ||
        tickets_bytes < static_cast<long long>(sizeof(int)) * rows) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch<true>(a, b, prods, lasts, carries, static_cast<int*>(tickets), rows, n, nb,
                        block_len, static_cast<cudaStream_t>(stream));
}

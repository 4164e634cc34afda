// B7h — one stable LSB radix-2^k pass that also exports the row's digit
// histogram: B7 plus the (b, 2^k) int32 bucket totals.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/split_mm.py::_radix_pass_multibit_hist_kernel (launched by
// radix_pass_multibit(..., with_counts=True)), whose one caller is the
// per-shard pass of the distributed sort (src/repro/core/dist_ops.py
// _local_group; here split_mm.radix_pass_multibit(with_counts=True) from
// repro_torch/core/dist_ops.py _local_group): the totals are the shard's
// histogram that the bucket exchange is planned from.
//
// Design.  The two sweeps are B7's (radix_pass.cuh); the totals it already
// sums in shared memory after the histogram sweep are written out, one int32
// per bucket, before they become bucket bases.  The Pallas path pads each row
// to its tile side with all-ones keys and then subtracts the pad from bucket
// 2^k - 1; here both sweeps mask the ragged end of the row, so nothing is
// padded, nothing is subtracted, and the totals count the row's own elements.
//
// Bound.  As B7: each 32-bit key and permutation entry once in and once out,
// 16 B an element; the histogram adds 4·2^k B a row.  One CTA per row.
#include "radix_pass.cuh"

// keys/keys_out: (b, n) raw unsigned words of word_bytes (1, 2 or 4) bytes;
// perm/perm_out: (b, n) int32; counts: (b, 2^bits) int32 bucket totals.
// Retires bits [shift, shift + bits), bits <= 8.
extern "C" int repro_radix_pass_hist(const void* keys, const void* perm, void* keys_out,
                                     void* perm_out, void* counts, int b, long long n,
                                     int shift, int bits, int word_bytes, void* stream) {
    if (counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return repro::radix::launch(keys, perm, keys_out, perm_out, static_cast<int*>(counts), b,
                                n, shift, bits, word_bytes, stream);
}

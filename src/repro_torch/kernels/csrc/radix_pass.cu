// B7 — one stable LSB radix-2^k pass (k = bits <= 8) over raw key words.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/split_mm.py::_radix_pass_multibit_kernel (launched by
// radix_pass_multibit): digit d = (w >> shift) & (2^k - 1), a stable 2^k-way
// split of the row by d from the one-hot digit mask scans, and the keys and
// the int32 permutation scattered to base[d] + rank.
//
// The many-CTA tile split (upsweep, bucket-major scan, downsweep), its design
// and its bound are in radix_pass.cuh, which B7h (radix_pass_hist.cu) shares;
// this pass exports no histogram, so its bucket totals stay in scratch.
#include "radix_pass.cuh"

// keys/keys_out: (b, n) raw unsigned words of word_bytes (1, 2 or 4) bytes;
// perm/perm_out: (b, n) int32; scratch: b·2^bits·(ceil(n / tile) + 1) int32,
// tile == radix_pass.cuh's kTile.  Retires bits [shift, shift + bits), bits <= 8.
extern "C" int repro_radix_pass(const void* keys, const void* perm, void* keys_out,
                                void* perm_out, void* scratch, int b, long long n,
                                int shift, int bits, int word_bytes, int tile,
                                void* stream) {
    return repro::radix::launch(keys, perm, keys_out, perm_out, nullptr, scratch, b, n,
                                shift, bits, word_bytes, tile, stream);
}

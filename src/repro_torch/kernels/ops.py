"""Public kernel entry points, and the launch counters of the port's kernels.

Port of ``repro/kernels/ops.py`` for every kernel (B1–B17 and B7h).  The
kernels' own wrappers are ``scan_mm.scan_tiles`` (B1),
``scan_pipeline.{block_partial_sums,carry_scan,block_scan_carry}`` (B2–B4),
``split_mm.split_tiles`` (B5), ``split_mm.multi_split_tiles`` (B6),
``split_mm.radix_pass_multibit`` (B7; with ``with_counts`` B7h),
``split_mm.topp_mask_sample_tiles`` (B8),
``segscan_mm.{seg_scan_tiles,seg_block_summaries,seg_carry_scan,seg_block_scan_carry}``
(B9–B12),
``linrec_mm.{linrec_scan_tiles,linrec_block_summaries,linrec_carry_scan,linrec_block_scan_carry}``
(B13–B16) and ``ssd_chunk.ssd_chunk_scan`` (B17); each runs its CUDA kernel on CUDA
tensors and the kernel's plain PyTorch version on CPU tensors.  PyTorch runs
eagerly, so the entry points here are plain calls where the JAX package
``jit``s.  Every kernel launch adds one to its count;
:func:`launch_counts` reads the counts and :func:`reset_launch_counts` sets
them to zero, so a caller can show that a run went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.split_mm import radix_pass_multibit

__all__ = ["radix_sort_enc_kernel",
           "launch_counts", "reset_launch_counts", "KERNELS"]

# launch-counter key -> the TPU kernel it replaces
KERNELS = {
    "scan_mm": "B1 src/repro/kernels/scan_mm.py:36 _kernel",
    "radix_pass": "B7 src/repro/kernels/split_mm.py:262 _radix_pass_multibit_kernel",
    "radix_pass_hist": "B7h src/repro/kernels/split_mm.py:273 "
                       "_radix_pass_multibit_hist_kernel",
    "topp_tail": "B8 src/repro/kernels/split_mm.py:360 _topp_kernel",
    "block_sums": "B2 src/repro/kernels/scan_pipeline.py:71 _block_sums_kernel",
    "carry_scan": "B3 src/repro/kernels/scan_pipeline.py:105 _carry_scan_kernel",
    "block_scan": "B4 src/repro/kernels/scan_pipeline.py:143/:152 "
                  "_block_scan_scanu_kernel/_block_scan_scanul1_kernel",
    "split": "B5 src/repro/kernels/split_mm.py:136 _split_kernel",
    "seg_scan": "B9 src/repro/kernels/segscan_mm.py:186 _seg_kernel",
    "seg_summaries": "B10 src/repro/kernels/segscan_mm.py:252 _seg_summary_kernel",
    "seg_carry": "B11 src/repro/kernels/segscan_mm.py:293 _seg_carry_kernel",
    "seg_block_scan": "B12 src/repro/kernels/segscan_mm.py:325 _seg_block_carry_kernel",
    "linrec_scan": "B13 src/repro/kernels/linrec_mm.py:72 _tile_kernel",
    "linrec_summaries": "B14 src/repro/kernels/linrec_mm.py:143 _summary_kernel",
    "linrec_carry": "B15 src/repro/kernels/linrec_mm.py:183 _carry_kernel",
    "linrec_block_scan": "B16 src/repro/kernels/linrec_mm.py:219 _block_carry_kernel",
    "multi_split": "B6 src/repro/kernels/split_mm.py:194 _multi_split_kernel",
    "ssd_chunk": "B17 src/repro/kernels/ssd_chunk.py:27 _kernel",
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, per kernel."""
    return {k: _build.LAUNCHES[k] for k in KERNELS}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to zero."""
    _build.LAUNCHES.clear()


def radix_sort_enc_kernel(enc: torch.Tensor, *, bits: int, bits_per_pass: int = 1):
    """Stable LSB radix sort of raw-word keys via ``ceil(bits / k)`` fused passes.

    ``enc``: ``(..., n)`` raw-word keys (see ``primitives._encode_for_sort``).
    Returns ``(sorted_enc, permutation)``.  The kernel masks the ragged end of
    a row itself, so unlike the Pallas chain no max-key tail padding is
    needed; a ragged final digit uses the remaining bits.
    """
    *lead, n = enc.shape
    work = enc.reshape(-1, n)
    perm = torch.arange(n, dtype=torch.int32, device=enc.device).expand(
        work.shape[0], n).contiguous()
    for shift in range(0, bits, bits_per_pass):
        k = min(bits_per_pass, bits - shift)
        work, perm = radix_pass_multibit(work, perm, shift=shift, pass_bits=k)
    return work.reshape(*lead, n), perm.reshape(*lead, n)


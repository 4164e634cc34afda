"""B1: the fused ScanU / ScanUL1 tile scan (``csrc/scan_mm.cu``).

Port of ``repro/kernels/scan_mm.py``.  :func:`scan_tiles` scans the last axis
of a tensor as a row of ``s×s`` tiles walked in order with a running carry.
On a CUDA tensor it launches the hand-written kernel; on a CPU tensor it runs
:func:`scan_tiles_plain`, the same tile algebra in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.core import guards
from repro_torch.core.scan import (accum_dtype_for, tile_scan_scanu,
                                   tile_scan_scanul1)
from repro_torch.kernels import _build

__all__ = ["scan_tiles", "scan_tiles_plain", "kernel_operand", "VARIANTS", "MAX_TILE"]

VARIANTS = ("scanul1", "scanu")
MAX_TILE = 128

# input dtype -> the kernel's dtype code (fp32 accumulation for 0-2, int32 for 3-6)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.int8: 3, torch.uint8: 4, torch.int16: 5, torch.int32: 6}


def scan_tiles_plain(xb: torch.Tensor, *, s: int, variant: str,
                     acc: torch.dtype) -> torch.Tensor:
    """Plain version of the kernel on a ``(b, n)`` tensor.

    Per tile ``local = A@U_s (+ L⁻_s@(A@1_s))``, then the ordered carry
    ``out = local + carry; carry = out[-1, -1]`` as an exclusive running sum
    of the tile totals.
    """
    b, n = xb.shape
    ell = s * s
    pad = (-n) % ell
    xp = torch.nn.functional.pad(xb.to(acc), (0, pad)) if pad else xb
    tiles = xp.reshape(b, -1, s, s)
    fn = tile_scan_scanul1 if variant == "scanul1" else tile_scan_scanu
    local = fn(tiles, accum_dtype=acc)                       # (b, nt, s, s)
    totals = local[:, :, -1, -1]
    carry = torch.cumsum(totals, dim=-1, dtype=acc)
    carry = torch.cat([torch.zeros_like(carry[:, :1]), carry[:, :-1]], dim=-1)
    out = (local + carry[:, :, None, None]).reshape(b, -1)
    return out[:, :n]


def kernel_operand(xb: torch.Tensor, acc: torch.dtype, *, op: str):
    """``xb`` as the scan kernels read it, and its dtype code.

    ``bool`` is read as ``uint8``; an input whose ``accum_dtype_for`` is not
    ``acc`` is cast to ``acc`` first.  Raises ``TypeError`` for a dtype or an
    accumulation dtype the kernels do not take.
    """
    if xb.dtype == torch.bool:
        xb = xb.view(torch.uint8)
    if xb.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: the CUDA kernel takes {list(_DTYPE_CODES)}, "
                        f"got {xb.dtype}")
    if acc != accum_dtype_for(xb.dtype):
        if acc not in (torch.float32, torch.int32):
            raise TypeError(f"{op}: the CUDA kernel accumulates in fp32 or "
                            f"int32, got accum_dtype={acc}")
        xb = xb.to(acc)
    return xb.contiguous(), _DTYPE_CODES[xb.dtype]


def _scan_tiles_cuda(xb: torch.Tensor, *, s: int, variant: str,
                     acc: torch.dtype) -> torch.Tensor:
    xb, code = kernel_operand(xb, acc, op="scan_tiles")
    b, n = xb.shape
    out = torch.empty((b, n), dtype=acc, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        _build.launch("scan_mm", xb.data_ptr(), out.data_ptr(), b, n, s,
                      1 if variant == "scanul1" else 0, code, stream)
    return out


def scan_tiles(x: torch.Tensor, *, s: int = 128, variant: str = "scanul1",
               accum_dtype=None, precision: str = "highest") -> torch.Tensor:
    """Scan the last axis of ``x`` (any leading batch dims) with the tile scan.

    Args:
        x: Input tensor; a CUDA tensor launches the kernel, a CPU tensor runs
            the plain version.
        s: Tile side, ``1 <= s <= 128``.
        variant: ``"scanul1"`` or ``"scanu"``.
        accum_dtype: Accumulation dtype; defaults to ``accum_dtype_for``.
        precision: Only ``"highest"`` is ported.

    Returns:
        The inclusive scan in the accumulation dtype, shaped like ``x``.
    """
    variant = guards.validate_choice(variant, VARIANTS, name="variant",
                                     op="scan_tiles")
    s = guards.validate_positive(s, name="s", op="scan_tiles")
    if s > MAX_TILE:
        raise ValueError(f"scan_tiles: s must be <= {MAX_TILE}, got {s}")
    if precision != "highest":
        raise NotImplementedError(f"scan_tiles: precision={precision!r} is not "
                                  "ported yet (ROADMAP Queue A item 2)")
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(x.dtype)
    *lead, n = x.shape
    xb = x.reshape(-1, n)
    if n == 0 or xb.shape[0] == 0:
        return torch.zeros(x.shape, dtype=acc, device=x.device)
    if xb.is_cuda:
        out = _scan_tiles_cuda(xb, s=s, variant=variant, acc=acc)
    else:
        out = scan_tiles_plain(xb, s=s, variant=variant, acc=acc)
    return out.reshape(x.shape)

"""B1: the fused ScanU / ScanUL1 tile scan (``csrc/scan_mm.cu``).

Port of ``repro/kernels/scan_mm.py``.  :func:`scan_tiles` scans the last axis
of a tensor as a row of ``s×s`` tiles, each tile's carry the sum of the tiles
before it.  On a CUDA tensor it launches the hand-written kernel, one pass
over many CTAs a row: each CTA scans a group of ``g`` tiles
(:func:`group_geometry`) and takes its carry-in from the decoupled look-back
(:mod:`.lookback`).  On a CPU tensor it runs :func:`scan_tiles_plain`, the
same tile algebra in plain PyTorch, whose ``tile=`` models that split.

``precision`` (:mod:`repro_torch.core.precision`) reaches the plain
version's tile products, as it reaches the Pallas kernel's.  The CUDA kernel
forms no triangle: it adds one element at a time in IEEE fp32, so its
result under ``"compensated"`` and ``"fast"`` is the bits of ``"highest"``,
which lie inside both looser bounds.
"""
from __future__ import annotations

import torch

from repro_torch.core import guards
from repro_torch.core.precision import PRECISIONS, pdot
from repro_torch.core.scan import (accum_dtype_for, strictly_lower_ones,
                                   tile_scan_scanu, upper_ones)
from repro_torch.kernels import _build, lookback

__all__ = ["scan_tiles", "scan_tiles_plain", "kernel_operand", "group_geometry",
           "VARIANTS", "MAX_TILE", "SCAN_THREADS", "SCAN_ITEMS"]

VARIANTS = ("scanul1", "scanu")
MAX_TILE = 128
# csrc/scan_tile.cuh: a CTA's threads at most, and the elements a thread holds
SCAN_THREADS = 512
SCAN_ITEMS = 32

# input dtype -> the kernel's dtype code (fp32 accumulation for 0-2, int32 for 3-6)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.int8: 3, torch.uint8: 4, torch.int16: 5, torch.int32: 6}


def _pow2_at_least(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def group_geometry(s: int, n: int):
    """How the kernel cuts a row of ``n``: ``(g, elems, groups)``.

    ``scan_geom`` of ``csrc/scan_tile.cuh``: a thread holds at most
    ``SCAN_ITEMS`` elements, ``k`` whole tile rows (``s <= 32``) or one of the
    ``ceil(s / 32)`` segments of a row; a CTA of at most ``SCAN_THREADS``
    threads scans a group of ``g`` tiles, ``elems = g·s²`` elements, and a row
    is ``groups`` groups, one CTA each.
    """
    q = -(-s // 32)
    k = 1
    if q == 1:
        while s % (2 * k) == 0 and 2 * k * s <= SCAN_ITEMS:
            k *= 2
    per_tile = _pow2_at_least(s // k if q == 1 else s * _pow2_at_least(q))
    g = max(1, min(SCAN_THREADS // per_tile, -(-n // (s * s))))
    elems = g * s * s
    return g, elems, -(-n // elems)


def _tile_scanul1(a: torch.Tensor, *, accum_dtype: torch.dtype,
                  precision: str) -> torch.Tensor:
    """The Pallas kernel's ScanUL1 tile step, ``A@U_s + L⁻_s @ (A@1_s)``.

    Unlike :func:`repro_torch.core.scan.tile_scan_scanul1`, which sums the
    rows in ``accum_dtype``, the kernel forms ``C1 = A@1_s`` as a product
    too, so under ``"fast"`` its row sums are of the bf16 operands.
    """
    s = a.shape[-1]
    u = upper_ones(s, a.dtype, a.device)
    ones = torch.ones((s, s), dtype=a.dtype, device=a.device)
    lm = strictly_lower_ones(s, accum_dtype, a.device)
    c2 = pdot(a, u, acc=accum_dtype, precision=precision, exact="right")
    c1 = pdot(a, ones, acc=accum_dtype, precision=precision, exact="right")
    return c2 + pdot(lm, c1, acc=accum_dtype, precision=precision, exact="left")


def scan_tiles_plain(xb: torch.Tensor, *, s: int, variant: str,
                     acc: torch.dtype, tile: int | None = None,
                     precision: str = "highest") -> torch.Tensor:
    """Plain version of the kernel on a ``(b, n)`` tensor.

    Per tile ``local = A@U_s (+ L⁻_s@(A@1_s))``, then the carry, the sum of the
    tile totals before it (``out[-1, -1]`` of each tile).

    ``tile=None`` links all of a row's tiles as one ordered walk (an exclusive
    running sum of the totals).  ``tile`` (a multiple of ``s²``) models the
    kernel's split: the row is cut into groups of ``tile`` elements, ``g =
    tile / s²`` tiles; tile ``i`` of group ``k`` gets ``P_{k-1} + E_i``, where
    ``E_i`` folds the group's earlier tile totals from 0, the group's total
    ``A_k`` is ``E_g`` and ``P_k = P_{k-1} + A_k`` is the look-back's strict
    fold (:func:`.lookback.fold_exclusive`).  Integer sums are the same for
    every tile.  ``precision`` reaches every tile product.
    """
    b, n = xb.shape
    ell = s * s
    fn = _tile_scanul1 if variant == "scanul1" else tile_scan_scanu
    if tile is not None:
        if tile % ell:
            raise ValueError(f"scan_tiles_plain: tile={tile} is not a multiple of s*s={ell}")
        pad = (-n) % tile
        xp = torch.nn.functional.pad(xb.to(acc), (0, pad)) if pad else xb
        local = fn(xp.reshape(b, -1, tile // ell, s, s), accum_dtype=acc,
                   precision=precision)                      # (b, K, g, s, s)
        totals = local[..., -1, -1]
        run = torch.zeros_like(totals[..., 0])
        offsets = torch.empty_like(totals)
        for i in range(totals.shape[-1]):
            offsets[..., i] = run
            run = run + totals[..., i]
        carry = lookback.fold_exclusive(run)[..., None] + offsets
        return (local + carry[..., None, None]).reshape(b, -1)[:, :n]
    pad = (-n) % ell
    xp = torch.nn.functional.pad(xb.to(acc), (0, pad)) if pad else xb
    tiles = xp.reshape(b, -1, s, s)
    local = fn(tiles, accum_dtype=acc, precision=precision)  # (b, nt, s, s)
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


def _scan_tiles_cuda(xb: torch.Tensor, *, s: int, variant: str, acc: torch.dtype,
                     ws: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of B1; ``ws`` (the look-back's workspace, allocated here if
    None) ends with the count of CTAs that ran, ``b · groups``."""
    xb, code = kernel_operand(xb, acc, op="scan_tiles")
    b, n = xb.shape
    out = torch.empty((b, n), dtype=acc, device=xb.device)
    if ws is None:
        ws = lookback.workspace(b * group_geometry(s, n)[2], xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        _build.launch("scan_mm", xb.data_ptr(), out.data_ptr(), b, n, s,
                      1 if variant == "scanul1" else 0, code, ws.data_ptr(),
                      ws.numel() * ws.element_size(), stream)
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
        precision: One of ``PRECISIONS``, already resolved: the plain
            version's tile products follow it; the kernel's sums do not.

    Returns:
        The inclusive scan in the accumulation dtype, shaped like ``x``.
    """
    variant = guards.validate_choice(variant, VARIANTS, name="variant",
                                     op="scan_tiles")
    guards.validate_choice(precision, PRECISIONS, name="precision", op="scan_tiles")
    s = guards.validate_positive(s, name="s", op="scan_tiles")
    if s > MAX_TILE:
        raise ValueError(f"scan_tiles: s must be <= {MAX_TILE}, got {s}")
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(x.dtype)
    *lead, n = x.shape
    xb = x.reshape(-1, n)
    if n == 0 or xb.shape[0] == 0:
        return torch.zeros(x.shape, dtype=acc, device=x.device)
    if xb.is_cuda:
        out = _scan_tiles_cuda(xb, s=s, variant=variant, acc=acc)
    else:
        out = scan_tiles_plain(xb, s=s, variant=variant, acc=acc, precision=precision)
    return out.reshape(x.shape)

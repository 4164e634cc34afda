"""Matmul-based parallel scan (prefix sum) — the paper's core contribution.

Port of ``repro/core/scan.py``:

* ``ScanU`` (paper Alg. 1): ``A @ U_s`` computes ``s`` row-local scans of
  the ``s×s`` tile view ``A``; the row partials are then propagated with a
  cumsum of the row sums.
* ``ScanUL1`` (paper Alg. 2 / Eq. 1): the whole tile scan as matmuls,
  ``scan(z) = A @ U_s + L⁻_s @ (A @ 1_s)``.
* A multi-level block scan over tiles so any length runs in linear work.

Methods: ``"vector"`` is ``torch.cumsum``; ``"matmul"`` is the tile algebra
above as torch matrix products; ``"kernel"`` is the hand-written CUDA tile
scan (``repro_torch.kernels.scan_mm``, B1); ``"blocked"`` is the §4 three-phase
pipeline (``repro_torch.kernels.scan_pipeline``: block sums, carry scan and
the fused block scan plus carry, B2–B4).  The two kernel methods run their
plain PyTorch versions on CPU tensors.

Dtype rules follow the paper's cube unit: int8/uint8/int16/bool accumulate in
int32, bf16/fp16 in fp32, everything else in its own dtype.  Every method
returns the accumulation dtype, which makes the methods bit-comparable.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import guards
from repro_torch.core.autotune import maybe_resolve
from repro_torch.core.precision import pdot, resolve_precision

__all__ = ["scan", "cumsum", "tile_scan_scanu", "tile_scan_scanul1",
           "upper_ones", "strictly_lower_ones", "accum_dtype_for", "METHODS"]

METHODS = ("matmul", "vector", "kernel", "blocked")

_INT32_ACC = (torch.int8, torch.uint8, torch.int16, torch.bool)
_F32_ACC = (torch.bfloat16, torch.float16)


def upper_ones(s: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``U_s``: upper triangular all-ones (diagonal included)."""
    return torch.triu(torch.ones((s, s), dtype=dtype, device=device))


def strictly_lower_ones(s: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``L⁻_s``: strictly lower triangular all-ones (zero diagonal)."""
    return torch.tril(torch.ones((s, s), dtype=dtype, device=device), diagonal=-1)


def accum_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype mirroring the Ascend cube unit I/O types.

    Example:
        >>> accum_dtype_for(torch.int8), accum_dtype_for(torch.bfloat16)
        (torch.int32, torch.float32)
    """
    if dtype in _INT32_ACC:
        return torch.int32
    if dtype in _F32_ACC:
        return torch.float32
    return dtype


def _operand_dtype(dtype: torch.dtype) -> torch.dtype:
    """Dtype in which the constant triangles are fed to the matrix product."""
    if dtype in (torch.int8, torch.bool, torch.uint8):
        return torch.int8
    if dtype in (torch.int16, torch.int32, torch.bfloat16, torch.float16):
        return dtype
    return torch.float32


def tile_scan_scanu(a: torch.Tensor, *, accum_dtype=None,
                    precision: str = "highest") -> torch.Tensor:
    """ScanU tile step (Alg. 1): ``A @ U_s`` plus the exclusive row-sum prefix.

    Example:
        >>> tile_scan_scanu(torch.arange(1.0, 5.0).reshape(2, 2)).tolist()
        [[1.0, 3.0], [6.0, 10.0]]
    """
    s = a.shape[-1]
    acc = accum_dtype or accum_dtype_for(a.dtype)
    u = upper_ones(s, _operand_dtype(a.dtype), a.device)
    local = pdot(a, u, acc=acc, precision=precision, exact="right")
    row_sums = local[..., :, -1]
    row_prefix = torch.cumsum(row_sums, dim=-1, dtype=acc) - row_sums
    return local + row_prefix[..., :, None]


def tile_scan_scanul1(a: torch.Tensor, *, accum_dtype=None,
                      precision: str = "highest") -> torch.Tensor:
    """ScanUL1 tile step (Alg. 2 / Eq. 1): ``A@U_s + L⁻_s @ (A@1_s)``.

    Example:
        >>> tile_scan_scanul1(torch.arange(1.0, 5.0).reshape(2, 2)).tolist()
        [[1.0, 3.0], [6.0, 10.0]]
    """
    s = a.shape[-1]
    acc = accum_dtype or accum_dtype_for(a.dtype)
    od = _operand_dtype(a.dtype)
    u = upper_ones(s, od, a.device)
    lm = strictly_lower_ones(s, od, a.device)
    c2 = pdot(a, u, acc=acc, precision=precision, exact="right")
    # C1 = A @ 1_s == the row sums broadcast along the columns
    c1 = torch.sum(a.to(acc), dim=-1, keepdim=True, dtype=acc).expand(
        *a.shape[:-1], s)
    return c2 + pdot(lm.to(acc), c1, acc=acc, precision=precision, exact="left")


_TILE_FNS = {"scanu": tile_scan_scanu, "scanul1": tile_scan_scanul1}


def _scan_last_axis_matmul(x: torch.Tensor, s: int, variant: str, acc,
                           precision: str) -> torch.Tensor:
    """Multi-level block scan over the last axis using matmul tile scans."""
    *lead, n = x.shape
    ell = s * s
    if n <= s:
        if n == 1:
            return x.to(acc)
        u = upper_ones(n, _operand_dtype(x.dtype), x.device)
        return pdot(x[..., None, :], u, acc=acc, precision=precision,
                    exact="right")[..., 0, :]
    n_pad = (-n) % ell
    xp = torch.nn.functional.pad(x, (0, n_pad)) if n_pad else x
    nt = xp.shape[-1] // ell
    tiles = xp.reshape(*lead, nt, s, s)
    local = _TILE_FNS[variant](tiles, accum_dtype=acc, precision=precision)
    tile_sums = local[..., -1, -1]
    if nt > ell:
        tile_prefix = _scan_last_axis_matmul(tile_sums, s, variant, acc, precision)
    else:
        tile_prefix = torch.cumsum(tile_sums, dim=-1, dtype=acc)
    tile_prefix = tile_prefix - tile_sums                       # exclusive
    out = (local + tile_prefix[..., None, None]).reshape(*lead, nt * ell)
    return out[..., :n] if n_pad else out


def scan(x: torch.Tensor, axis: int = -1, *, exclusive: bool = False,
         reverse: bool = False, method: str = "auto",
         precision: str = "highest", variant: str = "scanul1",
         tile_s: int = 128, block_tiles: int = 8,
         accum_dtype: Optional[torch.dtype] = None,
         nonfinite: str = "propagate") -> torch.Tensor:
    """Inclusive (or exclusive) prefix sum along ``axis``.

    Args:
        x: Input tensor of any shape; it runs where it lives.
        axis: Axis to scan along.
        exclusive: Shift the result right by one with a leading zero.
        reverse: Scan from the end (suffix sums).
        method: ``"auto"`` (tuning table), ``"vector"``, ``"matmul"``,
            ``"kernel"`` or ``"blocked"``.
        precision: ``"highest"``, ``"compensated"`` or ``"fast"``
            (:mod:`repro_torch.core.precision`; ``precision_override`` >
            ``REPRO_SCAN_PRECISION`` > this argument).  On ``"matmul"`` and the
            kernels' plain versions (CPU tensors) the tile products follow it;
            the CUDA kernels sum in IEEE fp32 and return the bits of
            ``"highest"`` under every precision.  Only fp32 inputs are affected;
            an explicit non-default precision with ``method="vector"`` raises.
        variant: ``"scanu"`` (Alg. 1) or ``"scanul1"`` (Alg. 2).
        tile_s: Tile side ``s``; a tile covers ``s²`` elements.
        block_tiles: Tiles per block for ``method="blocked"`` (ignored
            otherwise, but validated as positive); a block covers
            ``block_tiles * tile_s²`` elements.
        accum_dtype: Accumulation dtype override.
        nonfinite: Non-finite input policy (:mod:`repro_torch.core.guards`;
            ``nonfinite_override`` > ``REPRO_NONFINITE`` > this argument):
            ``"propagate"`` keeps IEEE semantics and adds no operation,
            ``"raise"`` rejects a non-finite input before any launch,
            ``"sanitize"`` replaces non-finite elements with 0.  Integer scans
            are unaffected.

    Returns:
        The scanned tensor, same shape as ``x``, in the accumulation dtype.

    Raises:
        NonFiniteError: ``nonfinite="raise"`` and ``x`` holds a non-finite value.
        NotImplementedError: ``x`` requires grad under grad mode and the method
            is ``"kernel"`` or ``"blocked"``, where ``jax.grad`` fails too
            (``guards.refuse_grad``); ``"vector"`` and ``"matmul"`` differentiate.

    Example:
        >>> scan(torch.arange(1, 9, dtype=torch.int32), method="vector").tolist()
        [1, 3, 6, 10, 15, 21, 28, 36]
        >>> scan(torch.arange(1, 5), exclusive=True, method="matmul").tolist()
        [0, 1, 3, 6]
        >>> scan(torch.ones(10, dtype=torch.int8), method="blocked", tile_s=8)[-1].item()
        10
    """
    if method != "auto" and method not in METHODS:
        raise ValueError(f"unknown scan method {method!r}; expected one of "
                         f"{METHODS + ('auto',)}")
    if variant not in _TILE_FNS:
        raise ValueError(f"unknown scan variant {variant!r}")
    block_tiles = guards.validate_positive(block_tiles, name="block_tiles", op="scan")
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(x.dtype)
    axis = guards.validate_axis(axis, x.dim(), op="scan")
    explicit_method = method != "auto"
    method = maybe_resolve(method, "scan", x.shape[axis], x.dtype,
                           device=x.device)
    precision = resolve_precision(precision, method=method,
                                  explicit_method=explicit_method)
    guards.refuse_grad(x, op="scan", method=method)
    x = guards.apply_nonfinite(x, guards.resolve_nonfinite(nonfinite, op="scan"), op="scan")
    last = x.dim() - 1
    if axis != last:
        x = torch.movedim(x, axis, -1)
    if reverse:
        x = torch.flip(x, dims=(-1,))

    if method == "vector":
        out = torch.cumsum(x, dim=-1, dtype=acc)
    elif method == "kernel":
        from repro_torch.kernels.scan_mm import scan_tiles  # local import: no cycle
        out = scan_tiles(x, s=tile_s, variant=variant, accum_dtype=acc,
                         precision=precision)
    elif method == "blocked":
        from repro_torch.kernels.scan_pipeline import blocked_scan  # no cycle
        out = blocked_scan(x, s=tile_s, block_tiles=block_tiles, variant=variant,
                           accum_dtype=acc, precision=precision)
    else:
        out = _scan_last_axis_matmul(x, tile_s, variant, acc, precision)

    if exclusive:
        out = torch.cat([torch.zeros_like(out[..., :1]), out[..., :-1]], dim=-1)
    if reverse:
        out = torch.flip(out, dims=(-1,))
    if axis != last:
        out = torch.movedim(out, -1, axis)
    return out


def cumsum(x: torch.Tensor, axis: int = -1, **kw) -> torch.Tensor:
    """Drop-in ``torch.cumsum`` replacement backed by :func:`scan`."""
    return scan(x, axis=axis, **kw)

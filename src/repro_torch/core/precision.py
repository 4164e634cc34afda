"""Precision policy for the matmul-method scans — the ``"highest"`` slice.

Port of ``repro/core/precision.py``.  Only ``precision="highest"`` is ported:
operands reach the matrix product in fp32 (or exactly, for integers) and
accumulate in the accumulation dtype.  ``"compensated"`` and ``"fast"`` raise
``NotImplementedError`` until they are ported (ROADMAP Queue A item 2), and
so does the fp16 split behind them; :func:`normalize_exponents`, the exact
exponent split of the linear recurrences' weighted triangle, is ported.

PyTorch has no ``preferred_element_type``, so :func:`pdot` casts both operands
to the accumulation dtype before the product.  That is exact for the cases the
scans use: int8/int16/int32 operands into int32, and bf16/fp16 into fp32.
Two device rules follow from torch's kernels:

* ``int8 @ int8`` in torch returns int8 and wraps, so integer operands are
  widened first;
* CUDA has no integer matmul, so on the card integer products run in fp64,
  which is exact for the 0/1 triangles and int8 masks (every partial sum of
  the scans stays far below 2^53) and is then cast back to the integer dtype.

``"highest"`` must never run in TF32: :func:`pdot` refuses an fp32 product on
the card while ``torch.backends.cuda.matmul.allow_tf32`` is set.
"""
from __future__ import annotations

import torch

__all__ = ["PRECISIONS", "resolve_precision", "pdot", "require_ieee_fp32",
           "normalize_exponents"]

PRECISIONS = ("highest", "compensated", "fast")
_SQRT_HALF = 0.7071067811865476


def resolve_precision(precision: str = "highest", *, method=None,
                      explicit_method: bool = True) -> str:
    """Validate ``precision`` for one call; only ``"highest"`` is ported.

    Mirrors the JAX rule that an explicit ``method="vector"`` combined with
    an explicit non-default precision is rejected.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{PRECISIONS}")
    if method == "vector" and explicit_method and precision != "highest":
        raise ValueError(
            f"precision={precision!r} requires a matmul-engine method "
            "('matmul' or 'kernel'); method='vector' never touches the "
            "matrix engine")
    if precision != "highest":
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet (ROADMAP Queue A "
            "item 2); only 'highest' is available")
    return precision


def require_ieee_fp32() -> None:
    """Raise unless fp32 products on the card run in full fp32 (no TF32)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "precision='highest' needs IEEE fp32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def normalize_exponents(a: torch.Tensor, acc: torch.dtype):
    """Split ``a`` exactly into mantissas in ``[√½, √2)`` and int32 exponents.

    ``a == a_norm · 2^e`` with no rounding (``frexp`` and the conditional
    doubling move exponents only).  Mantissas centred on 1 keep a product of
    ``n`` of them within ``2^±(n/2)``, the bound the linear recurrences'
    weighted triangle (``repro_torch.core.linrec._pair_w``) relies on.

    Example:
        >>> m, e = normalize_exponents(torch.tensor([0.25, 3.0]), torch.float32)
        >>> m.tolist(), e.tolist()
        ([1.0, 0.75], [-2, 2])
    """
    m, e = torch.frexp(a.to(acc))                         # a = m·2^e, |m| ∈ [½, 1)
    small = m.abs() < _SQRT_HALF
    a_norm = torch.where(small, m * 2, m).to(acc)
    es = torch.where(small, e - 1, e).to(torch.int32)
    return a_norm, es


def pdot(a: torch.Tensor, b: torch.Tensor, *, acc: torch.dtype,
         precision: str = "highest") -> torch.Tensor:
    """``a @ b`` accumulated in ``acc`` (``precision="highest"`` only).

    Example:
        >>> a = torch.tensor([[100, 100, 100, 100]], dtype=torch.int8)
        >>> u = torch.ones((4, 1), dtype=torch.int8)
        >>> pdot(a, u, acc=torch.int32).tolist()
        [[400]]
    """
    if precision != "highest":
        resolve_precision(precision)
    if not acc.is_floating_point and a.is_cuda:
        # no integer matmul kernel on CUDA; fp64 products are exact here
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(acc)
    if acc == torch.float32 and a.is_cuda:
        require_ieee_fp32()
    return torch.matmul(a.to(acc), b.to(acc))

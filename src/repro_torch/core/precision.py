"""Precision policy for the matmul-method scans — the ``"highest"`` slice.

Port of ``repro/core/precision.py``.  Only ``precision="highest"`` is ported:
operands reach the matrix product in fp32 (or exactly, for integers) and
accumulate in the accumulation dtype.  ``"compensated"`` and ``"fast"`` raise
``NotImplementedError`` until they are ported (ROADMAP Queue A item 2).

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

__all__ = ["PRECISIONS", "resolve_precision", "pdot", "require_ieee_fp32"]

PRECISIONS = ("highest", "compensated", "fast")


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

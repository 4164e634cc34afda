"""Precision policy for the matmul-method scans (``precision=``).

Port of ``repro/core/precision.py``.  Every triangular contraction of the
float scan family goes through :func:`pdot`, which honours three precisions:

* ``"highest"`` (default) — operands reach the product in fp32 (or exactly,
  for integers) and accumulate in the accumulation dtype;
* ``"compensated"`` — fp32 data operands split **exactly** into an fp16 high
  part plus a ``2^-11``-scaled fp16 low part after an exact per-slice
  power-of-two scaling (:func:`split_f16`); the cross terms contract with
  fp32 accumulation and recombine to ~22 significand bits (the ``lo×lo``
  term, under ``2^-22`` relative, is dropped);
* ``"fast"`` — bf16 operands with fp32 accumulation (~8 significand bits).

Resolution mirrors ``method="auto"``: an active :func:`precision_override`
wins, else the ``REPRO_SCAN_PRECISION`` environment variable, else the
call-site argument (:func:`resolve_precision`).  An explicit
``method="vector"`` with an explicit non-default precision raises
``ValueError``; when ``"auto"``, an override or the environment lands on
``"vector"`` the precision degrades to ``"highest"`` silently.

Only fp32 data operands are ever split: integer contractions stay exact and
bf16/fp16 data already feed the product natively, so for those every
precision is ``"highest"``.

PyTorch has no ``preferred_element_type``, and a product of fp16 or bf16
operands returns fp16 or bf16, rounding the fp32 sum away.  So the split
parts are cast back to fp32 before their product: a product of two fp16 (or
two bf16) values is exact in fp32, and the sum then accumulates in fp32, as
the JAX product does up to the order of the sum.  The casts and the integer
rules:

* ``int8 @ int8`` in torch returns int8 and wraps, so integer operands are
  widened first;
* CUDA has no integer matmul, so on the card integer products run in fp64,
  which is exact for the 0/1 triangles and int8 masks (every partial sum of
  the scans stays far below 2^53) and is then cast back to the integer dtype;
* an fp32 product on the card must never run in TF32: :func:`pdot` refuses
  one while ``torch.backends.cuda.matmul.allow_tf32`` is set.

``torch.ldexp`` multiplies by ``2.0 ** e`` formed in the input's dtype, which
overflows or flushes for ``|e| > 127`` although the result is finite; the
split scales a slice whose max is subnormal by up to ``2^149``, and the
data×data product's ``ea + eb`` can pass ±127.  :func:`ldexp` therefore
scales in fp64 and rounds once to fp32.  The port keeps subnormals: XLA on
the CPU flushes them to zero in the split's scaling, so on subnormal inputs
the two packages differ (ROADMAP Queue C), and the port is held to fp64.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import torch

from repro_torch.kernels._build import on_card

__all__ = ["PRECISIONS", "SPLIT_SHIFT", "ENV_VAR", "resolve_precision",
           "precision_override", "split_f16", "ldexp", "pdot", "require_ieee_fp32",
           "normalize_exponents"]

PRECISIONS = ("highest", "compensated", "fast")
ENV_VAR = "REPRO_SCAN_PRECISION"

# fp16 carries 11 significand bits (the implicit one included): the low part is
# pre-scaled by 2^SPLIT_SHIFT so its leading bits are the residual bits the
# high part dropped.
SPLIT_SHIFT = 11

_SQRT_HALF = 0.7071067811865476

_OVERRIDE: List[str] = []


def _check_known(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{PRECISIONS}")


@contextlib.contextmanager
def precision_override(precision: str):
    """Force every precision resolution to ``precision`` inside the block.

    The in-process form of ``REPRO_SCAN_PRECISION``, which it outranks; the
    precision counterpart of :func:`repro_torch.core.autotune.method_override`.
    On a call that runs ``"vector"`` it degrades to ``"highest"``; integer
    contractions stay exact under every precision.

    Example:
        >>> with precision_override("compensated"):
        ...     resolve_precision("highest", method="matmul")
        'compensated'
    """
    _check_known(precision)
    _OVERRIDE.append(precision)
    try:
        yield
    finally:
        _OVERRIDE.pop()


def _env_precision() -> Optional[str]:
    """The ``REPRO_SCAN_PRECISION`` forced precision, or ``None``."""
    p = os.environ.get(ENV_VAR)
    if not p:
        return None
    if p not in PRECISIONS:
        raise ValueError(f"{ENV_VAR}={p!r} is not a known precision; expected one of "
                         f"{PRECISIONS}")
    return p


def resolve_precision(precision: str = "highest", *, method: Optional[str] = None,
                      explicit_method: bool = True) -> str:
    """The effective precision of one call: override > environment > argument.

    Args:
        precision: The caller's ``precision=`` argument.
        method: The call's resolved method (never ``"auto"``); ``None`` skips
            the vector-path rules.
        explicit_method: Whether the caller named the method (``False`` when
            ``method="auto"`` picked it).

    Returns:
        One of ``PRECISIONS``.

    Raises:
        ValueError: An unknown precision (argument or environment), or an
            explicit non-default ``precision`` with an explicit
            ``method="vector"``, which never forms a product.

    Example:
        >>> resolve_precision("compensated", method="kernel")
        'compensated'
        >>> resolve_precision("compensated", method="vector", explicit_method=False)
        'highest'
    """
    _check_known(precision)
    if method == "vector" and explicit_method and precision != "highest":
        raise ValueError(
            f"precision={precision!r} requires a matmul-engine method "
            "('matmul', 'kernel' or 'blocked'); method='vector' never touches the "
            "matrix engine.  Drop precision= (the vector path is the fp32 "
            "reference) or pick an engine method / method='auto'.")
    p = _OVERRIDE[-1] if _OVERRIDE else None
    if p is None:
        p = _env_precision()
    if p is None:
        p = precision
    if method == "vector" and p != "highest":
        return "highest"            # auto, override or env landed on the fp32 path
    return p


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


def ldexp(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x · 2^e`` in ``x``'s dtype with one rounding, for ``|e|`` up to 1000.

    The power of two is built from its fp64 bits and the product formed in
    fp64, where it is exact, then rounded once (to a subnormal, or to inf,
    only where the true value lies there).  inf, NaN and zeros pass through.

    Example:
        >>> ldexp(torch.tensor([2.0 ** -140]), torch.tensor([200])).tolist()
        [1.152921504606847e+18]
    """
    p2 = ((e.to(torch.int64) + 1023) << 52).view(torch.float64)
    return (x.to(torch.float64) * p2).to(x.dtype)


def split_f16(x: torch.Tensor, axis: int):
    """Exact per-slice scaled split of fp32 ``x`` into fp16 high and low parts.

    Each slice along ``axis`` (the contraction axis of the product the parts
    feed) is scaled by a power of two so that its largest finite magnitude
    lies in ``[½, 1)``; the high part is the fp16 rounding of the scaled
    slice, and the residual, exact in fp32, is pre-scaled by
    ``2^SPLIT_SHIFT`` and rounded to fp16 as the low part::

        x ≈ ldexp(hi + ldexp(lo, -SPLIT_SHIFT), e)      (~22 significand bits)

    Non-finite values ride the high part unchanged with a zero residual.

    Returns:
        ``(hi, lo, e)``: fp16 parts shaped like ``x`` and the int32 exponent
        with the slice axis kept (size 1).

    Example:
        >>> hi, lo, e = split_f16(torch.tensor([[3.0, 0.0078125]]), axis=-1)
        >>> x = ldexp(hi.float() + ldexp(lo.float(), torch.tensor(-SPLIT_SHIFT)), e)
        >>> x.tolist()
        [[3.0, 0.0078125]]
    """
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=x.device)
    finite = torch.isfinite(x)
    mag = torch.where(finite, x.abs(), zero)
    _, e = torch.frexp(torch.amax(mag, dim=axis, keepdim=True))
    xs = ldexp(x, -e)                                     # max finite |xs| ∈ [½, 1)
    hi = xs.to(torch.float16)
    r = torch.where(finite, xs - hi.to(f32), zero)
    lo = ldexp(r, torch.full_like(e, SPLIT_SHIFT)).to(torch.float16)
    return hi, lo, e.to(torch.int32)


def _mm(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``a @ b`` accumulated in ``acc``; operands are exact in ``acc``."""
    if not acc.is_floating_point and on_card(a):
        # no integer matmul kernel on CUDA; fp64 products are exact here
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(acc)
    if acc == torch.float32 and a.is_cuda:
        require_ieee_fp32()
    return torch.matmul(a.to(acc), b.to(acc))


def pdot(a: torch.Tensor, b: torch.Tensor, *, acc: torch.dtype,
         precision: str = "highest", exact: str = "none") -> torch.Tensor:
    """``a @ b`` accumulated in ``acc`` at ``precision`` (already resolved).

    Args:
        a: Left operand ``(..., m, k)``.
        b: Right operand ``(..., k, n)``.
        acc: Accumulation dtype.
        precision: One of ``PRECISIONS``.
        exact: Which operand is an exact 0/1 constant (a triangle, cast and
            never split): ``"left"``, ``"right"`` or ``"none"`` (both are
            data: three products, ``lo×lo`` dropped).

    If a data operand or ``acc`` is not fp32, the call is ``"highest"``.

    Example:
        >>> a = torch.tensor([[100, 100, 100, 100]], dtype=torch.int8)
        >>> u = torch.ones((4, 1), dtype=torch.int8)
        >>> pdot(a, u, acc=torch.int32).tolist()
        [[400]]
        >>> x = torch.tensor([[1.5, 2.5]])
        >>> u = torch.triu(torch.ones(2, 2))
        >>> pdot(x, u, acc=torch.float32, precision="compensated", exact="right").tolist()
        [[1.5, 4.0]]
    """
    f32 = torch.float32
    data_f32 = acc == f32
    if exact != "left":
        data_f32 = data_f32 and a.dtype == f32
    if exact != "right":
        data_f32 = data_f32 and b.dtype == f32
    if precision == "highest" or not data_f32:
        return _mm(a, b, acc)
    _check_known(precision)
    if precision == "fast":
        return _mm(a.to(torch.bfloat16).to(f32), b.to(torch.bfloat16).to(f32), acc)
    shift = torch.tensor(-SPLIT_SHIFT, dtype=torch.int32, device=a.device)
    if exact == "right":
        hi, lo, e = split_f16(a, axis=-1)
        b16 = b.to(torch.float16).to(f32)
        p = _mm(hi.to(f32), b16, acc) + ldexp(_mm(lo.to(f32), b16, acc), shift)
        return ldexp(p, e)
    if exact == "left":
        hi, lo, e = split_f16(b, axis=-2)
        a16 = a.to(torch.float16).to(f32)
        p = _mm(a16, hi.to(f32), acc) + ldexp(_mm(a16, lo.to(f32), acc), shift)
        return ldexp(p, e)
    ah, al, ea = split_f16(a, axis=-1)
    bh, bl, eb = split_f16(b, axis=-2)
    ah, al, bh, bl = (t.to(f32) for t in (ah, al, bh, bl))
    p = _mm(ah, bh, acc) + ldexp(_mm(ah, bl, acc) + _mm(al, bh, acc), shift)
    return ldexp(p, ea + eb)

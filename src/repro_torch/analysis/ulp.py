"""ulp-accuracy oracle for the float scans (the port's own copy).

The port's copy of ``repro/analysis/ulp.py``, so that the port and its chip
smoke run hold float scans to the same contract without importing the JAX
package.  An error of ``k`` ulps means the result differs from the fp64
sequential reference by at most ``k`` fp32 spacings at the conditioning
scale, the magnitude the op accumulated through, not that of a possibly
cancelled output:

* scan: ``scale_i = Σ_{j<=i} |x_j|``;
* linear recurrence: ``scale_i = |a_i|·scale_{i-1} + |b_i|``;
* segmented scan: the global (unrestarted) scan scale, which the
  subtract-the-segment-start methods need.

The bound for ``precision`` at length ``n`` is ``ULP_COEFF[precision] · √n``
ulps, the JAX package's coefficients: 8 for ``"highest"``, 16 for
``"compensated"`` and ``8·2^16`` for ``"fast"`` (bf16's spacing).  Plain
numpy, so the oracle cannot inherit a torch rounding quirk.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ULP_COEFF", "ulp_bound", "ulp_error", "max_ulp", "scan_ref",
           "scan_scale", "linrec_ref", "linrec_scale", "segment_scan_ref",
           "segment_scan_scale"]

ULP_COEFF = {"highest": 8.0, "compensated": 16.0, "fast": 8.0 * 2.0 ** 16}


def ulp_bound(precision: str, n: int) -> float:
    """The max-ulp bound for one scan of length ``n``.

    Example:
        >>> ulp_bound("highest", 4) == 16.0
        True
    """
    return ULP_COEFF[precision] * float(np.sqrt(max(n, 1)))


def _spacing_at(scale: np.ndarray) -> np.ndarray:
    s = np.abs(np.asarray(scale, np.float64))
    tiny = float(np.finfo(np.float32).tiny)
    huge = float(np.finfo(np.float32).max)
    s = np.clip(s, tiny, huge)
    return np.spacing(s.astype(np.float32)).astype(np.float64)


def ulp_error(got, ref, scale) -> np.ndarray:
    """Elementwise error of ``got`` vs ``ref`` in fp32 ulps at ``scale``.

    Non-finite reference elements score 0 when matched exactly (same-sign
    inf, or nan) and inf otherwise.
    """
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref) / _spacing_at(scale)
    bad = ~np.isfinite(ref)
    if bad.any():
        same = (np.isnan(ref) & np.isnan(got)) | (ref == got)
        err = np.where(bad, np.where(same, 0.0, np.inf), err)
    return err


def max_ulp(got, ref, scale) -> float:
    """``max(ulp_error(...))`` — 0.0 for empty inputs."""
    e = ulp_error(got, ref, scale)
    return float(np.max(e)) if e.size else 0.0


def scan_ref(x) -> np.ndarray:
    """fp64 inclusive prefix sum over the last axis."""
    return np.cumsum(np.asarray(x, np.float64), axis=-1)


def scan_scale(x) -> np.ndarray:
    """Conditioning scale of :func:`scan_ref`: prefix sums of ``|x|``."""
    return np.cumsum(np.abs(np.asarray(x, np.float64)), axis=-1)


def linrec_ref(a, b) -> np.ndarray:
    """fp64 sequential ``y_t = a_t * y_{t-1} + b_t`` over the last axis."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    out = np.empty(np.broadcast_shapes(a.shape, b.shape))
    a, b = np.broadcast_to(a, out.shape), np.broadcast_to(b, out.shape)
    state = np.zeros(out.shape[:-1])
    for i in range(out.shape[-1]):
        state = a[..., i] * state + b[..., i]
        out[..., i] = state
    return out


def linrec_scale(a, b) -> np.ndarray:
    """Conditioning scale of :func:`linrec_ref`: the ``|a|, |b|`` recurrence."""
    return linrec_ref(np.abs(np.asarray(a, np.float64)), np.abs(np.asarray(b, np.float64)))


def segment_scan_ref(x, offsets) -> np.ndarray:
    """fp64 per-segment inclusive prefix sums of the packed last axis of ``x``."""
    x = np.asarray(x, np.float64)
    off = np.asarray(offsets)
    out = np.empty_like(x)
    for i in range(off.shape[0] - 1):
        out[..., off[i]:off[i + 1]] = np.cumsum(x[..., off[i]:off[i + 1]], axis=-1)
    return out


def segment_scan_scale(x, offsets) -> np.ndarray:
    """Conditioning scale of :func:`segment_scan_ref`: the global ``|x|`` prefix.

    Not restarted at boundaries: the subtract-the-segment-start formulation
    (``"matmul"``, ``"vector"``) rounds at the packed global prefix scale, so
    the contract shared by every method is stated there.
    """
    del offsets
    return scan_scale(x)

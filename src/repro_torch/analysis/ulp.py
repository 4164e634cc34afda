"""ulp-accuracy oracle for the float scans (the port's own copy).

The port's copy of the scan half of ``repro/analysis/ulp.py``, so that the
port and its chip smoke run hold float scans to the same contract without
importing the JAX package.  An error of ``k`` ulps means the result differs
from the fp64 sequential reference by at most ``k`` fp32 spacings at the
conditioning scale ``scale_i = Σ_{j<=i} |x_j|`` — the magnitude the scan
accumulated through, not that of a possibly cancelled output.  The bound for
``precision="highest"`` is ``8 · √n`` ulps (the JAX package's coefficient).
Plain numpy, so the oracle cannot inherit a torch rounding quirk.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ULP_COEFF", "ulp_bound", "ulp_error", "max_ulp", "scan_ref",
           "scan_scale"]

ULP_COEFF = {"highest": 8.0}


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

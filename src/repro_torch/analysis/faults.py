"""Fault-injection harness for the guard layer (dispatch rule 10).

Port of ``repro/analysis/faults.py``.  ``tests/test_torch_faults.py`` drives
every injector below through the public operators and holds each fault to one
of the documented outcomes, never to silence or a crash inside a kernel:

* ``"value"`` / ``"type"``: rejected at the call site (``ValueError`` /
  ``TypeError`` from the validators);
* ``"nonfinite"``: rejected by ``nonfinite="raise"``
  (:class:`repro_torch.core.guards.NonFiniteError`);
* ``"checkified"``: caught by a :func:`~repro_torch.core.guards.guard_check`
  with checks on (:class:`repro_torch.core.guards.GuardCheckError`, where JAX
  raises ``checkify.JaxRuntimeError``);
* ``"ok"``: the call completed, as ``nonfinite="propagate"`` (IEEE semantics)
  and ``"sanitize"`` (the identity element, the greedy token) document.

JAX's ``"degraded"`` outcome (a failed lowering probe falling back to another
method) does not exist here: the port has no fallback.  A kernel method whose
libraries cannot be built or loaded raises
:class:`repro_torch.core.guards.KernelUnavailableError` from the backend probe
(``force_probe_failure`` simulates it), and :func:`classify` lets it
propagate, as JAX's ``classify`` does with exceptions it does not know.

The injectors are seeded, and :func:`inject_nonfinite` draws its positions
from numpy exactly as the JAX package does, so both packages poison the same
elements.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.guards import (  # noqa: F401  (re-exported harness hooks)
    GuardCheckError, NonFiniteError, checked, checks,
)

__all__ = [
    "OUTCOMES", "inject_nonfinite", "corrupt_offsets", "adversarial_params",
    "classify", "NonFiniteError", "GuardCheckError", "checked", "checks",
]

OUTCOMES = ("ok", "value", "type", "nonfinite", "checkified")


def inject_nonfinite(x: torch.Tensor, kind: str = "nan", frac: float = 0.1,
                     seed: int = 0) -> torch.Tensor:
    """Poison a seeded fraction of ``x`` with a non-finite payload.

    The positions are ``numpy.random.default_rng(seed).choice(x.numel(), k,
    replace=False)`` with ``k = max(1, int(frac * x.numel()))``, as in the JAX
    package; only those ``k`` elements are written, on ``x``'s device.

    Args:
        x: Float tensor to corrupt (it is not modified).
        kind: ``"nan"``, ``"inf"``, ``"-inf"``, or ``"extreme"`` (alternating
            ``±max_float``: finite, but it overflows any accumulation).
        frac: Fraction of elements to poison (at least one).
        seed: Seed of the poisoned positions.

    Returns:
        A copy of ``x`` with the payload written at the chosen positions.

    Example:
        >>> x = inject_nonfinite(torch.ones(8), "nan", frac=0.25)
        >>> int(torch.isnan(x).sum())
        2
    """
    payloads = {"nan": float("nan"), "inf": float("inf"), "-inf": float("-inf"),
                "extreme": None}
    if kind not in payloads:
        raise ValueError(f"unknown kind {kind!r}; expected one of {tuple(payloads)}")
    out = x.clone()
    flat = out.view(-1)
    k = max(1, int(frac * flat.numel()))
    idx = np.random.default_rng(seed).choice(flat.numel(), size=k, replace=False)
    where = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
    if kind == "extreme":
        big = torch.finfo(x.dtype).max
        vals = torch.as_tensor(np.where(np.arange(k) % 2 == 0, big, -big), dtype=x.dtype,
                               device=x.device)
        flat[where] = vals
    else:
        flat[where] = payloads[kind]
    return out


def corrupt_offsets(offsets, mode: str = "unsorted") -> torch.Tensor:
    """Break CSR offsets in one specific, documented way.

    Args:
        offsets: Valid ``(num_segments + 1,)`` int offsets.
        mode: ``"unsorted"`` (swap two interior offsets), ``"negative"`` (first
            entry below zero), ``"overrun"`` (last entry past ``n``), ``"head"``
            (first entry nonzero), or ``"float"`` (float dtype, a ``TypeError``).

    Example:
        >>> corrupt_offsets(torch.tensor([0, 3, 5]), "overrun").tolist()
        [0, 3, 6]
    """
    off = np.array(torch.as_tensor(offsets).cpu().numpy(), copy=True)
    if mode == "unsorted":
        if off.shape[0] < 3:
            raise ValueError("unsorted needs at least two segments")
        mid = off.shape[0] // 2
        off[mid], off[mid - 1] = off[mid - 1], off[mid] + 1
    elif mode == "negative":
        off[0] = -1
    elif mode == "overrun":
        off[-1] = off[-1] + 1
    elif mode == "head":
        off[0] = 1
    elif mode == "float":
        return torch.as_tensor(off, dtype=torch.float32)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return torch.as_tensor(off)


def adversarial_params(which: str) -> dict:
    """Named adversarial sampler parameter sets for the fault suite.

    Example:
        >>> adversarial_params("p_over")["p"]
        1.5
    """
    table = {
        "p_over": {"p": 1.5},
        "p_under": {"p": -0.1},
        "p_nan": {"p": float("nan")},
        "temp_negative": {"temperature": -1.0},
        "temp_nan": {"temperature": float("nan")},
        "temp_inf": {"temperature": float("inf")},
        "temp_zero": {"temperature": 0.0},   # legal: the greedy limit
    }
    if which not in table:
        raise ValueError(f"unknown param set {which!r}; expected one of {tuple(table)}")
    return dict(table[which])


def classify(fn, *args, **kwargs) -> Tuple[str, Optional[object]]:
    """Run ``fn(*args, **kwargs)`` and classify its outcome.

    Returns ``(outcome, detail)``: ``outcome`` is one of ``OUTCOMES`` and
    ``detail`` the result (``"ok"``) or the exception.  Any other exception
    propagates, :class:`~repro_torch.core.guards.KernelUnavailableError`
    among them: an undocumented failure is what the fault suite must flag.
    A result on the card is synchronized before it counts as ``"ok"``.

    Example:
        >>> from repro_torch.core.scan import scan
        >>> classify(scan, torch.ones(4), axis=7)[0]
        'value'
    """
    try:
        out = fn(*args, **kwargs)
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.synchronize(out.device)
    except NonFiniteError as e:
        return "nonfinite", e
    except GuardCheckError as e:
        return "checkified", e
    except TypeError as e:
        return "type", e
    except ValueError as e:
        return "value", e
    return "ok", out

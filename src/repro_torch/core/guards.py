"""Pre-dispatch validation shared by the port's public entry points.

Port of the validators of ``repro/core/guards.py``.  PyTorch runs eagerly, so
every check is a plain Python check on concrete values that raises at the
call site; there is no traced/checkified half.

Only the ``nonfinite="propagate"`` policy is ported: non-finite values keep
IEEE semantics.  ``"raise"`` and ``"sanitize"`` raise ``NotImplementedError``
until the guardrail layer is ported.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = [
    "NONFINITE", "validate_axis", "validate_bits_per_pass",
    "validate_positive", "validate_choice", "validate_probability",
    "validate_temperature", "validate_same_shape", "validate_broadcastable_to",
    "validate_offsets", "resolve_nonfinite", "resolve_device", "refuse_grad",
]

NONFINITE = ("propagate", "raise", "sanitize")


def validate_axis(axis: int, ndim: int, *, op: str) -> int:
    """Normalize ``axis`` against ``ndim``, rejecting out-of-range values.

    Example:
        >>> validate_axis(-1, 3, op="scan")
        2
    """
    if ndim == 0:
        raise ValueError(f"{op}: input is 0-d; scans need at least one axis")
    if not -ndim <= axis < ndim:
        raise ValueError(f"{op}: axis {axis} is out of bounds for a "
                         f"{ndim}-d input (expected -{ndim} <= axis < {ndim})")
    return axis % ndim


def validate_bits_per_pass(bits_per_pass: int, *, op: str) -> int:
    """Reject ``bits_per_pass`` outside ``[1, 8]`` (the radix-2^k contract)."""
    if not 1 <= int(bits_per_pass) <= 8:
        raise ValueError(f"{op}: bits_per_pass must be in [1, 8], got "
                         f"{bits_per_pass}")
    return int(bits_per_pass)


def validate_positive(value, *, name: str, op: str) -> int:
    """Reject a non-positive integer knob (tile sides, lengths, budgets)."""
    if int(value) < 1:
        raise ValueError(f"{op}: {name} must be >= 1, got {value!r}")
    return int(value)


def validate_choice(value, choices, *, name: str, op: str):
    """Reject a knob outside its closed set (e.g. an unknown kernel variant)."""
    if value not in choices:
        raise ValueError(f"{op}: {name} must be one of {tuple(choices)}, "
                         f"got {value!r}")
    return value


def validate_probability(p, *, name: str = "p", op: str) -> None:
    """Reject a probability outside ``[0, 1]`` (NaN included)."""
    v = float(p)
    if not 0.0 <= v <= 1.0:  # NaN fails every comparison -> rejected too
        raise ValueError(f"{op}: {name} must be in [0, 1], got {p!r}")


def validate_temperature(temperature, *, op: str) -> None:
    """Reject a negative, NaN or infinite temperature (0 is the greedy limit)."""
    v = float(temperature)
    if not v >= 0.0 or not math.isfinite(v):
        raise ValueError(f"{op}: temperature must be a finite value >= 0, "
                         f"got {temperature!r}")


def validate_same_shape(a_shape: Tuple[int, ...], b_shape: Tuple[int, ...],
                        *, op: str, a_name: str = "x",
                        b_name: str = "flags") -> None:
    """Reject mismatched payload/companion shapes with a call-site error."""
    if tuple(a_shape) != tuple(b_shape):
        raise ValueError(f"{op}: {a_name} shape {tuple(a_shape)} and "
                         f"{b_name} shape {tuple(b_shape)} must match")


def validate_broadcastable_to(b_shape, target, *, op: str,
                              name: str = "flags") -> None:
    """Reject a companion operand that does not broadcast to the payload shape.

    Example:
        >>> validate_broadcastable_to((8,), (4, 8), op="seg_scan_tiles")
    """
    try:
        ok = tuple(torch.broadcast_shapes(tuple(b_shape), tuple(target))) == tuple(target)
    except RuntimeError:
        ok = False
    if not ok:
        raise ValueError(f"{op}: {name} shape {tuple(b_shape)} does not "
                         f"broadcast to the payload shape {tuple(target)}")


def validate_offsets(offsets: torch.Tensor, n: int, *, op: str) -> torch.Tensor:
    """Validate CSR segment ``offsets`` against a packed length ``n``.

    Checks the whole contract on every call: rank 1 and not empty, an integer
    dtype, ``offsets[0] == 0``, ``offsets[-1] == n`` and non-decreasing.  The
    values are read on the host once per call, which for offsets on the card
    is one device-to-host copy (the packed sampler pays it once per token).

    Returns:
        ``offsets`` unchanged.

    Raises:
        ValueError: A structural or CSR violation.
        TypeError: Non-integer offsets.

    Example:
        >>> o = torch.tensor([0, 3, 5], dtype=torch.int32)
        >>> validate_offsets(o, 5, op="segment_scan") is o
        True
    """
    if offsets.dim() != 1:
        raise ValueError(f"{op}: offsets must be 1-D (num_segments + 1,), got "
                         f"shape {tuple(offsets.shape)}")
    if offsets.shape[0] < 1:
        raise ValueError(f"{op}: offsets cannot be empty (need at least [0] — one "
                         "entry per segment boundary plus one)")
    if offsets.dtype.is_floating_point or offsets.dtype.is_complex or \
            offsets.dtype == torch.bool:
        raise TypeError(f"{op}: offsets must be integer, got {offsets.dtype}")
    off = offsets.tolist()
    if off[0] != 0:
        raise ValueError(f"{op}: offsets[0] must be 0, got {off[0]}")
    if off[-1] != n:
        raise ValueError(f"{op}: offsets[-1] ({off[-1]}) must equal the packed "
                         f"length ({n})")
    if any(b < a for a, b in zip(off, off[1:])):
        raise ValueError(f"{op}: offsets must be non-decreasing, got {off}")
    return offsets


def resolve_device(device, *, op: str):
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Entry points run on the card unless the caller asks for the CPU; without
    a usable GPU they raise instead of carrying on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{op}: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def refuse_grad(*xs, op: str) -> None:
    """Raise when grad mode is on and a tensor among ``xs`` requires grad.

    The port's linear recurrences and the SSD chunk kernel have no backward
    pass yet (it comes with training); running them on such inputs would
    silently drop the gradient.
    """
    if torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                       for x in xs):
        raise NotImplementedError(
            f"{op} has no gradient in the port yet: its backward pass comes with "
            "training (ROADMAP Queue A item 11); run it under torch.no_grad() or on "
            "inputs that do not require grad")


def resolve_nonfinite(nonfinite: str, *, op: str = "op") -> str:
    """Validate the ``nonfinite=`` policy; only ``"propagate"`` is ported."""
    validate_choice(nonfinite, NONFINITE, name="nonfinite", op=op)
    if nonfinite != "propagate":
        raise NotImplementedError(
            f"{op}: nonfinite={nonfinite!r} is not ported yet (ROADMAP "
            "Queue A item 8); only 'propagate' is available")
    return nonfinite

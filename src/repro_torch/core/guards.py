"""Guardrails: validation, the non-finite policy and opt-in checks.

Port of ``repro/core/guards.py`` (``docs/architecture.md`` dispatch rule 10).
Its three layers, in the order an entry point runs them:

1. **Validation** -- plain Python checks on concrete values (axis bounds,
   ``bits_per_pass``, probabilities, temperatures, CSR offsets) that raise
   ``ValueError``/``TypeError`` at the call site.  PyTorch runs eagerly, so
   there is no traced half.
2. **The non-finite policy** -- ``nonfinite="propagate" | "raise" |
   "sanitize"`` on the scan and sampler family, resolved like ``method``
   (rule 8) and ``precision`` (rule 9): an active :func:`nonfinite_override`
   wins, else ``REPRO_NONFINITE``, else the argument.  ``"propagate"`` (the default) adds no operation; ``"raise"``
   reads one ``isfinite(x).all()`` on the host before any kernel launches and
   raises :class:`NonFiniteError`; ``"sanitize"`` writes the operator's
   identity over every non-finite element with one ``torch.where`` before the
   launch (the samplers map a degenerate row to its greedy token).
3. **Opt-in checks** -- :func:`guard_check` asserts a predicate only when
   ``REPRO_CHECKS=1`` or a :func:`checks` block is active, raising
   :class:`GuardCheckError` (where JAX raises ``checkify.JaxRuntimeError``).
   Predicates are thunks, so with checks off nothing is computed and no host
   sync happens.

:func:`guards_disabled` turns all three off, and the backend probe with them.

The three override chains, each resolved once a call before any launch: the
method (``method_override`` > ``REPRO_SCAN_METHOD`` > the tuning table,
:func:`repro_torch.core.autotune.maybe_resolve`); the precision
(``precision_override`` > ``REPRO_SCAN_PRECISION`` > the argument,
:func:`repro_torch.core.precision.resolve_precision`), after the method and
against it, so that a call landing on ``"vector"`` runs ``"highest"``; and
the non-finite policy (:func:`nonfinite_override` > ``REPRO_NONFINITE`` > the
argument, :func:`resolve_nonfinite`).  The entry points resolve them
(``scan``, ``segment_scan``, ``linear_scan``, ``segment_linear_scan``,
``dist_linear_scan``, ``dist_segment_scan``); the kernel wrappers below them
only validate what they are handed.

**The backend probe** (:func:`ensure_available`, dispatch rule 10).  Method
resolution (:func:`repro_torch.core.autotune.maybe_resolve`) passes every
``"kernel"`` and ``"blocked"`` method, explicit or resolved, through it.  On
a CUDA device the first call of each (family, method) builds, if they are
missing, and loads that family's CUDA libraries through
``kernels/_build.py``; on the CPU it passes at once, since the kernels' plain
versions run there.  Where JAX degrades a failed probe to another method with
a ``ProbeFallbackWarning``, the port raises :class:`KernelUnavailableError`
and never returns another method, so ``ProbeFallbackWarning`` has no
counterpart here.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.autotune import OP_ALIASES, TUNED_OPS

__all__ = [
    "NONFINITE", "ENV_VAR", "CHECKS_ENV_VAR", "NonFiniteError", "GuardCheckError",
    "resolve_nonfinite", "nonfinite_override", "apply_nonfinite",
    "checks", "checks_enabled", "guard_check", "checked",
    "guards_disabled", "guards_active",
    "validate_axis", "validate_bits_per_pass",
    "validate_positive", "validate_choice", "validate_probability",
    "validate_temperature", "validate_same_shape", "validate_broadcastable_to",
    "validate_offsets", "resolve_device", "refuse_grad",
    "KernelUnavailableError", "ensure_available", "probe_build", "force_probe_failure",
    "PROBE_LIBRARIES",
]

NONFINITE = ("propagate", "raise", "sanitize")
ENV_VAR = "REPRO_NONFINITE"
CHECKS_ENV_VAR = "REPRO_CHECKS"


class NonFiniteError(ValueError):
    """Raised by ``nonfinite="raise"`` when a payload holds a non-finite value."""


class GuardCheckError(RuntimeError):
    """Raised by :func:`guard_check` when checks are on and its predicate is false."""


class KernelUnavailableError(RuntimeError):
    """Raised by :func:`ensure_available` when a kernel method cannot run on the card."""


_NONFINITE_OVERRIDE: List[str] = []
_CHECKS_OVERRIDE: List[bool] = []
_BYPASS: List[bool] = []


def guards_active() -> bool:
    """False inside a :func:`guards_disabled` block, else True."""
    return not _BYPASS


@contextlib.contextmanager
def guards_disabled():
    """Turn the whole guard layer off inside the block (a bench and test hook).

    The validators, the non-finite policy and the checks become no-ops.  With
    checks off, a guarded operator's default call issues exactly the ATen
    operations it issues inside this block (``tests/test_torch_guards.py``).

    Example:
        >>> with guards_disabled():
        ...     guards_active()
        False
    """
    _BYPASS.append(True)
    try:
        yield
    finally:
        _BYPASS.pop()


# ---------------------------------------------------------------------------
# The non-finite policy (dispatch rule 10)
# ---------------------------------------------------------------------------


def _unknown_policy(policy, op: str) -> ValueError:
    return ValueError(f"{op}: unknown nonfinite policy {policy!r}; expected one of "
                      f"{NONFINITE}")


@contextlib.contextmanager
def nonfinite_override(policy: str):
    """Force every non-finite-policy resolution to ``policy`` inside the block.

    The in-process form of ``REPRO_NONFINITE``, and it wins over it; the
    non-finite counterpart of :func:`repro_torch.core.autotune.method_override`
    and :func:`repro_torch.core.precision.precision_override`.

    Example:
        >>> with nonfinite_override("sanitize"):
        ...     resolve_nonfinite("propagate")
        'sanitize'
    """
    if policy not in NONFINITE:
        raise _unknown_policy(policy, "nonfinite_override")
    _NONFINITE_OVERRIDE.append(policy)
    try:
        yield
    finally:
        _NONFINITE_OVERRIDE.pop()


def _env_nonfinite() -> Optional[str]:
    """The policy that ``REPRO_NONFINITE`` forces, or ``None``."""
    p = os.environ.get(ENV_VAR)
    if not p:
        return None
    if p not in NONFINITE:
        raise ValueError(f"{ENV_VAR}={p!r} is not a known nonfinite policy; "
                         f"expected one of {NONFINITE}")
    return p


def resolve_nonfinite(policy: str = "propagate", *, op: str = "op") -> str:
    """The non-finite policy one call runs under.

    An active :func:`nonfinite_override` wins, else ``REPRO_NONFINITE``, else
    the call's ``nonfinite=`` argument; inside :func:`guards_disabled` it is
    ``"propagate"``.

    Raises:
        ValueError: ``policy`` (argument or environment) is unknown.

    Example:
        >>> resolve_nonfinite()
        'propagate'
        >>> resolve_nonfinite("sanitize")
        'sanitize'
    """
    if policy not in NONFINITE:
        raise _unknown_policy(policy, op)
    if _BYPASS:
        return "propagate"
    p = _NONFINITE_OVERRIDE[-1] if _NONFINITE_OVERRIDE else None
    if p is None:
        p = _env_nonfinite()
    return policy if p is None else p


def apply_nonfinite(x: torch.Tensor, policy: str, *, op: str,
                    identity: float = 0.0) -> torch.Tensor:
    """Apply a resolved non-finite policy to a payload.

    * ``"propagate"``: ``x`` itself, with no operation (IEEE semantics);
    * ``"raise"``: one ``isfinite(x).all()`` read on the host; a non-finite
      element raises :class:`NonFiniteError`, and ``x`` comes back untouched;
    * ``"sanitize"``: ``x`` with ``identity`` at every non-finite element
      (0 for sums; the recurrences pass ``a -> 1``, ``b -> 0``).

    Integer and bool payloads are always finite and come back untouched.

    Example:
        >>> x = torch.tensor([1.0, float("inf"), float("nan")])
        >>> apply_nonfinite(x, "sanitize", op="scan").tolist()
        [1.0, 0.0, 0.0]
        >>> try:
        ...     apply_nonfinite(x, "raise", op="scan")
        ... except NonFiniteError:
        ...     print("rejected")
        rejected
    """
    if _BYPASS or policy == "propagate" or not x.dtype.is_floating_point:
        return x
    if policy == "raise":
        if not bool(torch.isfinite(x).all()):
            raise NonFiniteError(
                f"{op}: non-finite input under nonfinite='raise' (use 'propagate' for "
                "IEEE semantics or 'sanitize' for the identity-element fallback)")
        return x
    return torch.where(torch.isfinite(x), x,
                       torch.full((), identity, dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Opt-in checks (REPRO_CHECKS=1 / checks())
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def checks(enable: bool = True):
    """Turn :func:`guard_check` assertions on (or off) inside the block.

    The in-process form of ``REPRO_CHECKS=1``, and it wins over it.

    Example:
        >>> with checks():
        ...     checks_enabled()
        True
    """
    _CHECKS_OVERRIDE.append(bool(enable))
    try:
        yield
    finally:
        _CHECKS_OVERRIDE.pop()


def checks_enabled() -> bool:
    """Whether :func:`guard_check` asserts: an active :func:`checks` block wins,
    else ``REPRO_CHECKS=1``; :func:`guards_disabled` forces them off."""
    if _BYPASS:
        return False
    if _CHECKS_OVERRIDE:
        return _CHECKS_OVERRIDE[-1]
    return os.environ.get(CHECKS_ENV_VAR, "") == "1"


def guard_check(pred, msg: str) -> None:
    """Assert ``pred`` when checks are on; with checks off, do nothing.

    Pass the predicate as a thunk (a function of no arguments) whenever it
    computes anything: with checks off it is never called, so the call adds
    no operation and no host sync.  With checks on, a tensor predicate is
    read on the host (one sync on the card).

    Raises:
        GuardCheckError: Checks are on and the predicate is false.

    Example:
        >>> guard_check(lambda: 1 / 0, "never evaluated: checks are off")
        >>> with checks():
        ...     guard_check(True, "fine")
    """
    if not checks_enabled():
        return
    if callable(pred):
        pred = pred()
    if not bool(pred):
        raise GuardCheckError(msg)


def checked(fn: Callable) -> Callable:
    """``fn`` with its :func:`guard_check` assertions firing.

    JAX functionalizes a traced function with ``checkify`` and throws the
    collected error after the call.  PyTorch runs eagerly, so an assertion
    already raises :class:`GuardCheckError` where it fails, and the wrapper
    only calls ``fn``; it is kept so that harness code reads the same in both
    packages.

    Example:
        >>> def f(x):
        ...     guard_check(lambda: bool((x > 0).all()), "x must be positive")
        ...     return x * 2
        >>> with checks():
        ...     checked(f)(torch.tensor([1.0, 2.0])).tolist()
        [2.0, 4.0]
    """
    @functools.wraps(fn)
    def run(*args, **kwargs):
        return fn(*args, **kwargs)

    return run


# ---------------------------------------------------------------------------
# Validation shared by every public entry point
# ---------------------------------------------------------------------------


def validate_axis(axis: int, ndim: int, *, op: str) -> int:
    """Normalize ``axis`` against ``ndim``, rejecting out-of-range values.

    Example:
        >>> validate_axis(-1, 3, op="scan")
        2
    """
    if _BYPASS:
        return axis % max(ndim, 1)
    if ndim == 0:
        raise ValueError(f"{op}: input is 0-d; scans need at least one axis")
    if not -ndim <= axis < ndim:
        raise ValueError(f"{op}: axis {axis} is out of bounds for a "
                         f"{ndim}-d input (expected -{ndim} <= axis < {ndim})")
    return axis % ndim


def validate_bits_per_pass(bits_per_pass: int, *, op: str) -> int:
    """Reject ``bits_per_pass`` outside ``[1, 8]`` (the radix-2^k contract)."""
    if not _BYPASS and not 1 <= int(bits_per_pass) <= 8:
        raise ValueError(f"{op}: bits_per_pass must be in [1, 8], got "
                         f"{bits_per_pass}")
    return int(bits_per_pass)


def validate_positive(value, *, name: str, op: str) -> int:
    """Reject a non-positive integer knob (tile sides, lengths, budgets)."""
    if not _BYPASS and int(value) < 1:
        raise ValueError(f"{op}: {name} must be >= 1, got {value!r}")
    return int(value)


def validate_choice(value, choices, *, name: str, op: str):
    """Reject a knob outside its closed set (e.g. an unknown kernel variant)."""
    if not _BYPASS and value not in choices:
        raise ValueError(f"{op}: {name} must be one of {tuple(choices)}, "
                         f"got {value!r}")
    return value


def validate_probability(p, *, name: str = "p", op: str) -> None:
    """Reject a probability outside ``[0, 1]`` (NaN included)."""
    if _BYPASS:
        return
    v = float(p)
    if not 0.0 <= v <= 1.0:  # NaN fails every comparison -> rejected too
        raise ValueError(f"{op}: {name} must be in [0, 1], got {p!r}")


def validate_temperature(temperature, *, op: str) -> None:
    """Reject a negative, NaN or infinite temperature (0 is the greedy limit)."""
    if _BYPASS:
        return
    v = float(temperature)
    if not v >= 0.0 or not math.isfinite(v):
        raise ValueError(f"{op}: temperature must be a finite value >= 0, "
                         f"got {temperature!r}")


def validate_same_shape(a_shape: Tuple[int, ...], b_shape: Tuple[int, ...],
                        *, op: str, a_name: str = "x",
                        b_name: str = "flags") -> None:
    """Reject mismatched payload/companion shapes with a call-site error."""
    if not _BYPASS and tuple(a_shape) != tuple(b_shape):
        raise ValueError(f"{op}: {a_name} shape {tuple(a_shape)} and "
                         f"{b_name} shape {tuple(b_shape)} must match")


def validate_broadcastable_to(b_shape, target, *, op: str,
                              name: str = "flags") -> None:
    """Reject a companion operand that does not broadcast to the payload shape.

    Example:
        >>> validate_broadcastable_to((8,), (4, 8), op="seg_scan_tiles")
    """
    if _BYPASS:
        return
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
    if _BYPASS:
        return offsets
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


def refuse_grad(*xs, op: str, method: str,
                methods: Tuple[str, ...] = ("kernel", "blocked"),
                instead: Optional[str] = None) -> None:
    """Raise when ``method`` has no gradient and an input among ``xs`` needs one.

    The JAX package differentiates its ``"vector"`` and ``"matmul"`` paths and
    ``linear_scan``'s custom VJP on every method; ``jax.grad`` fails on the
    other Pallas kernels (``scan``, ``segment_scan``, ``split`` and
    ``multi_split`` on ``"kernel"``, the first two also on ``"blocked"``, and
    the SSD chunk kernel).  The port refuses exactly there, on the CPU (where
    the plain versions are differentiable torch) and on the card (where a
    kernel writes a fresh tensor with no graph) alike.  Entry points call this
    in the method's dispatch, after ``"auto"`` resolved; integer inputs never
    require grad.

    Args:
        xs: The operands; non-tensors are ignored.
        op: The operator, for the message.
        method: The resolved method.
        methods: The methods of ``op`` that have no gradient.
        instead: What differentiates, for the message; by default the
            methods of ``METHODS`` outside ``methods``.

    Raises:
        NotImplementedError: grad mode is on, ``method`` is in ``methods`` and a
            tensor among ``xs`` requires grad.

    Example:
        >>> refuse_grad(torch.ones(2, requires_grad=True), op="scan", method="vector")
        >>> refuse_grad(torch.ones(2), op="scan", method="kernel")
    """
    if method not in methods or not torch.is_grad_enabled():
        return
    if not any(isinstance(x, torch.Tensor) and x.requires_grad for x in xs):
        return
    if instead is None:
        ok = [m for m in ("vector", "matmul", "kernel", "blocked") if m not in methods]
        instead = " and ".join(f"method={m!r}" for m in ok)
    raise NotImplementedError(
        f"{op} has no gradient on method={method!r}, as in the JAX package (jax.grad "
        f"fails on its Pallas kernel there); {instead} differentiate, as does "
        "method='auto' where it resolves to them. Run it under torch.no_grad() or on "
        "inputs that do not require grad")


# ---------------------------------------------------------------------------
# Backend probe (a raise, never a fallback)
# ---------------------------------------------------------------------------

# (probe family, method) -> the libraries its operators launch without going
# through method resolution again (a nested operator call probes its own family)
PROBE_LIBRARIES: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("scan", "kernel"): ("scan_mm",),
    ("scan", "blocked"): ("block_sums", "carry_scan", "block_scan"),
    ("split", "kernel"): ("split", "multi_split"),
    ("sort", "kernel"): ("radix_pass", "radix_pass_hist"),
    ("top_p_sample", "kernel"): ("radix_pass", "radix_pass_hist", "multi_split",
                                 "topp_tail"),
    ("segment_scan", "kernel"): ("seg_scan",),
    ("segment_scan", "blocked"): ("seg_summaries", "seg_carry", "seg_block_scan"),
    ("linear_scan", "kernel"): ("linrec_scan",),
    ("linear_scan", "blocked"): ("linrec_summaries", "linrec_carry", "linrec_block_scan"),
}

# (family, method) -> None once the libraries loaded, else the error (kept, so a
# failed build is tried once a process)
_PROBE_CACHE: Dict[Tuple[str, str], Optional[str]] = {}
_FORCED_FAILURES: List[Tuple[Optional[str], Optional[str]]] = []


def _reset_probes_for_testing() -> None:
    """Clear the probe cache (tests only)."""
    _PROBE_CACHE.clear()


@contextlib.contextmanager
def force_probe_failure(op: Optional[str] = None, method: Optional[str] = None):
    """Make the backend probe fail inside the block (a fault-injection hook).

    ``op`` and ``method`` restrict the failure to one family and one of
    ``("kernel", "blocked")``; ``None`` matches everything.  The probe cache is
    cleared on entry and restored on exit, so the forced failure neither sees
    nor leaves real results.  It applies on every device, the CPU included.

    Example:
        >>> with force_probe_failure("scan", "kernel"):
        ...     probe_build("scan", "kernel", device=torch.device("cpu")) is not None
        True
    """
    saved = dict(_PROBE_CACHE)
    _PROBE_CACHE.clear()
    _FORCED_FAILURES.append((op, method))
    try:
        yield
    finally:
        _FORCED_FAILURES.pop()
        _PROBE_CACHE.clear()
        _PROBE_CACHE.update(saved)


def _probe_family(op: str, method: str) -> str:
    """Collapse an entry-point op onto the kernel family its probe loads."""
    fam = OP_ALIASES.get(op, op)
    if fam not in TUNED_OPS:
        fam = "scan"
    if method == "blocked" and fam in ("split", "sort", "top_p_sample"):
        # the blocked variants of the §5 operators are built from blocked
        # scans: they share the scan pipeline's probe
        fam = "scan"
    return fam


def probe_build(op: str, method: str, *, device: torch.device) -> Optional[str]:
    """Whether ``method`` can run ``op``'s family on ``device``: None, or the error.

    On a CUDA device the first probe of a (family, method) builds, if they are
    missing, and loads the family's libraries (:data:`PROBE_LIBRARIES`) with
    ``kernels/_build.py`` ``load``; the result is cached.  On the CPU the plain
    versions run, and the probe passes without building.
    """
    fam = _probe_family(op, method)
    for f_op, f_method in _FORCED_FAILURES:
        if (f_op is None or _probe_family(f_op, method) == fam) and \
                (f_method is None or f_method == method):
            return "forced by force_probe_failure"
    if torch.device(device).type != "cuda":
        return None
    key = (fam, method)
    if key not in _PROBE_CACHE:
        from repro_torch.kernels import _build  # local import: built only on the card
        try:
            for lib in PROBE_LIBRARIES[key]:
                _build.load(lib)
            _PROBE_CACHE[key] = None
        except (RuntimeError, OSError) as e:   # nvcc missing or failing, dlopen failing
            _PROBE_CACHE[key] = f"{type(e).__name__}: {e}"
    return _PROBE_CACHE[key]


def ensure_available(method: str, op: str, *, device: torch.device) -> str:
    """Return ``method``, or raise when its kernels cannot run on ``device``.

    Called by :func:`repro_torch.core.autotune.maybe_resolve` on every
    ``"kernel"`` and ``"blocked"`` method, explicit or resolved.  It never
    returns another method: JAX's ``ProbeFallbackWarning`` degrade has no
    counterpart in the port.  ``"matmul"`` and ``"vector"`` never probe, and
    inside :func:`guards_disabled` nothing does.

    Raises:
        KernelUnavailableError: The probe failed; the message names the op, the
            method, the family and the build's error (nvcc's output).

    Example:
        >>> ensure_available("vector", "scan", device=torch.device("cpu"))
        'vector'
        >>> ensure_available("kernel", "scan", device=torch.device("cpu"))
        'kernel'
    """
    if _BYPASS or method not in ("kernel", "blocked"):
        return method
    err = probe_build(op, method, device=device)
    if err is not None:
        raise KernelUnavailableError(
            f"{op}: method={method!r} (kernel family {_probe_family(op, method)!r}) "
            f"cannot run on {torch.device(device)}: {err}")
    return method

"""Linear recurrences ``y_t = a_t·y_{t−1} + b_t``: ``linear_scan``, ``cumprod``, ``cummax``.

Port of ``repro/core/linrec.py``.  The ``a ≡ 1`` case is the prefix sum; a
general ``a`` replaces the all-ones triangle ``U_s`` of the tile scans by the
weighted triangle

    W[i, j] = Π_{k = j+1 .. i} a_k          (i >= j; 1 on the diagonal),

built from cumulative products of exponent-normalized multipliers
(:func:`_pair_w`).  :func:`linear_scan` dispatches through the port's method
table:

* ``"vector"`` — the affine-pair scan ``(a, b) ∘ (a', b') = (a·a', a'·b + b')``
  as a log-step doubling over the scan axis (the JAX package's
  ``associative_scan``);
* ``"matmul"`` — chunked ``W @ b`` contractions with a recursive cross-chunk
  affine carry scan; a decay shared across payload dims stays unbroadcast, so
  one triangle serves the whole payload batch;
* ``"kernel"`` — B13 (``repro_torch.kernels.linrec_mm.linrec_scan_tiles``);
* ``"blocked"`` — B14–B16, the §4 pipeline over ``(Π a, trailing sum)`` block
  summaries (``linrec_mm.linrec_blocked_scan``).

On both kernel methods a short scan axis that is not the last (at most
``linrec_mm.LINREC_COLUMN_MAX`` pairs; on ``"blocked"`` one block long) is
walked where it lies, one launch of B13's or B16's column walk
(``linrec_mm.linrec_columns``), with no copy of the operands.

The two kernel methods run their plain PyTorch versions on CPU tensors.
Integer and bool inputs accumulate in fp32 (:func:`linrec_accum_dtype_for`).
``precision=`` reaches every ``W @ b`` product (:func:`_w_matvec`, the one
data×data contraction: under ``"compensated"`` both operands split); the CUDA
kernels and the column walk form no triangle and return the bits of
``"highest"`` under every precision.

Every method has the same analytic gradient, JAX's custom VJP: the adjoint
of a linear recurrence is the same recurrence run in reverse,

    λ_t = ḡ_t + a_{t+1}·λ_{t+1},      b̄_t = λ_t,      ā_t = λ_t·y_{t−1},

computed by one more call of the same method (:class:`_LinrecCore`; on the
card B13 or B14–B16 launch again), or by the column walk from the other end
(:class:`_LinrecColumns`).  ``initial``, ``exclusive``, ``reverse``, the
length-1 step and the non-finite policy stay outside it, in differentiable
torch, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.core import guards
from repro_torch.core.autotune import maybe_resolve
from repro_torch.core.precision import normalize_exponents, pdot, resolve_precision
from repro_torch.core.primitives import _register, dispatch
from repro_torch.core.scan import METHODS, accum_dtype_for

__all__ = ["linear_scan", "cumprod", "cummax", "linrec_accum_dtype_for", "MAX_TILE"]

# Longest axis _pair_w takes: normalized mantissas lie in [√½, √2), so a
# cumulative product of n of them stays within 2^±(n/2), inside fp32's range
# for n ≤ 256.  Longer chains are chunked through the recursive carry scan.
MAX_TILE = 256


def linrec_accum_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of a linear recurrence over ``dtype``.

    Floats follow ``accum_dtype_for`` (bf16/fp16 -> fp32); integers and bool
    accumulate in fp32, because the weighted triangle divides cumulative
    products.

    Example:
        >>> linrec_accum_dtype_for(torch.int8), linrec_accum_dtype_for(torch.bfloat16)
        (torch.float32, torch.float32)
    """
    if not dtype.is_floating_point:
        return torch.float32
    return accum_dtype_for(dtype)


# ---------------------------------------------------------------------------
# the weighted-triangular algebra (shared with repro_torch.kernels.linrec_mm)
# ---------------------------------------------------------------------------


def _pair_w(a: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """Weighted triangle ``W[..., i, j] = Π_{k=j+1..i} a_k`` of the last axis.

    Each ``a_k`` splits exactly into ``a_norm · 2^e`` (``normalize_exponents``);
    the mantissa quotient of cumulative products stays in range for windows of
    at most ``MAX_TILE``, and the exponents travel through an exact integer
    cumsum re-applied with ``ldexp``.  Zeros of ``a`` are replaced by 1 in the
    products and re-imposed by masking every window that straddles one.
    """
    s = a.shape[-1]
    az = a == 0
    a1 = torch.where(az, torch.ones((), dtype=acc, device=a.device), a.to(acc))
    a_norm, e = normalize_exponents(a1, acc)
    es = torch.cumsum(e, dim=-1, dtype=torch.int32)
    p = torch.cumprod(a_norm, dim=-1)                       # |p| within 2^±(s/2)
    pos = torch.arange(s, device=a.device)
    lastz = torch.cummax(torch.where(az, pos, -1), dim=-1).values
    ri, cj = pos[:, None], pos[None, :]
    keep = (ri > cj) & (lastz[..., :, None] <= cj)
    ratio = p[..., :, None] / p[..., None, :]
    w = torch.ldexp(ratio, es[..., :, None] - es[..., None, :])
    w = torch.where(keep, w, torch.zeros((), dtype=acc, device=a.device))
    return torch.where(ri == cj, torch.ones((), dtype=acc, device=a.device), w)


def _w_matvec(w: torch.Tensor, b: torch.Tensor, acc: torch.dtype,
              precision: str) -> torch.Tensor:
    """``(W @ b)[..., i] = Σ_j W[..., i, j] b[..., j]`` in ``acc``.

    ``w`` is ``(..., s, s)`` and ``b`` ``(..., s)``, rank-aligned.  Where ``w``
    has size 1 and ``b`` does not (a decay shared across payload dims), those
    dims become the columns of one product, so the triangle is never copied
    per payload element.  Both operands are data (``exact="none"``): under
    ``"compensated"`` ``W`` splits per row and ``b`` per vector (per column
    of the shared product), three products with ``lo×lo`` dropped.
    """
    b = b.to(acc)
    nd = b.dim() - 1
    pay = [d for d in range(nd) if w.shape[d] == 1 and b.shape[d] != 1]
    if not pay:
        return pdot(w, b[..., None], acc=acc, precision=precision,
                    exact="none")[..., 0].to(acc)
    keep = [d for d in range(nd) if d not in pay]
    perm = keep + [nd] + pay
    bp = b.permute(*perm)                                   # (...keep, s, *pay)
    pshape = bp.shape[len(keep) + 1:]
    bp = bp.reshape(*bp.shape[:len(keep) + 1], -1)
    wk = w.reshape([w.shape[d] for d in keep] + list(w.shape[-2:]))
    out = pdot(wk, bp, acc=acc, precision=precision, exact="none").to(acc)
    out = out.reshape(*out.shape[:-1], *pshape)
    return out.permute(*[perm.index(d) for d in range(nd + 1)])


def _shift_in(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x`` shifted one place right along the last axis, ``value`` entering."""
    return F.pad(x, (1, 0), value=value)[..., :-1]


def _linrec_block(a2: torch.Tensor, b2: torch.Tensor, acc: torch.dtype,
                  precision: str):
    """Linear recurrence of ``(..., m, s)`` row-major blocks with zero incoming state.

    Per-row ``W @ b`` contractions give the ``m`` row-local recurrences; the
    rows are chained through their summaries ``(row product, row-local last)``
    by a second weighted-triangular contraction (through the chunked scan when
    ``m > MAX_TILE``).  Returns ``(out, mult)``: the block-local recurrence
    and ``mult[r, i] = Π a[block start .. (r, i)]``, the multiplier an incoming
    carry picks up (plain cumulative products, zeros included exactly).
    """
    rowmult = torch.cumprod(a2.to(acc), dim=-1)
    local = _w_matvec(_pair_w(a2, acc), b2, acc, precision)
    rp = rowmult[..., :, -1]
    rl = local[..., :, -1]
    if rp.shape[-1] <= MAX_TILE:
        y_rows = _w_matvec(_pair_w(rp, acc), rl, acc, precision)
    else:  # tall blocks: chain the row summaries through the chunked scan
        y_rows = _linrec_matmul(rp, rl, method="matmul", tile_s=128, block_tiles=0,
                                accum_dtype=acc, precision=precision)
    out = local + rowmult * _shift_in(y_rows, 0.0)[..., :, None]
    rowprefix = _shift_in(torch.cumprod(rp, dim=-1), 1.0)
    return out, rowmult * rowprefix[..., :, None]


# ---------------------------------------------------------------------------
# the methods, registered in the shared dispatch table
# ---------------------------------------------------------------------------


@_register("linear_scan", "vector")
def _linrec_vector(a, b, *, method, tile_s, block_tiles, accum_dtype, precision):
    """The affine-pair scan as a log-step doubling (the correctness oracle).

    At distance ``d`` each element from ``d`` on composes with the element
    ``d`` before it: ``(A, B) <- (A_l·A, A·B_l + B)``; the first ``d`` are
    left as they are (composing them with an identity ``(1, 0)`` would turn an
    overflowed ``A`` into ``inf·0 = NaN``).  ``A`` keeps ``a``'s (possibly
    unbroadcast) shape.
    """
    acc = accum_dtype
    av = a.to(acc)
    bv = b.to(acc).expand(torch.broadcast_shapes(a.shape, b.shape))
    n = bv.shape[-1]
    d = 1
    while d < n:
        bv = torch.cat([bv[..., :d], av[..., d:] * bv[..., :-d] + bv[..., d:]], dim=-1)
        av = torch.cat([av[..., :d], av[..., d:] * av[..., :-d]], dim=-1)
        d *= 2
    return bv


@_register("linear_scan", "matmul")
def _linrec_matmul(a, b, *, method, tile_s, block_tiles, accum_dtype, precision):
    """Chunked ``W @ b`` contractions plus a recursive cross-chunk affine carry scan.

    ``a`` and ``b`` are rank-aligned with equal scan lengths; ``W`` is built
    from the unbroadcast ``a``, so a decay shared across payload dims (the SSD
    cross-chunk case) gets one triangle for the whole payload batch.
    """
    acc = accum_dtype
    q = tile_s
    n = a.shape[-1]
    if n <= q:
        return _w_matvec(_pair_w(a, acc), b, acc, precision)
    pad = (-n) % q
    if pad:  # the identity affine element: a = 1, b = 0
        a = F.pad(a, (0, pad), value=1.0)
        b = F.pad(b, (0, pad))
    nc = a.shape[-1] // q
    ac = a.reshape(*a.shape[:-1], nc, q)
    bc = b.reshape(*b.shape[:-1], nc, q)
    local = _w_matvec(_pair_w(ac, acc), bc, acc, precision)
    mult = torch.cumprod(ac.to(acc), dim=-1)
    carry_inc = _linrec_matmul(mult[..., -1], local[..., -1], method=method, tile_s=q,
                               block_tiles=block_tiles, accum_dtype=acc,
                               precision=precision)
    out = local + mult * _shift_in(carry_inc, 0.0)[..., None]
    out = out.reshape(*out.shape[:-2], nc * q)
    return out[..., :n] if pad else out


def _broadcast_pair(a, b):
    """Both operands at their common shape (the kernel wrappers flatten to rows)."""
    shp = torch.broadcast_shapes(a.shape, b.shape)
    return a.expand(shp), b.expand(shp)


@_register("linear_scan", "kernel")
def _linrec_kernel(a, b, *, method, tile_s, block_tiles, accum_dtype, precision):
    """B13: one ordered walk per row (``linrec_mm.linrec_scan_tiles``)."""
    from repro_torch.kernels.linrec_mm import linrec_scan_tiles  # no import cycle
    a, b = _broadcast_pair(a, b)
    return linrec_scan_tiles(a, b, s=tile_s, accum_dtype=accum_dtype, precision=precision)


@_register("linear_scan", "blocked")
def _linrec_blocked(a, b, *, method, tile_s, block_tiles, accum_dtype, precision):
    """B14–B16: the §4 pipeline with an affine phase-2 carry scan."""
    from repro_torch.kernels.linrec_mm import linrec_blocked_scan  # no import cycle
    a, b = _broadcast_pair(a, b)
    return linrec_blocked_scan(a, b, s=tile_s, block_tiles=block_tiles,
                               accum_dtype=accum_dtype, precision=precision)


# ---------------------------------------------------------------------------
# the analytic adjoint (JAX's _linrec_core custom VJP)
# ---------------------------------------------------------------------------


def _unbroadcast(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum-reduce ``x`` back to a rank-aligned ``shape`` it broadcast from."""
    if tuple(x.shape) == tuple(shape):
        return x
    dims = tuple(i for i, (xs, ps) in enumerate(zip(x.shape, shape)) if ps == 1 and xs != 1)
    return torch.sum(x, dim=dims, keepdim=True)


class _LinrecCore(torch.autograd.Function):
    """The method-dispatched inclusive recurrence over the last axis from a zero
    state, and its reverse-recurrence adjoint.

    ``b`` arrives at the output's shape, so its cotangent is ``λ`` as it is;
    ``a`` may keep size-1 dims of a shared decay, whose cotangent sums back
    over them.  The backward recurrence runs the same method, tile, block and
    precision (a compensated forward pass gets a compensated adjoint).
    """

    @staticmethod
    def forward(ctx, a, b, method, tile_s, block_tiles, acc, precision):
        y = dispatch("linear_scan", method)(a, b, method=method, tile_s=tile_s,
                                            block_tiles=block_tiles, accum_dtype=acc,
                                            precision=precision)
        ctx.save_for_backward(a, y)
        ctx.opts = dict(method=method, tile_s=tile_s, block_tiles=block_tiles,
                        accum_dtype=acc, precision=precision)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, y = ctx.saved_tensors
        acc = ctx.opts["accum_dtype"]
        ash = torch.cat([a[..., 1:], torch.ones_like(a[..., :1])], dim=-1)
        flip = (-1,)
        lam = torch.flip(dispatch("linear_scan", ctx.opts["method"])(
            torch.flip(ash, flip), torch.flip(g.to(acc), flip), **ctx.opts), flip)
        ga = None
        if ctx.needs_input_grad[0]:
            ga = _unbroadcast(lam * _shift_in(y, 0.0), a.shape).to(a.dtype)
        return ga, lam, None, None, None, None, None


def _step_shift(x: torch.Tensor, axis: int, *, later: bool, reverse: bool, fill):
    """``x`` along ``axis`` moved one step of a walk: with ``later``, place ``t``
    holds the step after ``t`` (``t + 1``, or ``t - 1`` walking in ``reverse``),
    else the step before it; the place left open holds ``fill`` (a scalar, or a
    tensor shaped like ``x`` without ``axis``)."""
    n = x.shape[axis]
    head = later != reverse                  # the kept steps come from the axis's end
    kept = x.narrow(axis, 1, n - 1) if head else x.narrow(axis, 0, n - 1)
    shape = list(x.shape)
    shape[axis] = 1
    if isinstance(fill, torch.Tensor):
        edge = fill.to(x.dtype).unsqueeze(axis).expand(shape)
    else:
        edge = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([kept, edge] if head else [edge, kept], dim=axis)


class _LinrecColumns(torch.autograd.Function):
    """The column walk of a short axis that is not the last (one launch of B13's
    or B16's walk on the card), and its adjoint: the walk from the other end
    over the shifted ``a`` and the output's cotangent.

    ``initial`` and ``exclusive`` stay inside the walk, as the kernel applies
    them, so the forward pass keeps its bits; their cotangents are formed here:
    ``initial`` receives ``a``'s first step times ``λ``'s (plus the cotangent of
    the exclusive output's first step, which is ``initial``).
    """

    @staticmethod
    def forward(ctx, a, b, initial, axis, exclusive, reverse, blocked):
        from repro_torch.kernels import linrec_mm  # no import cycle
        out = linrec_mm.linrec_columns(a, b, axis, exclusive=exclusive, reverse=reverse,
                                       initial=initial, blocked=blocked)
        ctx.save_for_backward(a, out, initial)
        ctx.opts = (axis, exclusive, reverse, blocked, tuple(b.shape))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        from repro_torch.kernels import linrec_mm  # no import cycle
        a, out, initial = ctx.saved_tensors
        axis, exclusive, reverse, blocked, b_shape = ctx.opts
        n = out.shape[axis]
        first = n - 1 if reverse else 0
        ae = a.expand(*a.shape[:axis], n, *a.shape[axis + 1:])
        g = g.to(out.dtype)
        # the cotangent of the inclusive states: the exclusive output at t is y
        # of the step before t
        gy = _step_shift(g, axis, later=True, reverse=reverse, fill=0.0) if exclusive else g
        ash = _step_shift(ae, axis, later=True, reverse=reverse, fill=1.0)
        lam = linrec_mm.linrec_columns(ash, gy, axis, reverse=not reverse, blocked=blocked)
        ga = gb = gi = None
        if ctx.needs_input_grad[0]:
            y_prev = out if exclusive else _step_shift(
                out, axis, later=False, reverse=reverse,
                fill=0.0 if initial is None else initial.expand(
                    out.shape[:axis] + out.shape[axis + 1:]))
            ga = _unbroadcast(lam * y_prev, a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _unbroadcast(lam, b_shape)
        if initial is not None and ctx.needs_input_grad[2]:
            gi = lam.select(axis, first) * ae.select(axis, first)
            if exclusive:
                gi = gi + g.select(axis, first)
            gi = gi.sum_to_size(initial.shape).to(initial.dtype)
        return ga, gb, gi, None, None, None, None


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def linear_scan(a, b, *, axis: int = -1, exclusive: bool = False, reverse: bool = False,
                method: str = "auto", precision: str = "highest", initial=None,
                tile_s: int = 128, block_tiles: int = 8,
                accum_dtype: Optional[torch.dtype] = None,
                nonfinite: str = "propagate") -> torch.Tensor:
    """First-order linear recurrence ``y_t = a_t * y_{t-1} + b_t`` along ``axis``.

    Args:
        a: Multipliers ``(..., n)``, broadcast against ``b``.
        b: Additive inputs ``(..., n)``, broadcast against ``a``.
        axis: Axis to scan along.
        exclusive: Return the state entering each step: ``out[t] = y_{t-1}``,
            ``out[0] = initial`` (or 0).
        reverse: Scan from the end (``y_t = a_t * y_{t+1} + b_t``).
        method: ``"auto"`` (tuning table), ``"vector"``, ``"matmul"``,
            ``"kernel"`` (B13) or ``"blocked"`` (B14–B16).
        precision: ``"highest"``, ``"compensated"`` or ``"fast"``
            (``precision_override`` > ``REPRO_SCAN_PRECISION`` > this
            argument): the ``W @ b`` products of ``"matmul"`` and of the
            kernels' plain versions follow it; the CUDA kernels and the column
            walk return the bits of ``"highest"``.  An explicit non-default
            precision with ``method="vector"`` raises ``ValueError``.
        initial: Optional starting state ``y_{-1}`` (scalar, or a tensor
            broadcastable to ``a``/``b`` without the scan axis), folded into
            the first step as ``b_0 + a_0 * initial``.  A length-1 scan is then
            that one fused step for every method, with no kernel launch (the
            decode step).
        tile_s: Tile side ``s`` in ``[2, MAX_TILE]``: the matmul path chunks
            ``s`` at a time, the kernels' plain versions walk ``s²`` tiles.
        block_tiles: Tiles per block for ``method="blocked"``.
        accum_dtype: Accumulation dtype; defaults to
            :func:`linrec_accum_dtype_for` of the operands' common dtype.
        nonfinite: Non-finite input policy (:mod:`repro_torch.core.guards`):
            ``"propagate"``, ``"raise"``, or ``"sanitize"`` (``a -> 1``,
            ``b -> 0``: the affine identity) before any launch.

    Returns:
        The recurrence at the broadcast shape of ``a`` and ``b``, in the
        accumulation dtype.

    Raises:
        ValueError: An unknown ``method`` or ``precision``, ``tile_s`` out
            of range, an axis out of bounds, or an explicit non-default
            ``precision`` with an explicit ``method="vector"``.
        NonFiniteError: ``nonfinite="raise"`` and ``a`` or ``b`` holds a
            non-finite value.

    Example:
        >>> a = torch.tensor([1.0, 2.0, 0.0, 3.0])
        >>> b = torch.tensor([1.0, 1.0, 5.0, 1.0])
        >>> linear_scan(a, b, method="vector").tolist()
        [1.0, 3.0, 5.0, 16.0]
        >>> linear_scan(a, b, exclusive=True, initial=7.0, method="matmul").tolist()
        [7.0, 8.0, 17.0, 5.0]
    """
    if method != "auto" and method not in METHODS:
        raise ValueError(f"unknown scan method {method!r}; expected one of "
                         f"{METHODS + ('auto',)}")
    if not 2 <= tile_s <= MAX_TILE:
        raise ValueError(f"tile_s must be in [2, {MAX_TILE}] (the exponent-normalized "
                         f"window-product range), got {tile_s}")
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, device=b.device if isinstance(b, torch.Tensor) else None)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    # rank-align without materializing the broadcast: a decay shared across
    # payload dims must reach the matmul path unbroadcast
    nd = max(a.dim(), b.dim(), 1)
    a = a.reshape((1,) * (nd - a.dim()) + tuple(a.shape))
    b = b.reshape((1,) * (nd - b.dim()) + tuple(b.shape))
    dtype = torch.promote_types(a.dtype, b.dtype)
    acc = accum_dtype if accum_dtype is not None else linrec_accum_dtype_for(dtype)
    axis = guards.validate_axis(axis, nd, op="linear_scan")
    n = max(a.shape[axis], b.shape[axis])
    explicit_method = method != "auto"
    method = maybe_resolve(method, "linear_scan", n, dtype, device=b.device)
    precision = resolve_precision(precision, method=method,
                                  explicit_method=explicit_method)
    nonfinite = guards.resolve_nonfinite(nonfinite, op="linear_scan")
    a = guards.apply_nonfinite(a, nonfinite, op="linear_scan", identity=1.0)
    b = guards.apply_nonfinite(b, nonfinite, op="linear_scan", identity=0.0)
    from repro_torch.kernels import linrec_mm  # no import cycle
    walk = linrec_mm.column_walk_applies(method, nd, axis, n, tile_s, block_tiles)
    if walk and (b.is_cuda or precision == "highest"):
        # a short axis that is not the last: walked where it lies, nothing moved.
        # The walk forms no product, so on the card every precision gets
        # "highest"'s bits; on the CPU a split precision takes the rows' tile
        # products below, as JAX's Pallas kernel does after moving the axis
        init = None if initial is None else torch.as_tensor(initial, dtype=acc,
                                                            device=b.device)
        return _LinrecColumns.apply(a.to(acc), b.to(acc), init, axis, exclusive, reverse,
                                    method == "blocked")
    moved = axis != nd - 1
    if moved:
        a, b = torch.movedim(a, axis, -1), torch.movedim(b, axis, -1)
    a = a.expand(*a.shape[:-1], n)                     # the scan axis is real on both
    b = b.expand(*b.shape[:-1], n)
    full = torch.broadcast_shapes(a.shape, b.shape)
    b = b.expand(full)                                 # b is output-sized anyway
    if reverse:
        a, b = torch.flip(a, dims=(-1,)), torch.flip(b, dims=(-1,))
    if n == 0:
        out = torch.zeros(full, dtype=acc, device=b.device)
    else:
        a, b = a.to(acc), b.to(acc)
        init = None
        if initial is not None:
            init = torch.as_tensor(initial, dtype=acc, device=b.device)
            b0 = (b[..., 0] + a[..., 0] * init).expand(full[:-1])
            b = torch.cat([b0[..., None], b[..., 1:]], dim=-1)
        if n == 1:
            # y_0 = a_0·initial + b_0, already folded into b: every method computes
            # exactly this, so no dispatch and no kernel launch (the decode step)
            out = b.expand(full).clone()
        else:
            out = _LinrecCore.apply(a, b, method, tile_s, block_tiles, acc, precision)
        if exclusive:
            if init is not None:
                first = (init[..., None] if init.dim() else init).expand(out[..., :1].shape)
            else:
                first = torch.zeros_like(out[..., :1])
            out = torch.cat([first, out[..., :-1]], dim=-1)
    if reverse:
        out = torch.flip(out, dims=(-1,))
    if moved:
        out = torch.movedim(out, -1, axis)
    return out


def cumprod(x: torch.Tensor, axis: int = -1, **kw) -> torch.Tensor:
    """Cumulative product along ``axis``: ``linear_scan`` of ``x`` with ``b = 0``
    from ``initial = 1``, on any ``method``.

    Example:
        >>> cumprod(torch.tensor([1, 2, 3, 4], dtype=torch.int32), method="matmul").tolist()
        [1.0, 2.0, 6.0, 24.0]
    """
    kw.setdefault("initial", 1.0)
    return linear_scan(x, torch.zeros_like(x), axis=axis, **kw)


def cummax(x: torch.Tensor, axis: int = -1, *, method: str = "auto",
           reverse: bool = False, tile_s: int = 128,
           block_tiles: int = 8) -> torch.Tensor:
    """Cumulative maximum along ``axis``, bit-identical on every ``method``.

    ``"vector"`` is ``torch.cummax``; the other methods share the chunked
    tropical contraction (a masked ``(s, s)`` max per chunk, chunk maxima
    carried exclusively), as in the JAX package, which has no kernel for it.
    ``block_tiles`` is accepted for signature compatibility and unused.

    Example:
        >>> cummax(torch.tensor([1, 3, 2, 5, 4]), method="matmul").tolist()
        [1, 3, 3, 5, 5]
    """
    if method != "auto" and method not in METHODS:
        raise ValueError(f"unknown scan method {method!r}; expected one of "
                         f"{METHODS + ('auto',)}")
    if x.dim():
        method = maybe_resolve(method, "cummax", x.shape[axis % x.dim()], x.dtype,
                               device=x.device)
    if x.dtype == torch.bool:                          # max == prefix-any
        return cummax(x.to(torch.int8), axis=axis, method=method, reverse=reverse,
                      tile_s=tile_s) > 0
    axis = axis % max(x.dim(), 1)
    if x.dim() and axis != x.dim() - 1:
        out = cummax(torch.movedim(x, axis, -1), method=method, reverse=reverse,
                     tile_s=tile_s)
        return torch.movedim(out, -1, axis)
    if reverse:
        return torch.flip(cummax(torch.flip(x, dims=(-1,)), method=method,
                                 tile_s=tile_s), dims=(-1,))
    n = x.shape[-1]
    if n == 0:
        return x.clone()
    if method == "vector":
        return torch.cummax(x, dim=-1).values
    lowest = (torch.finfo(x.dtype).min if x.dtype.is_floating_point
              else torch.iinfo(x.dtype).min)
    q = tile_s
    *lead, _ = x.shape
    pad = (-n) % q
    xp = F.pad(x, (0, pad), value=lowest) if pad else x
    nc = xp.shape[-1] // q
    xc = xp.reshape(*lead, nc, q)
    pos = torch.arange(q, device=x.device)
    low = torch.full((), lowest, dtype=x.dtype, device=x.device)
    masked = torch.where(pos[None, :] <= pos[:, None], xc[..., None, :], low)
    local = masked.amax(dim=-1)                        # the tropical A @ U_s
    carry = torch.cummax(local[..., -1], dim=-1).values
    carry = F.pad(carry, (1, 0), value=lowest)[..., :-1]
    out = torch.maximum(local, carry[..., None]).reshape(*lead, nc * q)
    return out[..., :n] if pad else out

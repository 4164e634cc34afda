"""B13–B16: the linear-recurrence kernels (``y_t = a_t·y_{t−1} + b_t``).

Port of ``repro/kernels/linrec_mm.py``.  Four kernels, one CUDA source each,
sharing the affine-pair walk of ``csrc/affine_tile.cuh``:

* :func:`linrec_scan_tiles` (B13, ``csrc/linrec_scan.cu``) — the recurrence of
  each row as a single pass over tiles of ``linrec_scan_tile(n)`` pairs, one
  CTA a tile, linked by the decoupled look-back under the affine operator
  (rows of at most ``LINREC_WARP_MAX`` pairs: one warp a row);
* :func:`linrec_block_summaries` (B14, ``csrc/linrec_summaries.cu``) — phase 1
  of the §4 pipeline: each block's affine map ``y_out = p·y_in + l`` as the
  pair ``(Π a, trailing sum)``;
* :func:`linrec_carry_scan` (B15, ``csrc/linrec_carry.cu``) — phase 2: the
  exclusive scan of those pairs under affine composition, the state entering
  each block;
* :func:`linrec_block_scan_carry` (B16, ``csrc/linrec_block_scan.cu``) —
  phases 1 and 3 fused: each block's recurrence seeded with its carry.

:func:`linrec_blocked_scan` runs B14–B16 with the JAX geometry: blocks of
``t = min(block_tiles, ⌈n/s²⌉)`` tiles, ``m = t·s`` rows of ``s``; with one
block per row the carry is zero and B14 and B15 are not launched.

:func:`linrec_columns` walks a short scan axis that is not the last where it
lies (``csrc/linrec_columns.cuh``: one thread a column of an ``(outer, n,
inner)`` view, a decay shared by trailing axes read unbroadcast, ``y`` written
in the caller's layout): ``linear_scan`` hands such axes of at most
``LINREC_COLUMN_MAX`` pairs to it on ``"kernel"`` (one launch of B13) and, when
they are one block, on ``"blocked"`` (one launch of B16), in place of the
moved, broadcast and copied rows.

On CUDA tensors the wrappers launch the kernels, which read and write fp32
only (operands are cast to fp32; any other accumulation dtype raises on the
card) and mask the ragged row end themselves.  On CPU tensors they run the
plain versions (``*_plain``), which follow the JAX block algebra on the
identity-padded (``a = 1``, ``b = 0``) tile or block view: the weighted
triangles of ``core.linrec._linrec_block``, suffix products for the
summaries, the chunked ``W @ b`` scan for the carries, and the running state
across ordered tiles.  They build ``(…, s, s)`` triangles per row of ``s``, so
they work a bounded number of tiles or blocks at a time.

``precision`` reaches the ``W @ b`` products of B13, B15 and B16, as in JAX;
B14 (suffix products) and the column walk take none.  On the card the
kernels walk affine pairs in IEEE fp32 under every precision, so their
result is the bits of ``"highest"``.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.core import guards
from repro_torch.core.linrec import _linrec_block, _linrec_matmul, linrec_accum_dtype_for
from repro_torch.core.precision import PRECISIONS
from repro_torch.kernels import _build, lookback
from repro_torch.kernels.scan_pipeline import block_geometry

__all__ = ["linrec_scan_tiles", "linrec_block_summaries", "linrec_carry_scan",
           "linrec_block_scan_carry", "linrec_blocked_scan", "linrec_scan_tiles_plain",
           "linrec_block_summaries_plain", "linrec_carry_scan_plain",
           "linrec_block_scan_carry_plain", "linrec_blocked_scan_plain", "linrec_scan_tile",
           "linrec_columns", "linrec_columns_plain", "column_walk_applies",
           "LINREC_SCAN_THREADS", "LINREC_SCAN_ITEMS", "LINREC_WARP_MAX", "LINREC_COLUMN_MAX"]

# elements of the largest triangle stack a plain version builds at once
_CHUNK_ELEMS = 1 << 26
# row counts reach the kernels as a C int
_MAX_ROWS = (1 << 31) - 1
# csrc/linrec_scan.cu: B13's threads a CTA at most and the pairs a thread
# scans; csrc/affine_tile.cuh: the longest row one warp walks (no look-back)
LINREC_SCAN_THREADS = 512
LINREC_SCAN_ITEMS = 16
LINREC_WARP_MAX = 2048
# the longest scan axis, not the last, that linear_scan's kernel methods walk
# where it lies, one thread a column: the SSD's cross-chunk axis is S/Q (16 at
# zamba2's prefill); a column walk is sequential in n, and an axis of 64 steps
# still keeps every thread's loads of 8 steps in flight while the columns fill
# the card
LINREC_COLUMN_MAX = 64


def linrec_scan_tile(n: int) -> int:
    """Pairs of B13's tile, one CTA's round, for rows of ``n > LINREC_WARP_MAX``:
    ``lin_threads(n, 512, 16)`` threads (``csrc/affine_tile.cuh``) times
    ``LINREC_SCAN_ITEMS``: 8192 for rows of 8192 or more."""
    threads = min(max((n // LINREC_SCAN_ITEMS + 31) // 32 * 32, 32), LINREC_SCAN_THREADS)
    return threads * LINREC_SCAN_ITEMS


# ---------------------------------------------------------------------------
# plain versions (the CPU path)
# ---------------------------------------------------------------------------


def _blocks(a: torch.Tensor, b: torch.Tensor, acc, precision):
    """``_linrec_block`` over ``(..., m, s)`` blocks, a bounded number at a time."""
    *lead, m, s = a.shape
    a2, b2 = a.reshape(-1, m, s), b.reshape(-1, m, s)
    step = max(1, _CHUNK_ELEMS // (m * s * s + m * m))
    parts = [_linrec_block(a2[i:i + step], b2[i:i + step], acc, precision)
             for i in range(0, a2.shape[0], step)]
    out = torch.cat([p[0] for p in parts]).reshape(*lead, m, s)
    mult = torch.cat([p[1] for p in parts]).reshape(*lead, m, s)
    return out, mult


def _identity_pad(ab: torch.Tensor, bb: torch.Tensor, length: int, acc):
    """``(rows, n)`` pairs padded to ``length`` with the identity ``a = 1, b = 0``."""
    pad = length - ab.shape[-1]
    return F.pad(ab.to(acc), (0, pad), value=1.0), F.pad(bb.to(acc), (0, pad))


def linrec_scan_tiles_plain(ab: torch.Tensor, bb: torch.Tensor, *, s: int,
                            acc: torch.dtype, precision: str = "highest",
                            tile: int | None = None) -> torch.Tensor:
    """Plain version of B13 on ``(rows, n)`` pairs.

    Each ``s×s`` tile runs the block algebra; the tiles are then linked in
    order as the Pallas kernel links them, the running state ``y`` entering a
    tile as ``out + mult·y`` and leaving as that tile's last value.

    ``tile`` models the kernel's single pass: the row is cut into tiles of
    ``tile`` pairs (identity-padded), each scanned as above from a zero state;
    a tile's aggregate is its map ``(Π a, last value)``, and the state entering
    it the look-back's fold of the earlier tiles' maps in index order
    (:func:`lookback.fold_exclusive` under the affine operator), which then
    seeds the tile's first pair, ``b₀ ← a₀·y + b₀``, for a second scan.
    """
    if tile is not None:
        return _linrec_lookback_plain(ab, bb, s=s, acc=acc, precision=precision, tile=tile)
    rows, n = ab.shape
    ell = s * s
    a, b = _identity_pad(ab, bb, -(-n // ell) * ell, acc)
    nt = a.shape[-1] // ell
    out, mult = _blocks(a.reshape(rows, nt, s, s), b.reshape(rows, nt, s, s), acc, precision)
    last_out, last_mult = out[..., -1, -1], mult[..., -1, -1]
    y = torch.zeros((rows,), dtype=acc, device=ab.device)
    ins = []
    for t in range(nt):
        ins.append(y)
        y = last_out[:, t] + last_mult[:, t] * y
    out = out + mult * torch.stack(ins, dim=-1)[..., None, None]
    return out.reshape(rows, nt * ell)[:, :n]


def linrec_columns_plain(a: torch.Tensor, b: torch.Tensor, axis: int, *,
                         exclusive: bool = False, reverse: bool = False,
                         initial: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the column walk: the recurrence along ``axis`` step by step.

    ``a`` and ``b`` are rank-aligned and broadcast against each other; the
    result has their broadcast shape and dtype.  Each step is
    ``y = a_t·y + b_t`` with one rounding (formed in fp64, as the kernel's
    ``fmaf``, up to a rare double rounding); a zero state enters the first step,
    or ``initial`` (broadcast against the shape without ``axis``) folded in as
    ``b_0 + a_0·initial`` with two roundings, as ``linear_scan`` folds it.
    ``exclusive`` gives the state entering each step, ``reverse`` walks from the
    end.
    """
    full = torch.broadcast_shapes(a.shape, b.shape)
    ae, be = a.expand(full), b.expand(full)
    n = full[axis]
    out = torch.empty(full, dtype=be.dtype, device=be.device)
    rest = full[:axis] + full[axis + 1:]
    y = (torch.zeros(rest, dtype=be.dtype, device=be.device) if initial is None
         else initial.to(be.dtype).expand(rest))
    for step in range(n):
        t = n - 1 - step if reverse else step
        at, bt = ae.select(axis, t), be.select(axis, t)
        if step == 0 and initial is not None:
            nxt = bt + at * y
        else:
            nxt = (at.double() * y.double() + bt.double()).to(be.dtype)
        out.select(axis, t).copy_(y if exclusive else nxt)
        y = nxt
    return out


def _linrec_lookback_plain(ab, bb, *, s, acc, precision, tile):
    rows, n = ab.shape
    nt = max(-(-n // tile), 1)
    a, b = _identity_pad(ab, bb, nt * tile, acc)
    at, bt = a.reshape(rows * nt, tile), b.reshape(rows * nt, tile)
    local = linrec_scan_tiles_plain(at, bt, s=s, acc=acc, precision=precision)
    entering = lookback.fold_exclusive(local[:, -1].reshape(rows, nt),
                                       mults=torch.prod(at, dim=-1).reshape(rows, nt))
    bt = bt.clone()
    bt[:, 0] = at[:, 0] * entering.reshape(-1) + bt[:, 0]
    out = linrec_scan_tiles_plain(at, bt, s=s, acc=acc, precision=precision)
    return out.reshape(rows, nt * tile)[:, :n]


def _suffix_prods_excl(a: torch.Tensor) -> torch.Tensor:
    """Exclusive suffix products ``Π_{k > j} a_k`` of the last axis (no division)."""
    cp = torch.flip(torch.cumprod(torch.flip(a, dims=(-1,)), dim=-1), dims=(-1,))
    return F.pad(cp[..., 1:], (0, 1), value=1.0)


def linrec_block_summaries_plain(ablocks: torch.Tensor, bblocks: torch.Tensor,
                                 acc: torch.dtype):
    """Per ``(m, s)`` block: ``(Π a, trailing sum)`` as two ``(rows, nb)``, from
    suffix products, as the Pallas kernel forms them."""
    a, b = ablocks.to(acc), bblocks.to(acc)
    rl = torch.sum(b * _suffix_prods_excl(a), dim=-1)       # row-local last values
    rp = torch.prod(a, dim=-1)                              # row products
    return torch.prod(rp, dim=-1), torch.sum(rl * _suffix_prods_excl(rp), dim=-1)


def linrec_carry_scan_plain(prods: torch.Tensor, lasts: torch.Tensor, *,
                            precision: str = "highest") -> torch.Tensor:
    """Exclusive affine scan of ``(rows, nb)`` summaries through the chunked scan."""
    inc = _linrec_matmul(prods, lasts, method="matmul", tile_s=128, block_tiles=0,
                         accum_dtype=prods.dtype, precision=precision)
    return F.pad(inc, (1, 0))[..., :-1]


def linrec_block_scan_carry_plain(ablocks: torch.Tensor, bblocks: torch.Tensor,
                                  carries: torch.Tensor, acc: torch.dtype,
                                  precision: str = "highest") -> torch.Tensor:
    """Each ``(m, s)`` block's recurrence plus ``mult · carry``."""
    out, mult = _blocks(ablocks, bblocks, acc, precision)
    return out + mult * carries.to(acc)[..., None, None]


def linrec_blocked_scan_plain(ab: torch.Tensor, bb: torch.Tensor, *, s: int,
                              block_tiles: int, acc: torch.dtype,
                              precision: str = "highest") -> torch.Tensor:
    """Plain version of the pipeline on ``(rows, n)`` pairs."""
    rows, n = ab.shape
    m, block_len, nb = block_geometry(n, s, block_tiles)
    a, b = _identity_pad(ab, bb, nb * block_len, acc)
    ablocks, bblocks = a.reshape(rows, nb, m, s), b.reshape(rows, nb, m, s)
    if nb == 1:
        carries = torch.zeros((rows, 1), dtype=acc, device=ab.device)
    else:
        carries = linrec_carry_scan_plain(
            *linrec_block_summaries_plain(ablocks, bblocks, acc), precision=precision)
    out = linrec_block_scan_carry_plain(ablocks, bblocks, carries, acc, precision)
    return out.reshape(rows, nb * block_len)[:, :n]


# ---------------------------------------------------------------------------
# kernel launches on (rows, n) fp32 rows; the kernels mask the ragged end
# ---------------------------------------------------------------------------


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _kernel_rows(a: torch.Tensor, b: torch.Tensor, acc, *, op: str):
    """``(rows, n)`` operands as the kernels read them: contiguous fp32."""
    if acc != torch.float32:
        raise TypeError(f"{op}: the CUDA kernels accumulate in fp32, got accum_dtype={acc}")
    if a.shape[0] > _MAX_ROWS:
        raise ValueError(f"{op}: {a.shape[0]} rows exceed the kernels' int row count")
    return _f32(a), _f32(b)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _linrec_scan_cuda(ak, bk, ws=None):
    """One launch of B13.  Rows longer than ``LINREC_WARP_MAX`` take the
    look-back's workspace ``ws`` (two words a tile; allocated here if None),
    which ends with the count of CTAs that ran, one a tile."""
    rows, n = ak.shape
    out = torch.empty_like(ak)
    if ws is None and n > LINREC_WARP_MAX:
        ws = lookback.workspace(rows * -(-n // linrec_scan_tile(n)), ak.device, words=2)
    with torch.cuda.device(ak.device):
        _build.launch("linrec_scan", ak.data_ptr(), bk.data_ptr(), out.data_ptr(), rows, n,
                      None if ws is None else ws.data_ptr(),
                      0 if ws is None else ws.numel() * ws.element_size(), _stream(ak))
    return out


def _linrec_summaries_cuda(ak, bk, nb, block_len):
    rows, n = ak.shape
    prods = torch.empty((rows, nb), dtype=torch.float32, device=ak.device)
    lasts = torch.empty_like(prods)
    with torch.cuda.device(ak.device):
        _build.launch("linrec_summaries", ak.data_ptr(), bk.data_ptr(), prods.data_ptr(),
                      lasts.data_ptr(), rows, n, nb, block_len, _stream(ak))
    return prods, lasts


def _linrec_carry_cuda(prods, lasts):
    rows, nb = prods.shape
    carries = torch.empty_like(prods)
    with torch.cuda.device(prods.device):
        _build.launch("linrec_carry", prods.data_ptr(), lasts.data_ptr(), carries.data_ptr(),
                      rows, nb, _stream(prods))
    return carries


def _linrec_block_scan_cuda(ak, bk, carries, nb, block_len):
    rows, n = ak.shape
    out = torch.empty_like(ak)
    with torch.cuda.device(ak.device):
        _build.launch("linrec_block_scan", ak.data_ptr(), bk.data_ptr(), carries.data_ptr(),
                      out.data_ptr(), rows, n, nb, block_len, _stream(ak))
    return out


def _collapse(sizes, strides):
    """The stride ``s`` for which the dims (row-major) sit at ``flat index · s``, or
    None; dims of size 1 do not count, and no dims give 0."""
    dims = [(z, st) for z, st in zip(sizes, strides) if z != 1]
    if not dims:
        return 0
    s, span = dims[-1][1], 1
    for z, st in reversed(dims):
        if st != s * span:
            return None
        span *= z
    return s


def _a_view(ae, full, k):
    """``(a_so, a_sg, group)`` of the expanded multipliers, or None: the trailing
    inner axes ``ae`` is broadcast over are its group."""
    j = len(full)
    while j > k + 1 and (full[j - 1] == 1 or ae.stride(j - 1) == 0):
        j -= 1
    a_so = _collapse(full[:k], ae.stride()[:k])
    a_sg = _collapse(full[k + 1:j], ae.stride()[k + 1:j])
    if a_so is None or a_sg is None:
        return None
    return a_so, a_sg, math.prod(full[j:])


def _column_geometry(a, b, initial, axis):
    """The ``(outer, n, inner)`` views of ``csrc/linrec_columns.cuh``: the operands
    (copied only where their strides do not fit it) and its 11 geometry values."""
    full = tuple(torch.broadcast_shapes(a.shape, b.shape))
    k = axis
    outer, n, inner = math.prod(full[:k]), full[k], math.prod(full[k + 1:])
    ae = a.expand(full)
    view = _a_view(ae, full, k)
    if view is None:
        ae = ae.contiguous()
        view = _a_view(ae, full, k)
    a_so, a_sg, group = view
    be = b.expand(full)
    if _collapse(full[:k], be.stride()[:k]) is None or \
            (inner > 1 and _collapse(full[k + 1:], be.stride()[k + 1:]) != 1):
        be = be.contiguous()
    i_so = i_si = 0
    if initial is not None:
        rest = full[:k] + full[k + 1:]
        initial = initial.expand(rest)
        i_so = _collapse(full[:k], initial.stride()[:k])
        i_si = _collapse(full[k + 1:], initial.stride()[k:])
        if i_so is None or i_si is None:
            initial = initial.contiguous()
            i_so = _collapse(full[:k], initial.stride()[:k])
            i_si = _collapse(full[k + 1:], initial.stride()[k:])
    geom = [outer, n, inner, group, a_so, ae.stride(k), a_sg,
            _collapse(full[:k], be.stride()[:k]), be.stride(k), i_so, i_si]
    return ae, be, initial, full, geom


def _linrec_columns_cuda(a, b, initial, axis, *, exclusive, reverse, blocked):
    ae, be, init, full, geom = _column_geometry(a, b, initial, axis)
    out = torch.empty(full, dtype=torch.float32, device=b.device)
    g = (ctypes.c_longlong * 13)(*geom, int(reverse), int(exclusive))
    name = "linrec_block_scan" if blocked else "linrec_scan"
    with torch.cuda.device(b.device):
        _build.launch(name, ae.data_ptr(), be.data_ptr(),
                      None if init is None else init.data_ptr(), out.data_ptr(), g,
                      _stream(b), entry=f"repro_{name}_columns")
    return out


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def column_walk_applies(method: str, ndim: int, axis: int, n: int, tile_s: int,
                        block_tiles: int) -> bool:
    """Whether ``linear_scan`` walks its scan axis where it lies: ``"kernel"`` and
    ``"blocked"`` on an axis that is not the last, of ``2 … LINREC_COLUMN_MAX``
    pairs, and on ``"blocked"`` one block long (B16 alone, as the rows would be)."""
    if method not in ("kernel", "blocked") or axis == ndim - 1:
        return False
    if not 2 <= n <= LINREC_COLUMN_MAX:
        return False
    return method == "kernel" or block_geometry(n, tile_s, block_tiles)[2] == 1


def linrec_columns(a: torch.Tensor, b: torch.Tensor, axis: int, *, exclusive: bool = False,
                   reverse: bool = False, initial: torch.Tensor | None = None,
                   blocked: bool = False) -> torch.Tensor:
    """The linear recurrence along ``axis``, walked where it lies, one launch.

    Args:
        a, b: Rank-aligned multipliers and additive inputs, broadcast against
            each other (a decay shared over trailing axes stays unbroadcast);
            CUDA tensors launch the column walk of B13 (``blocked``: of B16),
            CPU tensors run :func:`linrec_columns_plain`.
        axis: The scan axis (non-negative).
        exclusive, reverse: As in ``linear_scan``.
        initial: The state entering the first step, broadcast against the shape
            without ``axis``; None for zero.
        blocked: Count the launch as B16's (``linear_scan(method="blocked")``).

    Returns:
        The recurrence at the broadcast shape, contiguous, in ``b``'s dtype.

    Raises:
        TypeError: on the card, operands that are not fp32.
    """
    if not b.is_cuda:
        return linrec_columns_plain(a, b, axis, exclusive=exclusive, reverse=reverse,
                                    initial=initial)
    for t in (a, b) + (() if initial is None else (initial,)):
        if t.dtype != torch.float32:
            raise TypeError(f"linrec_columns: the CUDA kernels read fp32, got {t.dtype}")
    full = torch.broadcast_shapes(a.shape, b.shape)
    if math.prod(full) == 0:                           # nothing to walk, no launch
        return torch.empty(full, dtype=torch.float32, device=b.device)
    return _linrec_columns_cuda(a, b, initial, axis, exclusive=exclusive, reverse=reverse,
                                blocked=blocked)


def _acc_of(a: torch.Tensor, b: torch.Tensor, accum_dtype):
    return accum_dtype if accum_dtype is not None else linrec_accum_dtype_for(
        torch.promote_types(a.dtype, b.dtype))


def _check_pair(op: str, a: torch.Tensor, b: torch.Tensor, ndim=None) -> None:
    guards.validate_same_shape(a.shape, b.shape, op=op, a_name="a", b_name="b")
    if a.dim() < 1 or (ndim is not None and a.dim() != ndim):
        raise ValueError(f"{op}: unexpected operand shape {tuple(a.shape)}")


def linrec_scan_tiles(a: torch.Tensor, b: torch.Tensor, *, s: int = 128,
                      accum_dtype=None, precision: str = "highest") -> torch.Tensor:
    """Linear recurrence of the last axis, each row's tiles linked in order.

    Args:
        a, b: ``(..., n)`` multipliers and additive inputs of one shape; CUDA
            tensors launch B13 (one launch: a single pass over tiles of
            ``linrec_scan_tile(n)`` pairs linked by the look-back, or one warp
            a row for rows of at most ``LINREC_WARP_MAX``), CPU tensors run the
            plain version.
        s: Tile side of the plain version's ``s×s`` tiles (the kernel walks
            elements and reads no tile side).
        accum_dtype: Accumulation dtype; defaults to ``linrec_accum_dtype_for``.
        precision: One of ``PRECISIONS``, already resolved: the plain
            version's products follow it; the kernel's sums do not.

    Returns:
        The inclusive recurrence from a zero state, in the accumulation dtype.

    Example:
        >>> linrec_scan_tiles(torch.tensor([2.0, 0.0, 3.0]), torch.ones(3), s=2).tolist()
        [1.0, 1.0, 4.0]
    """
    _check_pair("linrec_scan_tiles", a, b)
    s = guards.validate_positive(s, name="s", op="linrec_scan_tiles")
    guards.validate_choice(precision, PRECISIONS, name="precision", op="linrec_scan_tiles")
    acc = _acc_of(a, b, accum_dtype)
    if a.numel() == 0:
        return torch.zeros(a.shape, dtype=acc, device=a.device)
    n = a.shape[-1]
    ab, bb = a.reshape(-1, n), b.reshape(-1, n)
    if not ab.is_cuda:
        return linrec_scan_tiles_plain(ab, bb, s=s, acc=acc,
                                       precision=precision).reshape(a.shape)
    ak, bk = _kernel_rows(ab, bb, acc, op="linrec_scan_tiles")
    return _linrec_scan_cuda(ak, bk).reshape(a.shape)


def linrec_block_summaries(ablocks: torch.Tensor, bblocks: torch.Tensor, *,
                           accum_dtype=None):
    """Phase 1: ``(prods, lasts)``, each ``(rows, nb)``, of ``(rows, nb, m, s)`` blocks.

    Block ``c`` maps an incoming state to ``prods[c]·y_in + lasts[c]``.
    """
    _check_pair("linrec_block_summaries", ablocks, bblocks, ndim=4)
    rows, nb, m, s = ablocks.shape
    acc = _acc_of(ablocks, bblocks, accum_dtype)
    if not ablocks.is_cuda or ablocks.numel() == 0:
        return linrec_block_summaries_plain(ablocks, bblocks, acc)
    ak, bk = _kernel_rows(ablocks.reshape(rows, -1), bblocks.reshape(rows, -1), acc,
                          op="linrec_block_summaries")
    return _linrec_summaries_cuda(ak, bk, nb, m * s)


def linrec_carry_scan(prods: torch.Tensor, lasts: torch.Tensor, *,
                      precision: str = "highest") -> torch.Tensor:
    """Phase 2: the state entering each block, ``(rows, nb)``.

    ``carry[c] = Σ_{q<c} lasts[q] · Π_{r=q+1..c-1} prods[r]``, the exclusive
    scan of the summaries under affine composition.
    """
    guards.validate_choice(precision, PRECISIONS, name="precision", op="linrec_carry_scan")
    _check_pair("linrec_carry_scan", prods, lasts, ndim=2)
    if not prods.is_cuda or prods.numel() == 0:
        return linrec_carry_scan_plain(prods, lasts, precision=precision)
    pk, lk = _kernel_rows(prods, lasts, prods.dtype, op="linrec_carry_scan")
    return _linrec_carry_cuda(pk, lk)


def linrec_block_scan_carry(ablocks: torch.Tensor, bblocks: torch.Tensor,
                            carries: torch.Tensor, *, accum_dtype=None,
                            precision: str = "highest") -> torch.Tensor:
    """Fused phases 1 and 3: each ``(m, s)`` block's recurrence seeded with its carry.

    Args:
        ablocks, bblocks: ``(rows, nb, m, s)`` row-major block views.
        carries: ``(rows, nb)`` states entering the blocks.
        accum_dtype: Accumulation dtype; defaults to ``linrec_accum_dtype_for``.
        precision: One of ``PRECISIONS``, already resolved: the plain
            version's products follow it; the kernel's sums do not.

    Returns:
        ``(rows, nb, m, s)`` in the accumulation dtype.
    """
    guards.validate_choice(precision, PRECISIONS, name="precision",
                           op="linrec_block_scan_carry")
    _check_pair("linrec_block_scan_carry", ablocks, bblocks, ndim=4)
    rows, nb, m, s = ablocks.shape
    guards.validate_same_shape((rows, nb), carries.shape, op="linrec_block_scan_carry",
                               a_name="blocks (rows, nb)", b_name="carries")
    acc = _acc_of(ablocks, bblocks, accum_dtype)
    if not ablocks.is_cuda or ablocks.numel() == 0:
        return linrec_block_scan_carry_plain(ablocks, bblocks, carries, acc, precision)
    ak, bk = _kernel_rows(ablocks.reshape(rows, -1), bblocks.reshape(rows, -1), acc,
                          op="linrec_block_scan_carry")
    out = _linrec_block_scan_cuda(ak, bk, _f32(carries), nb, m * s)
    return out.reshape(rows, nb, m, s)


def linrec_blocked_scan(a: torch.Tensor, b: torch.Tensor, *, s: int = 128,
                        block_tiles: int = 8, accum_dtype=None,
                        precision: str = "highest") -> torch.Tensor:
    """Linear recurrence of the last axis with the three-phase blocked pipeline.

    Example:
        >>> linrec_blocked_scan(torch.full((300,), 0.5), torch.ones(300), s=8,
        ...                     block_tiles=1)[-1].item()
        2.0
    """
    _check_pair("linrec_blocked_scan", a, b)
    s = guards.validate_positive(s, name="s", op="linrec_blocked_scan")
    block_tiles = guards.validate_positive(block_tiles, name="block_tiles",
                                           op="linrec_blocked_scan")
    guards.validate_choice(precision, PRECISIONS, name="precision", op="linrec_blocked_scan")
    acc = _acc_of(a, b, accum_dtype)
    if a.numel() == 0:
        return torch.zeros(a.shape, dtype=acc, device=a.device)
    n = a.shape[-1]
    ab, bb = a.reshape(-1, n), b.reshape(-1, n)
    if not ab.is_cuda:
        return linrec_blocked_scan_plain(ab, bb, s=s, block_tiles=block_tiles, acc=acc,
                                         precision=precision).reshape(a.shape)
    _, block_len, nb = block_geometry(n, s, block_tiles)
    ak, bk = _kernel_rows(ab, bb, acc, op="linrec_blocked_scan")
    if nb == 1:
        # one block: the carry is zero, so phases 1 and 2 are skipped
        carries = torch.zeros((ab.shape[0], 1), dtype=torch.float32, device=a.device)
    else:
        carries = _linrec_carry_cuda(*_linrec_summaries_cuda(ak, bk, nb, block_len))
    return _linrec_block_scan_cuda(ak, bk, carries, nb, block_len).reshape(a.shape)

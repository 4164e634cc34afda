"""B9–B12: the segmented scan kernels (the carry resets at segment boundaries).

Port of ``repro/kernels/segscan_mm.py``.  A packed batch is a row of values
plus flags, nonzero where an element starts a new segment.  Four kernels:

* :func:`seg_scan_tiles` (B9, ``csrc/seg_scan.cu``) — the segmented scan of
  each row in one pass over many CTAs a row, each tile's carry-in from the
  decoupled look-back (:mod:`.lookback`), a carry that never crosses a flag;
* :func:`seg_block_summaries` (B10, ``csrc/seg_summaries.cu``) — phase 1 of
  the segmented §4 pipeline: per block, the sum of the elements at or after
  its last flag (all of them if it has none) and whether it has a flag, on
  the card a walk from the block's end in rounds of 16-element runs folded
  under the segmented-pair operator, stopping at the last flag
  (``seg_block_summaries_plain(fold=True)`` is its order);
* :func:`seg_carry_scan` (B11, ``csrc/seg_carry.cu``) — phase 2: the
  exclusive scan of those summaries under the segmented-pair operator
  ``(a ⊕ b) = b.h ? b.ts : a.ts + b.ts``, on the card B9's single pass
  (``csrc/seg_pass.cuh``) made exclusive, with no look-back where a row of
  summaries is one tile (``seg_carry_scan_plain(tile=)`` models it);
* :func:`seg_block_scan_carry` (B12, ``csrc/seg_block_scan.cu``) — phases 1
  and 3 fused: each block's segmented scan plus its carry, added only where no
  flag has been seen since the block start.

:func:`seg_blocked_scan` runs B10–B12 with the geometry of
``scan_pipeline.blocked_scan``; with one block per row the carries are zero
and B10 and B11 are not launched.

On CUDA tensors the wrappers launch the kernels, which read any flag dtype's
nonzero bytes, take ``(n,)`` flags shared by every row with a row stride of 0,
and mask the ragged row end themselves, so nothing is padded.  On CPU tensors
they run the plain versions (``*_plain``), which follow the JAX block algebra
on the zero-padded tile or block view: row starts from a ``cummax`` of
``iota · flag``, the flag-masked ``A @ U_s`` contraction (B9) or its
start-column gather form (B12), the masked triangular row carries, and the
``seen`` gate.  They build on the port's ``pdot``, so no integer product goes
through torch's wrapping ``int8 @ int8``.  Padding joins the last segment, as
in the JAX code, and is sliced off.

Flags count as set where they are nonzero (the JAX kernels test ``> 0`` after
an int8 cast; the two agree on boolean and non-negative flags), and the
has-boundary output of B10 is 0 or 1.

``precision`` reaches the masked products of B9, B11 and B12 (each masked
triangle an exact operand, as in JAX); B10 takes none.  On the card those
kernels sum in IEEE fp32 under every precision, so their result is the bits
of ``"highest"``.
"""
from __future__ import annotations

import torch

from repro_torch.core import guards
from repro_torch.core.precision import PRECISIONS, pdot
from repro_torch.core.scan import _operand_dtype, accum_dtype_for
from repro_torch.kernels import _build, lookback
from repro_torch.kernels.scan_mm import kernel_operand
from repro_torch.kernels.scan_pipeline import block_geometry

__all__ = ["seg_scan_tiles", "seg_block_summaries", "seg_carry_scan",
           "seg_block_scan_carry", "seg_blocked_scan", "seg_scan_tiles_plain",
           "seg_block_summaries_plain", "seg_carry_scan_plain",
           "seg_block_scan_carry_plain", "seg_blocked_scan_plain", "seg_scan_tile",
           "seg_summaries_geometry", "SEG_SCAN_THREADS", "SEG_SCAN_ITEMS",
           "SEG_SUMMARIES_THREADS", "SEG_SUMMARIES_RUN"]

_CARRY_CODES = {torch.float32: 0, torch.int32: 1}
# csrc/seg_pass.cuh: B9's and B11's threads a CTA at most, and the elements a
# thread scans
SEG_SCAN_THREADS = 512
SEG_SCAN_ITEMS = 16
# csrc/seg_summaries.cu: B10's threads a CTA at most (a round is a run a
# thread), and the elements of a run (one 16-byte load of flags)
SEG_SUMMARIES_THREADS = 256
SEG_SUMMARIES_RUN = 16
# elements of the largest intermediate a plain version builds at once
_CHUNK_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# the block algebra of the plain versions
# ---------------------------------------------------------------------------


def _row_starts(f: torch.Tensor) -> torch.Tensor:
    """``start[..., r, j]``: the last flagged column ``<= j`` of row ``r`` (0 if none)."""
    pos = torch.arange(f.shape[-1], device=f.device)
    return torch.cummax(torch.where(f, pos, 0), dim=-1).values


def _seg_rows_masked(a: torch.Tensor, startc: torch.Tensor, acc,
                     precision: str) -> torch.Tensor:
    """Row-local segmented scans as one flag-masked ``A @ U_s`` contraction.

    ``mask[r, i, j] = start[r, j] <= i <= j`` folds the flags into the upper
    triangle, one masked operand per row.
    """
    s = a.shape[-1]
    ri = torch.arange(s, device=a.device)[:, None]
    cj = torch.arange(s, device=a.device)[None, :]
    mseg = (ri <= cj) & (ri >= startc[..., None, :])            # (..., m, s, s)
    return pdot(a[..., None, :], mseg.to(_operand_dtype(a.dtype)), acc=acc,
                precision=precision, exact="right")[..., 0, :]


def _seg_rows_gather(a: torch.Tensor, startc: torch.Tensor, acc,
                     precision: str) -> torch.Tensor:
    """Row-local segmented scans as ``A @ U_s`` minus the value before each start.

    ``local[r, j] = (A @ U_s)[r, j] - exclusive(A @ U_s)[r, start[r, j]]``:
    exact for integers and integer-valued floats; no ``(m, s, s)`` mask.
    """
    s = a.shape[-1]
    u = torch.triu(torch.ones((s, s), dtype=_operand_dtype(a.dtype), device=a.device))
    full = pdot(a, u, acc=acc, precision=precision, exact="right").to(acc)
    ex = full - a.to(acc)
    return full - torch.gather(ex, -1, startc)


def _seg_row_carries(ts: torch.Tensor, hrow: torch.Tensor, acc,
                     precision: str) -> torch.Tensor:
    """Exclusive segmented carry over rows: ``c[r] = Σ ts[lastb[r] .. r-1]``.

    ``lastb[r]`` is the last row before ``r`` that holds a flag (0 if none);
    the sum is one masked triangular contraction.
    """
    m = ts.shape[-1]
    rowi = torch.arange(m, device=ts.device)
    lastb = torch.cummax(torch.where(hrow, rowi, 0), dim=-1).values
    lastb_ex = torch.cat([torch.zeros_like(lastb[..., :1]), lastb[..., :-1]], dim=-1)
    qi, rj = rowi[:, None], rowi[None, :]
    m2 = (qi < rj) & (qi >= lastb_ex[..., None, :])              # (..., m, m)
    return pdot(ts[..., None, :], m2.to(acc), acc=acc, precision=precision,
                exact="right")[..., 0, :]


def _seg_block_scan(a: torch.Tensor, f: torch.Tensor, acc, *, masked: bool,
                    precision: str):
    """Segmented scan of ``(K, m, s)`` row-major blocks, with no incoming carry.

    Returns ``(out, seen)``; ``seen`` is true where a flag lies at or before the
    element within its block — where an incoming carry must not reach.
    """
    startc = _row_starts(f)
    local = (_seg_rows_masked if masked else _seg_rows_gather)(a, startc, acc, precision)
    hrow = f.any(dim=-1)
    c = _seg_row_carries(local[..., -1], hrow, acc, precision)
    seen_row = torch.cummax(f.to(torch.int32), dim=-1).values > 0
    out = local + torch.where(seen_row, torch.zeros((), dtype=acc, device=a.device),
                              c[..., None])
    prev = torch.cummax(hrow.to(torch.int32), dim=-1).values
    prev = torch.cat([torch.zeros_like(prev[..., :1]), prev[..., :-1]], dim=-1)
    return out, seen_row | (prev[..., None] > 0)


def _seg_blocks(a: torch.Tensor, f: torch.Tensor, acc, *, masked: bool,
                precision: str):
    """:func:`_seg_block_scan` over ``(..., m, s)`` blocks, a bounded number at a time."""
    *lead, m, s = a.shape
    a2, f2 = a.reshape(-1, m, s), f.reshape(-1, m, s)
    per = max(m * s * s if masked else m * s, m * m)
    step = max(1, _CHUNK_ELEMS // per)
    parts = [_seg_block_scan(a2[i:i + step], f2[i:i + step], acc, masked=masked,
                             precision=precision)
             for i in range(0, a2.shape[0], step)]
    out = torch.cat([p[0] for p in parts]).reshape(*lead, m, s)
    seen = torch.cat([p[1] for p in parts]).reshape(*lead, m, s)
    return out, seen


def _seg_pair_exclusive(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of the last axis under ``(a ⊕ b) = b.h ? b.v : a.v + b.v``.

    Log-step doubling, so each result is a direct sum of one segment's terms.
    """
    n = v.shape[-1]
    d = 1
    while d < n:
        ov = torch.cat([torch.zeros_like(v[..., :d]), v[..., :-d]], dim=-1)
        oh = torch.cat([torch.zeros_like(h[..., :d]), h[..., :-d]], dim=-1)
        v = torch.where(h, v, ov + v)
        h = h | oh
        d *= 2
    return torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], dim=-1)


# ---------------------------------------------------------------------------
# plain versions (the CPU path)
# ---------------------------------------------------------------------------


def seg_scan_tile(n: int) -> int:
    """Elements of B9's tile, one CTA's round, for rows of ``n``: ``seg_threads(n,
    512, 16)`` threads (``csrc/seg_tile.cuh``) times ``SEG_SCAN_ITEMS``."""
    threads = min(max((n // SEG_SCAN_ITEMS + 31) // 32 * 32, 32), SEG_SCAN_THREADS)
    return threads * SEG_SCAN_ITEMS


def seg_scan_tiles_plain(xb: torch.Tensor, fb: torch.Tensor, *, s: int,
                         acc: torch.dtype, tile: int | None = None,
                         precision: str = "highest") -> torch.Tensor:
    """Plain version of B9 on ``(b, n)`` values and ``(b, n)`` bool flags.

    Each ``s×s`` tile is scanned with the flag-masked contraction, its rows
    linked by the masked row carries; the tiles are then linked in order, the
    carry into a tile being the segmented-pair scan of the tile totals.

    ``tile`` (a multiple of ``s²``) models the kernel's split: the row is cut
    into tiles of ``tile`` elements, each scanned as above with no carry; a
    tile's aggregate is its last element and whether it holds a flag, and its
    carry-in, the look-back's strict fold of the earlier aggregates under
    ``c ⊕ a = a.h ? a.v : c + a.v`` (:func:`.lookback.fold_exclusive`),
    reaches its elements before its first flag.
    """
    b, n = xb.shape
    if tile is not None:
        if tile % (s * s):
            raise ValueError(f"seg_scan_tiles_plain: tile={tile} is not a multiple of "
                             f"s*s={s * s}")
        pad = (-n) % tile
        xt = torch.nn.functional.pad(xb.to(acc), (0, pad)).reshape(-1, tile)
        ft = torch.nn.functional.pad(fb, (0, pad)).reshape(-1, tile)
        local = seg_scan_tiles_plain(xt, ft, s=s, acc=acc,
                                     precision=precision).reshape(b, -1, tile)
        ft = ft.reshape(b, -1, tile)
        cin = lookback.fold_exclusive(local[..., -1], ft.any(dim=-1))
        seen = torch.cummax(ft.to(torch.int32), dim=-1).values > 0
        out = local + torch.where(seen, torch.zeros((), dtype=acc, device=xb.device),
                                  cin[..., None])
        return out.reshape(b, -1)[:, :n]
    pad = (-n) % (s * s)
    tiles = torch.nn.functional.pad(xb.to(acc), (0, pad)).reshape(b, -1, s, s)
    # padding joins the last segment
    ftiles = torch.nn.functional.pad(fb, (0, pad)).reshape(b, -1, s, s)
    out, seen = _seg_blocks(tiles, ftiles, acc, masked=True, precision=precision)
    cin = _seg_pair_exclusive(out[..., -1, -1], ftiles.flatten(-2).any(dim=-1))
    out = out + torch.where(seen, torch.zeros((), dtype=acc, device=xb.device),
                            cin[..., None, None])
    return out.reshape(b, -1)[:, :n]


def seg_summaries_geometry(block_len: int):
    """``(threads, rounds)`` of B10's CTA for blocks of ``block_len``.

    A run of ``SEG_SUMMARIES_RUN`` elements a thread a round, whole warps, at
    most ``SEG_SUMMARIES_THREADS`` (``threads_for`` in
    ``csrc/seg_summaries.cu``); the block is ``rounds`` rounds of ``threads``
    runs, the last one ragged.
    """
    run = SEG_SUMMARIES_RUN
    threads = min((-(-block_len // run) + 31) // 32 * 32, SEG_SUMMARIES_THREADS)
    return threads, -(-block_len // (threads * run))


def _seg_pair(av, ah, bv, bh):
    """``(a ⊕ b) = (b.h ? b.v : a.v + b.v, a.h | b.h)`` elementwise."""
    return torch.where(bh, bv, av + bv), ah | bh


def _seg_summaries_fold(a: torch.Tensor, f: torch.Tensor):
    """B10's walk over ``(K, L)`` blocks, in the kernel's order.

    Each run of ``SEG_SUMMARIES_RUN`` folds to its trailing sum (restarting at
    each flag) and has-flag; a warp's 32 runs combine under ⊕ as a pairwise
    tree (the lanes' shuffles); the warps' pairs combine in order into the
    round's pair, from the identity ``(0, false)``; and the rounds are taken
    from the block's last to its first, each on the left of what has been
    gathered, ``acc = round ⊕ acc``.  The kernel stops at the round that holds
    the block's last flag, which changes no bit, so every round is taken here.
    The block's ragged end is zeros without flags.
    """
    k, length = a.shape
    threads, rounds = seg_summaries_geometry(length)
    warps, run = threads // 32, SEG_SUMMARIES_RUN
    pad = rounds * threads * run - length
    a = torch.nn.functional.pad(a, (0, pad)).view(k, rounds, warps, 32, run)
    f = torch.nn.functional.pad(f, (0, pad)).view(k, rounds, warps, 32, run)
    v = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    for j in range(run):
        v = torch.where(f[..., j], a[..., j], v + a[..., j])
    h = f.any(-1)
    while v.shape[-1] > 1:
        v, h = _seg_pair(v[..., 0::2], h[..., 0::2], v[..., 1::2], h[..., 1::2])
    v, h = v[..., 0], h[..., 0]
    rv, rh = torch.zeros_like(v[..., 0]), torch.zeros_like(h[..., 0])
    for w in range(warps):
        rv, rh = _seg_pair(rv, rh, v[..., w], h[..., w])
    bv, bh = torch.zeros_like(rv[..., 0]), torch.zeros_like(rh[..., 0])
    for r in reversed(range(rounds)):
        bv, bh = _seg_pair(rv[..., r], rh[..., r], bv, bh)
    return bv, bh


def seg_block_summaries_plain(blocks: torch.Tensor, fblocks: torch.Tensor,
                              acc: torch.dtype, *, fold: bool = False):
    """Per ``(m, s)`` block: ``(trailing-segment sum, has-flag)`` as two ``(b, nb)``.

    ``fold=True`` takes the CUDA kernel's walk instead of one sum of the
    masked trailing segment: 16-element runs folded under the segmented-pair
    operator, combined in the kernel's fixed order
    (:func:`_seg_summaries_fold`), so fp32 sums round as the kernel's do.
    """
    a = blocks.flatten(-2).to(acc)
    f = fblocks.flatten(-2) != 0
    if fold:
        ts, h = _seg_summaries_fold(a.reshape(-1, a.shape[-1]), f.reshape(-1, f.shape[-1]))
        return ts.reshape(a.shape[:-1]), h.reshape(a.shape[:-1]).to(torch.int32)
    rank = torch.arange(a.shape[-1], device=a.device)
    lastpos = torch.where(f, rank, 0).amax(dim=-1, keepdim=True)
    trailing = torch.where(rank >= lastpos, a, torch.zeros((), dtype=acc, device=a.device))
    return torch.sum(trailing, dim=-1, dtype=acc), f.any(dim=-1).to(torch.int32)


def seg_carry_scan_plain(sums: torch.Tensor, has_boundary: torch.Tensor, *,
                         tile: int | None = None, s: int = 8,
                         precision: str = "highest") -> torch.Tensor:
    """Exclusive segmented scan of each row of the ``(b, nb)`` summaries.

    ``tile`` (a multiple of ``s²``) models the kernel's pass instead of the one
    masked contraction: the inclusive tile pass of B9
    (:func:`seg_scan_tiles_plain` with ``tile=``: each tile's fold, its carry-in
    from the look-back's left-to-right fold of the earlier tiles' aggregates),
    then the shift to exclusive, block 0's carry being zero.
    """
    if tile is None:
        return _seg_row_carries(sums, has_boundary != 0, sums.dtype, precision)
    inc = seg_scan_tiles_plain(sums, has_boundary != 0, s=s, acc=sums.dtype, tile=tile,
                               precision=precision)
    return torch.cat([torch.zeros_like(inc[:, :1]), inc[:, :-1]], dim=-1)


def seg_block_scan_carry_plain(blocks: torch.Tensor, fblocks: torch.Tensor,
                               carries: torch.Tensor, acc: torch.dtype,
                               precision: str = "highest") -> torch.Tensor:
    """Each ``(m, s)`` block's segmented scan (gather form) plus its gated carry."""
    out, seen = _seg_blocks(blocks, fblocks != 0, acc, masked=False, precision=precision)
    return out + torch.where(seen, torch.zeros((), dtype=acc, device=blocks.device),
                             carries.to(acc)[..., None, None])


def seg_blocked_scan_plain(xb: torch.Tensor, fb: torch.Tensor, *, s: int,
                           block_tiles: int, acc: torch.dtype,
                           precision: str = "highest") -> torch.Tensor:
    """Plain version of the segmented pipeline on ``(b, n)`` rows and bool flags."""
    b, n = xb.shape
    m, block_len, nb = block_geometry(n, s, block_tiles)
    pad = nb * block_len - n
    blocks = torch.nn.functional.pad(xb.to(acc), (0, pad)).reshape(b, nb, m, s)
    fblocks = torch.nn.functional.pad(fb, (0, pad)).reshape(b, nb, m, s)
    if nb == 1:
        carries = torch.zeros((b, 1), dtype=acc, device=xb.device)
    else:
        carries = seg_carry_scan_plain(*seg_block_summaries_plain(blocks, fblocks, acc),
                                       precision=precision)
    out = seg_block_scan_carry_plain(blocks, fblocks, carries, acc, precision)
    return out.reshape(b, nb * block_len)[:, :n]


# ---------------------------------------------------------------------------
# kernel launches on (b, n) rows; the kernels mask the ragged end
# ---------------------------------------------------------------------------


def _flag_rows(flags: torch.Tensor, shape):
    """Flags as the kernels read them — one byte each, nonzero where a segment
    starts — and their row stride: 0 when one row of flags serves every row."""
    n = shape[-1]
    f = flags.view(torch.uint8) if flags.dtype == torch.bool else flags
    if f.dtype not in (torch.int8, torch.uint8):
        f = (f != 0).view(torch.uint8)
    if f.numel() == n:
        return f.reshape(n).contiguous(), 0
    return f.expand(shape).reshape(-1, n).contiguous(), n


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _seg_scan_cuda(xk, code, fk, fstride, acc, ws=None):
    """One launch of B9; ``ws`` (the look-back's workspace, allocated here if
    None) ends with the count of CTAs that ran, one a tile."""
    b, n = xk.shape
    out = torch.empty((b, n), dtype=acc, device=xk.device)
    if ws is None:
        ws = lookback.workspace(b * -(-n // seg_scan_tile(n)), xk.device)
    with torch.cuda.device(xk.device):
        _build.launch("seg_scan", xk.data_ptr(), fk.data_ptr(), fstride, out.data_ptr(),
                      b, n, code, ws.data_ptr(), ws.numel() * ws.element_size(),
                      _stream(xk))
    return out


def _seg_summaries_cuda(xk, code, fk, fstride, acc, nb, block_len):
    b, n = xk.shape
    ts = torch.empty((b, nb), dtype=acc, device=xk.device)
    h = torch.empty((b, nb), dtype=torch.int32, device=xk.device)
    with torch.cuda.device(xk.device):
        _build.launch("seg_summaries", xk.data_ptr(), fk.data_ptr(), fstride, ts.data_ptr(),
                      h.data_ptr(), b, n, nb, block_len, code, _stream(xk))
    return ts, h


def _seg_carry_cuda(ts, h, ws=None):
    """One launch of B11, B9's single pass made exclusive.  Rows of more than one
    tile take the look-back's workspace ``ws`` (allocated here if None; its last
    word ends as the count of CTAs that ran); rows of one tile take none."""
    b, nb = ts.shape
    carries = torch.empty_like(ts)
    tiles = -(-nb // seg_scan_tile(nb))
    if ws is None and tiles > 1:
        ws = lookback.workspace(b * tiles, ts.device)
    ptr, nbytes = (0, 0) if ws is None else (ws.data_ptr(), ws.numel() * ws.element_size())
    with torch.cuda.device(ts.device):
        _build.launch("seg_carry", ts.data_ptr(), h.data_ptr(), carries.data_ptr(), b, nb,
                      _CARRY_CODES[ts.dtype], ptr, nbytes, _stream(ts))
    return carries


def _seg_block_scan_cuda(xk, code, fk, fstride, carries, acc, nb, block_len):
    b, n = xk.shape
    out = torch.empty((b, n), dtype=acc, device=xk.device)
    with torch.cuda.device(xk.device):
        _build.launch("seg_block_scan", xk.data_ptr(), fk.data_ptr(), fstride,
                      carries.data_ptr(), out.data_ptr(), b, n, nb, block_len, code,
                      _stream(xk))
    return out


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check_blocks(op: str, blocks: torch.Tensor, fblocks: torch.Tensor) -> None:
    if blocks.dim() != 4:
        raise ValueError(f"{op}: blocks must be (b, nb, m, s), got {tuple(blocks.shape)}")
    guards.validate_same_shape(blocks.shape, fblocks.shape, op=op, a_name="blocks",
                               b_name="fblocks")


def seg_scan_tiles(x: torch.Tensor, flags: torch.Tensor, *, s: int = 128,
                   accum_dtype=None, precision: str = "highest") -> torch.Tensor:
    """Segmented scan of the last axis of ``x``, each row's tiles linked in order.

    Args:
        x: ``(..., n)`` packed values; a CUDA tensor launches B9, a CPU tensor
            runs the plain version.
        flags: Broadcastable to ``x``; nonzero where an element starts a new
            segment.  ``(n,)`` flags are shared by every row.
        s: Tile side of the plain version's ``s×s`` tiles (the kernel cuts a
            row into tiles of ``seg_scan_tile(n)`` elements and reads no side).
        accum_dtype: Accumulation dtype; defaults to ``accum_dtype_for``.
        precision: One of ``PRECISIONS``, already resolved: the plain
            version's products follow it; the kernel's sums do not.

    Returns:
        The per-segment inclusive scan in the accumulation dtype, shaped like ``x``.

    Example:
        >>> seg_scan_tiles(torch.ones(5, dtype=torch.int8),
        ...                torch.tensor([1, 0, 1, 0, 0]), s=2).tolist()
        [1, 2, 1, 2, 3]
    """
    guards.validate_broadcastable_to(flags.shape, x.shape, op="seg_scan_tiles")
    s = guards.validate_positive(s, name="s", op="seg_scan_tiles")
    guards.validate_choice(precision, PRECISIONS, name="precision", op="seg_scan_tiles")
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(x.dtype)
    if x.numel() == 0:
        return torch.zeros(x.shape, dtype=acc, device=x.device)
    n = x.shape[-1]
    xb = x.reshape(-1, n)
    if not xb.is_cuda:
        fb = (flags != 0).expand(x.shape).reshape(xb.shape)
        return seg_scan_tiles_plain(xb, fb, s=s, acc=acc,
                                    precision=precision).reshape(x.shape)
    xk, code = kernel_operand(xb, acc, op="seg_scan_tiles")
    fk, fstride = _flag_rows(flags, x.shape)
    return _seg_scan_cuda(xk, code, fk, fstride, acc).reshape(x.shape)


def seg_block_summaries(blocks: torch.Tensor, fblocks: torch.Tensor, *,
                        accum_dtype=None):
    """Phase 1: ``(trailing sums, has-boundary)`` of ``(b, nb, m, s)`` blocks.

    ``ts`` is the sum of a block's elements at or after its last flag (the
    whole block if it has none), in ``acc``; ``h`` is int32, 1 where the block
    holds a flag.  Reads the raw input only.
    """
    _check_blocks("seg_block_summaries", blocks, fblocks)
    b, nb, m, s = blocks.shape
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(blocks.dtype)
    if not blocks.is_cuda or blocks.numel() == 0:
        return seg_block_summaries_plain(blocks, fblocks, acc)
    xk, code = kernel_operand(blocks.reshape(b, nb * m * s), acc, op="seg_block_summaries")
    fk, fstride = _flag_rows(fblocks.reshape(b, nb * m * s), xk.shape)
    return _seg_summaries_cuda(xk, code, fk, fstride, acc, nb, m * s)


def seg_carry_scan(sums: torch.Tensor, has_boundary: torch.Tensor, *,
                   precision: str = "highest") -> torch.Tensor:
    """Phase 2: exclusive segmented scan of the ``(b, nb)`` block summaries.

    The carry into block ``i`` is the sum of ``sums`` from the last block
    before ``i`` that has a boundary (the first block if none) up to ``i-1``.
    """
    guards.validate_choice(precision, PRECISIONS, name="precision", op="seg_carry_scan")
    if sums.dim() != 2:
        raise ValueError(f"seg_carry_scan: sums must be (b, nb), got {tuple(sums.shape)}")
    guards.validate_same_shape(sums.shape, has_boundary.shape, op="seg_carry_scan",
                               a_name="sums", b_name="has_boundary")
    if not sums.is_cuda or sums.numel() == 0:
        return seg_carry_scan_plain(sums, has_boundary, precision=precision)
    if sums.dtype not in _CARRY_CODES:
        raise TypeError(f"seg_carry_scan: the CUDA kernel takes {list(_CARRY_CODES)}, "
                        f"got {sums.dtype}")
    return _seg_carry_cuda(sums.contiguous(), has_boundary.to(torch.int32).contiguous())


def seg_block_scan_carry(blocks: torch.Tensor, fblocks: torch.Tensor,
                         carries: torch.Tensor, *, accum_dtype=None,
                         precision: str = "highest") -> torch.Tensor:
    """Fused phases 1 and 3: each block's segmented scan plus its gated carry.

    Args:
        blocks: ``(b, nb, m, s)`` row-major block views.
        fblocks: Their flags, same shape.
        carries: ``(b, nb)`` from :func:`seg_carry_scan`; block ``i``'s carry
            reaches only its elements with no flag at or before them.
        accum_dtype: Accumulation dtype; defaults to ``accum_dtype_for``.
        precision: One of ``PRECISIONS``, already resolved: the plain
            version's products follow it; the kernel's sums do not.

    Returns:
        ``(b, nb, m, s)`` in the accumulation dtype.
    """
    guards.validate_choice(precision, PRECISIONS, name="precision",
                           op="seg_block_scan_carry")
    _check_blocks("seg_block_scan_carry", blocks, fblocks)
    b, nb, m, s = blocks.shape
    guards.validate_same_shape((b, nb), carries.shape, op="seg_block_scan_carry",
                               a_name="blocks (b, nb)", b_name="carries")
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(blocks.dtype)
    if not blocks.is_cuda or blocks.numel() == 0:
        return seg_block_scan_carry_plain(blocks, fblocks, carries, acc, precision)
    xk, code = kernel_operand(blocks.reshape(b, nb * m * s), acc, op="seg_block_scan_carry")
    fk, fstride = _flag_rows(fblocks.reshape(b, nb * m * s), xk.shape)
    out = _seg_block_scan_cuda(xk, code, fk, fstride, carries.to(acc).contiguous(), acc,
                               nb, m * s)
    return out.reshape(b, nb, m, s)


def seg_blocked_scan(x: torch.Tensor, flags: torch.Tensor, *, s: int = 128,
                     block_tiles: int = 8, accum_dtype=None,
                     precision: str = "highest") -> torch.Tensor:
    """Segmented scan of the last axis with the three-phase blocked pipeline.

    Blocks are ``block_tiles`` tiles of ``s×s`` (clamped to the row's tiles),
    as in ``scan_pipeline.blocked_scan``; with one block per row B10 and B11
    are skipped.

    Example:
        >>> seg_blocked_scan(torch.ones(300, dtype=torch.int8),
        ...                  torch.tensor([1] + [0] * 199 + [1] + [0] * 99), s=8)[-1].item()
        100
    """
    guards.validate_broadcastable_to(flags.shape, x.shape, op="seg_blocked_scan")
    s = guards.validate_positive(s, name="s", op="seg_blocked_scan")
    block_tiles = guards.validate_positive(block_tiles, name="block_tiles",
                                           op="seg_blocked_scan")
    guards.validate_choice(precision, PRECISIONS, name="precision", op="seg_blocked_scan")
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(x.dtype)
    if x.numel() == 0:
        return torch.zeros(x.shape, dtype=acc, device=x.device)
    n = x.shape[-1]
    xb = x.reshape(-1, n)
    if not xb.is_cuda:
        fb = (flags != 0).expand(x.shape).reshape(xb.shape)
        return seg_blocked_scan_plain(xb, fb, s=s, block_tiles=block_tiles,
                                      acc=acc, precision=precision).reshape(x.shape)
    _, block_len, nb = block_geometry(n, s, block_tiles)
    xk, code = kernel_operand(xb, acc, op="seg_blocked_scan")
    fk, fstride = _flag_rows(flags, x.shape)
    if nb == 1:
        # one block: the carry is zero, so phases 1 and 2 are skipped
        carries = torch.zeros((xb.shape[0], 1), dtype=acc, device=x.device)
    else:
        carries = _seg_carry_cuda(*_seg_summaries_cuda(xk, code, fk, fstride, acc, nb,
                                                       block_len))
    return _seg_block_scan_cuda(xk, code, fk, fstride, carries, acc, nb,
                                block_len).reshape(x.shape)

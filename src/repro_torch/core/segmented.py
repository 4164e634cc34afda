"""Segmented and ragged operators: the §5 operators on packed batches.

Port of ``repro/core/segmented.py``.  A packed batch is CSR-style: ``values``
holds every segment back to back (``n`` elements) and int32 ``offsets`` of
shape ``(num_segments + 1,)`` frame them, with ``offsets[0] == 0`` and
``offsets[-1] == n``; an empty segment is a repeated offset.
:class:`SegmentedBatch` bundles the pair.

The foundation is :func:`segment_scan`, a prefix sum whose carry resets at
segment boundaries, dispatched through the ``method=`` table of
:mod:`repro_torch.core.primitives`:

* ``"matmul"`` / ``"vector"`` — the full unsegmented :func:`scan`, minus the
  scan value before each element's segment start (exact for integer and
  integer-valued payloads);
* ``"kernel"`` — one launch of the segmented tile scan (B9,
  ``kernels.segscan_mm.seg_scan_tiles``);
* ``"blocked"`` — the segmented §4 pipeline (B10–B12,
  ``kernels.segscan_mm.seg_blocked_scan``).

On top ride :func:`segment_cumsum`, :func:`segment_sums`,
:func:`segment_compress`, :func:`segment_sort`, :func:`segment_topk`,
:func:`segment_softmax` and :func:`segment_top_p_sample`;
:func:`segment_linear_scan` is one unsegmented ``linear_scan`` with ``a``
zeroed at the segment starts.  Each is
bit-identical to looping the 1-D operator over the segments, for every
method: offsets, permutations and counts come from exact int8 -> int32 mask
scans.

Every entry point validates the offsets on the host (``guards.validate_offsets``),
one read per call.  :func:`segment_scan`, :func:`segment_sums` and
:func:`segment_linear_scan` take ``precision=`` (``"highest"``,
``"compensated"``, ``"fast"``; :mod:`repro_torch.core.precision`), resolved
once against the resolved method and passed on.  :func:`segment_scan`,
:func:`segment_linear_scan` and :func:`segment_top_p_sample` take the
non-finite policy of :mod:`repro_torch.core.guards` (``nonfinite=``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import guards
from repro_torch.core.autotune import maybe_resolve
from repro_torch.core.linrec import linear_scan, linrec_accum_dtype_for
from repro_torch.core.precision import resolve_precision
from repro_torch.core.primitives import _encode_for_sort, _register, dispatch
from repro_torch.core.scan import accum_dtype_for, scan

__all__ = [
    "SegmentedBatch", "boundary_flags", "segment_ids", "segment_scan",
    "segment_cumsum", "segment_sums", "segment_softmax", "segment_compress",
    "segment_sort", "segment_topk", "segment_top_p_sample",
    "segment_linear_scan",
]


# ---------------------------------------------------------------------------
# The packed container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegmentedBatch:
    """CSR-style packed batch: ``values`` back to back, ``offsets`` framing them.

    Segment ``i`` is ``values[offsets[i]:offsets[i + 1]]``.

    Example:
        >>> sb = SegmentedBatch.from_ragged([[1, 2, 3], [], [4, 5]])
        >>> sb.num_segments, sb.lengths.tolist()
        (3, [3, 0, 2])
        >>> [seg.tolist() for seg in sb.to_ragged()]
        [[1, 2, 3], [], [4, 5]]
    """

    values: torch.Tensor
    offsets: torch.Tensor

    @property
    def num_segments(self) -> int:
        """Number of segments, ``offsets.shape[0] - 1``."""
        return self.offsets.shape[0] - 1

    @property
    def lengths(self) -> torch.Tensor:
        """Per-segment lengths, int32 of shape ``(num_segments,)``."""
        return (self.offsets[1:] - self.offsets[:-1]).to(torch.int32)

    @classmethod
    def from_ragged(cls, segments: Sequence, dtype=None) -> "SegmentedBatch":
        """Pack a host-side list of 1-D array-likes (empties allowed) into one CPU batch.

        Args:
            segments: The segments, in order.
            dtype: Optional torch dtype of the packed values.
        """
        arrs = [np.asarray(s).reshape(-1) for s in segments]
        ref = next((a for a in arrs if a.size), None)
        if ref is not None:  # keep empties from promoting the concat dtype
            arrs = [a.astype(ref.dtype) if a.size == 0 else a for a in arrs]
        lens = np.asarray([a.shape[0] for a in arrs], np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        values = np.concatenate(arrs) if ref is not None else np.zeros((0,), np.int32)
        v = torch.as_tensor(values)
        if dtype is not None:
            v = v.to(dtype)
        return cls(v, torch.as_tensor(offsets))

    def to_ragged(self) -> List[np.ndarray]:
        """Unpack to a host-side list of per-segment numpy arrays."""
        v = self.values.cpu().numpy()
        off = self.offsets.cpu().numpy()
        return [v[off[i]:off[i + 1]] for i in range(self.num_segments)]

    def to_dense(self, fill_value=0) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side ``(num_segments, max_len)`` ``(dense, mask)`` numpy pair."""
        segs = self.to_ragged()
        width = max((s.shape[0] for s in segs), default=0)
        dense = np.full((len(segs), width), fill_value, dtype=self.values.cpu().numpy().dtype)
        mask = np.zeros((len(segs), width), bool)
        for i, s in enumerate(segs):
            dense[i, :s.shape[0]] = s
            mask[i, :s.shape[0]] = True
        return dense, mask


def _unwrap(values, offsets, *, op: str = "segmented"):
    """Accept a :class:`SegmentedBatch` or a ``(values, offsets)`` pair.

    Loose offsets are cast to int32 on the values' device, as the JAX package
    casts them.  Either way the CSR contract is checked here, the one choke
    point of every packed-batch entry point, and int32 offsets come out.
    """
    if isinstance(values, SegmentedBatch):
        values, offsets = values.values, values.offsets
    elif offsets is None:
        raise ValueError("offsets required when values is not a SegmentedBatch")
    else:
        offsets = torch.as_tensor(offsets, device=values.device).to(torch.int32)
    offsets = guards.validate_offsets(offsets, values.shape[-1], op=op)
    return values, offsets.to(torch.int32)


# ---------------------------------------------------------------------------
# Boundary structure (flags / ids / end gathers)
# ---------------------------------------------------------------------------


def _start_index(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """Segment starts as int64 indices, with starts at ``n`` sent to slot ``n``."""
    return torch.clamp(offsets[:-1].to(torch.int64), max=n)


def boundary_flags(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """Int8 flags marking segment starts: ``flags[i] = 1`` iff ``i`` starts one.

    Offsets equal to ``n`` (trailing empty segments) are dropped, and the
    starts of empty segments collapse onto one flag.

    Example:
        >>> boundary_flags(torch.tensor([0, 2, 2, 5]), 5).tolist()
        [1, 0, 1, 0, 0]
    """
    flags = torch.zeros((n + 1,), dtype=torch.int8, device=offsets.device)
    return flags.scatter_(0, _start_index(offsets, n), 1)[:n]


def segment_ids(offsets: torch.Tensor, n: int, *, method: str = "vector",
                tile_s: int = 128) -> torch.Tensor:
    """Segment id of every packed element, via a scan of the start counts.

    One count per segment start (empty segments stack on one index), then the
    inclusive scan minus one, so each element maps to the segment that holds it.

    Example:
        >>> segment_ids(torch.tensor([0, 2, 2, 5]), 5).tolist()
        [0, 0, 2, 2, 2]
    """
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=offsets.device)
    counts = torch.zeros((n + 1,), dtype=torch.int32, device=offsets.device)
    ones = torch.ones((offsets.shape[0] - 1,), dtype=torch.int32, device=offsets.device)
    counts.scatter_add_(0, _start_index(offsets, n), ones)
    return scan(counts[:n], method=method, tile_s=tile_s).to(torch.int32) - 1


def _segment_ends(per_element: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``per_element`` read at each segment's last element (0 for an empty segment)."""
    n = per_element.shape[-1]
    num_segments = offsets.shape[0] - 1
    if n == 0:
        return torch.zeros(per_element.shape[:-1] + (num_segments,),
                           dtype=per_element.dtype, device=per_element.device)
    lens = offsets[1:] - offsets[:-1]
    ends = torch.clamp(offsets[1:] - 1, 0, n - 1).to(torch.int64)
    vals = per_element.index_select(-1, ends)
    return torch.where(lens > 0, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))


# ---------------------------------------------------------------------------
# segment_scan — method-dispatched
# ---------------------------------------------------------------------------


@_register("segment_scan", "matmul", "vector")
def _segment_scan_unfused(values, offsets, *, method, tile_s, block_tiles, accum_dtype,
                          precision):
    """Full unsegmented scan, minus the scan value before each segment start.

    ``seg[i] = scan(values)[i] - scan(values)[start(i) - 1]``: exact whenever
    the partial sums are (integer paths, integer-valued floats).
    """
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(values.dtype)
    full = scan(values, axis=-1, method=method, tile_s=tile_s, block_tiles=block_tiles,
                accum_dtype=acc, precision=precision)
    n = values.shape[-1]
    starts = offsets.index_select(0, segment_ids(offsets, n).to(torch.int64))
    base = full.index_select(-1, torch.clamp(starts - 1, 0, n - 1).to(torch.int64))
    return full - torch.where(starts > 0, base, torch.zeros((), dtype=acc,
                                                            device=full.device))


@_register("segment_scan", "kernel")
def _segment_scan_fused(values, offsets, *, method, tile_s, block_tiles, accum_dtype,
                        precision):
    """One B9 launch for the whole packed batch (every leading row shares the flags)."""
    from repro_torch.kernels.segscan_mm import seg_scan_tiles
    flags = boundary_flags(offsets, values.shape[-1])
    return seg_scan_tiles(values, flags, s=tile_s, accum_dtype=accum_dtype,
                          precision=precision)


@_register("segment_scan", "blocked")
def _segment_scan_blocked(values, offsets, *, method, tile_s, block_tiles, accum_dtype,
                          precision):
    """The segmented §4 pipeline (B10, B11, B12; B12 alone for one block a row)."""
    from repro_torch.kernels.segscan_mm import seg_blocked_scan
    flags = boundary_flags(offsets, values.shape[-1])
    return seg_blocked_scan(values, flags, s=tile_s, block_tiles=block_tiles,
                            accum_dtype=accum_dtype, precision=precision)


def segment_scan(values, offsets=None, *, exclusive: bool = False,
                 reverse: bool = False, method: str = "auto", tile_s: int = 128,
                 block_tiles: int = 8, accum_dtype=None, precision: str = "highest",
                 nonfinite: str = "propagate") -> torch.Tensor:
    """Per-segment prefix sum of a packed batch: the carry resets at boundaries.

    The segmented analogue of :func:`repro_torch.core.scan.scan`, with its
    ``method=`` dispatch and accumulation dtypes.  Leading batch dimensions
    share the offsets (the one-hot mask scans of :func:`segment_sort`).

    Args:
        values: Packed tensor ``(..., n)``, or a :class:`SegmentedBatch`.
        offsets: ``(num_segments + 1,)`` CSR offsets framing the last axis;
            required unless ``values`` is a :class:`SegmentedBatch`.
        exclusive: Shift each segment right by one with a leading 0.
        reverse: Scan each segment from its end.
        method: ``"auto"`` or one of ``METHODS`` (module docstring).
        tile_s: Tile side ``s`` of the matmul scans and the kernels' geometry.
        block_tiles: Tiles per block for ``method="blocked"``.
        accum_dtype: Accumulation dtype override.
        precision: ``"highest"``, ``"compensated"`` or ``"fast"``
            (``precision_override`` > ``REPRO_SCAN_PRECISION`` > this
            argument): the masked products on ``"matmul"`` and the kernels'
            plain versions follow it; the CUDA kernels return the bits of
            ``"highest"``.  An explicit non-default precision with
            ``method="vector"`` raises ``ValueError``.
        nonfinite: Non-finite input policy (:mod:`repro_torch.core.guards`):
            ``"propagate"``, ``"raise"`` or ``"sanitize"`` (non-finite -> 0).

    Returns:
        The per-segment scan, shaped like ``values``, in the accumulation dtype.

    Raises:
        NonFiniteError: ``nonfinite="raise"`` and ``values`` holds a non-finite
            value.
        NotImplementedError: ``values`` requires grad under grad mode on
            ``"kernel"`` or ``"blocked"`` (B9–B12), where ``jax.grad`` fails too.

    Example:
        >>> x = torch.ones(5, dtype=torch.int32)
        >>> segment_scan(x, torch.tensor([0, 2, 5]), method="vector").tolist()
        [1, 2, 1, 2, 3]
        >>> segment_scan(x, [0, 2, 5], exclusive=True, method="vector").tolist()
        [0, 1, 0, 1, 2]
    """
    values, offsets = _unwrap(values, offsets, op="segment_scan")
    values = guards.apply_nonfinite(
        values, guards.resolve_nonfinite(nonfinite, op="segment_scan"), op="segment_scan")
    return _segment_scan(values, offsets, exclusive=exclusive, reverse=reverse,
                         method=method, tile_s=tile_s, block_tiles=block_tiles,
                         accum_dtype=accum_dtype, precision=precision)


def _segment_scan(values, offsets, *, exclusive, reverse, method, tile_s, block_tiles,
                  accum_dtype, precision):
    n = values.shape[-1]
    explicit_method = method != "auto"
    method = maybe_resolve(method, "segment_scan", n, values.dtype, device=values.device)
    precision = resolve_precision(precision, method=method,
                                  explicit_method=explicit_method)
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(values.dtype)
    if n == 0:
        return torch.zeros(values.shape, dtype=acc, device=values.device)
    if reverse:
        rev_off = torch.flip(n - offsets, dims=(0,))
        out = _segment_scan(torch.flip(values, dims=(-1,)), rev_off, exclusive=exclusive,
                            reverse=False, method=method, tile_s=tile_s,
                            block_tiles=block_tiles, accum_dtype=accum_dtype,
                            precision=precision)
        return torch.flip(out, dims=(-1,))
    guards.refuse_grad(values, op="segment_scan", method=method)
    out = dispatch("segment_scan", method)(values, offsets, method=method, tile_s=tile_s,
                                           block_tiles=block_tiles, accum_dtype=acc,
                                           precision=precision)
    if exclusive:
        shifted = torch.cat([torch.zeros_like(out[..., :1]), out[..., :-1]], dim=-1)
        out = torch.where(boundary_flags(offsets, n) > 0,
                          torch.zeros((), dtype=out.dtype, device=out.device), shifted)
    return out


def segment_cumsum(values, offsets=None, **kw) -> torch.Tensor:
    """Per-segment ``cumsum``: an alias of :func:`segment_scan`.

    Example:
        >>> segment_cumsum(torch.tensor([3, 4, 5]), [0, 1, 3], method="vector").tolist()
        [3, 4, 9]
    """
    return segment_scan(values, offsets, **kw)


def segment_linear_scan(a, b, offsets=None, *, exclusive: bool = False,
                        reverse: bool = False, method: str = "auto", initial=0.0,
                        tile_s: int = 128, block_tiles: int = 8, accum_dtype=None,
                        precision: str = "highest",
                        nonfinite: str = "propagate") -> torch.Tensor:
    """Per-segment linear recurrence ``y_t = a_t * y_{t-1} + b_t`` of a packed batch.

    At every segment start the state resets to ``initial``: ``a`` is zeroed
    there and ``a_t * initial`` folded into ``b_t``, so the packed batch runs as
    one unsegmented :func:`~repro_torch.core.linrec.linear_scan` on any
    ``method`` (B13 on ``"kernel"``, B14–B16 on ``"blocked"``), with no extra
    kernel: a zero of ``a`` resets the recurrence exactly.

    Args:
        a: Packed multipliers ``(..., n)``, or a :class:`SegmentedBatch`
            (then ``offsets`` comes from it); broadcast against ``b``.
        b: Packed additive inputs ``(..., n)``.
        offsets: ``(num_segments + 1,)`` CSR offsets of the last axis.
        exclusive: Return the state entering each step; segment starts get
            ``initial``.
        reverse: Scan each segment from its end.
        method: ``"auto"`` or one of ``METHODS``, forwarded to ``linear_scan``.
        initial: The state at each segment start: a scalar, or a tensor
            broadcastable against the leading dims (one value per row).
        tile_s, block_tiles, accum_dtype, precision: As in ``linear_scan``.
        nonfinite: Non-finite input policy, as in ``linear_scan`` (``"sanitize"``:
            ``a -> 1``, ``b -> 0``).

    Returns:
        The per-segment recurrence at the broadcast shape of ``a`` and ``b``,
        in the linrec accumulation dtype.

    Example:
        >>> a, b = torch.full((5,), 2.0), torch.ones(5)
        >>> segment_linear_scan(a, b, [0, 2, 5], method="vector").tolist()
        [1.0, 3.0, 1.0, 3.0, 7.0]
        >>> segment_linear_scan(a, b, [0, 2, 5], initial=1.0, method="matmul").tolist()
        [3.0, 7.0, 3.0, 7.0, 15.0]
    """
    a, offsets = _unwrap(a, offsets, op="segment_linear_scan")
    b = torch.as_tensor(b, device=a.device)
    nf = guards.resolve_nonfinite(nonfinite, op="segment_linear_scan")
    a = guards.apply_nonfinite(a, nf, op="segment_linear_scan", identity=1.0)
    b = guards.apply_nonfinite(b, nf, op="segment_linear_scan", identity=0.0)
    shp = torch.broadcast_shapes(a.shape, b.shape)
    a, b = a.expand(shp), b.expand(shp)
    n = shp[-1]
    dtype = torch.promote_types(a.dtype, b.dtype)
    explicit_method = method != "auto"
    method = maybe_resolve(method, "segment_linear_scan", n, dtype, device=a.device)
    precision = resolve_precision(precision, method=method,
                                  explicit_method=explicit_method)
    acc = accum_dtype if accum_dtype is not None else linrec_accum_dtype_for(dtype)
    if n == 0:
        return torch.zeros(shp, dtype=acc, device=a.device)
    if reverse:
        rev_off = torch.flip(n - offsets, dims=(0,))
        out = segment_linear_scan(torch.flip(a, dims=(-1,)), torch.flip(b, dims=(-1,)),
                                  rev_off, exclusive=exclusive, method=method,
                                  initial=initial, tile_s=tile_s, block_tiles=block_tiles,
                                  accum_dtype=accum_dtype, precision=precision)
        return torch.flip(out, dims=(-1,))
    flags = boundary_flags(offsets, n) > 0
    init = torch.as_tensor(initial, dtype=acc, device=a.device)
    # an array initial is per leading row: align it against the packed axis
    init_e = init[..., None] if init.dim() else init
    a_acc, b_acc = a.to(acc), b.to(acc)
    a_cut = torch.where(flags, torch.zeros((), dtype=acc, device=a.device), a_acc)
    b_cut = torch.where(flags, b_acc + a_acc * init_e, b_acc)
    out = linear_scan(a_cut, b_cut, method=method, tile_s=tile_s, block_tiles=block_tiles,
                      accum_dtype=acc, precision=precision)
    if exclusive:
        shifted = torch.nn.functional.pad(out, (1, 0))[..., :-1]
        out = torch.where(flags, init_e.expand(out.shape), shifted)
    return out


def segment_sums(values, offsets=None, *, method: str = "auto", tile_s: int = 128,
                 block_tiles: int = 8, accum_dtype=None,
                 precision: str = "highest") -> torch.Tensor:
    """Per-segment totals, read off the inclusive segmented scan's last element.

    Returns:
        ``(..., num_segments)`` in the accumulation dtype (0 for an empty segment).

    Example:
        >>> segment_sums(torch.ones(5, dtype=torch.int8), [0, 2, 2, 5],
        ...              method="vector").tolist()
        [2, 0, 3]
    """
    values, offsets = _unwrap(values, offsets, op="segment_sums")
    inc = segment_scan(values, offsets, method=method, tile_s=tile_s,
                       block_tiles=block_tiles, accum_dtype=accum_dtype,
                       precision=precision)
    return _segment_ends(inc, offsets)


# ---------------------------------------------------------------------------
# segment_compress — per-segment SplitInd
# ---------------------------------------------------------------------------


@_register("segment_compress", "matmul", "vector", "kernel", "blocked")
def _segment_compress_impl(values, mask, offsets, *, method, fill_value, tile_s,
                           block_tiles):
    """Per-segment masked select via one segmented int8 mask scan + scatter."""
    n = values.shape[-1]
    ids = segment_ids(offsets, n).to(torch.int64)
    seg_start = offsets.index_select(0, ids)
    m32 = mask.to(torch.int32)
    ex = segment_scan(mask.to(torch.int8), offsets, exclusive=True, method=method,
                      tile_s=tile_s, block_tiles=block_tiles)
    counts = _segment_ends(ex + m32, offsets)
    seg_count = counts.index_select(0, ids)
    pos_in_seg = torch.arange(n, dtype=torch.int32, device=values.device) - seg_start
    dest = seg_start + torch.where(mask.to(torch.bool), ex, seg_count + pos_in_seg - ex)
    z = torch.zeros_like(values).scatter_(0, dest.to(torch.int64), values)
    keep = pos_in_seg < seg_count
    z = torch.where(keep, z, torch.tensor(fill_value, dtype=z.dtype, device=z.device))
    return z, counts


def segment_compress(values, mask, offsets=None, *, method: str = "auto",
                     fill_value=0, tile_s: int = 128,
                     block_tiles: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment masked select: within each segment, kept elements pack left.

    Args:
        values: Packed payload ``(n,)`` or a :class:`SegmentedBatch`.
        mask: Boolean ``(n,)``; true elements pack to their segment's front.
        offsets: CSR offsets (unless ``values`` is a batch).
        method: ``"auto"`` or one of ``METHODS``.
        fill_value: Fill for every segment's dropped tail.
        tile_s: Tile side for the mask scans.
        block_tiles: Tiles per block for ``method="blocked"``.

    Returns:
        ``(packed, counts)``: ``packed`` shaped like ``values``, each segment's
        kept elements first and its tail filled; ``counts`` int32 per segment.

    Example:
        >>> z, c = segment_compress(torch.tensor([1, 2, 3, 4, 5]),
        ...                         torch.tensor([False, True, True, False, True]),
        ...                         [0, 2, 5], method="vector")
        >>> z.tolist(), c.tolist()
        ([2, 0, 3, 5, 0], [1, 2])
    """
    values, offsets = _unwrap(values, offsets, op="segment_compress")
    guards.validate_same_shape(values.shape, mask.shape, op="segment_compress",
                               a_name="values", b_name="mask")
    method = maybe_resolve(method, "segment_compress", values.shape[-1], values.dtype,
                           device=values.device)
    return dispatch("segment_compress", method)(
        values, mask, offsets, method=method, fill_value=fill_value, tile_s=tile_s,
        block_tiles=block_tiles)


# ---------------------------------------------------------------------------
# segment_sort / segment_topk — per-segment radix passes, one packed pass set
# ---------------------------------------------------------------------------


def _segment_multi_split_dest(digits, num_buckets, offsets, ids, seg_start, *,
                              method, tile_s, block_tiles):
    """Destinations for a stable in-segment ``num_buckets``-way split.

    All ``R`` bucket mask scans run as one batched segmented int8 -> int32
    scan (a leading bucket axis, shared offsets); each (segment, bucket) base
    is an ``R``-wide exclusive prefix of the per-segment bucket counts.
    """
    d = digits.to(torch.int64)
    buckets = torch.arange(num_buckets, device=digits.device)
    oh = (d[None, :] == buckets[:, None]).to(torch.int8)                 # (R, n)
    ex = segment_scan(oh, offsets, exclusive=True, method=method, tile_s=tile_s,
                      block_tiles=block_tiles)
    counts = _segment_ends(ex + oh.to(torch.int32), offsets)             # (R, S)
    base = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts       # R-wide scan
    ex_el = torch.gather(ex, 0, d[None, :])[0]
    dest = seg_start + base[d, ids] + ex_el
    return dest, counts


def segment_sort(values, offsets=None, *, descending: bool = False,
                 method: str = "auto", bits_per_pass: int = 4,
                 return_indices: bool = True, tile_s: int = 128, block_tiles: int = 8):
    """Stable per-segment radix sort of a packed batch, one pass set for all.

    Each pass is a stable in-segment ``2^bits_per_pass``-way split, so no
    element leaves its segment: bit-identical to :func:`radix_sort` on each
    segment, for every ``method``.

    Returns:
        ``(sorted_values, indices)`` (or the values alone): ``indices`` are int32
        positions in the *packed* array.

    Example:
        >>> v, i = segment_sort(torch.tensor([3, 1, 9, 2, 5], dtype=torch.int32),
        ...                     [0, 2, 5], method="vector")
        >>> v.tolist(), i.tolist()
        ([1, 3, 2, 5, 9], [1, 0, 3, 4, 2])
    """
    bits_per_pass = guards.validate_bits_per_pass(bits_per_pass, op="segment_sort")
    values, offsets = _unwrap(values, offsets, op="segment_sort")
    if values.dim() != 1:
        raise ValueError("segment_sort expects 1-D packed values")
    n = values.shape[-1]
    method = maybe_resolve(method, "segment_sort", n, values.dtype, device=values.device)
    enc, bits, decode = _encode_for_sort(values)
    if descending:
        enc = ~enc
    ids = segment_ids(offsets, n).to(torch.int64)
    seg_start = offsets.index_select(0, ids)
    perm = torch.arange(n, dtype=torch.int32, device=values.device)
    for shift in range(0, bits, bits_per_pass):
        k = min(bits_per_pass, bits - shift)
        digits = (enc >> shift) & ((1 << k) - 1)
        dest, _ = _segment_multi_split_dest(digits, 1 << k, offsets, ids, seg_start,
                                            method=method, tile_s=tile_s,
                                            block_tiles=block_tiles)
        dest = dest.to(torch.int64)
        enc = torch.empty_like(enc).scatter_(0, dest, enc)
        perm = torch.empty_like(perm).scatter_(0, dest, perm)
    if descending:
        enc = ~enc
    sorted_values = decode(enc)
    if return_indices:
        return sorted_values, perm
    return sorted_values


def segment_topk(values, offsets=None, k: int = 1, *, method: str = "auto",
                 bits_per_pass: int = 4, fill_value=0, tile_s: int = 128,
                 block_tiles: int = 8):
    """Per-segment top-k via one descending segmented sort.

    Returns:
        ``(values, indices, counts)``: ``(S, k)`` values filled past
        ``counts``, ``(S, k)`` int32 *segment-local* indices (-1 past
        ``counts``) and ``(S,)`` int32 ``counts = min(length, k)``.

    Example:
        >>> v, i, c = segment_topk(torch.tensor([3, 1, 9, 2, 5], dtype=torch.int32),
        ...                        [0, 2, 5], k=2, method="vector")
        >>> v.tolist(), i.tolist(), c.tolist()
        ([[3, 1], [9, 5]], [[0, 1], [0, 2]], [2, 2])
    """
    values, offsets = _unwrap(values, offsets, op="segment_topk")
    n = values.shape[-1]
    num_segments = offsets.shape[0] - 1
    dev = values.device
    if n == 0:  # all segments empty: nothing to rank
        return (torch.full((num_segments, k), fill_value, dtype=values.dtype, device=dev),
                torch.full((num_segments, k), -1, dtype=torch.int32, device=dev),
                torch.zeros((num_segments,), dtype=torch.int32, device=dev))
    sv, sperm = segment_sort(values, offsets, descending=True, method=method,
                             bits_per_pass=bits_per_pass, tile_s=tile_s,
                             block_tiles=block_tiles)
    lens = offsets[1:] - offsets[:-1]
    counts = torch.clamp(lens, max=k).to(torch.int32)
    col = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
    valid = col < counts[:, None]
    src = torch.clamp(offsets[:-1, None] + col, 0, n - 1).to(torch.int64)
    vals = torch.where(valid, sv[src], torch.tensor(fill_value, dtype=sv.dtype, device=dev))
    idx = torch.where(valid, sperm[src] - offsets[:-1, None], -1)
    return vals, idx.to(torch.int32), counts


# ---------------------------------------------------------------------------
# segment_softmax / segment_top_p_sample — the ragged decode sampler
# ---------------------------------------------------------------------------


def _segment_reduce(x: torch.Tensor, ids: torch.Tensor, num_segments: int, how: str,
                    init) -> torch.Tensor:
    out = torch.full((num_segments,), init, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, ids, x, how, include_self=True)


def segment_softmax(values, offsets=None, *, method: str = "auto", tile_s: int = 128,
                    block_tiles: int = 8) -> torch.Tensor:
    """Per-segment softmax of packed logits, in fp32.

    The max subtraction uses the exact per-segment max; the normaliser is the
    per-segment total of the exponentials, read off the segmented scan.

    Example:
        >>> p = segment_softmax(torch.zeros(4), [0, 1, 4], method="vector")
        >>> [round(float(v), 4) for v in p]
        [1.0, 0.3333, 0.3333, 0.3333]
    """
    values, offsets = _unwrap(values, offsets, op="segment_softmax")
    n = values.shape[-1]
    x = values.to(torch.float32)
    ids = segment_ids(offsets, n).to(torch.int64)
    m = _segment_reduce(x, ids, offsets.shape[0] - 1, "amax", float("-inf"))
    e = torch.exp(x - m[ids])
    denom = segment_sums(e, offsets, method=method, tile_s=tile_s, block_tiles=block_tiles)
    return e / denom[ids]


def _segment_greedy(values, offsets, n: int, num_segments: int) -> torch.Tensor:
    """Per-segment argmax as a segment-local id: NaN counts as ``-inf``, ties go low."""
    x = values.to(torch.float32)
    x = torch.where(torch.isnan(x), float("-inf"), x)
    ids = segment_ids(offsets, n).to(torch.int64)
    m = _segment_reduce(x, ids, num_segments, "amax", float("-inf"))
    iota = torch.arange(n, dtype=torch.int64, device=x.device)
    cand = torch.where(x == m[ids], iota, n)
    first = _segment_reduce(cand, ids, num_segments, "amin", n)
    return torch.clamp(first - offsets[:-1], min=0).to(torch.int32)


def _reject_poisoned_packed_logits(values, offsets, n: int, num_segments: int) -> None:
    """The packed ``nonfinite="raise"`` gate of :func:`segment_top_p_sample`.

    ``-inf`` entries are legal vocabulary masks; NaN, ``+inf`` and a non-empty
    segment with no finite entry are rejected, with one host read.
    """
    v = values.to(torch.float32)
    ids = segment_ids(offsets, n).to(torch.int64)
    has_finite = _segment_reduce(torch.isfinite(v).to(torch.int32), ids, num_segments,
                                 "amax", 0)
    lens = offsets[1:] - offsets[:-1]
    bad = (torch.isnan(v).any() | torch.isposinf(v).any()
           | ((has_finite == 0) & (lens > 0)).any())
    if bool(bad):
        raise guards.NonFiniteError(
            "segment_top_p_sample: poisoned logits under nonfinite='raise' — NaN, "
            "+inf, or a segment with no finite entry (-inf vocab masks are allowed)")


def segment_top_p_sample(values, offsets=None, generator: Optional[torch.Generator] = None,
                         p: float = 0.9, temperature: float = 1.0, *,
                         method: str = "auto", bits_per_pass: int = 4,
                         is_probs: bool = False, u: Optional[torch.Tensor] = None,
                         tile_s: int = 128, block_tiles: int = 8,
                         nonfinite: str = "propagate") -> torch.Tensor:
    """Nucleus-sample every segment of a packed ragged batch.

    The packed analogue of :func:`repro_torch.core.primitives.top_p_sample`:
    a per-segment softmax, a descending segmented radix sort on bf16 keys,
    the segmented prefix sum of the sorted probabilities, the llama3 cut, and
    a per-segment inverse-transform sample.  Every scan runs on the segmented
    scan of ``method``: eight per call (the softmax's normaliser, one per
    radix pass of the 16-bit keys at ``bits_per_pass=4``, then ``cum``,
    ``cdf`` and the count below ``theta``).

    Args:
        values: Packed logits ``(n,)`` or a :class:`SegmentedBatch`.
        offsets: CSR offsets (unless ``values`` is a batch).
        generator: Source of the ``(num_segments, 1)`` uniforms when ``u`` is
            not given.
        p: Nucleus mass in ``[0, 1]``.
        temperature: Logit divisor; ``0`` is the greedy limit (per-segment
            argmax, ties low, no uniform drawn).
        method: ``"auto"`` or one of ``METHODS`` for every scan.
        bits_per_pass: Bits per radix pass of the key sort.
        is_probs: ``values`` are already per-segment probabilities.
        u: Optional ``(num_segments, 1)`` uniforms.
        tile_s: Tile side for the mask scans.
        block_tiles: Tiles per block for ``method="blocked"``.
        nonfinite: Non-finite logits policy (:mod:`repro_torch.core.guards`):
            ``"raise"`` rejects NaN, ``+inf`` and fully masked segments (``-inf``
            vocab masks stay legal); ``"sanitize"`` gives each segment that
            holds a non-finite probability its greedy token (NaN read as
            ``-inf``, ties low).

    Returns:
        ``(num_segments,)`` int32 segment-local token ids (0 for empty segments).

    Raises:
        NonFiniteError: ``nonfinite="raise"`` and poisoned logits.

    Example:
        >>> logits = torch.tensor([0.0, 20.0, 0.0, 0.0, 20.0])
        >>> segment_top_p_sample(logits, [0, 3, 5], u=torch.tensor([[0.3], [0.7]]),
        ...                      method="vector").tolist()
        [1, 1]
    """
    values, offsets = _unwrap(values, offsets, op="segment_top_p_sample")
    guards.validate_probability(p, op="segment_top_p_sample")
    guards.validate_temperature(temperature, op="segment_top_p_sample")
    nonfinite = guards.resolve_nonfinite(nonfinite, op="segment_top_p_sample")
    n = values.shape[-1]
    num_segments = offsets.shape[0] - 1
    dev = values.device
    if n == 0:  # all segments empty: the documented 0 per segment
        return torch.zeros((num_segments,), dtype=torch.int32, device=dev)
    lens = offsets[1:] - offsets[:-1]
    if not is_probs and float(temperature) == 0.0:
        greedy = _segment_greedy(values, offsets, n, num_segments)
        return torch.where(lens > 0, greedy, 0).to(torch.int32)
    method = maybe_resolve(method, "segment_top_p_sample", n, values.dtype, device=dev)
    kw = dict(method=method, tile_s=tile_s, block_tiles=block_tiles)
    if nonfinite == "raise":
        _reject_poisoned_packed_logits(values, offsets, n, num_segments)
    if is_probs:
        probs = values.to(torch.float32)
    else:
        v = values if temperature == 1.0 else values / temperature
        probs = segment_softmax(v, offsets, **kw)
    _, order = segment_sort(probs.to(torch.bfloat16), offsets, descending=True,
                            bits_per_pass=bits_per_pass, **kw)
    sorted_p = probs[order.to(torch.int64)]
    cum = segment_scan(sorted_p, offsets, **kw)
    cut = (cum - sorted_p) > p                    # llama3's sample_top_p formula
    masked = torch.where(cut, torch.zeros((), device=dev), sorted_p)
    cdf = segment_scan(masked, offsets, **kw)
    totals = _segment_ends(cdf, offsets)
    if u is None:
        u = torch.rand((num_segments, 1), generator=generator, device=dev,
                       dtype=torch.float32)
    theta = u[..., 0].to(device=dev, dtype=cdf.dtype) * totals
    ids = segment_ids(offsets, n).to(torch.int64)
    less = (cdf < theta[ids]).to(torch.int32)
    cnt = _segment_ends(segment_scan(less, offsets, **kw), offsets)
    j = torch.minimum(torch.clamp(cnt, min=0), torch.clamp(lens - 1, min=0))
    pos = torch.clamp(offsets[:-1] + j, 0, n - 1).to(torch.int64)
    tok = torch.where(lens > 0, order[pos] - offsets[:-1], 0).to(torch.int32)
    if nonfinite == "sanitize":
        bad = _segment_reduce((~torch.isfinite(probs)).to(torch.int32), ids, num_segments,
                              "amax", 0) > 0
        greedy = _segment_greedy(values, offsets, n, num_segments)
        tok = torch.where(bad & (lens > 0), greedy, tok)
    return tok

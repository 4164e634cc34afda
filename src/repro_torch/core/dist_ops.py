"""Distributed operator family — paper §4's two-level algorithm for every op.

Port of ``repro/core/dist_ops.py`` on ``torch.distributed``.  JAX runs each
operator under ``shard_map`` over a mesh axis; the port runs one process per
rank (SPMD): every function takes the calling rank's shard of the last axis,
the global length ``n`` and the process group of that axis
(``repro_torch.core.comm``), and returns the rank's shard of the result.  With
``D`` ranks, rank ``d`` holds global positions ``[d·L, min((d+1)·L, n))``,
``L = ceil(n / D)``; each rank pads its shard to ``L`` as the JAX package pads
the global axis to a multiple of ``D`` (the maximum key for sorts, ``a = 1,
b = 0`` for recurrences, zeros with the last segment extended for segmented
scans, ``-inf`` for top-p), so no rank ever holds more than its shard plus the
``O(D·R)`` summaries.  :func:`~repro_torch.core.comm.shard_last` and
:func:`~repro_torch.core.comm.gather_last` cut a global tensor into shards and
join them again.

* **distributed radix sort** (:func:`dist_radix_sort`): each pass groups the
  shard by its digit locally (phase 1: B7h with ``method="kernel"``, which
  exports the shard's histogram from the same launch), ``all_gather`` s the
  ``(D, R)`` histograms and turns them into global bucket bases (phase 2),
  then sends every element once to the rank that owns its globally sorted
  slot with one ``all_to_all`` (phase 3).
* **sharded-vocab top-p sampling** (:func:`dist_top_p_sample`): softmax over
  the vocab shard with two scalar all-reduces, the distributed sort on bf16
  keys with token ids and probabilities riding the exchange, per-shard prefix
  mass via :func:`~repro_torch.core.distributed.mcscan_local`, and a ``D``-sized
  ``all_gather`` of shard thresholds plus two all-reduces for the sample.
* **linear recurrence** (:func:`dist_linear_scan`) and **segmented scan**
  (:func:`dist_segment_scan`): each shard is an affine map; the ``(A, B)``
  pairs travel in one small ``all_gather`` and fold into per-shard carries.

The exchange.  JAX's ``all_to_all`` is static-shape, so each shard builds a
dense ``(D, C, n_local)`` buffer and the receivers sum over sources as a
select: it sends ``D`` times the data.  The port sends each element once with
``all_to_all_single``: every rank knows every shard's histogram after the
``all_gather``, hence where each run of a bucket lands, so the split sizes and
each received element's slot follow without a further collective.  The
per-pass collectives stay one ``all_gather`` and one ``all_to_all``; the bytes
are in :func:`repro_torch.analysis.collectives.modeled_dist_traffic`.

Parity: every operator equals its single-device sibling in
:mod:`~repro_torch.core.primitives` / :mod:`~repro_torch.core.linrec` /
:mod:`~repro_torch.core.segmented` on the gathered input — bit-equal for
sorts, top-k, integer recurrences and segmented scans, on every method —
except the float paths where the sharded reductions associate differently:
fp32 recurrences (within rounding) and the top-p sampler, whose tokens match
the JAX package's ``dist_top_p_sample`` under the same uniforms.  On a group
of one rank every entry point is its local sibling.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import comm, guards
from repro_torch.core.autotune import maybe_resolve
from repro_torch.core.distributed import mcscan_local
from repro_torch.core.linrec import cumprod, linear_scan, linrec_accum_dtype_for
from repro_torch.core.precision import resolve_precision
from repro_torch.core.primitives import (_encode_for_sort, _multi_split_dest,
                                         _scatter_payloads, _take_along_last, _uniforms,
                                         radix_sort, top_p_sample)
from repro_torch.core.segmented import segment_scan

__all__ = ["dist_radix_sort", "dist_sort", "dist_topk", "dist_top_p_sample",
           "dist_linear_scan", "dist_segment_scan"]


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------


def _layout(shard: torch.Tensor, n: int, group, *, op: str) -> Tuple[int, int, int, int]:
    """``(D, me, L, real)`` of this rank's shard of a global length ``n``.

    Raises:
        ValueError: The shard's length is not this rank's share of ``n``.
    """
    if n < 1:
        raise ValueError(f"{op}: the global length n must be >= 1, got {n}")
    d, me = comm.axis_size(group), comm.axis_index(group)
    L = comm.shard_len(n, d)
    real = max(0, min(L, n - me * L))
    if shard.shape[-1] != real:
        raise ValueError(f"{op}: rank {me} of {d} holds global positions "
                         f"[{me * L}, {me * L + real}) of n = {n}, a shard of {real}; "
                         f"got a last axis of {shard.shape[-1]}")
    return d, me, L, real


def _pad_last(x: torch.Tensor, length: int, fill) -> torch.Tensor:
    """Pad the last axis of ``x`` up to ``length`` with ``fill``."""
    pad = length - x.shape[-1]
    if pad <= 0:
        return x
    return torch.cat([x, torch.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype,
                                    device=x.device)], dim=-1)


def _widen(enc: torch.Tensor) -> torch.Tensor:
    """Raw-word sort keys as int32 bit patterns, zero-extended (JAX's uint32)."""
    if enc.dtype == torch.int16:
        return enc.to(torch.int32) & 0xFFFF
    return enc.to(torch.int32)


# ---------------------------------------------------------------------------
# the bucket exchange (phases 2 and 3 of the distributed radix pass)
# ---------------------------------------------------------------------------


def _global_dest(c_all: torch.Tensor) -> torch.Tensor:
    """Global slot of the first element of each run: shard ``s``'s keys of bucket ``b``.

    The paper's phase-2 carry scan generalized to per-shard bases: the global
    bucket bases are the exclusive scan of the bucket totals, and shard ``s``'s
    run of a bucket follows the runs of the shards before it (the masked
    matvec of :func:`~repro_torch.core.distributed.mcscan_local`).

    Args:
        c_all: int64 ``(D, B, R)`` histograms of every shard's rows.

    Returns:
        int64 ``(D, B, R)`` first global slots; shard ``s``'s elements of bucket
        ``b`` in row ``r`` take the next ``c_all[s, r, b]`` slots, so over all
        shards the slots are a permutation of ``0 .. D·L - 1``.
    """
    totals = c_all.sum(dim=0)                                   # (B, R)
    gbase = torch.cumsum(totals, dim=-1) - totals
    return gbase[None] + torch.cumsum(c_all, dim=0) - c_all


def _runs_index(starts: torch.Tensor, lens: torch.Tensor, total: int,
                device) -> torch.Tensor:
    """Concatenated ``range(start, start + len)`` of every run, in order."""
    starts, lens = starts.to(device), lens.to(device)
    shift = starts - (torch.cumsum(lens, dim=0) - lens)
    return (torch.repeat_interleave(shift, lens, output_size=total)
            + torch.arange(total, device=device))


def _exchange(grouped: Sequence[torch.Tensor], counts: torch.Tensor,
              group) -> Tuple[torch.Tensor, ...]:
    """Send every locally grouped element to its global slot: one ``all_gather``
    of the histograms and one ``all_to_all`` of the packed channels.

    Args:
        grouped: int32 ``(B, L)`` channels, grouped by bucket (stably).
        counts: int32 ``(B, R)`` local histogram of the grouping.
        group: Process group of the sorted axis.

    Returns:
        The channels after the pass: this rank holds global slots
        ``[me·L, (me+1)·L)`` of every row.
    """
    d, me = comm.axis_size(group), comm.axis_index(group)
    b, L = grouped[0].shape
    dev = grouped[0].device
    c_all = comm.all_gather(counts, group).cpu().to(torch.int64)      # (D, B, R)
    lo = _global_dest(c_all)                                           # (D, B, R)
    hi = lo + c_all
    win = torch.arange(d, dtype=torch.int64) * L                       # rank windows
    clo = torch.clamp(lo[..., None], win, win + L)                     # (D, B, R, D)
    seg = torch.clamp(hi[..., None], win, win + L) - clo
    # sender: my runs cut at the rank windows, in (destination, row, bucket) order
    lbase = torch.cumsum(c_all[me], dim=-1) - c_all[me]                # (B, R)
    rows = torch.arange(b, dtype=torch.int64)[:, None] * L
    src = (rows + lbase)[..., None] + clo[me] - lo[me][..., None]      # (B, R, D)
    send_splits = seg[me].sum(dim=(0, 1)).tolist()
    send_idx = _runs_index(src.permute(2, 0, 1).reshape(-1),
                           seg[me].permute(2, 0, 1).reshape(-1), b * L, dev)
    # receiver: every shard's runs inside my window, in (source, row, bucket) order
    dst = (rows[None] + clo[..., me] - me * L).reshape(-1)             # (D·B·R,)
    recv_lens = seg[..., me]
    recv_splits = recv_lens.sum(dim=(1, 2)).tolist()
    recv_idx = _runs_index(dst, recv_lens.reshape(-1), b * L, dev)
    packed = torch.stack([c.reshape(-1) for c in grouped], dim=-1)     # (B·L, C)
    got = comm.all_to_all(packed[send_idx], send_splits, recv_splits, group)
    out = torch.empty_like(packed)
    out[recv_idx] = got
    return tuple(out[:, i].reshape(b, L) for i in range(out.shape[-1]))


def _local_group(channels: Sequence[torch.Tensor], digits: torch.Tensor, radix: int, *,
                 shift: int, pass_bits: int, method: str, tile_s: int):
    """Stable local radix-2^k grouping of the pass channels, with histogram.

    ``method="kernel"`` runs the (keys, perm) channels through B7h, whose
    histogram comes out of the same launch, and any extra channel through B6;
    the other methods share one :func:`~repro_torch.core.primitives._multi_split_dest`
    mask scan for every channel, as the single-device sort pass does.

    Returns:
        ``(grouped_channels, counts)`` with ``counts`` int32 ``(B, R)``.
    """
    if method == "kernel":
        from repro_torch.kernels.split_mm import multi_split_tiles, radix_pass_multibit
        wo, po, counts = radix_pass_multibit(channels[0], channels[1], shift=shift,
                                             pass_bits=pass_bits, with_counts=True)
        extra = [multi_split_tiles(c, digits, num_buckets=radix)[0] for c in channels[2:]]
        return (wo, po, *extra), counts
    dest, counts = _multi_split_dest(digits, radix, method=method, tile_s=tile_s)
    return _scatter_payloads(tuple(channels), dest, with_indices=False), counts


def _dist_radix_passes(channels: Tuple[torch.Tensor, ...], bits: int, group, *,
                       method: str, tile_s: int, bits_per_pass: int):
    """Run every distributed radix pass; ``channels[0]`` holds the work keys.

    Per pass: the local stable split (phase 1), the histogram ``all_gather``
    and global bucket bases (phase 2), one ``all_to_all`` (phase 3).  Keys are
    int32 bit patterns of the widened encoding (only the low ``bits`` are
    read; ``>>`` sign-extends, so the digit is masked after the shift), and any
    descending complement is already applied.
    """
    for shift in range(0, bits, bits_per_pass):
        k = min(bits_per_pass, bits - shift)
        radix = 1 << k
        digits = (channels[0] >> shift) & (radix - 1)
        grouped, counts = _local_group(channels, digits, radix, shift=shift, pass_bits=k,
                                       method=method, tile_s=tile_s)
        channels = _exchange(grouped, counts, group)
    return channels


# ---------------------------------------------------------------------------
# distributed sort / top-k
# ---------------------------------------------------------------------------


def dist_radix_sort(x: torch.Tensor, n: int, group=None, *, descending: bool = False,
                    method: str = "auto", return_indices: bool = True,
                    tile_s: int = 128, bits_per_pass: int = 4):
    """Stable LSB radix sort with the keys sharded over the ranks of ``group``.

    The paper's scan-based radix sort (§5) lifted to the two-level §4
    structure: each of the ``ceil(bits / bits_per_pass)`` passes groups the
    shard locally, gathers the ``(D, R)`` histograms, and sends every (key,
    index) pair once to the rank of its global slot.  Bit-equal to
    :func:`repro_torch.core.primitives.radix_sort` on the gathered input for
    every ``method``: offsets are exact integer counts, and the shard-major
    order of the exchange keeps ties in arrival order.

    Args:
        x: This rank's shard ``(..., real)`` of the global keys (dtypes as in
            ``radix_sort``); ``real`` is this rank's share of ``n``.
        n: Global length of the sorted axis.
        group: Process group of the sorted axis; one rank sorts locally.
        descending: Sort high to low (the complemented encoding keeps it stable).
        method: One of ``METHODS`` (``"auto"`` resolves on the shard length);
            ``"kernel"`` runs each pass as one B7h launch.
        return_indices: If false, return only the sorted values.
        tile_s: Tile side ``s`` for the local mask scans.
        bits_per_pass: Bits retired per radix pass (``1..8``).

    Returns:
        This rank's shard of ``(values, permutation)`` — or of ``values`` — of
        the global sort; the permutation holds global int32 indices.
    """
    bits_per_pass = guards.validate_bits_per_pass(bits_per_pass, op="dist_radix_sort")
    d, me, L, real = _layout(x, n, group, op="dist_radix_sort")
    if d == 1:
        return radix_sort(x, descending=descending, method=method,
                          return_indices=return_indices, tile_s=tile_s,
                          bits_per_pass=bits_per_pass)
    enc, bits, decode = _encode_for_sort(x)
    if descending:
        enc = ~enc
    # the all-ones pad key stays at the global end of every pass (stability:
    # real maximum-key ties precede it)
    work = _pad_last(_widen(enc), L, -1)
    method = maybe_resolve(method, "dist_sort", L, x.dtype, device=x.device)
    lead = work.shape[:-1]
    w = work.reshape(-1, L).contiguous()
    gperm = (me * L + torch.arange(L, dtype=torch.int32, device=x.device)).expand(
        w.shape).contiguous()
    w, gperm = _dist_radix_passes((w, gperm), bits, group, method=method, tile_s=tile_s,
                                  bits_per_pass=min(bits_per_pass, bits))
    w = w[:, :real].reshape(*lead, real).to(enc.dtype)
    gperm = gperm[:, :real].reshape(*lead, real)
    if descending:
        w = ~w
    values = decode(w)
    return (values, gperm) if return_indices else values


def dist_sort(x: torch.Tensor, n: int, group=None, *, descending: bool = False,
              method: str = "auto", tile_s: int = 128, bits_per_pass: int = 4):
    """Sharded ``sort``: this rank's shard of ``(values, indices)``.

    Thin wrapper over :func:`dist_radix_sort`, as ``primitives.sort`` is over
    ``radix_sort``.
    """
    return dist_radix_sort(x, n, group, descending=descending, method=method,
                           return_indices=True, tile_s=tile_s, bits_per_pass=bits_per_pass)


def dist_topk(x: torch.Tensor, k: int, n: int, group=None, *, method: str = "auto",
              tile_s: int = 128, bits_per_pass: int = 4):
    """Top-k of a sharded axis via the distributed descending radix sort.

    As ``primitives.topk``, the whole descending order is computed (the
    paper's §5 form) and its leading ``k`` columns kept.  They stay in the
    sort's layout: rank ``d`` returns global columns ``[d·L, min((d+1)·L, k))``
    with ``L = ceil(n / D)``, so ``gather_last(values, k, group, length=L)``
    joins them.

    Returns:
        This rank's part of ``(values, indices)`` of the top ``k``.
    """
    values, idx = dist_radix_sort(x, n, group, descending=True, method=method,
                                  tile_s=tile_s, bits_per_pass=bits_per_pass)
    d, me = comm.axis_size(group), comm.axis_index(group)
    keep = max(0, min(values.shape[-1], k - me * comm.shard_len(n, d)))
    return values[..., :keep], idx[..., :keep]


# ---------------------------------------------------------------------------
# the affine carry fold (phase 2 of linrec / segmented)
# ---------------------------------------------------------------------------


def _affine_carry(A: torch.Tensor, B: torch.Tensor, group, s0) -> torch.Tensor:
    """Exclusive fold of per-shard affine maps — one small ``all_gather``.

    Shard ``d`` summarizes its chunk as ``x -> A_d * x + B_d``; the carry into
    this rank is the composition of every earlier shard applied to ``s0``.
    The ``(A, B)`` pairs are stacked so that one ``all_gather`` of ``2·D``
    scalars a row carries phase 2.

    Args:
        A: Local slope ``(..., 1)`` in the accumulation dtype.
        B: Local offset ``(..., 1)``, same dtype.
        group: Process group of the shards.
        s0: Scalar initial carry.

    Returns:
        The carry into this rank's shard, ``(..., 1)``.
    """
    g = comm.all_gather(torch.cat([A.expand_as(B), B], dim=-1), group)   # (D, ..., 2)
    s = torch.full_like(B, s0)
    for d in range(comm.axis_index(group)):
        s = g[d, ..., 0:1] * s + g[d, ..., 1:2]
    return s


# ---------------------------------------------------------------------------
# distributed linear recurrence
# ---------------------------------------------------------------------------


def dist_linear_scan(a: torch.Tensor, b: torch.Tensor, n: int, group=None, *,
                     exclusive: bool = False, initial=None, method: str = "auto",
                     precision: str = "highest", tile_s: int = 128, block_tiles: int = 8,
                     accum_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """First-order linear recurrence ``y_t = a_t * y_{t-1} + b_t``, scanned axis sharded.

    Each rank runs the local :func:`~repro_torch.core.linrec.linear_scan` (phase
    1) while its affine summary ``(A, B) = (prod a, trailing b-sum)`` is
    computed independently of it — ``B`` from reversed suffix products, not
    from the local scan's last element — so the ``all_gather`` of the pairs
    does not wait for the local scan.  Phase 3 applies the folded carry through
    the local multiplier prefix.  Bit-equal to the single-device sibling for
    integer-valued inputs; for floats the carry associates differently.

    Args:
        a: This rank's shard ``(..., real)`` of the multipliers; broadcast
            against ``b``.
        b: This rank's shard of the addends.
        n: Global length of the scanned axis.
        group: Process group of the scanned axis; one rank runs locally.
        exclusive: Shift-by-one output, ``out[0] = initial``.
        initial: Scalar initial carry (``y_{-1}``); defaults to 0.
        method: One of ``METHODS`` for the local recurrence (``"kernel"``:
            B13; ``"blocked"``: B14–B16).
        precision: ``"highest"``, ``"compensated"`` or ``"fast"`` for the local
            recurrences, resolved once against the resolved method
            (``precision_override`` > ``REPRO_SCAN_PRECISION`` > this argument)
            and passed on.
        tile_s: Tile side ``s``.
        block_tiles: Tiles per block for ``method="blocked"``.
        accum_dtype: Accumulation dtype; defaults to ``linrec_accum_dtype_for``.

    Returns:
        This rank's shard of the recurrence, in the accumulation dtype.
    """
    a, b = torch.broadcast_tensors(a, b)
    d, me, L, real = _layout(a, n, group, op="dist_linear_scan")
    if d == 1:
        return linear_scan(a, b, exclusive=exclusive, initial=initial, method=method,
                           precision=precision, tile_s=tile_s, block_tiles=block_tiles,
                           accum_dtype=accum_dtype)
    a = _pad_last(a, L, 1)                      # identity tail: a = 1, b = 0
    b = _pad_last(b, L, 0)
    dtype = torch.result_type(a, b)
    acc = accum_dtype if accum_dtype is not None else linrec_accum_dtype_for(dtype)
    explicit_method = method != "auto"
    method = maybe_resolve(method, "dist_linear_scan", L, dtype, device=a.device)
    precision = resolve_precision(precision, method=method,
                                  explicit_method=explicit_method)
    s0 = 0 if initial is None else initial
    y = linear_scan(a, b, exclusive=exclusive, method=method, precision=precision,
                    tile_s=tile_s, block_tiles=block_tiles, accum_dtype=acc)
    p = cumprod(a, method=method, precision=precision, tile_s=tile_s,
                block_tiles=block_tiles, accum_dtype=acc)
    # phase 1, "vector units": B from reversed suffix products, independent of y
    q = torch.flip(torch.cumprod(torch.flip(a.to(acc), dims=(-1,)), dim=-1), dims=(-1,))
    q_excl = torch.cat([q[..., 1:], torch.ones_like(q[..., :1])], dim=-1)
    B = torch.sum(b.to(acc) * q_excl, dim=-1, keepdim=True)
    s = _affine_carry(p[..., -1:], B, group, s0)
    mult = torch.cat([torch.ones_like(p[..., :1]), p[..., :-1]], dim=-1) if exclusive else p
    return (y + s * mult)[..., :real]


# ---------------------------------------------------------------------------
# distributed segmented scan
# ---------------------------------------------------------------------------


def dist_segment_scan(values: torch.Tensor, offsets, n: int, group=None, *,
                      exclusive: bool = False, method: str = "auto", tile_s: int = 128,
                      block_tiles: int = 8, accum_dtype: Optional[torch.dtype] = None,
                      precision: str = "highest") -> torch.Tensor:
    """Segmented prefix sum with the flattened value axis sharded.

    Each rank clips the global CSR ``offsets`` into its own window (always a
    valid local CSR) and runs the local
    :func:`~repro_torch.core.segmented.segment_scan` (phase 1).  The carry pair
    is the degenerate affine map with ``A = [no boundary inside the shard]``
    and ``B`` the shard's trailing inclusive sum, so the folded carry (phase
    2, one ``all_gather``) is exactly the sum flowing into the shard's leading
    open segment; phase 3 adds it before the first boundary.  Bit-equal to
    the single-device sibling on the gathered input.

    Args:
        values: This rank's shard ``(..., real)`` of the flattened values.
        offsets: Global CSR segment starts ``(num_segments + 1,)`` with
            ``offsets[0] == 0`` and ``offsets[-1] == n``, the same on every rank.
        n: Global length of the value axis.
        group: Process group of the value axis; one rank runs locally.
        exclusive: Per-segment exclusive scan.
        method: One of ``METHODS`` for the local segmented scan (``"kernel"``:
            B9; ``"blocked"``: B10–B12).
        tile_s: Tile side ``s``.
        block_tiles: Tiles per block for ``method="blocked"``.
        accum_dtype: Accumulation dtype override.
        precision: ``"highest"``, ``"compensated"`` or ``"fast"`` for the local
            segmented scan, resolved once against the resolved method and
            passed on.

    Returns:
        This rank's shard of the per-segment scan, in the accumulation dtype.
    """
    offsets = torch.as_tensor(offsets, device=values.device).to(torch.int32)
    offsets = guards.validate_offsets(offsets, n, op="dist_segment_scan")
    d, me, L, real = _layout(values, n, group, op="dist_segment_scan")
    if d == 1:
        return segment_scan(values, offsets, exclusive=exclusive, method=method,
                            tile_s=tile_s, block_tiles=block_tiles,
                            accum_dtype=accum_dtype, precision=precision)
    values = _pad_last(values, L, 0)
    if d * L != n:
        # extend the last segment over the zero tail (the real positions'
        # prefixes are unchanged; the tail is cut off)
        offsets = offsets.clone()
        offsets[-1] = d * L
    explicit_method = method != "auto"
    method = maybe_resolve(method, "dist_segment_scan", L, values.dtype,
                           device=values.device)
    precision = resolve_precision(precision, method=method,
                                  explicit_method=explicit_method)
    start = me * L
    y = segment_scan(values, torch.clamp(offsets - start, 0, L), exclusive=exclusive,
                     method=method, tile_s=tile_s, block_tiles=block_tiles,
                     accum_dtype=accum_dtype, precision=precision)
    acc = y.dtype
    pos = offsets[:-1] - start                          # segment starts, local
    first = torch.where((pos >= 0) & (pos < L), pos, L).min()
    A = (first == L).to(acc).expand(y.shape[:-1] + (1,))
    tail = y[..., -1:] + values[..., -1:].to(acc) if exclusive else y[..., -1:]
    s = _affine_carry(A, tail, group, 0)
    gate = (torch.arange(L, device=values.device) < first).to(acc)
    return (y + s * gate)[..., :real]


# ---------------------------------------------------------------------------
# sharded-vocab nucleus sampling
# ---------------------------------------------------------------------------


def _dist_greedy(logits: torch.Tensor, n: int, group, start: int) -> torch.Tensor:
    """The first index of the global maximum (NaN read as ``-inf``): two all-reduces."""
    g = torch.where(torch.isnan(logits), float("-inf"), logits.to(torch.float32))
    g = _pad_last(g, 1, float("-inf"))                   # an empty shard bids -inf
    top = comm.all_reduce(g.max(dim=-1).values, "max", group)
    hit = g[..., :logits.shape[-1]] == top[..., None]
    first = start + torch.argmax(_pad_last(hit, 1, False).to(torch.int32), dim=-1)
    idx = torch.where(hit.any(dim=-1), first, n).to(torch.int32)
    return comm.all_reduce(idx, "min", group)


def _poisoned_rows(ll: torch.Tensor, group) -> torch.Tensor:
    """Per global row: (has a finite entry, holds NaN, holds ``+inf``), read over
    every shard with one all-reduce; ``(rows, 3)`` bool."""
    flags = torch.stack([torch.isfinite(ll).any(-1), torch.isnan(ll).any(-1),
                         torch.isposinf(ll).any(-1)], dim=-1).to(torch.int32)
    return comm.all_reduce(flags, "max", group) > 0


def dist_top_p_sample(logits: torch.Tensor, n: int, group=None, *,
                      generator: Optional[torch.Generator] = None, p: float = 0.9,
                      temperature: float = 1.0, method: str = "auto", tile_s: int = 128,
                      bits_per_pass: int = 4, u: Optional[torch.Tensor] = None,
                      nonfinite: str = "propagate") -> torch.Tensor:
    """Nucleus sampling with the vocabulary axis sharded over the ranks of ``group``.

    The paper's Llama3 sampling pipeline (§5/§6.5) without gathering the
    vocab: the softmax's maximum and normaliser are two all-reduces; the bf16
    sort keys, the token ids and the fp32 probabilities (as int32 bits) ride
    the distributed radix sort's exchange; the sorted prefix mass is two
    :func:`~repro_torch.core.distributed.mcscan_local` scans; the
    inverse-transform index is an ``all_gather`` of the shard thresholds (the
    nucleus mass is the last shard's CDF tail) plus an all-reduce rank count
    and an all-reduce gather of the one token.

    Parity: the sort is exact integer routing, but the sharded softmax and
    prefix mass associate differently from the single-device sampler, so a
    draw may land on another token only where ``u`` falls within a few ulp of
    a nucleus CDF boundary (as in the JAX package).

    Args:
        logits: This rank's shard ``(..., real)`` of the scores.
        n: The vocabulary size (global length).
        group: Process group of the vocab shards; one rank samples locally.
        generator: Source of the uniforms when ``u`` is not given; every rank
            must hold the same generator state.
        p: Nucleus mass in ``[0, 1]``.
        temperature: Logit divisor; ``0`` is the greedy limit (the first index
            of the global maximum, NaN read as ``-inf``).
        method: One of ``METHODS`` for the sort and the prefix-mass scans
            (``"kernel"``: B7h and B6 for each pass, B1 for each scan).
        tile_s: Tile side ``s``.
        bits_per_pass: Bits per radix pass over the 16 bf16 key bits.
        u: Optional uniforms ``logits.shape[:-1] + (1,)``, the same on every rank.
        nonfinite: Non-finite logit policy, as in ``top_p_sample``.  The rows'
            state is read over the shards with one all-reduce: ``"raise"``
            rejects NaN, ``+inf`` and fully masked rows on every rank alike;
            ``"sanitize"`` gives each row that holds NaN or no finite entry a
            one-hot at its greedy token inside the sharded body, and that token
            (two more all-reduces) after it.

    Returns:
        int32 token ids ``logits.shape[:-1]``, the same on every rank.

    Raises:
        NonFiniteError: ``nonfinite="raise"`` and poisoned logits on any rank.
    """
    guards.validate_probability(p, op="dist_top_p_sample")
    guards.validate_temperature(temperature, op="dist_top_p_sample")
    bits_per_pass = guards.validate_bits_per_pass(bits_per_pass, op="dist_top_p_sample")
    nonfinite = guards.resolve_nonfinite(nonfinite, op="dist_top_p_sample")
    d, me, L, real = _layout(logits, n, group, op="dist_top_p_sample")
    if d == 1:
        return top_p_sample(logits, generator, p=p, temperature=temperature, method=method,
                            sort_method="radix", tile_s=tile_s,
                            bits_per_pass=bits_per_pass, u=u, nonfinite=nonfinite)
    start = me * L
    lead = logits.shape[:-1]
    if float(temperature) == 0.0:
        return _dist_greedy(logits.reshape(math.prod(lead), real), n, group,
                            start).reshape(lead)
    if nonfinite == "raise":
        has = _poisoned_rows(logits.reshape(math.prod(lead), real).to(torch.float32),
                             group)
        if bool((has[:, 1] | has[:, 2] | ~has[:, 0]).any()):
            raise guards.NonFiniteError(
                "dist_top_p_sample: poisoned logits under nonfinite='raise' (NaN/+inf "
                "entries or a fully masked row)")
    if temperature != 1.0:
        logits = logits / temperature
    # -inf padding: zero probability, an exact normaliser, sorted last
    ll = _pad_last(logits.to(torch.float32), L, float("-inf")).reshape(-1, L)
    method = maybe_resolve(method, "dist_top_p_sample", L, torch.float32, device=ll.device)
    if u is None:
        u = _uniforms(lead + (1,), generator, ll.device)
    uu = u.reshape(-1, 1).to(device=ll.device, dtype=torch.float32)
    gidx = start + torch.arange(L, dtype=torch.int32, device=ll.device)
    if nonfinite == "sanitize":
        has = _poisoned_rows(ll, group)
        bad = has[:, 1] | ~has[:, 0]                     # NaN, or no finite entry
        greedy = _dist_greedy(logits.reshape(math.prod(lead), real), n, group, start)
    m = comm.all_reduce(torch.amax(ll, dim=-1, keepdim=True), "max", group)
    e = torch.exp(ll - m)
    probs = e / comm.all_reduce(torch.sum(e, dim=-1, keepdim=True), "sum", group)
    if nonfinite == "sanitize":
        onehot = (gidx == greedy[:, None]).to(probs.dtype)
        probs = torch.where(bad[:, None], onehot, probs)
    # 16 bf16 sort bits as in the paper's fp16 evaluation; descending
    keys16, _, _ = _encode_for_sort(probs.to(torch.bfloat16))
    work = _widen(~keys16)
    toks = gidx.expand(ll.shape).contiguous()
    _, tok_sorted, p_bits = _dist_radix_passes(
        (work, toks, probs.contiguous().view(torch.int32)), 16, group, method=method,
        tile_s=tile_s, bits_per_pass=bits_per_pass)
    p_sorted = p_bits.view(torch.float32)
    cum = mcscan_local(p_sorted, group, method=method, tile_s=tile_s)
    masked = torch.where((cum - p_sorted) > p, torch.zeros_like(p_sorted), p_sorted)
    cdf = mcscan_local(masked, group, method=method, tile_s=tile_s)
    total = comm.all_gather(cdf[..., -1:], group)[-1]    # the last shard's CDF tail
    guards.guard_check(lambda: torch.isfinite(total).all(),
                       "dist_top_p_sample: non-finite nucleus mass before the "
                       "inverse-transform sample")
    theta = uu * total
    rank = comm.all_reduce(torch.sum(cdf < theta, dim=-1, dtype=torch.int32), "sum", group)
    rel = torch.clamp(rank, 0, n - 1) - start           # pads carry no mass: never hit
    in_range = (rel >= 0) & (rel < L)
    at = _take_along_last(tok_sorted, torch.clamp(rel, 0, L - 1)[..., None])[..., 0]
    tok = comm.all_reduce(torch.where(in_range, at, torch.zeros_like(at)), "sum", group)
    if nonfinite == "sanitize":
        tok = torch.where(bad, greedy.to(tok.dtype), tok)
    return tok.reshape(lead).to(torch.int32)

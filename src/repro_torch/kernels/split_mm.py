"""B5 (SplitInd), B6 (the multi-way split), B7 and B7h (one radix-2^k pass,
without and with its histogram) and B8 (the fused top-p tail).

Port of five kernels of ``repro/kernels/split_mm.py``:

* :func:`split_tiles` (``csrc/split.cu``): SplitInd — the mask scan, stable
  destinations (flagged elements first) and the scatter of the payload and
  its original index, with the number of flagged elements; on the card B6's
  tile split on two slots (the tiles' trues and falses, their slot-major
  scan, each element's in-tile rank plus its tile's base).
* :func:`multi_split_tiles` (``csrc/multi_split.cu``): the stable ``R``-way
  split by int32 digits — up to ``MULTI_SPLIT_TILE_MAX_BUCKETS`` buckets as
  B7's tile split on ``R + 1`` slots (tile slot counts, their bucket-major
  scan, each element's in-tile rank plus its tile's base, and the scatter of
  the payload and its original index), above that one CTA a row.
* :func:`radix_pass_multibit` (``csrc/radix_pass.cu``): one stable LSB
  radix-2^k pass as a tile split over many CTAs a row — tile digit counts,
  their bucket-major scan, then each key's in-tile rank (the one-hot mask
  scans) plus its tile's base, and the scatter of keys and permutation; with
  ``with_counts`` it is B7h (``csrc/radix_pass_hist.cu``), which also exports
  the row's digit histogram for the distributed sort.
* :func:`topp_mask_sample_tiles` (``csrc/topp_tail.cu``): prefix sum of the
  sorted probabilities, the llama3 cut ``(cum - sp) > p``, the masked CDF and
  the inverse-transform sample, one int32 per row; on the card one cluster of
  ``TOPP_CLUSTER`` CTAs a row, each holding a slice of the row in shared
  memory (:func:`_topp_tail_cluster` repeats its arithmetic).

Keys travel as raw words: ``uint8`` for 8-bit keys, ``int16`` for 16-bit keys
and ``int32`` for 32-bit keys (the bit patterns of the unsigned encodings;
torch's ``uint16``/``uint32`` lack shifts and scatters on the CPU).  A pass
only ever extracts bits, so the signed container is harmless.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run the
plain versions in this module.
"""
from __future__ import annotations

import torch

from repro_torch.core import guards
from repro_torch.kernels import _build

__all__ = ["split_tiles", "split_plain", "multi_split_tiles", "multi_split_plain",
           "radix_pass_multibit", "radix_pass_plain", "topp_mask_sample_tiles",
           "topp_tail_plain", "topp_tail_geometry", "KEY_DTYPES", "TOPP_BAND",
           "TOPP_CLUSTER", "TOPP_MAX_ITEMS", "TOPP_MAX_SLICE", "MULTI_SPLIT_MAX_BUCKETS",
           "MULTI_SPLIT_TILE_MAX_BUCKETS", "RADIX_TILE"]

KEY_DTYPES = {torch.uint8: 8, torch.int16: 16, torch.int32: 32}

# the most buckets B6 takes: one warp's R + 1 counters and the R + 1 totals
# fill the card's 227 KB of shared memory (csrc/multi_split.cu)
MULTI_SPLIT_MAX_BUCKETS = 232448 // 8 - 1

# the most buckets B6's tile split takes (kTileMaxBuckets in csrc/multi_split.cu:
# its downsweep scans the R + 1 slots one thread a slot, 512 threads); above it
# B6 runs one CTA a row
MULTI_SPLIT_TILE_MAX_BUCKETS = 511

# keys a tile of the B5/B6/B7/B7h tile splits: kTile in csrc/radix_pass.cuh, which
# the entry points check it against; the plain versions' default tile
RADIX_TILE = 4096

# fp32 summation-order band of the fused top-p tail, relative to the row's
# probability mass (derivation in csrc/topp_tail.cu)
TOPP_BAND = 2.0 ** -16

# csrc/topp_tail.cu: B8's CTAs a row (one cluster), the longest run a thread sums
# where 1024 threads allow it (a CTA has the fewest of 256, 512 and 1024 threads
# that keep to it), and the most elements a CTA holds in shared memory (longer
# rows are walked in rounds)
TOPP_CLUSTER = 8
TOPP_MAX_ITEMS = 63
TOPP_MAX_SLICE = 55296


def split_plain(x: torch.Tensor, flags: torch.Tensor, *, tile=None):
    """Plain version of SplitInd on ``(b, n)`` payloads and ``bool`` flags.

    Returns ``(z, ind, n_true)``: destinations are the exclusive int32 mask
    scan ``ex`` for a flagged element and ``n_true + i - ex`` for the others.

    ``tile`` models the kernel's tile split on two slots, slot 0 for a
    flagged element and 1 for the others: the tiles' slot counts
    (:func:`_radix_tile_hist`), their slot-major exclusive scan
    (:func:`_radix_tile_scan`, whose slot-0 total is ``n_true``) and each
    element's in-tile rank plus its tile's base (:func:`_radix_tile_dest`).
    A stable split has one answer, so every ``tile`` gives the same bits.
    """
    n = x.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=x.device)
    if tile is None:
        fi = flags.to(torch.int32)
        inc = torch.cumsum(fi, dim=-1, dtype=torch.int32)           # exact
        ex = inc - fi
        n_true = inc[:, -1]
        dest = torch.where(flags, ex, n_true[:, None] + iota - ex).to(torch.int64)
    else:
        slot = (~flags).to(torch.int64)
        tile = max(min(tile, n), 1)                # a short row is one tile, unpadded
        tile_base, totals = _radix_tile_scan(_radix_tile_hist(slot, 2, tile))
        dest = _radix_tile_dest(slot, tile_base, totals, tile)
        n_true = totals[:, 0].contiguous()
    z = torch.empty_like(x).scatter_(1, dest, x)
    ind = torch.empty(dest.shape, dtype=torch.int32, device=x.device).scatter_(
        1, dest, iota.expand(dest.shape))
    return z, ind, n_true


def split_tiles(x: torch.Tensor, flags: torch.Tensor):
    """SplitInd over the last axis: ``(z, ind, n_true)``.

    Args:
        x: ``(..., n)`` payload of any dtype with 1-, 2-, 4- or 8-byte
            elements; a CUDA tensor launches the kernel, a CPU tensor runs
            :func:`split_plain`.
        flags: Same shape; cast to ``bool`` first, so every non-zero flag
            counts as true.  (The Pallas kernel casts flags to int8 and puts
            an element first only where its flag is exactly 1; for ``bool``
            flags the two agree.)  The Pallas kernel's tile side ``s`` has
            no counterpart: the CUDA kernel splits tiles of ``RADIX_TILE``
            elements, many CTAs a row, with an int32 scratch of
            ``b·2·(T + 1)`` for the tiles' slot counts and the row totals.

    Returns:
        ``z`` shaped like ``x``, ``ind`` (int32) shaped like ``x``, and
        ``n_true`` (int32) of shape ``x.shape[:-1]`` (0-d for a 1-D ``x``).
    """
    guards.validate_same_shape(x.shape, flags.shape, op="split_tiles")
    if x.device != flags.device:
        raise ValueError("split_tiles: x and flags live on different devices")
    *lead, n = x.shape
    if x.numel() == 0:
        return (x.clone(), torch.zeros(x.shape, dtype=torch.int32, device=x.device),
                torch.zeros(lead, dtype=torch.int32, device=x.device))
    xb = x.reshape(-1, n)
    fb = flags.reshape(-1, n).to(torch.bool)
    b = xb.shape[0]
    if not _build.on_card(xb):
        z, ind, cnt = split_plain(xb, fb)
    else:
        if xb.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"split_tiles: the CUDA kernel moves 1-, 2-, 4- or 8-byte "
                            f"elements, got {xb.dtype}")
        if n >= 1 << 31:
            raise ValueError(f"split_tiles: rows of {n} elements overflow the int32 index")
        xb, fb = xb.contiguous(), fb.contiguous()
        z = torch.empty_like(xb)
        ind = torch.empty((b, n), dtype=torch.int32, device=xb.device)
        cnt = torch.empty((b,), dtype=torch.int32, device=xb.device)
        # the tiles' (trues, falses) counts (b, 2, T), then the row totals (b, 2)
        scratch = torch.empty(b * 2 * (-(-n // RADIX_TILE) + 1), dtype=torch.int32,
                              device=xb.device)
        if _build.record("split", (xb, fb), (z, ind, cnt)):
            return z.reshape(x.shape), ind.reshape(x.shape), cnt.reshape(lead)
        with torch.cuda.device(xb.device):
            stream = torch.cuda.current_stream(xb.device).cuda_stream
            _build.launch("split", xb.data_ptr(), fb.data_ptr(), z.data_ptr(),
                          ind.data_ptr(), cnt.data_ptr(), scratch.data_ptr(), b, n,
                          xb.element_size(), RADIX_TILE, stream)
    return z.reshape(x.shape), ind.reshape(x.shape), cnt.reshape(lead)


def multi_split_plain(x: torch.Tensor, digits: torch.Tensor, num_buckets: int, *,
                      tile=None):
    """Plain version of the multi-way split on ``(b, n)`` payloads and int32 digits.

    A digit outside ``[0, R)`` goes to the extra slot ``R``, after every
    bucket, uncounted, as in the kernel.  The tile split's three phases on the
    ``R + 1`` slots, on tiles of ``tile`` elements: the tiles' slot counts
    (:func:`_radix_tile_hist`), their slot-major exclusive scan
    (:func:`_radix_tile_scan`) and each element's in-tile rank plus its tile's
    base (:func:`_radix_tile_dest`).  A stable split has one answer, so every
    ``tile`` gives the same bits; ``None`` takes the whole row as one tile, the
    exclusive scans of the row's ``(b, R + 1, n)`` one-hot slot masks.
    Returns ``(z, ind, counts)`` with counts ``(b, R)``.
    """
    n = x.shape[-1]
    d = digits.to(torch.int64)
    d = torch.where((d >= 0) & (d < num_buckets), d, num_buckets)
    tile = max(min(tile or n, n), 1)               # a short row is one tile, unpadded
    tile_base, totals = _radix_tile_scan(_radix_tile_hist(d, num_buckets + 1, tile))
    dest = _radix_tile_dest(d, tile_base, totals, tile)
    iota = torch.arange(n, dtype=torch.int32, device=x.device).expand(dest.shape)
    return (torch.empty_like(x).scatter_(1, dest, x),
            torch.empty(dest.shape, dtype=torch.int32, device=x.device).scatter_(1, dest, iota),
            totals[:, :num_buckets].contiguous())


def multi_split_tiles(x: torch.Tensor, digits: torch.Tensor, *, num_buckets: int):
    """Stable ``num_buckets``-way split over the last axis: ``(z, indices, counts)``.

    Args:
        x: ``(..., n)`` payload of any dtype with 1-, 2-, 4- or 8-byte
            elements; a CUDA tensor launches the kernel, a CPU tensor runs
            :func:`multi_split_plain`.
        digits: Same shape, bucket ids in ``[0, num_buckets)``, cast to int32
            as the Pallas wrapper casts them.  A digit outside that range goes
            after every bucket, in order, and is not counted (the Pallas kernel
            puts its element on index 0).
        num_buckets: ``R``, from 1 to ``MULTI_SPLIT_MAX_BUCKETS``.  On a CUDA
            tensor ``R`` alone chooses the kernel: up to
            ``MULTI_SPLIT_TILE_MAX_BUCKETS`` the tile split (three kernels on
            tiles of ``RADIX_TILE`` elements, many CTAs a row, with an int32
            scratch of ``b·(R + 1)·(T + 1)``), above it one CTA a row (its
            counters fill shared memory).  Both rank 32 elements at a time and
            mask the ragged row end, so nothing is padded; the Pallas kernel's
            tile side ``s`` has no counterpart.

    Returns:
        ``z`` shaped like ``x``, ``indices`` (int32) shaped like ``x`` and
        ``counts`` (int32) of shape ``(..., num_buckets)``.
    """
    guards.validate_same_shape(x.shape, digits.shape, op="multi_split_tiles",
                               b_name="digits")
    num_buckets = guards.validate_positive(num_buckets, name="num_buckets",
                                           op="multi_split_tiles")
    if num_buckets > MULTI_SPLIT_MAX_BUCKETS:
        raise ValueError(f"multi_split_tiles: num_buckets {num_buckets} exceeds "
                         f"{MULTI_SPLIT_MAX_BUCKETS}, the most whose counters fit the "
                         "card's 227 KB of shared memory")
    if x.device != digits.device:
        raise ValueError("multi_split_tiles: x and digits live on different devices")
    *lead, n = x.shape
    if x.numel() == 0:
        return (x.clone(), torch.zeros(x.shape, dtype=torch.int32, device=x.device),
                torch.zeros((*lead, num_buckets), dtype=torch.int32, device=x.device))
    xb = x.reshape(-1, n)
    db = digits.reshape(-1, n).to(torch.int32)
    b = xb.shape[0]
    if not _build.on_card(xb):
        z, ind, cnt = multi_split_plain(xb, db, num_buckets)
    else:
        if xb.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"multi_split_tiles: the CUDA kernel moves 1-, 2-, 4- or 8-byte "
                            f"elements, got {xb.dtype}")
        if n >= 1 << 31:
            raise ValueError(f"multi_split_tiles: rows of {n} elements overflow the int32 "
                             "index")
        xb, db = xb.contiguous(), db.contiguous()
        z = torch.empty_like(xb)
        ind = torch.empty((b, n), dtype=torch.int32, device=xb.device)
        cnt = torch.empty((b, num_buckets), dtype=torch.int32, device=xb.device)
        # the tile split's slot counts (b, R + 1, T), then its slot totals
        scratch = (torch.empty(b * (num_buckets + 1) * (-(-n // RADIX_TILE) + 1),
                               dtype=torch.int32, device=xb.device)
                   if num_buckets <= MULTI_SPLIT_TILE_MAX_BUCKETS else None)
        if _build.record("multi_split", (xb, db), (z, ind, cnt)):
            return (z.reshape(x.shape), ind.reshape(x.shape),
                    cnt.reshape(*lead, num_buckets))
        with torch.cuda.device(xb.device):
            stream = torch.cuda.current_stream(xb.device).cuda_stream
            _build.launch("multi_split", xb.data_ptr(), db.data_ptr(), z.data_ptr(),
                          ind.data_ptr(), cnt.data_ptr(),
                          None if scratch is None else scratch.data_ptr(), b, n, num_buckets,
                          xb.element_size(), RADIX_TILE, stream)
    return (z.reshape(x.shape), ind.reshape(x.shape),
            cnt.reshape(*lead, num_buckets))


def _radix_tile_hist(digits: torch.Tensor, radix: int, tile: int = RADIX_TILE):
    """Phase 1 of the tile split (the upsweep): each tile's digit counts.

    ``digits``: ``(b, n)`` int64 digits in ``[0, radix)``.  Returns the
    ``(b, R, T)`` int32 counts, bucket-major, of the ``T = ceil(n / tile)``
    tiles of ``tile`` keys; the ragged last tile counts only its own keys.
    """
    return _tile_one_hot(digits, radix, tile).sum(-1, dtype=torch.int32).transpose(1, 2)


def _radix_tile_scan(tile_counts: torch.Tensor):
    """Phase 2 (the bucket-major scan): ``(b, R, T)`` counts in, ``(tile_base,
    totals)`` out, the exclusive scan of each bucket's counts over the tiles and
    the ``(b, R)`` bucket totals (B7h's histogram)."""
    inc = torch.cumsum(tile_counts, dim=-1, dtype=torch.int32)
    return inc - tile_counts, tile_counts.sum(-1, dtype=torch.int32)


def _radix_tile_dest(digits: torch.Tensor, tile_base: torch.Tensor, totals: torch.Tensor,
                     tile: int = RADIX_TILE) -> torch.Tensor:
    """Phase 3 (the downsweep): each key's destination in its row, ``(b, n)`` int64.

    A key of digit ``d`` at in-tile position ``j`` of tile ``t`` goes to the
    row's base of bucket ``d`` (the exclusive scan of ``totals``), plus
    ``tile_base[d, t]``, plus its in-tile rank: the exclusive scan of the
    tile's one-hot mask of ``d`` at ``j``.
    """
    b, n = digits.shape
    radix = totals.shape[-1]
    oh = _tile_one_hot(digits, radix, tile)                      # (b, T, R, tile)
    rank = torch.cumsum(oh, dim=-1, dtype=torch.int32) - oh      # exclusive, exact
    row_base = torch.cumsum(totals, dim=-1, dtype=torch.int32) - totals
    base = (row_base[:, :, None] + tile_base).transpose(1, 2)    # (b, T, R)
    d = _tiled(digits, tile, radix - 1)                          # pads read bucket R-1
    dest = torch.gather(base, 2, d) + torch.gather(rank, 2, d[:, :, None, :])[:, :, 0]
    return dest.flatten(1)[:, :n].to(torch.int64)


def _tiled(digits: torch.Tensor, tile: int, pad: int) -> torch.Tensor:
    """``(b, n)`` digits as ``(b, T, tile)``, the last tile padded with ``pad``."""
    b, n = digits.shape
    tiles = -(-n // tile)
    return torch.nn.functional.pad(digits, (0, tiles * tile - n), value=pad).view(
        b, tiles, tile)


def _tile_one_hot(digits: torch.Tensor, radix: int, tile: int) -> torch.Tensor:
    """``(b, T, R, tile)`` int32 one-hot digit masks; the pad of the last tile
    (digit ``R``) is in no bucket."""
    d = _tiled(digits, tile, radix)
    buckets = torch.arange(radix, device=digits.device)
    return (d[:, :, None, :] == buckets[None, None, :, None]).to(torch.int32)


def radix_pass_plain(work: torch.Tensor, perm: torch.Tensor, *, shift: int,
                     pass_bits: int, with_counts: bool = False, tile: int = RADIX_TILE):
    """Plain version of one radix pass on ``(b, n)`` raw-word keys.

    The kernel's three phases on tiles of ``tile`` keys: the tiles' digit
    counts (:func:`_radix_tile_hist`), their bucket-major exclusive scan
    (:func:`_radix_tile_scan`), and each key's in-tile rank plus its tile's
    base (:func:`_radix_tile_dest`).  The result is the same for every tile;
    a tile of the whole row is the untiled form, the exclusive scans of the
    row's one-hot digit masks.
    With ``with_counts`` the ``(b, 2^k)`` int32 bucket totals come out as well
    (the plain version of B7h).
    """
    radix = 1 << pass_bits
    digits = ((work >> shift) & (radix - 1)).to(torch.int64)
    tile = min(tile, max(work.shape[-1], 1))       # a short row is one tile, unpadded
    tile_base, counts = _radix_tile_scan(_radix_tile_hist(digits, radix, tile))
    dest = _radix_tile_dest(digits, tile_base, counts, tile)
    out = (torch.empty_like(work).scatter_(1, dest, work),
           torch.empty_like(perm).scatter_(1, dest, perm))
    return out + (counts,) if with_counts else out


def radix_pass_multibit(work: torch.Tensor, perm: torch.Tensor, *, shift: int,
                        pass_bits: int, with_counts: bool = False):
    """One stable radix-2^k pass: ``(keys, perm)`` regrouped by digit ``shift``.

    Args:
        work: ``(b, n)`` raw-word keys (``uint8``, ``int16`` or ``int32``).
        perm: ``(b, n)`` int32 permutation carried along with the keys.
        shift: Lowest bit of the digit.
        pass_bits: Digit width ``k`` in ``[1, 8]``.
        with_counts: Also return the row's ``(b, 2^k)`` int32 digit
            histogram: on CUDA tensors that launches B7h
            (``csrc/radix_pass_hist.cu``) instead of B7.  Both kernels mask
            the ragged end of a row, so, unlike the Pallas wrapper, nothing is
            padded and the histogram counts only the row's own keys.

    Returns:
        ``(keys, perm)`` after the pass, and ``counts`` with ``with_counts``.
    """
    if work.dtype not in KEY_DTYPES:
        raise TypeError(f"radix_pass_multibit: keys must be one of "
                        f"{list(KEY_DTYPES)}, got {work.dtype}")
    if perm.dtype != torch.int32:
        raise TypeError(f"radix_pass_multibit: perm must be int32, got {perm.dtype}")
    if work.dim() != 2:
        raise ValueError(f"radix_pass_multibit: keys must be (b, n), got {tuple(work.shape)}")
    guards.validate_same_shape(work.shape, perm.shape, op="radix_pass_multibit",
                               a_name="keys", b_name="perm")
    pass_bits = guards.validate_bits_per_pass(pass_bits, op="radix_pass_multibit")
    if not 0 <= shift <= KEY_DTYPES[work.dtype] - pass_bits:
        raise ValueError(f"radix_pass_multibit: bits [{shift}, {shift + pass_bits}) "
                         f"do not fit {KEY_DTYPES[work.dtype]}-bit keys")
    if work.device != perm.device:
        raise ValueError("radix_pass_multibit: keys and perm live on different devices")
    if not _build.on_card(work):
        return radix_pass_plain(work, perm, shift=shift, pass_bits=pass_bits,
                                with_counts=with_counts)
    b, n = work.shape
    if n >= 1 << 31:
        raise ValueError(f"radix_pass_multibit: rows of {n} keys overflow the int32 "
                         "permutation")
    work, perm = work.contiguous(), perm.contiguous()
    radix = 1 << pass_bits
    keys_out = torch.empty_like(work)
    perm_out = torch.empty_like(perm)
    # the tile counts (b, R, T), then the bucket totals when B7 exports none
    scratch = torch.empty(b * radix * (-(-n // RADIX_TILE) + 1), dtype=torch.int32,
                          device=work.device)
    if not with_counts and _build.record("radix_pass", (work, perm), (keys_out, perm_out)):
        return keys_out, perm_out
    # rows of no keys launch nothing, so their counts start at zero
    counts = (torch.zeros if n == 0 else torch.empty)(
        (b, radix), dtype=torch.int32, device=work.device) if with_counts else None
    if with_counts and _build.record("radix_pass_hist", (work, perm),
                                     (keys_out, perm_out, counts)):
        return keys_out, perm_out, counts
    with torch.cuda.device(work.device):
        stream = torch.cuda.current_stream(work.device).cuda_stream
        if not with_counts:
            _build.launch("radix_pass", work.data_ptr(), perm.data_ptr(),
                          keys_out.data_ptr(), perm_out.data_ptr(), scratch.data_ptr(), b, n,
                          shift, pass_bits, work.element_size(), RADIX_TILE, stream)
            return keys_out, perm_out
        _build.launch("radix_pass_hist", work.data_ptr(), perm.data_ptr(),
                      keys_out.data_ptr(), perm_out.data_ptr(), counts.data_ptr(),
                      scratch.data_ptr(), b, n, shift, pass_bits, work.element_size(),
                      RADIX_TILE, stream)
    return keys_out, perm_out, counts


def topp_tail_plain(sp: torch.Tensor, u: torch.Tensor, *, p: float) -> torch.Tensor:
    """Plain version of the fused tail on ``(b, n)`` fp32 and ``(b, 1)`` uniforms."""
    cum = torch.cumsum(sp, dim=-1)
    cut = (cum - sp) > p
    masked = torch.where(cut, torch.zeros_like(sp), sp)
    cdf = torch.cumsum(masked, dim=-1)
    theta = u * cdf[:, -1:]
    j = torch.sum(cdf < theta, dim=-1, dtype=torch.int32)
    return torch.clamp(j, 0, sp.shape[-1] - 1)


def topp_tail_geometry(n: int, cluster: int = TOPP_CLUSTER, threads: int | None = None):
    """``(slice, rounds, threads, items)`` of B8 for rows of ``n``: the elements of a
    CTA's slice (``ceil(n / cluster)`` rounded up to 4, at most ``TOPP_MAX_SLICE``),
    the rounds of ``cluster`` slices that cover the row, the threads a CTA (by
    default the fewest of 256, 512 and 1024 whose runs keep to ``TOPP_MAX_ITEMS``)
    and the odd length of a thread's run (``geometry``, ``threads_for`` and
    ``items`` in ``csrc/topp_tail.cu``)."""
    per = -(-n // cluster)
    slice_ = min(-(-per // 4) * 4, TOPP_MAX_SLICE)
    if threads is None:
        threads = next((t for t in (256, 512) if (-(-slice_ // t) | 1) <= TOPP_MAX_ITEMS),
                       1024)
    return slice_, -(-n // (cluster * slice_)), threads, -(-slice_ // threads) | 1


def _warp_inclusive(v: torch.Tensor) -> torch.Tensor:
    """Hillis-Steele inclusive scan of the last axis (32 lanes), as the shuffles add."""
    d = 1
    while d < v.shape[-1]:
        v = torch.cat([v[..., :d], v[..., d:] + v[..., :-d]], -1)
        d *= 2
    return v


def _slice_tree(v: torch.Tensor, threads: int):
    """B8's fixed tree over ``(b, slices, threads, items)`` values: each thread's
    running sums in order, and its base without the slice's prefix, ``(pw, lex)``
    (its warp's exclusive prefix across the warps and its own across the lanes),
    and each slice's total."""
    b, g = v.shape[:2]
    warps = threads // 32
    runs = torch.empty_like(v)
    acc = torch.zeros_like(v[..., 0])
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
        runs[..., k] = acc
    inc = _warp_inclusive(runs[..., -1].reshape(b, g, warps, 32))
    lex = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    winc = _warp_inclusive(torch.nn.functional.pad(inc[..., -1], (0, 32 - warps)))
    pw = torch.cat([torch.zeros_like(winc[..., :1]), winc[..., :warps - 1]], -1)
    return runs, pw, lex, winc[..., warps - 1]


def _fold_slices(totals: torch.Tensor) -> torch.Tensor:
    """Each slice's prefix: the strict left-to-right fold of the totals before it."""
    pre = torch.empty_like(totals)
    acc = torch.zeros_like(totals[:, 0])
    for q in range(totals.shape[1]):
        pre[:, q] = acc
        acc = acc + totals[:, q]
    return pre


def _topp_tail_cluster(sp: torch.Tensor, u: torch.Tensor, *, p: float,
                       cluster: int = TOPP_CLUSTER, threads: int | None = None,
                       parts: bool = False):
    """B8's arithmetic on the card, operation for operation, on ``(b, n)`` fp32 rows
    and ``(b, 1)`` uniforms (for tests; the CPU path is :func:`topp_tail_plain`).

    The row is cut into slices (:func:`topp_tail_geometry`), one a CTA of the
    cluster, a round of ``cluster`` slices at a time.  In each slice a thread
    sums its run of ``items`` elements in order, the lanes' and warps' totals
    are joined by Hillis-Steele scans (:func:`_slice_tree`), and the slices'
    totals are folded left to right into each slice's prefix; an element's
    value is ``((prefix + pw) + lex) + run``.  So for ``cum``, then for the
    masked values; ``theta = u · cdf[n-1]`` from the last element's own
    ``cdf``, and ``j`` is the sum of the slices' counts of ``cdf < theta``,
    clipped to ``[0, n - 1]``.  With ``parts=True`` also returns a dict of the
    slices' sums of ``cum`` and of the masked values (``(b, slices)``, in the
    order they are folded), ``cdf[n-1]``, the per-slice counts, and ``cum``,
    the masked values and ``cdf`` as ``(b, n)``.
    """
    b, n = sp.shape
    slice_, rounds, threads, items = topp_tail_geometry(n, cluster, threads)
    g = rounds * cluster
    x = torch.nn.functional.pad(sp.to(torch.float32), (0, g * slice_ - n)).reshape(b, g, slice_)
    x = torch.nn.functional.pad(x, (0, threads * items - slice_)).reshape(b, g, threads, items)

    def values(v):
        runs, pw, lex, tot = _slice_tree(v, threads)
        base = (_fold_slices(tot)[..., None, None] + pw[..., None]) + lex
        return base.reshape(b, g, threads)[..., None] + runs, tot

    cum, sums = values(x)
    m = torch.where((cum - x) > p, torch.zeros_like(x), x)
    cdf, msums = values(m)
    cdf = cdf.reshape(b, g, threads * items)[..., :slice_]
    last = cdf.reshape(b, g * slice_)[:, n - 1:n]
    theta = u.reshape(b, 1).to(torch.float32) * last
    valid = torch.arange(g * slice_).reshape(g, slice_) < n
    counts = ((cdf < theta[..., None]) & valid).sum(-1, dtype=torch.int64)
    j = torch.clamp(counts.sum(-1), 0, n - 1).to(torch.int32)
    if parts:
        def rows(t):
            return t.reshape(b, g, threads * items)[..., :slice_].reshape(b, -1)[:, :n]
        return j, {"slice_sums": sums, "masked_sums": msums, "last_cdf": last[:, 0],
                   "counts": counts, "cum": rows(cum), "masked": rows(m),
                   "cdf": cdf.reshape(b, -1)[:, :n]}
    return j


def topp_mask_sample_tiles(sorted_p: torch.Tensor, u: torch.Tensor, *,
                           p: float) -> torch.Tensor:
    """Fused nucleus-sampling tail: index into the descending sorted order.

    Args:
        sorted_p: ``(..., n)`` probabilities sorted descending (cast to fp32).
        u: ``(..., 1)`` uniforms in ``[0, 1)``.
        p: Nucleus mass in ``[0, 1]``.

    Returns:
        ``(...)`` int32 indices into the sorted order.
    """
    guards.validate_probability(p, op="topp_mask_sample_tiles")
    *lead, n = sorted_p.shape
    if n == 0:
        raise ValueError("topp_mask_sample_tiles: empty rows")
    sp = sorted_p.reshape(-1, n).to(torch.float32)
    ub = u.reshape(-1, 1).to(device=sp.device, dtype=torch.float32)
    if ub.shape[0] != sp.shape[0]:
        raise ValueError(f"topp_mask_sample_tiles: {ub.shape[0]} uniforms for "
                         f"{sp.shape[0]} rows")
    if not _build.on_card(sp):
        return topp_tail_plain(sp, ub, p=p).reshape(lead)
    # rows of unit element stride are read where they lie, at any row stride
    # and 4-byte alignment (a slice of a wider tensor is not copied)
    if sp.stride(-1) != 1:
        sp = sp.contiguous()
    ub = ub.contiguous()
    b = sp.shape[0]
    j = torch.empty((b,), dtype=torch.int32, device=sp.device)
    if _build.record("topp_tail", (sp, ub), (j,)):
        return j.reshape(lead)
    with torch.cuda.device(sp.device):
        stream = torch.cuda.current_stream(sp.device).cuda_stream
        _build.launch("topp_tail", sp.data_ptr(), sp.stride(0), ub.data_ptr(), j.data_ptr(),
                      b, n, float(p), stream)
    return j.reshape(lead)

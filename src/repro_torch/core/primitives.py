"""Scan-based operators (paper §5): split, compress, multi-way split, sorts, top-p.

Port of ``repro/core/primitives.py`` for the operators on the main path.
Every operator takes ``method=`` and routes through one dispatch table:

* ``"matmul"`` / ``"vector"`` / ``"blocked"`` — the unfused operators: one
  batched exclusive :func:`~repro_torch.core.scan.scan` over the int8 masks
  (the flags, or the one-hot digit masks), then a torch scatter; the scan
  method differs underneath, and ``"blocked"`` runs it on the §4 pipeline
  (B2–B4), so ``split``, ``compress``, ``multi_split``, ``radix_sort``,
  ``sort``, ``topk``, ``weighted_sample`` and ``top_p_sample`` all run there;
* ``"kernel"`` — the hand-written CUDA kernels of ``repro_torch.kernels``: B5
  for ``split``/``compress``, B6 for ``multi_split``, B7 for each radix pass,
  B8 for the whole top-p tail.

Destination offsets are exact int32 mask scans for every method, so splits
and sorts are bit-identical across methods in values and permutation.

Sort keys travel as raw words: ``uint8`` for 8-bit keys, ``int16`` for
16-bit and ``int32`` for 32-bit keys, holding the bits of the JAX package's
unsigned encodings (``uint8``/``uint16``/``uint32``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import guards
from repro_torch.core.autotune import maybe_resolve
from repro_torch.core.scan import METHODS, scan

__all__ = ["split", "compress", "multi_split", "radix_sort", "sort", "topk",
           "top_p_sample", "weighted_sample", "float_to_sortable_int",
           "sortable_int_to_float", "dispatch", "METHODS"]

_DISPATCH: Dict[str, Dict[str, Callable]] = {}


def _register(op: str, *methods: str):
    """Register the decorated function as ``op``'s impl for ``methods``."""
    def deco(fn):
        table = _DISPATCH.setdefault(op, {})
        for m in methods:
            table[m] = fn
        return fn
    return deco


def dispatch(op: str, method: str) -> Callable:
    """Look up the implementation of ``op`` for ``method``.

    Example:
        >>> dispatch("split", "vector").__name__
        '_split_unfused'
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    try:
        return _DISPATCH[op][method]
    except KeyError:
        raise ValueError(f"operator {op!r} has no {method!r} implementation") from None


def _take_along_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather ``x`` along the last axis."""
    return torch.gather(x, -1, idx.to(torch.int64))


def _scatter_payloads(payloads, dest, *, with_indices):
    """Scatter each ``(..., n)`` payload to the per-row destinations ``dest``."""
    d = dest.to(torch.int64)
    outs = tuple(torch.empty_like(p).scatter_(-1, d, p) for p in payloads)
    if with_indices:
        n = dest.shape[-1]
        iota = torch.arange(n, dtype=torch.int32, device=dest.device).expand(dest.shape)
        outs += (torch.empty(dest.shape, dtype=torch.int32,
                             device=dest.device).scatter_(-1, d, iota),)
    return outs


# ---------------------------------------------------------------------------
# split / compress
# ---------------------------------------------------------------------------


@_register("split", "matmul", "vector", "blocked")
def _split_unfused(x, flags, *, method, tile_s):
    """SplitInd via one exclusive int8 mask ``scan`` + torch scatter."""
    n = x.shape[-1]
    f8 = flags.to(torch.int8)
    ex = scan(f8, axis=-1, exclusive=True, method=method, tile_s=tile_s)
    n_true = ex[..., -1] + flags[..., -1].to(torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=x.device)
    dest = torch.where(flags.to(torch.bool), ex, n_true[..., None] + (iota - ex))
    z, ind = _scatter_payloads((x,), dest, with_indices=True)
    return z, ind, n_true


@_register("split", "kernel")
def _split_fused(x, flags, *, method, tile_s):
    """SplitInd as one B5 launch (the kernel takes no tile side)."""
    from repro_torch.kernels.split_mm import split_tiles
    return split_tiles(x, flags)


def split(x: torch.Tensor, flags: torch.Tensor, *, method: str = "auto",
          return_indices: bool = True, tile_s: int = 128):
    """Stable partition (the paper's SplitInd): flagged elements first, order kept.

    Args:
        x: Payload ``(..., n)``, any dtype.
        flags: Boolean ``(..., n)``; true elements move to the front.
        method: One of ``METHODS`` or ``"auto"`` (``"kernel"`` is one B5
            launch; ``"blocked"`` runs the mask scan on the §4 pipeline).
        return_indices: If false, omit the permutation from the result.
        tile_s: Tile side ``s`` for the matmul scans.

    Returns:
        ``(z, indices, n_true)`` (or ``(z, n_true)``): the partitioned
        payload, each output's original position (int32) and the per-row
        count of flagged elements (int32, 0-d for a 1-D ``x``).

    Example:
        >>> z, ind, k = split(torch.tensor([10, 20, 30, 40]),
        ...                   torch.tensor([False, True, False, True]), method="vector")
        >>> z.tolist(), ind.tolist(), int(k)
        ([20, 40, 10, 30], [1, 3, 0, 2], 2)
    """
    guards.validate_same_shape(x.shape, flags.shape, op="split")
    method = maybe_resolve(method, "split", x.shape[-1], x.dtype, device=x.device)
    guards.refuse_grad(x, op="split", method=method, methods=("kernel",))
    z, ind, n_true = dispatch("split", method)(x, flags, method=method, tile_s=tile_s)
    if return_indices:
        return z, ind, n_true
    return z, n_true


def compress(x: torch.Tensor, mask: torch.Tensor, *, method: str = "auto",
             fill_value=0, tile_s: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked select: the elements where ``mask`` is true, packed left.

    Args:
        x: Payload ``(..., n)``.
        mask: Boolean ``(..., n)``.
        method: One of ``METHODS`` or ``"auto"``; forwarded to :func:`split`.
        fill_value: Value for the ``values[..., count:]`` tail.
        tile_s: Tile side ``s`` for the matmul scans.

    Returns:
        ``(values, count)``: ``values`` shaped like ``x``, with
        ``values[..., count:]`` set to ``fill_value``.

    Example:
        >>> v, k = compress(torch.tensor([1, 2, 3, 4]),
        ...                 torch.tensor([True, False, True, False]), method="vector")
        >>> v.tolist(), int(k)
        ([1, 3, 0, 0], 2)
    """
    method = maybe_resolve(method, "compress", x.shape[-1], x.dtype, device=x.device)
    z, _, n_true = split(x, mask, method=method, tile_s=tile_s)
    iota = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
    keep = iota < n_true[..., None]
    z = torch.where(keep, z, torch.tensor(fill_value, dtype=z.dtype, device=z.device))
    return z, n_true


# ---------------------------------------------------------------------------
# multi_split (radix-2^k generalization of SplitInd)
# ---------------------------------------------------------------------------


def _multi_split_dest(digits, num_buckets, *, method, tile_s):
    """Destinations for a stable ``num_buckets``-way split.

    One batched exclusive scan over the ``(..., R, n)`` int8 one-hot digit
    masks gives every bucket's mask scan at once; the bucket bases are the
    ``R``-wide exclusive prefix of the bucket counts.
    """
    d = digits.to(torch.int64)
    buckets = torch.arange(num_buckets, device=digits.device)
    oh = (d[..., None, :] == buckets[:, None]).to(torch.int8)        # (..., R, n)
    ex = scan(oh, axis=-1, exclusive=True, method=method, tile_s=tile_s)
    counts = ex[..., -1] + oh[..., -1].to(torch.int32)                # (..., R)
    base = torch.cumsum(counts, dim=-1, dtype=torch.int32) - counts
    ex_d = torch.gather(ex, -2, d[..., None, :])[..., 0, :]
    dest = _take_along_last(base, d) + ex_d
    return dest, counts


@_register("multi_split", "matmul", "vector", "blocked")
def _multi_split_unfused(x, digits, num_buckets, *, method, tile_s):
    """Multi-way SplitInd via one batched ``scan`` + torch scatter."""
    dest, counts = _multi_split_dest(digits, num_buckets, method=method,
                                     tile_s=tile_s)
    z, ind = _scatter_payloads((x,), dest, with_indices=True)
    return z, ind, counts


@_register("multi_split", "kernel")
def _multi_split_fused(x, digits, num_buckets, *, method, tile_s):
    """Multi-way SplitInd as one B6 launch (the kernel takes no tile side)."""
    from repro_torch.kernels.split_mm import multi_split_tiles
    return multi_split_tiles(x, digits, num_buckets=num_buckets)


def multi_split(x: torch.Tensor, digits: torch.Tensor, num_buckets: int, *,
                method: str = "auto", return_indices: bool = True,
                tile_s: int = 128):
    """Stable ``num_buckets``-way partition — radix-2^k SplitInd.

    Returns:
        ``(z, indices, counts)`` (or ``(z, counts)``): the bucket-grouped
        payload, each output's original position (int32) and the per-bucket
        counts ``(..., num_buckets)`` (int32).

    Example:
        >>> z, ind, c = multi_split(torch.tensor([50, 10, 70, 30]),
        ...                         torch.tensor([2, 0, 2, 1]), 4)
        >>> z.tolist(), ind.tolist(), c.tolist()
        ([10, 30, 50, 70], [1, 3, 0, 2], [1, 1, 2, 0])
    """
    if num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    guards.validate_same_shape(x.shape, digits.shape, op="multi_split",
                               b_name="digits")
    method = maybe_resolve(method, "multi_split", x.shape[-1], x.dtype,
                           device=x.device)
    guards.refuse_grad(x, op="multi_split", method=method, methods=("kernel",))
    z, ind, counts = dispatch("multi_split", method)(
        x, digits, num_buckets, method=method, tile_s=tile_s)
    if return_indices:
        return z, ind, counts
    return z, counts


# ---------------------------------------------------------------------------
# Radix sort (paper §5, LSB; floats via order-preserving bit encodings)
# ---------------------------------------------------------------------------

_MSB = {torch.int16: -(1 << 15), torch.int32: -(1 << 31)}
_RAW = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
        torch.float32: torch.int32}


def float_to_sortable_int(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving float -> unsigned encoding, as raw words.

    Positive floats flip the sign bit, negative floats flip every bit.  The
    result holds the bits of the unsigned key in an ``int16`` (fp16/bf16) or
    ``int32`` (fp32) tensor.

    Example:
        >>> u = float_to_sortable_int(torch.tensor([-1.0, 0.0, 1.0]))
        >>> [v & 0xFFFFFFFF for v in u.tolist()] == sorted(
        ...     v & 0xFFFFFFFF for v in u.tolist())
        True
    """
    if x.dtype not in _RAW:
        raise TypeError(f"unsupported float dtype {x.dtype}")
    raw = _RAW[x.dtype]
    u = x.view(raw)
    return torch.where(u < 0, ~u, u | _MSB[raw])


def sortable_int_to_float(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`float_to_sortable_int`."""
    if dtype not in _RAW:
        raise TypeError(f"unsupported float dtype {dtype}")
    msb = _MSB[_RAW[dtype]]
    dec = torch.where(u < 0, u & ~msb, ~u)       # MSB set <=> a positive float
    return dec.view(dtype)


def _encode_for_sort(x: torch.Tensor) -> Tuple[torch.Tensor, int, Callable]:
    """Map ``x`` to raw-word unsigned keys; returns ``(keys, n_bits, decode)``."""
    dt = x.dtype
    if dt.is_floating_point:
        enc = float_to_sortable_int(x)
        return enc, enc.element_size() * 8, lambda u: sortable_int_to_float(u, dt)
    if dt in (torch.int16, torch.int32):
        msb = _MSB[dt]
        return x ^ msb, x.element_size() * 8, lambda u: u ^ msb
    if dt == torch.int8:
        return (x.view(torch.uint8) ^ 0x80, 8,
                lambda u: (u ^ 0x80).view(torch.int8))
    if dt == torch.uint8:
        return x, 8, lambda u: u
    if dt in (torch.uint16, torch.uint32):
        raw = torch.int16 if dt == torch.uint16 else torch.int32
        return x.view(raw), x.element_size() * 8, lambda u: u.view(dt)
    raise TypeError(f"radix sort: unsupported dtype {dt}")


@_register("radix_passes", "matmul", "vector", "blocked")
def _radix_passes_unfused(enc, bits, *, method, tile_s, bits_per_pass=1):
    """``ceil(bits / k)`` multi-way splits, keys and permutation co-scattered."""
    n = enc.shape[-1]
    perm = torch.arange(n, dtype=torch.int32, device=enc.device).expand(enc.shape)
    work = enc
    for shift in range(0, bits, bits_per_pass):
        k = min(bits_per_pass, bits - shift)
        digits = (work >> shift) & ((1 << k) - 1)
        dest, _ = _multi_split_dest(digits, 1 << k, method=method, tile_s=tile_s)
        work, perm = _scatter_payloads((work, perm), dest, with_indices=False)
    return work, perm


@_register("radix_passes", "kernel")
def _radix_passes_fused(enc, bits, *, method, tile_s, bits_per_pass=1):
    """All radix passes as B7 launches, ``bits_per_pass`` bits each."""
    from repro_torch.kernels import ops as _kops
    return _kops.radix_sort_enc_kernel(enc, bits=bits, bits_per_pass=bits_per_pass)


def radix_sort(x: torch.Tensor, *, descending: bool = False, method: str = "auto",
               return_indices: bool = True, tile_s: int = 128,
               bits_per_pass: int = 4):
    """Stable LSB radix sort built on scan-based multi-way splits (paper §5).

    Each pass is a stable ``2^bits_per_pass``-way split on one digit, so a key
    sorts in ``ceil(bits / bits_per_pass)`` passes.  Every (method,
    bits_per_pass) combination gives the same values and permutation.

    Returns:
        ``(values, permutation)`` (or ``values``); ``permutation`` is int32
        with ``values == gather(x, -1, permutation)``.

    Example:
        >>> v, idx = radix_sort(torch.tensor([3, -1, 2, -5], dtype=torch.int8),
        ...                     method="vector")
        >>> v.tolist(), idx.tolist()
        ([-5, -1, 2, 3], [3, 1, 2, 0])
    """
    bits_per_pass = guards.validate_bits_per_pass(bits_per_pass, op="radix_sort")
    method = maybe_resolve(method, "radix_sort", x.shape[-1], x.dtype,
                           device=x.device)
    enc, bits, decode = _encode_for_sort(x)
    if descending:
        enc = ~enc  # complement keeps stability while reversing the order
    work, perm = dispatch("radix_passes", method)(
        enc, bits, method=method, tile_s=tile_s,
        bits_per_pass=min(bits_per_pass, bits))
    if descending:
        work = ~work
    values = decode(work)
    if return_indices:
        return values, perm
    return values


def sort(x: torch.Tensor, *, descending: bool = False, method: str = "auto",
         tile_s: int = 128, bits_per_pass: int = 4):
    """``(values, indices)`` of a stable sort; radix under the hood."""
    return radix_sort(x, descending=descending, method=method,
                      return_indices=True, tile_s=tile_s,
                      bits_per_pass=bits_per_pass)


def topk(x: torch.Tensor, k: int, *, method: str = "auto", tile_s: int = 128,
         bits_per_pass: int = 4):
    """Top-k via the descending radix sort: ``(values, indices)``."""
    values, idx = radix_sort(x, descending=True, method=method, tile_s=tile_s,
                             bits_per_pass=bits_per_pass)
    return values[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# weighted / top-p sampling
# ---------------------------------------------------------------------------


def _uniforms(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def weighted_sample(w: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                    method: str = "auto", cdf: Optional[torch.Tensor] = None,
                    tile_s: int = 128, u: Optional[torch.Tensor] = None,
                    nonfinite: str = "propagate") -> torch.Tensor:
    """Inverse-transform sampling on the scanned CDF (paper §5).

    Args:
        w: Non-negative weights ``(..., n)``.
        generator: Source of the uniforms when ``u`` is not given.
        method: Scan method for the CDF.
        cdf: Optional precomputed inclusive scan of ``w``.
        tile_s: Tile side for the matmul scans.
        u: Optional uniforms of shape ``w.shape[:-1] + (1,)``.
        nonfinite: Non-finite weight policy (:mod:`repro_torch.core.guards`):
            ``"propagate"`` keeps IEEE semantics; ``"raise"`` rejects
            non-finite weights; ``"sanitize"`` zeroes them (a caller's ``cdf``
            is then dropped) and gives a row whose total is not finite and
            positive its greedy index (the argmax of the sanitized weights,
            ties low).  With checks on (``REPRO_CHECKS=1``), a non-finite CDF
            fails a ``guard_check``.

    Returns:
        int32 indices of shape ``w.shape[:-1]``, in ``[0, n)``.

    Example:
        >>> int(weighted_sample(torch.tensor([1.0, 1.0]), u=torch.tensor([0.75]),
        ...                     method="vector"))
        1
        >>> int(weighted_sample(torch.tensor([0.2, float("nan"), 0.1]),
        ...                     u=torch.tensor([0.99]), method="vector",
        ...                     nonfinite="sanitize"))
        2
    """
    method = maybe_resolve(method, "weighted_sample", w.shape[-1], w.dtype,
                           device=w.device)
    nonfinite = guards.resolve_nonfinite(nonfinite, op="weighted_sample")
    w_eff = guards.apply_nonfinite(w, nonfinite, op="weighted_sample")
    if w_eff is not w:
        cdf = None                                 # a caller's CDF no longer matches
    if cdf is None:
        cdf = scan(w_eff, axis=-1, method=method, tile_s=tile_s)
    if cdf.dtype.is_floating_point:
        guards.guard_check(lambda: torch.isfinite(cdf).all(),
                           "weighted_sample: non-finite CDF before the "
                           "inverse-transform sample")
    total = cdf[..., -1:]
    if u is None:
        u = _uniforms(w.shape[:-1] + (1,), generator, w.device)
    theta = u.to(device=cdf.device, dtype=cdf.dtype) * total
    idx = torch.sum(cdf < theta, dim=-1, dtype=torch.int32)
    idx = torch.clamp(idx, 0, w.shape[-1] - 1)
    if nonfinite == "sanitize" and w_eff.dtype.is_floating_point:
        bad = ~(torch.isfinite(total[..., 0]) & (total[..., 0] > 0))
        idx = torch.where(bad, torch.argmax(w_eff, dim=-1).to(idx.dtype), idx)
    return idx


def _reject_poisoned_logits(logits: torch.Tensor) -> None:
    """``nonfinite="raise"`` for the samplers: NaN, ``+inf`` and rows with no finite
    entry fail, with one host read.  ``-inf`` entries are legal vocabulary masks,
    so :func:`~repro_torch.core.guards.apply_nonfinite` would be too strict."""
    x = logits.to(torch.float32)
    bad = (torch.isnan(x).any() | torch.isposinf(x).any()
           | ~torch.isfinite(x).any(dim=-1).all())
    if guards.host_read(bad, meta=False):
        raise guards.NonFiniteError(
            "top_p_sample: poisoned logits under nonfinite='raise' (NaN/+inf "
            "entries or a fully masked row)")


@_register("top_p_tail", "matmul", "vector", "blocked")
def _top_p_tail_unfused(sorted_p, generator, *, p, method, tile_s, u=None):
    """Cumsum -> cutoff -> masked renormalised CDF -> inverse-transform sample."""
    cum = scan(sorted_p, axis=-1, method=method, tile_s=tile_s)
    cut = (cum - sorted_p) > p                    # llama3's sample_top_p formula
    masked = torch.where(cut, torch.zeros_like(sorted_p), sorted_p)
    return weighted_sample(masked, generator, method=method, tile_s=tile_s, u=u)


@_register("top_p_tail", "kernel")
def _top_p_tail_fused(sorted_p, generator, *, p, method, tile_s, u=None):
    """The whole nucleus-sampling tail as one B8 launch."""
    from repro_torch.kernels.split_mm import topp_mask_sample_tiles
    if u is None:
        u = _uniforms(sorted_p.shape[:-1] + (1,), generator, sorted_p.device)
    return topp_mask_sample_tiles(sorted_p, u.to(torch.float32), p=p)


def top_p_sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                 p: float = 0.9, temperature: float = 1.0, *, method: str = "auto",
                 sort_method: str = "radix", tile_s: int = 128,
                 bits_per_pass: int = 4, u: Optional[torch.Tensor] = None,
                 nonfinite: str = "propagate") -> torch.Tensor:
    """Nucleus sampling as in the paper's Llama3 case study (§5, §6.5).

    fp32 softmax -> radix sort on bf16-rounded keys (16 sort bits) -> prefix
    sum of the sorted probabilities -> mask tokens whose *preceding* mass
    exceeds ``p`` -> renormalised inverse-transform sample.  With
    ``method="kernel"`` the sort runs as B7 passes and the tail as one B8
    launch.

    Args:
        logits: Scores ``(..., vocab)``.
        generator: Source of the uniforms when ``u`` is not given.
        p: Nucleus mass in ``[0, 1]``.
        temperature: Logit divisor; ``0`` is the greedy (argmax) limit.
        method: One of ``METHODS`` or ``"auto"``.
        sort_method: ``"radix"`` (scan-based) or ``"xla"`` (a stable
            ``torch.argsort``; the name matches the JAX package's baseline).
        tile_s: Tile side for the matmul scans.
        bits_per_pass: Bits per radix pass (1..8).
        u: Optional uniforms of shape ``logits.shape[:-1] + (1,)``.
        nonfinite: Non-finite logit policy (:mod:`repro_torch.core.guards`):
            ``"propagate"`` keeps IEEE semantics (a fully masked or NaN row
            samples an undefined token); ``"raise"`` rejects NaN, ``+inf`` and
            fully masked rows before any launch (``-inf`` masks are legal);
            ``"sanitize"`` turns each row whose softmax is not finite into a
            one-hot at its greedy token (NaN read as ``-inf``, ties low)
            before the sort and pins that token after the tail.

    Returns:
        int32 token ids of shape ``logits.shape[:-1]``.

    Raises:
        NonFiniteError: ``nonfinite="raise"`` and poisoned logits.

    Example:
        >>> logits = torch.tensor([[0.0, 20.0, 0.0, 0.0]])
        >>> top_p_sample(logits, u=torch.tensor([[0.5]]), method="vector").tolist()
        [1]
        >>> top_p_sample(logits, temperature=0.0).tolist()
        [1]
    """
    guards.validate_probability(p, op="top_p_sample")
    guards.validate_temperature(temperature, op="top_p_sample")
    nonfinite = guards.resolve_nonfinite(nonfinite, op="top_p_sample")
    guards.validate_choice(sort_method, ("radix", "xla"), name="sort_method",
                           op="top_p_sample")
    if float(temperature) == 0.0:
        # the temperature -> 0 limit: all mass on the max logit
        greedy = torch.where(torch.isnan(logits), float("-inf"), logits)
        return torch.argmax(greedy, dim=-1).to(torch.int32)
    method = maybe_resolve(method, "top_p_sample", logits.shape[-1], logits.dtype,
                           device=logits.device)
    if nonfinite == "raise":
        _reject_poisoned_logits(logits)
    if temperature != 1.0:
        logits = logits / temperature
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    if nonfinite == "sanitize":
        # a row whose softmax is not finite (fully masked, NaN) becomes a one-hot at
        # its greedy token, so the sort and the tail see a valid distribution
        bad = ~torch.isfinite(probs).all(dim=-1)
        greedy = torch.argmax(torch.where(torch.isnan(logits), float("-inf"), logits),
                              dim=-1)
        onehot = torch.nn.functional.one_hot(greedy, probs.shape[-1]).to(probs.dtype)
        probs = torch.where(bad[..., None], onehot, probs)
    if sort_method == "radix":
        # 16 sort bits, as in the paper's fp16 evaluation
        keys16 = probs.to(torch.bfloat16)
        _, order = radix_sort(keys16, descending=True, method=method,
                              tile_s=tile_s, bits_per_pass=bits_per_pass)
    else:
        order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_p = _take_along_last(probs, order)
    j = dispatch("top_p_tail", method)(sorted_p, generator, p=p, method=method,
                                       tile_s=tile_s, u=u)
    tok = _take_along_last(order, j[..., None].to(torch.int64))[..., 0].to(torch.int32)
    if nonfinite == "sanitize":
        tok = torch.where(bad, greedy.to(tok.dtype), tok)    # pin the greedy token
    return tok

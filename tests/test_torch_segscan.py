"""The port's segmented scan kernels (B9–B12) against the JAX package, phase by phase.

Inputs and flags are drawn with numpy from a seed and go through both
packages.  The JAX kernels run in Pallas interpret mode (their own default on
the CPU), with ``s=8`` and short rows; the port's wrappers run their plain
versions, as every kernel wrapper does on a CPU tensor.  Tolerances:

* int8, int32, bool and integer-valued fp32 payloads are bit-identical to the
  JAX result (every partial sum is exact);
* random fp32 is held, in both packages, to the JAX package's own segmented
  contract (``analysis/ulp.py`` ``segment_scan_scale``): ``8·√n`` ulp against
  the fp64 per-segment scan, the ulp taken at the running sum of ``|x|`` from
  the row start, because the gather form of B12 subtracts partial sums at that
  scale.  On the card the kernels are held to 16 ulp at the per-segment scale
  (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Flag layouts cover empty segments (repeated offsets), a flag at 0 only, a flag
on every element, no flag at all (blocks without a boundary), segments that
cross several blocks, flags other than 1, and a ragged row end.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import ulp
from repro.kernels import segscan_mm as jax_seg
from repro_torch.kernels import segscan_mm as port_seg

N = 333                                       # ragged: not a multiple of any tile or block
KINDS = ["int8", "int32", "bool", "f32int", "f32rand"]
LAYOUTS = ["empties", "first", "all", "none", "long", "nonbool"]
_NP = {"int8": np.int8, "int32": np.int32}


@functools.lru_cache(maxsize=None)
def _values(kind: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "f32rand":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "f32int":
        return rng.integers(-8, 9, shape).astype(np.float32)
    if kind == "bool":
        return rng.random(shape) < 0.4
    return rng.integers(-100, 101, shape).astype(_NP[kind])


@functools.lru_cache(maxsize=None)
def _flags(layout: str, shape, seed: int = 1) -> np.ndarray:
    """int8 segment-start flags of one layout, for every row of ``shape``."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    f = np.zeros(shape, np.int8)
    if layout == "empties":
        # offsets with repeats: empty segments collapse onto their neighbour's start
        for row in f.reshape(-1, n):
            cuts = np.sort(rng.integers(0, n, 40))
            row[np.concatenate([[0], cuts])] = 1
    elif layout == "first":
        f[..., 0] = 1
    elif layout == "all":
        f[...] = 1
    elif layout == "long":                   # segments spanning several blocks
        f[..., ::150] = 1
    elif layout == "nonbool":
        f[...] = (rng.random(shape) < 0.05) * rng.integers(2, 4, shape)
    return f


def _seg_ref(x: np.ndarray, f: np.ndarray):
    """fp64 per-segment inclusive scan of ``x``, and the running ``Σ|x|`` of the row."""
    x = np.asarray(x, np.float64)
    f = np.broadcast_to(f, x.shape)
    pos = np.broadcast_to(np.arange(x.shape[-1]), x.shape)
    start = np.maximum.accumulate(np.where(f > 0, pos, 0), axis=-1)
    full = np.cumsum(x, axis=-1)
    return full - np.take_along_axis(full - x, start, axis=-1), ulp.scan_scale(x)


def _check(kind, got, want, x, f):
    """Bit-equal, or for random fp32 both within the ulp bound of the fp64 scan."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "f32rand":
        ref, sc = _seg_ref(x, f)
        bound = ulp.ulp_bound("highest", x.shape[-1])
        assert ulp.max_ulp(got, ref, sc) <= bound
        assert ulp.max_ulp(want, ref, sc) <= bound
    else:
        np.testing.assert_array_equal(got, want)


def _both(fn_jax, fn_port, *arrays, **kw):
    j = fn_jax(*(jnp.asarray(a) for a in arrays), **kw)
    t = fn_port(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    return j, t


# ---- B9: seg_scan_tiles ----


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", KINDS)
def test_seg_scan_tiles_matches_jax(kind, layout):
    x, f = _values(kind, (3, N)), _flags(layout, (3, N))
    j, t = _both(jax_seg.seg_scan_tiles, port_seg.seg_scan_tiles, x, f, s=8)
    _check(kind, t.numpy(), np.asarray(j), x, f)


@pytest.mark.parametrize("kind", KINDS)
def test_seg_scans_share_one_row_of_flags(kind):
    """An ``(R, n)`` batch over one ``(n,)`` row of flags (the one-hot mask scans)."""
    x, f = _values(kind, (4, N), seed=5), _flags("empties", (N,), seed=6)
    for jfn, tfn, kw in ((jax_seg.seg_scan_tiles, port_seg.seg_scan_tiles, {}),
                         (jax_seg.seg_blocked_scan, port_seg.seg_blocked_scan,
                          {"block_tiles": 2})):
        j, t = _both(jfn, tfn, x, f, s=8, **kw)
        _check(kind, t.numpy(), np.asarray(j), x, f)


# ---- B10-B12 on the block view, and the whole pipeline ----


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", KINDS)
def test_seg_block_summaries_matches_jax(kind, layout):
    blocks = _values(kind, (2, 3, 16, 8), seed=2)
    fblocks = _flags(layout, (2, 3, 16, 8), seed=3)
    (jts, jh), (tts, th) = _both(jax_seg.seg_block_summaries,
                                 port_seg.seg_block_summaries, blocks, fblocks)
    assert th.dtype == torch.int32 and set(th.unique().tolist()) <= {0, 1}
    np.testing.assert_array_equal(th.numpy(), (np.asarray(jh) > 0).astype(np.int32))
    if kind != "f32rand":
        np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
        return
    flat, ff = blocks.reshape(2, 3, -1).astype(np.float64), fblocks.reshape(2, 3, -1)
    rank = np.arange(flat.shape[-1])
    last = np.where(ff > 0, rank, 0).max(-1, keepdims=True)
    tail = np.where(rank >= last, flat, 0.0)
    ref, sc = tail.sum(-1), np.abs(tail).sum(-1)
    bound = ulp.ulp_bound("highest", flat.shape[-1])
    assert ulp.max_ulp(tts.numpy(), ref, sc) <= bound
    assert ulp.max_ulp(np.asarray(jts), ref, sc) <= bound


@pytest.mark.parametrize("hlayout", ["random", "none", "all"])
@pytest.mark.parametrize("kind", ["int32", "f32int", "f32rand"])
def test_seg_carry_scan_matches_jax(kind, hlayout):
    sums = _values(kind, (3, 50), seed=4)
    h = {"random": (np.random.default_rng(7).random((3, 50)) < 0.2),
         "none": np.zeros((3, 50), bool), "all": np.ones((3, 50), bool)}[hlayout]
    h = h.astype(np.int32)
    j, t = _both(jax_seg.seg_carry_scan, port_seg.seg_carry_scan, sums, h)
    assert (t[:, 0] == 0).all()
    if kind != "f32rand":
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        return
    ref, sc = _seg_ref(sums, h)                  # inclusive; the carries are exclusive
    ref = np.concatenate([np.zeros((3, 1)), ref[:, :-1]], -1)
    sc = np.concatenate([np.zeros((3, 1)), sc[:, :-1]], -1)
    bound = ulp.ulp_bound("highest", 50)
    assert ulp.max_ulp(t.numpy(), ref, sc) <= bound
    assert ulp.max_ulp(np.asarray(j), ref, sc) <= bound


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", KINDS)
def test_seg_block_scan_carry_matches_jax(kind, layout):
    blocks = _values(kind, (2, 3, 16, 8), seed=8)
    fblocks = _flags(layout, (2, 3, 16, 8), seed=9)
    integer = kind in ("int8", "int32", "bool")
    carries = _values("int32" if integer else "f32int", (2, 3), seed=10)
    carries = carries.astype(np.int32 if integer else np.float32)
    j, t = _both(jax_seg.seg_block_scan_carry, port_seg.seg_block_scan_carry,
                 blocks, fblocks, carries)
    if kind != "f32rand":
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        return
    flat, ff = blocks.reshape(2, 3, -1), fblocks.reshape(2, 3, -1)
    ref, sc = _seg_ref(flat, ff)
    unseen = np.maximum.accumulate(ff > 0, axis=-1) == 0
    ref = ref + np.where(unseen, carries[..., None], 0.0)
    sc = sc + np.where(unseen, np.abs(carries[..., None]), 0.0)
    bound = ulp.ulp_bound("highest", flat.shape[-1])
    for got in (t.numpy(), np.asarray(j)):
        assert ulp.max_ulp(got.reshape(flat.shape), ref, sc) <= bound


@pytest.mark.parametrize("s,block_tiles", [(8, 1), (8, 2), (8, 4)])
@pytest.mark.parametrize("layout", ["empties", "none", "long", "all"])
@pytest.mark.parametrize("kind", KINDS)
def test_seg_blocked_scan_matches_jax(kind, layout, s, block_tiles):
    x, f = _values(kind, (3, N)), _flags(layout, (3, N))
    j, t = _both(jax_seg.seg_blocked_scan, port_seg.seg_blocked_scan, x, f, s=s,
                 block_tiles=block_tiles)
    _check(kind, t.numpy(), np.asarray(j), x, f)


def test_one_block_row_skips_the_summaries():
    """``nb == 1``: the plain pipeline equals B12 alone with zero carries."""
    x, f = _values("int32", (2, 100)), _flags("empties", (2, 100))
    xt, ft = torch.from_numpy(x), torch.from_numpy(f)
    whole = port_seg.seg_blocked_scan(xt, ft, s=16, block_tiles=8)
    blocks = torch.nn.functional.pad(xt, (0, 156)).reshape(2, 1, 16, 16)
    fblocks = torch.nn.functional.pad(ft, (0, 156)).reshape(2, 1, 16, 16)
    alone = port_seg.seg_block_scan_carry(blocks, fblocks,
                                          torch.zeros((2, 1), dtype=torch.int32))
    assert torch.equal(whole, alone.reshape(2, -1)[:, :100])


# ---- argument checks ----


def test_wrappers_validate_their_arguments():
    x = torch.ones((2, 10))
    with pytest.raises(ValueError, match="broadcast"):
        port_seg.seg_scan_tiles(x, torch.ones(9))
    with pytest.raises(ValueError, match="s must be"):
        port_seg.seg_blocked_scan(x, torch.ones(10), s=0)
    with pytest.raises(ValueError, match="block_tiles"):
        port_seg.seg_blocked_scan(x, torch.ones(10), block_tiles=0)
    with pytest.raises(ValueError, match="precision"):
        port_seg.seg_scan_tiles(x, torch.ones(10), precision="exact")
    assert port_seg.seg_scan_tiles(x, torch.ones(10), s=2, precision="fast").sum() == 20
    blocks = torch.ones((1, 2, 4, 4))
    with pytest.raises(ValueError, match="fblocks"):
        port_seg.seg_block_summaries(blocks, torch.ones((1, 2, 4, 3)))
    with pytest.raises(ValueError, match="carries"):
        port_seg.seg_block_scan_carry(blocks, blocks, torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="has_boundary"):
        port_seg.seg_carry_scan(torch.zeros((2, 3)), torch.zeros((2, 4)))
    empty = port_seg.seg_scan_tiles(torch.zeros((3, 0), dtype=torch.int8),
                                    torch.zeros(0))
    assert empty.shape == (3, 0) and empty.dtype == torch.int32

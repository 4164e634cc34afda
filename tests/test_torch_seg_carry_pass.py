"""B11 as B9's single pass made exclusive, modelled on the CPU.

``csrc/seg_carry.cu`` runs the pass of ``csrc/seg_pass.cuh`` over the ``(b, nb)``
block summaries: each tile of ``seg_scan_tile(nb)`` summaries is folded under
``(a ⊕ b) = b.h ? b.ts : a.ts + b.ts``, takes its carry-in from the look-back's
strict left-to-right fold of the earlier tiles' aggregates, and the result is
shifted to exclusive (block 0's carry is zero).  ``seg_carry_scan_plain(tile=)``
models that split on top of B9's plain tile pass.  Here it is held to the
untiled plain version and to JAX's Pallas ``seg_carry_scan`` (interpret mode) at
tiles of 32 and 64, and to an exact reference at B9's own tile of 8192, on rows
of 1, 2, 31, tile - 1, tile, tile + 1 and 3·tile + 17 summaries, with has-flag
words all zero, all set, random and 7: int32 bit-equal, random fp32 within the
bound ``tests/test_torch_segscan.py`` holds the carry scan to, ``ulp_bound
("highest", nb)`` ulp of the fp64 scan at the row's running ``Σ|ts|``.  Inputs
are drawn with numpy from a seed.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.analysis import ulp
from repro.kernels import segscan_mm as jax_seg
from repro_torch.kernels import segscan_mm

LAYOUTS = ["none", "all", "random", "sevens"]
KINDS = ["int32", "f32rand"]
BIG = segscan_mm.seg_scan_tile(1 << 20)


def _rows(tile):
    return [1, 2, 31, tile - 1, tile, tile + 1, 3 * tile + 17]


@functools.lru_cache(maxsize=None)
def _inputs(kind: str, layout: str, nb: int):
    rng = np.random.default_rng(nb)
    ts = (rng.standard_normal((3, nb)).astype(np.float32) if kind == "f32rand"
          else rng.integers(-100, 101, (3, nb)).astype(np.int32))
    h = {"none": np.zeros((3, nb), np.int32), "all": np.ones((3, nb), np.int32),
         "random": (rng.random((3, nb)) < 0.05).astype(np.int32),
         "sevens": ((rng.random((3, nb)) < 0.05) * 7).astype(np.int32)}[layout]
    return ts, h


def _reference(ts, h):
    """fp64 exclusive segmented scan of the summaries, and the row's running Σ|ts|
    before each block (the scale of the carry scan's bound)."""
    x = ts.astype(np.float64)
    pos = np.broadcast_to(np.arange(x.shape[-1]), x.shape)
    start = np.maximum.accumulate(np.where(h != 0, pos, 0), axis=-1)
    full = np.cumsum(x, axis=-1)
    inc = full - np.take_along_axis(full - x, start, axis=-1)
    shift = lambda a: np.concatenate([np.zeros_like(a[:, :1]), a[:, :-1]], -1)  # noqa: E731
    return shift(inc), shift(np.cumsum(np.abs(x), axis=-1))


def _hold(kind, got, ts, h, want=None):
    ref, scale = _reference(ts, h)
    if kind == "int32":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got.astype(np.float64), ref)
        if want is not None:
            np.testing.assert_array_equal(got, want)
        return
    assert got.dtype == np.float32
    bound = ulp.ulp_bound("highest", ts.shape[-1])
    assert ulp.max_ulp(got, ref, scale) <= bound
    if want is not None:
        assert ulp.max_ulp(want, ref, scale) <= bound


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nb", sorted(set(_rows(32) + _rows(64))))
def test_tile_pass_matches_plain_and_jax(nb, kind, layout):
    ts, h = _inputs(kind, layout, nb)
    t_ts, t_h = torch.from_numpy(ts), torch.from_numpy(h)
    untiled = segscan_mm.seg_carry_scan_plain(t_ts, t_h).numpy()
    jax_out = np.asarray(jax_seg.seg_carry_scan(jnp.asarray(ts), jnp.asarray(h)))
    for tile in (32, 64):
        got = segscan_mm.seg_carry_scan_plain(t_ts, t_h, tile=tile, s=4).numpy()
        assert (got[:, 0] == 0).all()
        _hold(kind, got, ts, h, untiled)
        _hold(kind, got, ts, h, jax_out)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nb", _rows(BIG))
def test_tile_pass_at_the_kernel_tile(nb, kind, layout):
    """B9's tile for these rows, 8192 summaries (the pipeline's nb = 128 is one tile
    of 128): against the exact reference; the untiled contraction is too large here."""
    ts, h = _inputs(kind, layout, nb)
    got = segscan_mm.seg_carry_scan_plain(torch.from_numpy(ts), torch.from_numpy(h),
                                          tile=BIG, s=16).numpy()
    assert (got[:, 0] == 0).all()
    _hold(kind, got, ts, h)


def test_kernel_tiles_of_the_pipeline():
    """B11 takes B9's tile rule: the pipeline's nb = 128 (and every nb <= 8192) is one
    tile, so no look-back and no workspace; 2^20 summaries are 128 tiles a row."""
    assert segscan_mm.seg_scan_tile(128) == 512
    assert all(-(-nb // segscan_mm.seg_scan_tile(nb)) == 1 for nb in (1, 7, 128, 8191, 8192))
    assert -(-8193 // segscan_mm.seg_scan_tile(8193)) == 2
    assert (1 << 20) // segscan_mm.seg_scan_tile(1 << 20) == 128

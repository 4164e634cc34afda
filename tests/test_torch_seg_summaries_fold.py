"""The walk of B10 (the segmented block summaries) against JAX's Pallas kernel.

On the card B10 (``csrc/seg_summaries.cu``) walks each block from its end in
rounds of one 16-element run a thread and stops at the round that holds the
block's last flag: a run folds to (sum from its last flag on, has-flag), a
warp's 32 runs combine under the segmented-pair operator
``(a ⊕ b) = (b.h ? b.v : a.v + b.v, a.h | b.h)`` as a pairwise tree, the
warps' pairs combine in order into the round's pair, and each round goes on
the left of what has been gathered.  ``segscan_mm.seg_block_summaries_plain
(fold=True)`` runs that fold in the kernel's order (``seg_summaries_geometry``
gives its threads and rounds).  Here, on the CPU, it is held against the
plain version (one masked sum) and the Pallas kernel
(``repro.kernels.segscan_mm.seg_block_summaries`` in interpret mode): integers
and integer-valued fp32 exact; random fp32 within the bound that
``tests/test_torch_segscan.py`` states for B10, ``ulp_bound("highest", m·s)``
ulp of the fp64 trailing sum at the scale of its ``Σ|x|``.  The has-boundary
output is 0 or 1, where the Pallas kernel writes the block's largest flag.
Blocks cover a part of one run, one round of one and of four warps, and
several rounds of eight warps with a ragged last one; flags sit on each
run's first or last element, nowhere, everywhere, on each block's last
element, at random (values 1 to 3), and in one row shared by the rows; a
ragged row is cut into blocks as the pipeline cuts it, its last block padded
with zeros without flags.  Inputs are drawn with numpy from a seed.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import ulp
from repro.kernels import segscan_mm as jax_seg
from repro_torch.kernels import segscan_mm
from repro_torch.kernels.scan_pipeline import block_geometry

RUN = segscan_mm.SEG_SUMMARIES_RUN
# (m, s) blocks: part of one run; one round of one warp; one round of four
# warps; two, four and five rounds of eight warps, the last one ragged
GEOMETRIES = ((3, 5), (16, 8), (128, 16), (64, 128), (128, 128), (100, 200))
KINDS = ("int8", "int32", "f32int", "f32rand")
LAYOUTS = ("run_first", "run_last", "none", "all", "block_last", "random", "shared")
_NP = {"int8": np.int8, "int32": np.int32}


def _values(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "f32rand":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "f32int":
        return rng.integers(-8, 9, shape).astype(np.float32)
    return rng.integers(-100, 101, shape).astype(_NP[kind])


def _flags(layout: str, shape, seed: int) -> np.ndarray:
    """int8 flags of ``(b, nb, m, s)`` blocks, the position taken within the block."""
    rng = np.random.default_rng(seed)
    b, nb, m, s = shape
    pos = np.arange(m * s).reshape(m, s)
    f = np.zeros(shape, np.int8)
    if layout == "run_first":
        f[...] = pos % RUN == 0
    elif layout == "run_last":
        f[...] = pos % RUN == RUN - 1
    elif layout == "all":
        f[...] = 1
    elif layout == "block_last":
        f[..., -1, -1] = 1
    elif layout == "random":
        f[...] = (rng.random(shape) < 0.01) * rng.integers(1, 4, shape)
    elif layout == "shared":
        f[...] = (rng.random((1, nb, m, s)) < 0.01) * rng.integers(1, 4, (1, nb, m, s))
    return f


def _check(kind, got, want, blocks, fblocks):
    """Exact, or for random fp32 within the ulp bound of the fp64 trailing sum."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind != "f32rand":
        np.testing.assert_array_equal(got, want)
        return
    flat = blocks.reshape(*blocks.shape[:2], -1).astype(np.float64)
    ff = fblocks.reshape(flat.shape)
    rank = np.arange(flat.shape[-1])
    last = np.where(ff != 0, rank, 0).max(-1, keepdims=True)
    tail = np.where(rank >= last, flat, 0.0)
    bound = ulp.ulp_bound("highest", flat.shape[-1])
    assert ulp.max_ulp(got, tail.sum(-1), np.abs(tail).sum(-1)) <= bound
    assert ulp.max_ulp(want, tail.sum(-1), np.abs(tail).sum(-1)) <= bound


@functools.lru_cache(maxsize=None)
def _jax(kind, geometry, layout):
    shape = (2, 3, *geometry)
    blocks = _values(kind, shape, seed=len(layout))
    fblocks = _flags(layout, shape, seed=7)
    ts, h = jax_seg.seg_block_summaries(jnp.asarray(blocks), jnp.asarray(fblocks))
    return blocks, fblocks, np.asarray(ts), np.asarray(h)


def test_fold_geometry_matches_the_kernel_source():
    src = (Path(segscan_mm.__file__).parent / "csrc" / "seg_summaries.cu").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) \
        == segscan_mm.SEG_SUMMARIES_THREADS
    assert int(re.search(r"constexpr int kRun = (\d+);", src).group(1)) == RUN
    assert "atomicAdd(" not in src
    assert segscan_mm.seg_summaries_geometry(1) == (32, 1)
    assert segscan_mm.seg_summaries_geometry(15) == (32, 1)
    assert segscan_mm.seg_summaries_geometry(128) == (32, 1)
    assert segscan_mm.seg_summaries_geometry(2048) == (128, 1)
    assert segscan_mm.seg_summaries_geometry(4096) == (256, 1)
    assert segscan_mm.seg_summaries_geometry(20000) == (256, 5)
    assert segscan_mm.seg_summaries_geometry(131072) == (256, 32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_fold_matches_plain_and_jax(kind, geometry, layout):
    blocks, fblocks, jts, jh = _jax(kind, geometry, layout)
    bt, ft = torch.from_numpy(blocks), torch.from_numpy(fblocks)
    acc = torch.int32 if kind in _NP else torch.float32
    ts, h = segscan_mm.seg_block_summaries_plain(bt, ft, acc, fold=True)
    pts, ph = segscan_mm.seg_block_summaries_plain(bt, ft, acc)
    assert h.dtype == torch.int32 and torch.equal(h, ph)
    np.testing.assert_array_equal(h.numpy(), (jh > 0).astype(np.int32))
    _check(kind, ts.numpy(), pts.numpy(), blocks, fblocks)
    _check(kind, ts.numpy(), jts, blocks, fblocks)


@pytest.mark.parametrize("kind", KINDS)
def test_fold_of_a_ragged_row(kind):
    """A row of 3·2048 + 333 cut into blocks of 128 x 16 as the pipeline cuts it
    (s = 16, 8 tiles a block): the last block zero-padded without flags, as the
    kernel masks it."""
    n = 3 * 2048 + 333
    m, block_len, nb = block_geometry(n, 16, 8)
    assert (m, nb) == (128, 4) and nb * block_len > n
    x = _values(kind, (2, n), seed=11)
    f = _flags("random", (2, 1, 1, n), seed=12).reshape(2, n)
    f[:, -1] = 1
    pad = ((0, 0), (0, nb * block_len - n))
    blocks = np.pad(x, pad).reshape(2, nb, m, 16)
    fblocks = np.pad(f, pad).reshape(2, nb, m, 16)
    jts, jh = jax_seg.seg_block_summaries(jnp.asarray(blocks), jnp.asarray(fblocks))
    acc = torch.int32 if kind in _NP else torch.float32
    ts, h = segscan_mm.seg_block_summaries_plain(torch.from_numpy(blocks),
                                                 torch.from_numpy(fblocks), acc, fold=True)
    np.testing.assert_array_equal(h.numpy(), (np.asarray(jh) > 0).astype(np.int32))
    _check(kind, ts.numpy(), np.asarray(jts), blocks, fblocks)

"""The tile algebra of the single-pass B13 scan against JAX's Pallas linrec scan.

The CUDA kernel (``csrc/linrec_scan.cu``) cuts each row longer than
``linrec_mm.LINREC_WARP_MAX`` into tiles, one CTA a tile, and links them with
the decoupled look-back of ``csrc/lookback.cuh`` under the affine operator: the
state entering tile ``j`` is the strict left-to-right fold
``y ← A_i·y + B_i`` of the earlier tiles' maps from the nearest tile that has
published its state, so the result does not depend on which tiles had
published when.  The plain version models that split with ``tile=``
(``linrec_mm.linrec_scan_tiles_plain``) and ``lookback.fold_exclusive(mults=)``
evaluates the fold under any look-back schedule.  Here, on the CPU, tiles of
32 and 64 pairs must give the Pallas kernel's result
(``repro.kernels.linrec_mm.linrec_scan_tiles``, interpret mode, ``s=8``) on
rows of 1, tile - 1, tile, tile + 1 and 3·tile + 17 pairs: integer-valued
pairs bit-equal, gated fp32 within the ``1e-6`` of
``tests/test_torch_linrec_kernels.py``.  A recurrence's output at an element
depends only on the pairs before it, so one JAX call on the longest row
serves every shorter one.  Inputs are drawn with numpy from a seed.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import linrec_mm as jax_lin
from repro_torch.kernels import _build, linrec_mm, lookback

CSRC = Path(linrec_mm.__file__).parent / "csrc"
TILES = (32, 64)
NMAX = 3 * max(TILES) + 17
KINDS = ["int", "gated", "zeros"]
TOL = dict(rtol=1e-6, atol=1e-6)


def _rows(tile):
    return (1, tile - 1, tile, tile + 1, 3 * tile + 17)


@functools.lru_cache(maxsize=None)
def _pair(kind: str):
    """(3, NMAX) pairs: integer-valued (a ∈ {-1, 0, 1}, b ∈ [-3, 3]), gated fp32
    (a = exp(-0.1|g|), b ~ N(0, 1)), and gated with ~20% zeros in a."""
    rng = np.random.default_rng(19)
    shape = (3, NMAX)
    if kind == "int":
        return (rng.integers(-1, 2, shape).astype(np.float32),
                rng.integers(-3, 4, shape).astype(np.float32))
    a = np.exp(-np.abs(rng.standard_normal(shape)) * 0.1).astype(np.float32)
    if kind == "zeros":
        a[rng.random(shape) < 0.2] = 0.0
    return a, rng.standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(kind: str) -> np.ndarray:
    a, b = _pair(kind)
    return np.asarray(jax_lin.linrec_scan_tiles(jnp.asarray(a), jnp.asarray(b), s=8))


def test_geometry_matches_the_kernel_sources():
    """The wrapper sizes the look-back's workspace from these constants: two
    8-byte words a tile (the affine pair), then the counter."""
    src = (CSRC / "linrec_scan.cu").read_text()
    tile_src = (CSRC / "affine_tile.cuh").read_text()
    for text, name, value in ((src, "kThreads", linrec_mm.LINREC_SCAN_THREADS),
                              (src, "kItems", linrec_mm.LINREC_SCAN_ITEMS),
                              (tile_src, "kLinWarpMax", linrec_mm.LINREC_WARP_MAX)):
        m = re.search(rf"constexpr (?:int|long long) {name} = (\d+);", text)
        assert m is not None and int(m.group(1)) == value, name
    assert "(2 * total + 1)" in src
    assert lookback.workspace(5, "cpu", words=2).numel() == 11
    n = 1 << 24
    assert linrec_mm.linrec_scan_tile(n) == 8192
    assert -(-n // linrec_mm.linrec_scan_tile(n)) == 2048     # CTAs a row at (4, 2^24)
    assert linrec_mm.linrec_scan_tile(2049) == 2048          # two tiles of 128 threads
    assert linrec_mm.linrec_scan_tile(8191) == 8192


def test_lookback_source_publishes_a_pair_and_folds_it_in_order():
    """The affine look-back: each status word carries its value, so relaxed
    atomics suffice; the aggregate is ready only when both words show it; the
    fold is the state's fmaf through each map, nearest published prefix first."""
    src = (CSRC / "lookback.cuh").read_text()
    assert "ld.acquire" not in src and "st.release" not in src
    assert "ld.relaxed.gpu.global.u64" in src and "st.relaxed.gpu.global.u64" in src
    affine = src[src.index("struct AffineFold"):]
    assert "(w2 & kTileStatus) == kTileAggregate" in affine
    assert "return fmaf(value_of(w, 0.f), c, value_of(w2, 0.f));" in affine
    carry = src[src.index("lookback_affine_carry("):]
    assert "st_relaxed(row + j, tile_word(kTileAggregate, A));" in carry
    assert "st_relaxed(row2 + j, tile_word(kTileAggregate, B));" in carry
    assert "tile_word(kTileInclusive, fmaf(A, c, B))" in carry
    kernel = (CSRC / "linrec_scan.cu").read_text()
    assert "lookback_affine_carry(" in kernel and "take_tile(" in kernel
    assert not any("ftz" in flag for flag in _build.NVCC_FLAGS)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("row", range(5))
@pytest.mark.parametrize("tile", TILES)
def test_tile_split_matches_jax(tile, row, kind):
    n = _rows(tile)[row]
    a, b = (np.ascontiguousarray(x[:, :n]) for x in _pair(kind))
    got = linrec_mm.linrec_scan_tiles_plain(torch.from_numpy(a), torch.from_numpy(b), s=8,
                                            acc=torch.float32, tile=tile).numpy()
    want = _jax(kind)[:, :n]
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# ---- the affine fold under look-back schedules ----

def _schedules(ntiles: int, count: int, seed: int):
    """Random look-back schedules: for each tile, the predecessor whose state it
    found published (-1: none)."""
    rng = np.random.default_rng(seed)
    return [[int(rng.integers(-1, j)) if j else -1 for j in range(ntiles)]
            for _ in range(count)]


def _maps(ntiles: int):
    """fp32 tile maps (A, B) whose composition rounds differently in another
    order: decays near 1, offsets across many magnitudes, a zero A (a reset)."""
    rng = np.random.default_rng(5)
    a = (1.0 - rng.random((2, ntiles)) * 1e-3).astype(np.float32)
    b = (rng.standard_normal((2, ntiles)) * 10.0 ** rng.integers(-4, 5, (2, ntiles))
         ).astype(np.float32)
    a[1, 17] = 0.0
    return torch.from_numpy(a), torch.from_numpy(b)


def _compose_exclusive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each tile's entering state from the maps composed into one another first,
    (A_l, B_l) ∘ (A_r, B_r) = (A_l·A_r, A_r·B_l + B_r), as a tree of pairs, then
    applied to 0: the order a textbook look-back may take, for the contrast."""
    def tree(pa, pb):
        while pa.shape[-1] > 1:
            if pa.shape[-1] % 2:
                pa = torch.cat([pa, torch.ones_like(pa[..., :1])], -1)
                pb = torch.cat([pb, torch.zeros_like(pb[..., :1])], -1)
            pa, pb = pa[..., 0::2] * pa[..., 1::2], pa[..., 1::2] * pb[..., 0::2] + pb[..., 1::2]
        return pb[..., 0]
    out = torch.zeros_like(b)
    for j in range(1, b.shape[-1]):
        out[:, j] = tree(a[:, :j], b[:, :j])
    return out


def test_affine_fold_is_the_same_bits_under_every_schedule():
    """Every schedule gives the strict fold's bits, which is the state a walk of
    the tiles in order carries; composing the maps as a tree rounds otherwise."""
    a, b = _maps(48)
    want = lookback.fold_exclusive(b, mults=a)
    for stops in _schedules(48, 60, seed=9):
        assert torch.equal(lookback.fold_exclusive(b, stops=stops, mults=a), want)
    y = torch.zeros_like(b[:, 0])
    for j in range(b.shape[-1]):                    # the strict fold, written out
        assert torch.equal(want[:, j], y)
        y = a[:, j] * y + b[:, j]
    assert torch.equal(want[1, 18], b[1, 17])       # a zero A resets the state
    assert not torch.equal(_compose_exclusive(a, b), want)


@pytest.mark.parametrize("tile", TILES)
def test_tiles_linked_by_the_fold_are_the_untiled_scan(tile):
    """Integer-valued pairs: the plain single-pass model equals the one ordered
    walk at every tile, with the fold stopping anywhere."""
    a, b = (torch.from_numpy(x) for x in _pair("int"))
    whole = linrec_mm.linrec_scan_tiles_plain(a, b, s=8, acc=torch.float32)
    got = linrec_mm.linrec_scan_tiles_plain(a, b, s=8, acc=torch.float32, tile=tile)
    assert torch.equal(got, whole)
    nt = -(-NMAX // tile)
    pad = nt * tile - NMAX
    at = torch.nn.functional.pad(a, (0, pad), value=1.0).reshape(3, nt, tile)
    bt = torch.nn.functional.pad(b, (0, pad)).reshape(3, nt, tile)
    local = linrec_mm.linrec_scan_tiles_plain(at.reshape(-1, tile), bt.reshape(-1, tile), s=8,
                                              acc=torch.float32)[:, -1].reshape(3, nt)
    last_before = whole[:, tile - 1::tile][:, :nt - 1]      # the state leaving each tile
    for stops in _schedules(nt, 10, seed=tile):
        entering = lookback.fold_exclusive(local, stops=stops, mults=at.prod(-1))
        assert torch.equal(entering[:, 1:], last_before)

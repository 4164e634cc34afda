"""The tile algebra of the single-pass B1 and B9 scans against JAX's Pallas kernels.

The CUDA kernels (``csrc/lookback.cuh``) cut each row into tiles, one CTA a
tile, and link them with a decoupled look-back whose fold is strictly left to
right, so that the result does not depend on which tiles had published their
prefix when.  The plain versions model that split with ``tile=``
(``scan_mm.scan_tiles_plain``, ``segscan_mm.seg_scan_tiles_plain``) and
``lookback.fold_exclusive`` evaluates the fold under any look-back schedule.
Here, on the CPU, every tile of 32 and 64 elements (B1: groups of g = 1, 2
and 4 tiles of s×s) must give the Pallas kernels' results
(``repro.kernels.scan_mm.scan_tiles`` / ``segscan_mm.seg_scan_tiles`` in
interpret mode) on rows of 1, tile - 1, tile, tile + 1 and 3·tile + 17
elements: ints and integer-valued fp32 bit-equal, random fp32 within the JAX
tests' ``8·√n`` ulp of the fp64 scan.  A scan's output at an element depends
only on the elements before it, so one JAX call on the longest row serves
every shorter one.  Inputs are drawn with numpy from a seed.
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
from repro.kernels import scan_mm as jax_scan_mm
from repro.kernels import segscan_mm as jax_seg
from repro_torch.kernels import lookback, scan_mm, segscan_mm

CSRC = Path(scan_mm.__file__).parent / "csrc"
TILES = (32, 64)
NMAX = 3 * max(TILES) + 17
KINDS = ["int8", "int32", "f32int", "f32rand"]
_NP = {"int8": np.int8, "int32": np.int32}
# B1: (tile, s), groups of g = tile / s² tiles
B1_SPLITS = [(32, 4), (64, 8), (64, 4)]
LAYOUTS = ["spanning", "tile_first", "none", "all", "random", "shared"]


def _rows(tile):
    return (1, tile - 1, tile, tile + 1, 3 * tile + 17)


@functools.lru_cache(maxsize=None)
def _values(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "f32rand":
        return rng.standard_normal((3, NMAX)).astype(np.float32)
    if kind == "f32int":
        return rng.integers(-8, 9, (3, NMAX)).astype(np.float32)
    return rng.integers(-100, 101, (3, NMAX)).astype(_NP[kind])


@functools.lru_cache(maxsize=None)
def _flags(layout: str) -> np.ndarray:
    """int8 segment starts: segments spanning several tiles, a flag on every
    tile's first element, none, every element, random, or one row of flags
    shared by the rows (shape ``(NMAX,)``)."""
    rng = np.random.default_rng(7)
    f = np.zeros((3, NMAX), np.int8)
    if layout == "spanning":
        f[:, ::100] = 1
    elif layout == "tile_first":
        f[:, ::min(TILES)] = 1
    elif layout == "all":
        f[:] = 1
    elif layout == "random":
        f[:] = rng.random((3, NMAX)) < 0.05
    elif layout == "shared":
        return (rng.random(NMAX) < 0.03).astype(np.int8)
    return f


@functools.lru_cache(maxsize=None)
def _jax_b1(kind: str, s: int, variant: str) -> np.ndarray:
    return np.asarray(jax_scan_mm.scan_tiles(jnp.asarray(_values(kind)), s=s, variant=variant))


@functools.lru_cache(maxsize=None)
def _jax_b9(kind: str, layout: str) -> np.ndarray:
    return np.asarray(jax_seg.seg_scan_tiles(jnp.asarray(_values(kind)),
                                             jnp.asarray(_flags(layout)), s=8))


def _seg_ref(x: np.ndarray, f: np.ndarray) -> np.ndarray:
    """fp64 per-segment inclusive scan of ``x`` under the nonzero ``f``."""
    x = np.asarray(x, np.float64)
    f = np.broadcast_to(f, x.shape)
    pos = np.broadcast_to(np.arange(x.shape[-1]), x.shape)
    start = np.maximum.accumulate(np.where(f != 0, pos, 0), axis=-1)
    full = np.cumsum(x, axis=-1)
    return full - np.take_along_axis(full - x, start, axis=-1)


def _hold(kind, port: np.ndarray, jax: np.ndarray, ref: np.ndarray, scale: np.ndarray):
    """Bit-equal to JAX, or for random fp32 both within JAX's ulp bound."""
    assert port.dtype == jax.dtype and port.shape == jax.shape
    if kind == "f32rand":
        bound = ulp.ulp_bound("highest", port.shape[-1])
        assert ulp.max_ulp(port, ref, scale) <= bound
        assert ulp.max_ulp(jax, ref, scale) <= bound
    else:
        np.testing.assert_array_equal(port, jax)


def test_geometry_matches_the_kernel_sources():
    """The wrappers size the look-back's workspace from these constants."""
    scan_src = (CSRC / "scan_tile.cuh").read_text()
    seg_src = (CSRC / "seg_pass.cuh").read_text()
    for src, name, value in ((scan_src, "kScanThreads", scan_mm.SCAN_THREADS),
                             (scan_src, "kScanItems", scan_mm.SCAN_ITEMS),
                             (seg_src, "kSegPassThreads", segscan_mm.SEG_SCAN_THREADS),
                             (seg_src, "kSegPassItems", segscan_mm.SEG_SCAN_ITEMS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name


def test_many_ctas_a_row_at_the_main_shape():
    """At (4, 2^24) B1 runs 1024 CTAs a row (one 128×128 tile each; 64 tiles of
    16×16 at s = 16) and B9 2048 (8192 elements each); the workspaces are
    32 KB and 64 KB plus the counter.  The sampler's (1, 513024) row is 63
    tiles of B9."""
    n = 1 << 24
    assert scan_mm.group_geometry(128, n) == (1, 16384, 1024)
    assert scan_mm.group_geometry(16, n) == (64, 16384, 1024)
    assert segscan_mm.seg_scan_tile(n) == 8192
    assert 4 * scan_mm.group_geometry(128, n)[2] * 8 == 32 * 1024
    assert 4 * (n // segscan_mm.seg_scan_tile(n)) * 8 == 64 * 1024
    assert -(-513024 // segscan_mm.seg_scan_tile(513024)) == 63


@pytest.mark.parametrize("s", [1, 2, 3, 4, 8, 16, 32, 33, 64, 65, 100, 128])
def test_group_geometry_fits_a_cta(s):
    """At most 512 threads a CTA, 32 elements a thread, 2048 rows of the group's
    row sums and one group of whole tiles; short rows take fewer tiles."""
    g, elems, groups = scan_mm.group_geometry(s, 1 << 20)
    assert elems == g * s * s and 1 <= g <= scan_mm.SCAN_THREADS and g * s <= 2048
    assert groups == -(-(1 << 20) // elems)
    assert scan_mm.group_geometry(s, 1)[:2] == (1, s * s)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", ["scanu", "scanul1"])
@pytest.mark.parametrize("row", range(5))
@pytest.mark.parametrize("tile,s", B1_SPLITS)
def test_b1_split_matches_jax(tile, s, row, variant, kind):
    n = _rows(tile)[row]
    x = _values(kind)[:, :n]
    got = scan_mm.scan_tiles_plain(torch.from_numpy(np.ascontiguousarray(x)), s=s,
                                   variant=variant,
                                   acc=torch.int32 if kind.startswith("int") else torch.float32,
                                   tile=tile).numpy()
    _hold(kind, got, _jax_b1(kind, s, variant)[:, :n], ulp.scan_ref(x), ulp.scan_scale(x))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("row", range(5))
@pytest.mark.parametrize("tile", TILES)
def test_b9_split_matches_jax(tile, row, layout, kind):
    """Segments across tile edges, a flag on each tile's first element, rows
    with no flag and with every flag, and flags shared by the rows."""
    n = _rows(tile)[row]
    x = _values(kind)[:, :n]
    f = _flags(layout)[..., :n]
    got = segscan_mm.seg_scan_tiles_plain(
        torch.from_numpy(np.ascontiguousarray(x)),
        torch.from_numpy(np.broadcast_to(f, x.shape) != 0), s=4,
        acc=torch.int32 if kind.startswith("int") else torch.float32, tile=tile).numpy()
    _hold(kind, got, _jax_b9(kind, layout)[:, :n], _seg_ref(x, f), ulp.scan_scale(x))


# ---- the fold under look-back schedules ----

def _schedules(ntiles: int, count: int, seed: int):
    """Random look-back schedules: for each tile, the predecessor whose prefix it
    found published (-1: none)."""
    rng = np.random.default_rng(seed)
    return [[int(rng.integers(-1, j)) if j else -1 for j in range(ntiles)]
            for _ in range(count)]


def _tree_exclusive(values: torch.Tensor) -> torch.Tensor:
    """Each tile's exclusive prefix as a pairwise tree sum of the aggregates: the
    order a textbook look-back may take, for the contrast."""
    def tree(v):
        while v.shape[-1] > 1:
            if v.shape[-1] % 2:
                v = torch.cat([v, torch.zeros_like(v[..., :1])], -1)
            v = v[..., 0::2] + v[..., 1::2]
        return v[..., 0]
    out = torch.zeros_like(values)
    for j in range(1, values.shape[-1]):
        out[:, j] = tree(values[:, :j])
    return out


def _rounding_sensitive(ntiles: int) -> torch.Tensor:
    """fp32 aggregates whose running sum rounds differently in a tree: ones
    and halves of an ulp of 1, and a large value that absorbs them."""
    v = np.full((2, ntiles), 2.0 ** -24, np.float32)
    v[:, 0] = 1.0
    v[1, ::5] = 3.0
    v[1, 7] = -2.0 ** 20
    return torch.from_numpy(v)


@pytest.mark.parametrize("operator", ["sum", "segmented"])
def test_fold_is_the_same_bits_under_every_schedule(operator):
    """B9's operator and B1's sum: every schedule gives the strict fold's bits,
    while a tree sum of the same aggregates rounds differently."""
    values = _rounding_sensitive(40)
    flags = None
    if operator == "segmented":
        flags = torch.zeros(values.shape, dtype=torch.bool)
        flags[:, 19] = True
        flags[1, 33] = True
    want = lookback.fold_exclusive(values, flags)
    for stops in _schedules(40, 50, seed=3):
        assert torch.equal(lookback.fold_exclusive(values, flags, stops), want)
    if operator == "sum":
        assert not torch.equal(_tree_exclusive(values), want)
        start = torch.zeros_like(values[:, 0])
        for j in range(values.shape[-1]):          # the strict fold, written out
            assert torch.equal(want[:, j], start)
            start = start + values[:, j]


@pytest.mark.parametrize("tile,s", [(16, 4), (32, 4), (256, 8)])
def test_b1_group_prefix_is_its_aggregate_added_once(tile, s):
    """B1 at g = 1 and g > 1: a group publishes P_k = P_{k-1} + A_k, with A_k
    folded from 0 over its g tile totals, so the look-back's fold of the A's
    is the plain model's carry under every schedule.  Replaying the g totals
    onto P_{k-1} instead would round differently from P_{k-1} + A_k, so a
    successor that folded A's onto a replayed prefix would depend on timing."""
    g = tile // (s * s)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 6 * tile)) * np.where(rng.random((2, 6 * tile)) < 0.1, 1e6,
                                                        1.0)).astype(np.float32)
    xt = torch.from_numpy(x)
    out = scan_mm.scan_tiles_plain(xt, s=s, variant="scanul1", acc=torch.float32, tile=tile)
    local = scan_mm.scan_tiles_plain(xt.reshape(-1, tile), s=s, variant="scanul1",
                                     acc=torch.float32, tile=tile).reshape(2, 6, tile)
    aggregates = local[..., -1]        # A_k: the group's last element with no carry
    for stops in _schedules(6, 30, seed=5):
        carry = lookback.fold_exclusive(aggregates, stops=stops)
        # each group's first tile carries P_{k-1} + E_0 = P_{k-1} + 0
        assert torch.equal(out.reshape(2, 6, tile)[..., :s * s],
                           local[..., :s * s] + carry[..., None])
    if g > 1:
        totals = torch.full((1, g), 2.0 ** -24)
        p_prev = torch.tensor([1.0])
        replay, a = p_prev.clone(), torch.zeros(1)
        for i in range(g):
            replay = replay + totals[:, i]
            a = a + totals[:, i]
        assert not torch.equal(replay, p_prev + a)

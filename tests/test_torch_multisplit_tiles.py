"""The tile algebra of the B6 multi-way split against JAX's Pallas split.

On R ≤ ``split_mm.MULTI_SPLIT_TILE_MAX_BUCKETS`` buckets the CUDA kernel
(``csrc/multi_split.cu``) runs B7's tile split (``csrc/radix_pass.cuh``) on
``R + 1`` slots: each tile's slot counts, their exclusive scan over the tiles
with the slot totals, each element's in-tile rank plus its tile's base.  The
plain version ``split_mm.multi_split_plain(tile=)`` runs the same phases on
any tile, so here, on the CPU, tiles of 32 and 64 elements must give the
payload, permutation and counts of the Pallas kernel
(``repro.kernels.split_mm.multi_split_tiles`` in interpret mode) bit for bit,
on rows of 1, tile - 1, tile, tile + 1 and 3·tile + 17 elements, for
R ∈ {1, 2, 5, 16, 33} and fp32, bf16 and int32 payloads.  The Pallas kernel
splits each row on its own and its wrapper pads a row with digit R - 1, which
lands at the row's tail; so every row length is one row of a single call on
rows padded that way to the longest length, and its result is the head of
that row, its count of R - 1 less the padding.  Digits outside ``[0, R)``
are held against a stable argsort of the slot digits instead: the kernel puts
them after every bucket, the Pallas kernel on index 0 (the documented
difference).  Inputs are drawn with numpy from a seed.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import split_mm as jax_split_mm
from repro_torch.kernels import split_mm

TILES = (32, 64)
ROWS = sorted({n for t in TILES for n in (1, t - 1, t, t + 1, 3 * t + 17)})
NMAX = max(ROWS)
BUCKETS = (1, 2, 5, 16, 33)
PAYLOADS = ("float32", "bfloat16", "int32")


def _payload(kind: str, x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if kind == "bfloat16" else t


@functools.lru_cache(maxsize=None)
def _inputs(r: int, kind: str):
    """One (2, n) payload and in-range digit row pair per row length, rows of
    equal digits across the tile edges."""
    rng = np.random.default_rng(r)
    out = {}
    for n in ROWS:
        if kind == "int32":
            x = rng.integers(-2 ** 30, 2 ** 30, (2, n)).astype(np.int32)
        else:
            x = rng.standard_normal((2, n)).astype(np.float32)
        d = rng.integers(0, r, (2, n)).astype(np.int32)
        for t in TILES:
            for edge in range(t, n, t):
                d[:, max(edge - 3, 0):edge + 3] = d[:, max(edge - 3, 0)][:, None]
        out[n] = (x, d)
    return out


@functools.lru_cache(maxsize=None)
def _jax_split(r: int, kind: str):
    """The Pallas split of every row length in one interpret-mode call: the
    rows padded to NMAX with digit R - 1, as its wrapper pads; per length the
    head of each row and the counts less the padding."""
    inputs = _inputs(r, kind)
    xs = np.concatenate([np.pad(x, ((0, 0), (0, NMAX - n))) for n, (x, _) in inputs.items()])
    ds = np.concatenate([np.pad(d, ((0, 0), (0, NMAX - n)), constant_values=r - 1)
                         for n, (_, d) in inputs.items()])
    xj = jnp.asarray(xs)
    if kind == "bfloat16":
        xj = xj.astype(jnp.bfloat16)
    z, ind, cnt = jax_split_mm.multi_split_tiles(xj, jnp.asarray(ds), num_buckets=r, s=8)
    z = np.asarray(z.astype(jnp.float32)) if kind == "bfloat16" else np.asarray(z)
    ind, cnt = np.asarray(ind), np.asarray(cnt).copy()
    out = {}
    for i, n in enumerate(inputs):
        rows = slice(2 * i, 2 * i + 2)
        c = cnt[rows].copy()
        c[:, -1] -= NMAX - n
        out[n] = (z[rows, :n], ind[rows, :n], c)
    return out


def _numpy(out, kind):
    z, ind, cnt = out
    return (z.float().numpy() if kind == "bfloat16" else z.numpy()), ind.numpy(), cnt.numpy()


def test_ceiling_matches_the_kernel_source():
    """The tile split takes R + 1 slots, one downsweep thread a slot (512
    threads), so R ≤ 511; above it the wrapper passes no scratch and the
    kernel runs one CTA a row."""
    src = (Path(split_mm.__file__).parent / "csrc" / "multi_split.cu").read_text()
    radix = (Path(split_mm.__file__).parent / "csrc" / "radix_pass.cuh").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", radix).group(1))
    assert re.search(r"constexpr int kTileMaxBuckets = kThreads - 1;", src)
    assert split_mm.MULTI_SPLIT_TILE_MAX_BUCKETS == threads - 1 == 511
    assert "return radix <= kTileMaxBuckets" in src
    assert "upsweep_kernel<int, SlotDigit>" in src and "scan_kernel<<<" in src
    assert "atomicAdd(" not in src                       # no global atomics
    assert split_mm.MULTI_SPLIT_TILE_MAX_BUCKETS < split_mm.MULTI_SPLIT_MAX_BUCKETS


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("kind", PAYLOADS)
@pytest.mark.parametrize("r", BUCKETS)
def test_tile_split_matches_jax(r, kind, n):
    """Payload, permutation and counts of tiles of 32 and 64, and of the whole
    row as one tile, equal the Pallas split's and a stable argsort's."""
    x, d = _inputs(r, kind)[n]
    want = _jax_split(r, kind)[n]
    xt, dt = _payload(kind, x), torch.from_numpy(d)
    for tile in TILES + (None,):
        got = _numpy(split_mm.multi_split_plain(xt, dt, r, tile=tile), kind)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    order = np.argsort(d, axis=-1, kind="stable")
    np.testing.assert_array_equal(want[1], order)
    np.testing.assert_array_equal(want[2], np.stack([np.bincount(row, minlength=r) for row in d]))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("r", BUCKETS)
def test_out_of_range_digits_go_last(r, tile):
    """Digits below 0 and at or above R take the extra slot R: after every
    bucket, in order, uncounted: a stable argsort of the slot digits."""
    rng = np.random.default_rng(100 + r)
    for n in (1, tile - 1, tile, tile + 1, 3 * tile + 17):
        x = rng.standard_normal((3, n)).astype(np.float32)
        d = rng.integers(-3, r + 3, (3, n)).astype(np.int32)
        z, ind, cnt = split_mm.multi_split_plain(torch.from_numpy(x), torch.from_numpy(d), r,
                                                 tile=tile)
        slot = np.where((d >= 0) & (d < r), d, r)
        order = np.argsort(slot, axis=-1, kind="stable")
        np.testing.assert_array_equal(ind.numpy(), order)
        np.testing.assert_array_equal(z.numpy(), np.take_along_axis(x, order, -1))
        np.testing.assert_array_equal(
            cnt.numpy(), np.stack([np.bincount(row, minlength=r + 1)[:r] for row in slot]))

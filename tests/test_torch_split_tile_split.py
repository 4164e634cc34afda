"""The tile split of B5 (SplitInd) against JAX's Pallas split.

On the card B5 (``csrc/split.cu``) is B6's tile split on two slots, the flag
as the digit (slot 0 for a true, 1 for a false): each tile's trues and
falses, their exclusive scan over the tiles with the row totals (slot 0's is
``n_true``), each element's in-tile rank plus its tile's base.  The plain
version ``split_mm.split_plain(tile=)`` runs the same phases on any tile, so
here, on the CPU, tiles of 4096 (the kernel's, ``split_mm.RADIX_TILE``) and
of 32 must give the payload, permutation and ``n_true`` of the untiled plain
version and of the Pallas kernel (``repro.kernels.split_mm.split_tiles`` in
interpret mode) bit for bit, on rows of 1, 31, 4095, 4096, 4097 and
3·4096 + 17 elements, each batch a random, an all-true and an all-false row,
for int8, bf16, fp32 and int64 payloads.  The Pallas kernel splits each row
on its own and pads it with false flags, which land at the row's tail; so
every row length is three rows of one call on rows padded that way to the
longest length, and its result is the head of those rows.  JAX runs without
64-bit types, so for int64 payloads the payload is held to the JAX
permutation applied to it.  Nonzero flags other than 1 count as true in the
port (the documented difference from the Pallas kernel, which takes exactly
1): they are held against JAX's split of the same flags made boolean.  Inputs
are drawn with numpy from a seed.
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

TILE = split_mm.RADIX_TILE
ROWS = (1, 31, TILE - 1, TILE, TILE + 1, 3 * TILE + 17)
NMAX = max(ROWS)
PAYLOADS = ("int8", "bfloat16", "float32", "int64")


def _payload(kind: str, rng, shape) -> np.ndarray:
    if kind == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    if kind == "int64":
        return rng.integers(-(1 << 40), 1 << 40, shape)
    return rng.standard_normal(shape).astype(np.float32)


def _torch(kind: str, x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if kind == "bfloat16" else t


@functools.lru_cache(maxsize=None)
def _inputs(kind: str):
    """Per row length a (3, n) payload and int8 flags: nonzero values 1, 2 and
    -1 at random in row 0, all true in row 1, all false in row 2."""
    rng = np.random.default_rng(len(kind))
    out = {}
    for n in ROWS:
        x = _payload(kind, rng, (3, n))
        f = (rng.random((3, n)) < 0.5) * rng.choice(np.array([1, 2, -1], np.int8), (3, n))
        f[1], f[2] = 1, 0
        out[n] = (x, f.astype(np.int8))
    return out


@functools.lru_cache(maxsize=None)
def _jax_split(kind: str):
    """The Pallas split of every row length in one interpret-mode call, on the
    flags made 0/1: rows padded to NMAX with false flags; per length the head
    of its three rows."""
    inputs = _inputs(kind)
    xs = np.concatenate([np.pad(x, ((0, 0), (0, NMAX - n))) for n, (x, _) in inputs.items()])
    fs = np.concatenate([np.pad(f != 0, ((0, 0), (0, NMAX - n)))
                         for n, (_, f) in inputs.items()])
    if kind == "int64":
        xj = jnp.zeros(xs.shape, jnp.int32)
    else:
        xj = jnp.asarray(xs, jnp.bfloat16 if kind == "bfloat16" else None)
    z, ind, cnt = jax_split_mm.split_tiles(xj, jnp.asarray(fs.astype(np.int8)))
    z = np.asarray(z.astype(jnp.float32)) if kind == "bfloat16" else np.asarray(z)
    ind, cnt = np.asarray(ind), np.asarray(cnt)
    return {n: (z[3 * i:3 * i + 3, :n], ind[3 * i:3 * i + 3, :n], cnt[3 * i:3 * i + 3])
            for i, n in enumerate(inputs)}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_tile_split_matches_the_kernel_source():
    """Two slots on radix_pass.cuh's tiles and scan, the tile the wrapper passes,
    and no global atomics."""
    csrc = Path(split_mm.__file__).parent / "csrc"
    src = (csrc / "split.cu").read_text()
    radix = (csrc / "radix_pass.cuh").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", radix).group(1)) == TILE
    assert '#include "radix_pass.cuh"' in src
    assert "scan_kernel<<<dim3(2, rows)" in src and "tc, tot, tiles, 2)" in src
    assert "tile != kTile || scratch == nullptr" in src
    assert "atomicAdd(" not in src


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("kind", PAYLOADS)
def test_tile_split_matches_plain_and_jax(kind, n):
    """Payload, permutation and n_true of tiles of 4096 and 32 equal the
    untiled plain version's, the Pallas split's and a stable argsort's."""
    x, f = _inputs(kind)[n]
    jz, jind, jcnt = _jax_split(kind)[n]
    xt, ft = _torch(kind, x), torch.from_numpy(f != 0)
    want = split_mm.split_plain(xt, ft)
    for tile in (TILE, 32):
        got = split_mm.split_plain(xt, ft, tile=tile)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    z, ind, cnt = want
    np.testing.assert_array_equal(ind.numpy(), jind)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    np.testing.assert_array_equal(cnt.numpy(), (f != 0).sum(-1))
    np.testing.assert_array_equal(ind.numpy(), np.argsort(f == 0, axis=-1, kind="stable"))
    np.testing.assert_array_equal(_numpy(z), np.take_along_axis(_numpy(xt), jind, -1))
    if kind != "int64":
        np.testing.assert_array_equal(_numpy(z), jz)


@pytest.mark.parametrize("kind", ("int8", "float32"))
def test_split_tiles_takes_nonzero_flags_as_true(kind):
    """The wrapper (the plain version on the CPU) casts flags to bool: flags of
    2 and -1 split as 1 does, as the Pallas split of the boolean flags."""
    n = 3 * TILE + 17
    x, f = _inputs(kind)[n]
    jz, jind, jcnt = _jax_split(kind)[n]
    z, ind, cnt = split_mm.split_tiles(_torch(kind, x), torch.from_numpy(f))
    np.testing.assert_array_equal(ind.numpy(), jind)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    np.testing.assert_array_equal(_numpy(z), jz)
    assert set(np.unique(f[0])) == {-1, 0, 1, 2}

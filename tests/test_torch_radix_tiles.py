"""The tile algebra of the B7/B7h radix pass against JAX's Pallas pass.

The CUDA kernels (``csrc/radix_pass.cuh``) cut each row into tiles of
``split_mm.RADIX_TILE`` keys and run three phases: each tile's digit counts,
bucket-major ``(b, R, T)``; their exclusive scan over the tiles with the
bucket totals; each key's in-tile rank plus its tile's base.  The plain
version ``split_mm.radix_pass_plain`` runs the same phases with any
``tile=``, so here, on the CPU, every tile must give the keys, permutation and
bucket totals of the Pallas pass (``repro.kernels.split_mm.radix_pass_multibit``
in interpret mode), of the one-hot form the plain version had before it was
cut into tiles (one tile the whole row) and of a stable sort of the digits,
bit for bit: on rows that end before, at and after a tile edge,
with runs of equal keys across the edges, for 1-, 4- and 8-bit digits of 8-,
16- and 32-bit keys.  Keys are drawn with numpy from a seed.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.kernels import split_mm as jax_split_mm
from repro_torch.kernels import split_mm

TILE = split_mm.RADIX_TILE
TILES = (32, 64, TILE)
# the port's key words (as numpy views) and the unsigned words the Pallas pass takes
WORDS = {"uint8": (np.uint8, np.uint8), "int16": (np.int16, np.uint16),
         "int32": (np.int32, np.uint32)}
ROWS = (1, 3 * 32 + 17, 3 * 64 + 17, TILE - 1, TILE, TILE + 1, 3 * TILE + 17)


def _keys(word: str, n: int, seed: int) -> np.ndarray:
    """(2, n) unsigned keys with runs of equal keys across every tile edge of TILES."""
    rng = np.random.default_rng(seed)
    udt = WORDS[word][1]
    w = rng.integers(0, np.iinfo(udt).max, (2, n), endpoint=True, dtype=np.uint64).astype(udt)
    for t in TILES:
        for edge in range(t, n, t):
            w[:, max(edge - 5, 0):edge + 5] = w[:, max(edge - 5, 0)][:, None]
    return w


def _jax_pass(w: np.ndarray, perm: np.ndarray, shift: int, bits: int):
    """The Pallas pass (interpret mode) as its callers run it: rows padded to its
    tile side with all-ones keys, which sort last, then trimmed; the pad is taken
    out of bucket 2^k - 1."""
    s = 16
    n = w.shape[-1]
    pad = -n % s
    wp = np.pad(w, ((0, 0), (0, pad)), constant_values=np.iinfo(w.dtype).max)
    pp = np.pad(perm, ((0, 0), (0, pad)))
    jw, jp, jc = jax_split_mm.radix_pass_multibit(jnp.asarray(wp), jnp.asarray(pp),
                                                  shift=shift, pass_bits=bits, s=s,
                                                  with_counts=True)
    jc = np.asarray(jc).copy()
    jc[:, -1] -= pad
    return np.asarray(jw)[:, :n], np.asarray(jp)[:, :n], jc


def test_tile_matches_the_kernel_source():
    """The wrapper sizes the kernels' scratch from RADIX_TILE; the kernels check it."""
    src = Path(split_mm.__file__).parent / "csrc" / "radix_pass.cuh"
    m = re.search(r"constexpr int kTile = (\d+);", src.read_text())
    assert m is not None and int(m.group(1)) == TILE


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("word", list(WORDS))
def test_tile_split_matches_jax_pass(word, bits, n):
    """Keys, permutation and B7h's totals of every tile equal the Pallas pass's,
    the one-hot form's (one tile a row), a stable sort's of the digits and
    (totals) a bincount of the digits."""
    port_dt, udt = WORDS[word]
    key_bits = 8 * np.dtype(udt).itemsize
    shift = key_bits - bits - (bits == 1)          # the top digit, or one below it
    w = _keys(word, n, seed=n * 31 + bits)
    perm = np.random.default_rng(n).permutation(n).astype(np.int32)[None].repeat(2, 0)
    jw, jp, jc = _jax_pass(w, perm, shift, bits)

    tw = torch.from_numpy(w.view(port_dt))
    tp = torch.from_numpy(perm)
    digits = (w.astype(np.int64) >> shift) & ((1 << bits) - 1)
    hist = np.stack([np.bincount(r, minlength=1 << bits) for r in digits])
    np.testing.assert_array_equal(jc, hist)
    order = torch.sort(torch.from_numpy(digits), dim=-1, stable=True).indices
    results = {"one_hot": split_mm.radix_pass_plain(tw, tp, shift=shift, pass_bits=bits,
                                                    with_counts=True, tile=n),
               "stable_sort": (tw.gather(1, order), tp.gather(1, order),
                               torch.from_numpy(hist.astype(np.int32))),
               "wrapper": split_mm.radix_pass_multibit(tw, tp, shift=shift, pass_bits=bits,
                                                       with_counts=True)}
    for t in TILES:
        results[f"tile={t}"] = split_mm.radix_pass_plain(tw, tp, shift=shift, pass_bits=bits,
                                                         with_counts=True, tile=t)
    for name, (kw, kp, kc) in results.items():
        np.testing.assert_array_equal(kw.numpy().view(udt), jw, err_msg=f"{name}: keys")
        np.testing.assert_array_equal(kp.numpy(), jp, err_msg=f"{name}: permutation")
        np.testing.assert_array_equal(kc.numpy(), jc, err_msg=f"{name}: counts")


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("tile", TILES)
def test_tile_phases(tile, bits, b):
    """Each phase alone: the (b, R, T) tile histograms, their exclusive scan over
    the tiles with the bucket totals, and destinations that are the untiled
    stable split's."""
    radix = 1 << bits
    n = 3 * tile + 17
    rng = np.random.default_rng(tile + bits + b)
    d = rng.integers(0, radix, (b, n))
    d[:, tile - 3:tile + 3] = d[:, tile - 3:tile - 2]          # a run across an edge
    digits = torch.from_numpy(d)

    hist = split_mm._radix_tile_hist(digits, radix, tile)
    tiles = -(-n // tile)
    want = np.zeros((b, radix, tiles), np.int32)
    for r in range(b):
        for t in range(tiles):
            want[r, :, t] = np.bincount(d[r, t * tile:(t + 1) * tile], minlength=radix)
    assert hist.dtype == torch.int32
    np.testing.assert_array_equal(hist.numpy(), want)

    tile_base, totals = split_mm._radix_tile_scan(hist)
    np.testing.assert_array_equal(tile_base.numpy(), np.cumsum(want, -1) - want)
    np.testing.assert_array_equal(totals.numpy(), want.sum(-1))

    dest = split_mm._radix_tile_dest(digits, tile_base, totals, tile).numpy()
    stable = np.argsort(d, axis=-1, kind="stable")             # element at each slot
    want_dest = np.empty_like(stable)
    np.put_along_axis(want_dest, stable, np.arange(n)[None].repeat(b, 0), axis=-1)
    np.testing.assert_array_equal(dest, want_dest)

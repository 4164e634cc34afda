"""The port's multi-way split (B6) on every method against the JAX package, on the CPU.

Payloads and digits are drawn with numpy from a seed.  The reference is the JAX
package's ``multi_split(method="kernel", tile_s=16)``, which runs the Pallas
kernel in interpret mode.  A stable split has one right answer, so the port's
payload, permutation and counts must equal it bit for bit on every method; on
CPU tensors ``method="kernel"`` runs B6's plain version.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.core.primitives import multi_split as jax_multi_split
from repro.kernels import split_mm as jax_split_mm
from repro_torch.core import primitives as P
from repro_torch.kernels import ops, split_mm

METHODS = ("vector", "matmul", "blocked", "kernel")
S = 16


def _jax(x, d, r, **kw):
    out = jax_multi_split(jnp.asarray(x), jnp.asarray(d), r, method="kernel", tile_s=S, **kw)
    return [np.asarray(o) for o in out]


def _port(x, d, r, method, **kw):
    out = P.multi_split(torch.from_numpy(x), torch.from_numpy(d), r, method=method,
                        tile_s=S, **kw)
    return [o.numpy() for o in out]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("method", METHODS)
def test_multi_split_matches_stable_argsort_and_jax(method):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(77).astype(np.float32)
    d = rng.integers(0, 8, 77).astype(np.int32)
    got = _port(x, d, 8, method)
    _equal(got, _jax(x, d, 8))
    order = np.argsort(d, kind="stable")
    _equal(got, [x[order], order.astype(np.int32), np.bincount(d, minlength=8)])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("r", [3, 16, 40])
def test_multi_split_batched_ragged(method, r):
    """(2, 3, 333): leading batch dims, a length no multiple of the tile, R not a power
    of two, and R = 40 with buckets left empty."""
    rng = np.random.default_rng(r)
    x = rng.integers(-1000, 1000, (2, 3, 333)).astype(np.int32)
    d = rng.integers(0, min(r, 30), (2, 3, 333)).astype(np.int32)
    got = _port(x, d, r, method)
    assert got[2].shape == (2, 3, r)
    _equal(got, _jax(x, d, r))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("digits", [[3, 3, 3, 3, 3], [0, 0, 0, 0, 0], [2, 0, 2, 0, 2]])
def test_multi_split_empty_and_full_buckets(method, digits):
    x = np.arange(5, dtype=np.int32)
    d = np.asarray(digits, np.int32)
    got = _port(x, d, 4, method)
    _equal(got, _jax(x, d, 4))
    assert int(got[2].sum()) == 5


@pytest.mark.parametrize("method", METHODS)
def test_multi_split_single_bucket_is_identity(method):
    x = np.asarray([5, 1, 7], np.int32)
    d = np.zeros(3, np.int32)
    got = _port(x, d, 1, method)
    _equal(got, _jax(x, d, 1))
    _equal(got, [x, np.arange(3, dtype=np.int32), np.asarray([3], np.int32)])


@pytest.mark.parametrize("method", METHODS)
def test_multi_split_return_indices_false(method):
    x = np.arange(4, dtype=np.int32)
    d = np.asarray([1, 0, 1, 0], np.int32)
    got = _port(x, d, 2, method, return_indices=False)
    _equal(got, _jax(x, d, 2, return_indices=False))
    np.testing.assert_array_equal(got[0], [1, 3, 0, 2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64, torch.int8, torch.bool])
def test_multi_split_kernel_moves_any_payload(dtype):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 2, (2, 50))).to(dtype)
    d = torch.from_numpy(rng.integers(0, 5, (2, 50)))                    # int64 digits
    z, ind, c = P.multi_split(x, d, 5, method="kernel")
    zv, iv, cv = P.multi_split(x, d, 5, method="vector")
    assert z.dtype == dtype and torch.equal(z, zv) and torch.equal(ind, iv)
    assert torch.equal(c, cv)


def test_multi_split_tiles_module_matches_the_pallas_kernel():
    """B6's wrapper against the Pallas kernel itself, on a row it pads."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 150)).astype(np.float32)
    d = rng.integers(0, 10, (3, 150)).astype(np.int32)
    want = jax_split_mm.multi_split_tiles(jnp.asarray(x), jnp.asarray(d), num_buckets=10,
                                          s=S)
    ops.reset_launch_counts()
    got = split_mm.multi_split_tiles(torch.from_numpy(x), torch.from_numpy(d), num_buckets=10)
    assert ops.launch_counts()["multi_split"] == 0          # CPU tensors: no launch
    _equal([g.numpy() for g in got], [np.asarray(w) for w in want])


def test_multi_split_out_of_range_digits_go_last_uncounted():
    """A digit outside [0, R) goes after every bucket, in order, and is not counted:
    the outputs stay a permutation (the Pallas kernel puts such an element on 0)."""
    x = torch.arange(6, dtype=torch.int32) * 10
    d = torch.tensor([1, -1, 0, 7, 1, 2], dtype=torch.int32)
    z, ind, c = split_mm.multi_split_tiles(x, d, num_buckets=3)
    assert ind.tolist() == [2, 0, 4, 5, 1, 3]
    assert z.tolist() == [20, 0, 40, 50, 10, 30]
    assert c.tolist() == [1, 2, 1]


def test_multi_split_validates():
    x = torch.arange(4, dtype=torch.int32)
    d = torch.tensor([1, 0, 1, 0])
    with pytest.raises(ValueError):
        P.multi_split(x, d, 0, method="kernel")
    with pytest.raises(ValueError):
        P.multi_split(x, d, 2, method="cube")
    with pytest.raises(ValueError):
        P.multi_split(x, d[:3], 2, method="kernel")
    with pytest.raises(ValueError, match="shared memory"):
        split_mm.multi_split_tiles(x, d, num_buckets=split_mm.MULTI_SPLIT_MAX_BUCKETS + 1)
    z, ind, c = split_mm.multi_split_tiles(x, d, num_buckets=split_mm.MULTI_SPLIT_MAX_BUCKETS)
    assert c.shape == (split_mm.MULTI_SPLIT_MAX_BUCKETS,) and int(c.sum()) == 4
    z, ind, c = split_mm.multi_split_tiles(torch.zeros((2, 0)), torch.zeros((2, 0)),
                                           num_buckets=3)
    assert z.shape == (2, 0) and c.tolist() == [[0, 0, 0], [0, 0, 0]]

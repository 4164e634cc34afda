"""The port's ``split``/``compress`` and the B5 module against the JAX package.

Payloads and flags are drawn with numpy from a seed and go through both
packages.  A split is a permutation with one right answer, so ``z``, the
index permutation and ``n_true`` must be bit-identical to the JAX result for
every port method (the JAX package holds all its methods to one answer, so
its ``method="vector"`` is the reference).  JAX runs without 64-bit types, so
for int64 payloads ``z`` is held to the JAX permutation applied to the
payload.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.core.primitives import compress as jax_compress
from repro.core.primitives import split as jax_split
from repro.kernels import split_mm as jax_split_mm
from repro_torch.core import primitives as P
from repro_torch.kernels import ops
from repro_torch.kernels import split_mm as port_split_mm

N = 203                                       # ragged: no multiple of 8, 16 or 128
METHODS = ("vector", "matmul", "blocked", "kernel")
PAYLOADS = ("bool", "int8", "bfloat16", "float32", "int64")


def _payload(dtype: str, shape, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return torch.from_numpy(rng.random(shape) < 0.5)
    if dtype == "int8":
        return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
    if dtype == "int64":
        return torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16) if dtype == "bfloat16" else x


def _to_jax(x: torch.Tensor):
    """The payload as JAX holds it, or ``None`` for int64 (no 64-bit types)."""
    if x.dtype == torch.int64:
        return None
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _flags(shape, seed: int) -> np.ndarray:
    """Bernoulli(0.5) flags; in a batch, one all-true and one all-false row."""
    f = np.random.default_rng(seed).random(shape) < 0.5
    if len(shape) == 2:
        f[1] = True
        f[2] = False
    return f


def _as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _check_split(x, f, z, ind, cnt):
    """``(z, ind, cnt)`` against the JAX split of the same payload and flags."""
    jx = _to_jax(x)
    jz, ji, jc = jax_split(jx if jx is not None else jnp.zeros(x.shape, jnp.int32),
                           jnp.asarray(f), method="vector")
    np.testing.assert_array_equal(ind.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jc))
    assert z.dtype == x.dtype and ind.dtype == torch.int32 and cnt.dtype == torch.int32
    assert cnt.shape == x.shape[:-1]
    np.testing.assert_array_equal(
        _as_np(z), _as_np(torch.gather(x, -1, torch.from_numpy(np.array(ji)).long())))
    if jx is not None:
        np.testing.assert_array_equal(_as_np(z), np.asarray(jz).astype(_as_np(z).dtype))


@pytest.mark.parametrize("shape", [(N,), (3, N)], ids=["1d", "batched"])
@pytest.mark.parametrize("dtype", PAYLOADS)
@pytest.mark.parametrize("method", METHODS)
def test_split_matches_jax(method, dtype, shape):
    x = _payload(dtype, shape, seed=len(shape))
    f = _flags(shape, seed=len(shape) + 10)
    z, ind, cnt = P.split(x, torch.from_numpy(f), method=method, tile_s=8)
    _check_split(x, f, z, ind, cnt)


@pytest.mark.parametrize("method", METHODS)
def test_split_without_indices_matches_jax(method):
    x = _payload("float32", (3, N), seed=1)
    f = _flags((3, N), seed=2)
    z, cnt = P.split(x, torch.from_numpy(f), method=method, tile_s=8, return_indices=False)
    jz, jc = jax_split(jnp.asarray(x.numpy()), jnp.asarray(f), return_indices=False)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jc))


@pytest.mark.parametrize("fill_value", [0, -7])
@pytest.mark.parametrize("dtype", ["int8", "float32", "bool"])
@pytest.mark.parametrize("method", METHODS)
def test_compress_matches_jax(method, dtype, fill_value):
    x = _payload(dtype, (3, N), seed=3)
    fill = bool(fill_value) if dtype == "bool" else fill_value
    m = _flags((3, N), seed=4)
    v, k = P.compress(x, torch.from_numpy(m), method=method, fill_value=fill, tile_s=8)
    jv, jk = jax_compress(_to_jax(x), jnp.asarray(m), method="vector", fill_value=fill)
    assert v.dtype == x.dtype
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))


@pytest.mark.parametrize("n", [1, 7, 64, 130])
@pytest.mark.parametrize("dtype", ["int8", "float32", "bool"])
def test_split_plain_matches_jax_split_tiles(dtype, n):
    """B5's module against the Pallas kernel itself (interpret mode)."""
    x = _payload(dtype, (3, n), seed=n)
    f = _flags((3, n), seed=n + 1)
    jz, ji, jc = jax_split_mm.split_tiles(_to_jax(x), jnp.asarray(f), s=8)
    z, ind, cnt = port_split_mm.split_tiles(x, torch.from_numpy(f))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(ind.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jc))
    pz, pind, pcnt = port_split_mm.split_plain(x, torch.from_numpy(f))
    assert torch.equal(pz, z) and torch.equal(pind, ind) and torch.equal(pcnt, cnt)


def test_split_tiles_shapes_flags_and_launches():
    ops.reset_launch_counts()
    x = torch.arange(10.0)
    z, ind, cnt = port_split_mm.split_tiles(x, torch.tensor([0, 2, 0, 1, 0, 0, 5, 0, 0, 1]))
    assert cnt.shape == () and int(cnt) == 4          # non-zero flags count as true
    assert ind.tolist() == [1, 3, 6, 9, 0, 2, 4, 5, 7, 8]
    assert torch.equal(z, x[ind.long()])
    assert ops.launch_counts()["split"] == 0          # a CPU tensor takes the plain path
    z, ind, cnt = port_split_mm.split_tiles(torch.zeros((2, 0)), torch.zeros((2, 0)))
    assert z.shape == ind.shape == (2, 0) and cnt.tolist() == [0, 0]
    assert port_split_mm.split_tiles(torch.zeros((0, 4)), torch.zeros((0, 4)))[2].shape == (0,)
    with pytest.raises(ValueError):
        port_split_mm.split_tiles(x, torch.ones(9, dtype=torch.bool))
    with pytest.raises(ValueError):
        P.split(x, torch.ones(9, dtype=torch.bool), method="vector")

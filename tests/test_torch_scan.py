"""The port's scan (``repro_torch.core.scan``) and B1 module against the JAX package.

Inputs are drawn with numpy from a seed and go through both packages.
Integer payloads, and fp32 payloads holding small integers, must be
bit-identical to the JAX result for every method, variant and tile size;
random fp32 must stay within the JAX package's ``8·√n``-ulp bound against the
fp64 reference (``repro.analysis.ulp``), as the JAX scans are held.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import ulp
from repro.core.scan import accum_dtype_for as jax_accum_dtype_for
from repro.core.scan import scan as jax_scan
from repro.kernels import scan_mm as jax_scan_mm
from repro_torch.core import scan as port_scan
from repro_torch.core.scan import accum_dtype_for
from repro_torch.kernels import scan_mm as port_scan_mm

N = 777                                       # ragged: not a multiple of any tile

_NP = {"int8": np.int8, "int32": np.int32, "float32": np.float32}


@functools.lru_cache(maxsize=None)
def _input(kind: str, n: int = N, rows: int = 3, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "f32rand":
        return rng.standard_normal((rows, n)).astype(np.float32)
    if kind == "f32int":
        return rng.integers(-8, 9, (rows, n)).astype(np.float32)
    return rng.integers(-100, 101, (rows, n)).astype(_NP[kind])


def _both(x, **kw):
    j = np.asarray(jax_scan(jnp.asarray(x), **kw))
    t = port_scan(torch.from_numpy(x), **kw).numpy()
    return j, t


def _check(kind, j, t, x, n):
    assert j.dtype == t.dtype
    if kind == "f32rand":
        bound = ulp.ulp_bound("highest", n)
        ref, sc = ulp.scan_ref(x), ulp.scan_scale(x)
        assert ulp.max_ulp(t, ref, sc) <= bound
        assert ulp.max_ulp(j, ref, sc) <= bound
    else:
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kind", ["int8", "int32", "f32int", "f32rand"])
@pytest.mark.parametrize("tile_s", [8, 16])
@pytest.mark.parametrize("variant", ["scanu", "scanul1"])
@pytest.mark.parametrize("method", ["vector", "matmul", "kernel"])
def test_scan_matches_jax(method, variant, tile_s, kind):
    x = _input(kind)
    j, t = _both(x, method=method, variant=variant, tile_s=tile_s)
    _check(kind, j, t, x, N)


@pytest.mark.parametrize("method", ["matmul", "kernel"])
@pytest.mark.parametrize("opts", [dict(exclusive=True), dict(reverse=True),
                                  dict(exclusive=True, reverse=True)],
                         ids=["exclusive", "reverse", "exclusive-reverse"])
def test_scan_exclusive_reverse_match_jax(method, opts):
    x = _input("int32")
    j, t = _both(x, method=method, tile_s=8, **opts)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("method", ["vector", "matmul", "kernel"])
def test_scan_other_axis_matches_jax(method):
    x = _input("int8", n=40, rows=6).reshape(2, 3, 40).transpose(2, 0, 1).copy()
    j, t = _both(x, axis=0, method=method, tile_s=8)
    assert t.shape == x.shape
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("n", [1, 5, 8, 64, 65])
def test_scan_short_rows_match_jax(n):
    x = _input("int32", n=n)
    for method in ("matmul", "kernel"):
        j, t = _both(x, method=method, tile_s=8)
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("variant", ["scanu", "scanul1"])
@pytest.mark.parametrize("kind", ["int8", "f32int", "f32rand"])
def test_scan_tiles_module_matches_jax_kernel(variant, kind):
    """B1's plain version against the Pallas kernel itself (interpret mode)."""
    x = _input(kind, n=300, rows=2, seed=1)
    j = np.asarray(jax_scan_mm.scan_tiles(jnp.asarray(x), s=8, variant=variant))
    t = port_scan_mm.scan_tiles(torch.from_numpy(x), s=8, variant=variant).numpy()
    _check(kind, j, t, x, 300)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "int32", "bool",
                                   "bfloat16", "float16", "float32"])
def test_accum_dtype_rules_match_jax(dtype):
    jd = jax_accum_dtype_for(jnp.dtype(dtype))
    td = accum_dtype_for(getattr(torch, dtype))
    assert str(td).rsplit(".", 1)[-1] == jd.name


def test_bf16_scan_accumulates_in_fp32_like_jax():
    x = _input("f32int").astype(np.float32)
    jb = np.asarray(jax_scan(jnp.asarray(x, jnp.bfloat16), method="matmul", tile_s=8))
    tb = port_scan(torch.from_numpy(x).to(torch.bfloat16), method="matmul",
                   tile_s=8).numpy()
    assert tb.dtype == np.float32
    np.testing.assert_array_equal(tb, jb)


def test_blocked_and_unknown_methods_raise():
    """``blocked`` runs, under every precision; unknown methods and precisions raise."""
    x = torch.ones(10)
    assert port_scan(x, method="blocked", tile_s=8)[-1].item() == 10.0
    assert port_scan(x, method="blocked", tile_s=8, precision="compensated")[-1].item() == 10.0
    with pytest.raises(ValueError, match="unknown precision"):
        port_scan(x, method="blocked", precision="exact")
    with pytest.raises(ValueError, match="block_tiles"):
        port_scan(x, method="blocked", block_tiles=0)
    with pytest.raises(ValueError):
        port_scan(x, method="cube")
    with pytest.raises(ValueError):
        port_scan(x, variant="scanx")
    with pytest.raises(ValueError):
        port_scan_mm.scan_tiles(x, s=129)

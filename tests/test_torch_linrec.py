"""The port's ``linear_scan`` against the JAX package, on every method.

Inputs are drawn with numpy from a seed and go through both packages on the
CPU; the JAX ``"kernel"`` and ``"blocked"`` methods run their Pallas kernels
in interpret mode, the port's run the kernels' plain versions.  Tolerances
are those of ``tests/test_linrec.py``:

* integer-valued payloads (``a ∈ {-1, 0, 1}``) are bit-identical to JAX and to
  the sequential recurrence on every method;
* gated fp32 recurrences are within ``3e-5`` of JAX's result on the same
  method (the JAX package's limit against its sequential oracle), bf16 inputs
  within ``1e-4``.

Options, broadcasting and the documented edge cases are in
``test_torch_linrec_options.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.core import linrec as jax_linrec
from repro_torch.core.linrec import linear_scan, linrec_accum_dtype_for

METHODS = ("vector", "matmul", "kernel", "blocked")
KW = dict(tile_s=8, block_tiles=2)
LENGTHS = (2, 7, 65, 257, 1000)


def _int_pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2, shape).astype(np.float32),
            rng.integers(-3, 4, shape).astype(np.float32))


def _gated_pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (np.exp(-np.abs(rng.standard_normal(shape)) * 0.1).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _both(a, b, method, **kw):
    """The JAX and the port result of one call, as numpy."""
    kw = {**KW, **kw}
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    # jitted: one compile, where eager JAX compiles each small op of the scan
    j = np.asarray(jax.jit(lambda x, y: jax_linrec.linear_scan(x, y, method=method, **jkw))(
        jnp.asarray(a), jnp.asarray(b)))
    t = linear_scan(torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b)),
                    method=method, **tkw)
    assert str(t.dtype).rsplit(".")[-1] == str(j.dtype) and tuple(t.shape) == j.shape
    return j, t.numpy()


def _seq(a, b, init=0.0):
    y, out = np.float64(init), np.empty(a.shape[-1])
    for t in range(a.shape[-1]):
        y = np.float64(a[t]) * y + b[t]
        out[t] = y
    return out


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", LENGTHS)
def test_int_payload_bit_identical_to_jax_and_sequential(method, n):
    a, b = _int_pair(n, seed=n)
    j, t = _both(a, b, method)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, _seq(a, b))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", (63, 1000))
def test_gated_fp32_matches_jax(method, n):
    a, b = _gated_pair(n, seed=n)
    j, t = _both(a, b, method)
    np.testing.assert_allclose(t, j, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(t, _seq(a, b), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("method", METHODS)
def test_integer_and_bf16_dtypes_accumulate_fp32(method):
    rng = np.random.default_rng(3)
    for dtype in (torch.int8, torch.int32, torch.bool):
        a = torch.from_numpy(rng.integers(0, 2, 100)).to(dtype)
        b = torch.from_numpy(rng.integers(0, 2, 100)).to(dtype)
        got = linear_scan(a, b, method=method, **KW)
        assert got.dtype == torch.float32 == linrec_accum_dtype_for(dtype)
        np.testing.assert_array_equal(got.numpy(), _seq(a.float().numpy(), b.float().numpy()))
    a, b = _gated_pair(500, seed=1)
    ab, bb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = linear_scan(ab, bb, method=method, **KW)
    want = jax.jit(lambda x, y: jax_linrec.linear_scan(x, y, method=method, **KW))(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

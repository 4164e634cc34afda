"""The port's chunked SSD scan against the JAX package and the sequential oracle.

Inputs are drawn with numpy from a seed (``x ~ N(0, 1)``, log decays
``-|0.2·g|``, ``B`` and ``C`` scaled by 0.3, as ``tests/test_ssd.py`` draws
them).  The port's ``ssd_scan`` on each method is held to the JAX
``ssd_scan`` on the same method within ``1e-5`` (fp32 einsums summed in other
orders by torch and XLA), and to the sequential oracle within the JAX
package's own ``2e-3`` (the chunked form reorders every sum).  The port's
``ssd_scan_ref`` matches JAX's within ``1e-5``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ssd as jax_ssd
from repro_torch.core.ssd import ssd_scan, ssd_scan_ref

METHODS = ("vector", "matmul", "kernel", "blocked")
TOL_JAX = dict(rtol=1e-5, atol=1e-5)
TOL_REF = dict(rtol=2e-3, atol=2e-3)


def _args(b, s, h, p, n, seed=0, decay=0.2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            (-np.abs(rng.standard_normal((b, s, h)) * decay)).astype(np.float32),
            (rng.standard_normal((b, s, h, n)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, s, h, n)) * 0.3).astype(np.float32))


def _t(args):
    return tuple(torch.from_numpy(x) for x in args)


def _jax(fn, args, **kw):
    out = jax.jit(lambda *xs: fn(*xs, **kw))(*(jnp.asarray(x) for x in args))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s,chunk", [(100, 24), (257, 32), (64, 16)],
                         ids=["ragged", "prime", "even"])
def test_ssd_scan_matches_jax_and_the_oracle(method, s, chunk):
    args = _args(2, s, 2, 4, 3, seed=s + chunk)
    want, wstate = _jax(jax_ssd.ssd_scan, args, chunk=chunk, scan_method=method,
                        return_final_state=True)
    got, state = ssd_scan(*_t(args), chunk=chunk, scan_method=method,
                          return_final_state=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL_JAX)
    np.testing.assert_allclose(state.numpy(), wstate, **TOL_JAX)
    ref, rstate = ssd_scan_ref(*_t(args), return_final_state=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL_REF)
    np.testing.assert_allclose(state.numpy(), rstate.numpy(), **TOL_REF)


@pytest.mark.parametrize("method", METHODS)
def test_ssd_state_handoff_matches_jax(method):
    """A ragged split: the second half starts from the first half's final state."""
    s, half, chunk = 90, 41, 16
    args = _args(1, s, 2, 4, 4, seed=7)
    first = tuple(x[:, :half] for x in args)
    second = tuple(x[:, half:] for x in args)
    ya, sta = ssd_scan(*_t(first), chunk=chunk, scan_method=method, return_final_state=True)
    yb, stb = ssd_scan(*_t(second), chunk=chunk, scan_method=method, initial_state=sta,
                       return_final_state=True)
    _, jsta = _jax(jax_ssd.ssd_scan, first, chunk=chunk, scan_method=method,
                   return_final_state=True)
    jyb, jstb = jax.tree.map(np.asarray, jax_ssd.ssd_scan(
        *(jnp.asarray(x) for x in second), chunk=chunk, scan_method=method,
        initial_state=jnp.asarray(jsta), return_final_state=True))
    np.testing.assert_allclose(yb.numpy(), jyb, **TOL_JAX)
    np.testing.assert_allclose(stb.numpy(), jstb, **TOL_JAX)
    y_ref, ref_state = ssd_scan_ref(*_t(args), return_final_state=True)
    np.testing.assert_allclose(torch.cat([ya, yb], 1).numpy(), y_ref.numpy(), **TOL_REF)
    np.testing.assert_allclose(stb.numpy(), ref_state.numpy(), **TOL_REF)


def test_ssd_scan_ref_matches_jax_and_runs_in_fp64():
    args = _args(2, 40, 2, 4, 3, seed=3)
    init = np.random.default_rng(4).standard_normal((2, 2, 3, 4)).astype(np.float32)
    want, wstate = jax.tree.map(np.asarray, jax_ssd.ssd_scan_ref(
        *(jnp.asarray(x) for x in args), initial_state=jnp.asarray(init),
        return_final_state=True))
    got, state = ssd_scan_ref(*_t(args), initial_state=torch.from_numpy(init),
                              return_final_state=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL_JAX)
    np.testing.assert_allclose(state.numpy(), wstate, **TOL_JAX)
    g64, s64 = ssd_scan_ref(*(x.double() for x in _t(args)),
                            initial_state=torch.from_numpy(init), return_final_state=True)
    assert g64.dtype == s64.dtype == torch.float64
    np.testing.assert_allclose(g64.numpy(), want, **TOL_JAX)


def test_ssd_strong_decay_long_sequence_is_finite():
    """Deep decay over many chunks: underflowed carries flush, never NaN."""
    args = _args(1, 512, 2, 4, 2, seed=3, decay=1.0)
    ref = ssd_scan_ref(*_t(args)).numpy()
    for method in METHODS:
        y = ssd_scan(*_t(args), chunk=32, scan_method=method).numpy()
        assert np.all(np.isfinite(y)), method
        np.testing.assert_allclose(y, ref, rtol=5e-3, atol=5e-3)

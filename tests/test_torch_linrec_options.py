"""The port's ``linear_scan`` against the JAX package: options, broadcasting and edges.

Inputs are drawn with numpy from a seed and go through both packages on the
CPU; the JAX ``"kernel"`` and ``"blocked"`` methods run their Pallas kernels
in interpret mode, the port's run the kernels' plain versions.  Tolerances
are those of ``tests/test_linrec.py``:

* integer-valued payloads (``a ∈ {-1, 0, 1}``) under ``exclusive``,
  ``reverse``, ``axis``, scalar and array ``initial`` and a shared decay are
  bit-identical to JAX on every method;
* the documented edge cases (zeros in ``a``, deep decay, moderate decay over
  a full tile) hold the port to the JAX outcome with the JAX tolerance.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import linrec as jax_linrec
from repro_torch.core import guards
from repro_torch.core import linrec as port_linrec
from repro_torch.core.linrec import linear_scan
from repro_torch.kernels import ops

METHODS = ("vector", "matmul", "kernel", "blocked")
KW = dict(tile_s=8, block_tiles=2)


def _int_pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2, shape).astype(np.float32),
            rng.integers(-3, 4, shape).astype(np.float32))


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
@pytest.mark.parametrize("kw", [
    dict(exclusive=True), dict(reverse=True), dict(exclusive=True, reverse=True),
    dict(initial=5.0), dict(initial=-2.0, exclusive=True), dict(axis=0),
    dict(initial=np.asarray([1.0, -3.0], np.float32), exclusive=True),
], ids=["exclusive", "reverse", "excl_rev", "initial", "initial_excl", "axis0",
        "array_initial"])
def test_exclusive_reverse_axis_initial_match_jax(method, kw):
    a, b = _int_pair((2, 65), seed=9)
    j, t = _both(a, b, method, **kw)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("method", METHODS)
def test_shared_decay_broadcast_matches_jax(method):
    """A decay shared over payload dims (the SSD cross-chunk shape), scanned on axis 1."""
    rng = np.random.default_rng(17)
    a = rng.integers(-1, 2, (2, 33, 1, 1)).astype(np.float32)
    b = rng.integers(-2, 3, (2, 33, 3, 4)).astype(np.float32)
    j, t = _both(a, b, method, axis=1)
    assert t.shape == b.shape
    np.testing.assert_array_equal(t, j)


class _Largest(TorchDispatchMode):
    """Records the largest tensor any operation produces."""

    def __init__(self):
        super().__init__()
        self.biggest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.biggest = max(self.biggest, o.numel())
        return out


def test_shared_decay_matmul_builds_one_triangle():
    """The matmul path builds ``W`` from the unbroadcast decay: one (q, q) triangle
    per chunk, never one per payload element (that would be 64 × 16 × the payload)."""
    a = torch.ones((1, 64, 1, 1))
    b = torch.ones((1, 64, 8, 8))
    with _Largest() as mode:
        out = linear_scan(a, b, axis=1, method="matmul", tile_s=16)
    assert mode.biggest <= 4 * b.numel(), mode.biggest
    np.testing.assert_array_equal(out[0, :, 0, 0].numpy(), np.arange(1, 65))


@pytest.mark.parametrize("method", METHODS)
def test_length_one_short_circuits_without_launch(method):
    """n == 1 is the decode step: one fused step, no dispatch, any method."""
    a = torch.tensor([[0.5], [2.0]])
    b = torch.tensor([[1.0], [3.0]])
    ops.reset_launch_counts()
    calls = []
    orig = port_linrec.dispatch
    port_linrec.dispatch = lambda *x: calls.append(x) or orig(*x)
    try:
        out = linear_scan(a, b, method=method, initial=torch.tensor([4.0, -1.0]))
    finally:
        port_linrec.dispatch = orig
    np.testing.assert_array_equal(out.numpy(), [[3.0], [1.0]])
    assert calls == [] and not any(ops.launch_counts().values())


@pytest.mark.parametrize("method", METHODS)
def test_broadcast_scalar_decay_and_empty(method):
    out = linear_scan(torch.tensor(0.5), torch.ones((2, 5)), method=method, **KW)
    assert out.shape == (2, 5)
    np.testing.assert_allclose(out[1].numpy(), 2.0 - 0.5 ** np.arange(5), rtol=1e-6)
    z = linear_scan(torch.ones((3, 0)), torch.ones((3, 0)), method=method, **KW)
    assert z.shape == (3, 0) and z.dtype == torch.float32


@pytest.mark.parametrize("method", METHODS)
def test_zeros_in_a_reset_exactly(method):
    a = np.asarray([2.0, 0.0, 2.0, 2.0, 0.0, 1.0], np.float32)
    b = np.asarray([1.0, 3.0, 1.0, 1.0, 4.0, 1.0], np.float32)
    j, t = _both(a, b, method, tile_s=2, block_tiles=1)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, _seq(a, b))


@pytest.mark.parametrize("method", METHODS)
def test_deep_decay_underflow_is_finite(method):
    a = np.full((4096,), 0.5, np.float32)
    b = np.ones((4096,), np.float32)
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(b), method=method,
                      tile_s=64).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, 2.0 - 0.5 ** np.arange(4096), rtol=1e-5)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("decay", (0.25, 0.05))
def test_moderate_decay_full_tile_stays_accurate(method, decay):
    n = 512
    a = np.full((n,), decay, np.float32)
    b = np.random.default_rng(31).standard_normal(n).astype(np.float32)
    j, t = _both(a, b, method, tile_s=128, block_tiles=8)
    np.testing.assert_allclose(t, _seq(a, b), rtol=3e-6, atol=3e-6)
    np.testing.assert_allclose(t, j, rtol=3e-6, atol=3e-6)


def test_validation_and_grad_refusal():
    a, b = torch.ones(4), torch.ones(4)
    with pytest.raises(ValueError, match="unknown scan method"):
        linear_scan(a, b, method="nope")
    with pytest.raises(ValueError, match="tile_s"):
        linear_scan(a, b, tile_s=512)
    with pytest.raises(ValueError, match="tile_s"):
        linear_scan(a, b, tile_s=1)
    with pytest.raises(ValueError):
        linear_scan(a, b, axis=1)
    with pytest.raises(ValueError, match="precision"):
        linear_scan(a, b, method="vector", precision="compensated")
    assert linear_scan(a, b, method="matmul", precision="compensated").tolist() == \
        [1.0, 2.0, 3.0, 4.0]
    # the non-finite policies: JAX's outcome and values (a -> 1, b -> 0)
    an = np.asarray([1.0, np.nan, 2.0, np.inf], np.float32)
    bn = np.asarray([1.0, 2.0, -np.inf, 3.0], np.float32)
    want = np.asarray(jax_linrec.linear_scan(jnp.asarray(an), jnp.asarray(bn),
                                             nonfinite="sanitize", method="vector"))
    got = linear_scan(torch.from_numpy(an), torch.from_numpy(bn), nonfinite="sanitize",
                      method="vector")
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(jax_linrec.guards.NonFiniteError):
        jax_linrec.linear_scan(jnp.asarray(an), jnp.asarray(bn), nonfinite="raise")
    with pytest.raises(guards.NonFiniteError):
        linear_scan(torch.from_numpy(an), torch.from_numpy(bn), nonfinite="raise")
    with pytest.raises(ValueError, match="nonfinite"):
        linear_scan(a, b, nonfinite="ignore")
    # no refusal any more: every method has JAX's custom-VJP gradient, for a,
    # b and initial (integer-valued, so exact on both sides)
    av, bv = np.asarray([1.0, -1.0, 0.0, 1.0], np.float32), np.asarray([1.0, 2.0, -3.0, 1.0],
                                                                      np.float32)
    w = np.asarray([1.0, 2.0, -1.0, 3.0], np.float32)
    for method in METHODS:
        def f(x, y, i):
            return jnp.sum(jax_linrec.linear_scan(x, y, method=method, initial=i) * w)
        want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(av), jnp.asarray(bv),
                                              jnp.asarray(2.0, jnp.float32))
        ta, tb = torch.tensor(av, requires_grad=True), torch.tensor(bv, requires_grad=True)
        ti = torch.tensor(2.0, requires_grad=True)
        (linear_scan(ta, tb, method=method, initial=ti) * torch.from_numpy(w)).sum().backward()
        for got, ref in zip((ta.grad, tb.grad, ti.grad), want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with torch.no_grad():
        out = linear_scan(a.clone().requires_grad_(), b, method="vector")
    assert out.tolist() == [1.0, 2.0, 3.0, 4.0] and not out.requires_grad


@pytest.mark.parametrize("method", METHODS)
def test_overflowing_recurrence_matches_jax(method):
    """``a ≡ 2, b ≡ 1``: the true state passes fp32's range at step 127.  Every
    method gives JAX's outcome on the same method: ``inf`` from there, and on
    ``"blocked"`` NaN where the block algebra multiplies an overflowed
    cumulative product by a zero carry (ROADMAP Queue C)."""
    a = np.full(300, 2.0, np.float32)
    b = np.ones(300, np.float32)
    j, t = _both(a, b, method)
    np.testing.assert_array_equal(t, j)                   # NaN where JAX has NaN
    assert np.isfinite(t[:127]).all() and not np.isfinite(t[127:]).any()
    assert method == "blocked" or not np.isnan(t).any()

"""Gradients of the port's recurrences against ``jax.grad`` of the JAX package, on the CPU.

``linear_scan``'s analytic adjoint (``core/linrec.py`` ``_LinrecCore`` on the
rows, ``_LinrecColumns`` on the column walk) against JAX's custom VJP on every
method: the JAX ``"kernel"`` and ``"blocked"`` methods run their Pallas
kernels in interpret mode, the port's the kernels' plain versions.  Inputs are
drawn with numpy from a seed; every JAX gradient is one jitted call, compiled
once and reused.  Tolerance: ``rtol=1e-5`` and ``atol = 1e-6 · max|ref|`` of
each gradient (the two adjoints sum the same recurrence in other orders).

``torch.autograd.gradcheck`` holds the adjoint to finite differences in
float64 on the rows path and on the column walk's plain version.

The refusal parity: ``scan``, ``segment_scan``, ``ssd_scan`` (whose log-decay
cumsum is a ``scan``) and ``ssd_chunk_scan`` raise exactly where ``jax.grad``
fails (the Pallas ``"kernel"``/``"blocked"`` paths and the SSD chunk kernel),
and elsewhere give JAX's gradient.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linrec as jax_linrec
from repro.core import segmented as jax_seg
from repro.core import ssd as jax_ssd
from repro.core.scan import scan as jax_scan
from repro.kernels.ops import ssd_kernel as jax_ssd_kernel
from repro_torch.core.linrec import linear_scan
from repro_torch.core.scan import scan
from repro_torch.core.segmented import segment_scan
from repro_torch.core.ssd import ssd_scan
from repro_torch.kernels import ops
from repro_torch.kernels.linrec_mm import linrec_columns_plain
from repro_torch.kernels.ssd_chunk import ssd_chunk_scan

METHODS = ("vector", "matmul", "kernel", "blocked")
RTOL, ATOL_FRAC = 1e-5, 1e-6
KW = dict(tile_s=8, block_tiles=2)


def _gated_rows(seed=0):
    """Random gates in (0.5, 1) on two rows of 150 with an exact reset at 3."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (2, 150)).astype(np.float32)
    a[:, 3] = 0.0
    return a, rng.standard_normal((2, 150)).astype(np.float32)


def _shared_decay(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 1.0, (40, 1)).astype(np.float32),
            rng.standard_normal((40, 3)).astype(np.float32))


def _walk(seed=2):
    """The SSD cross-chunk shape: a (2, 16, 3, 1, 1) decay shared by (4, 4) states."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.2, 1.0, (2, 16, 3, 1, 1)).astype(np.float32),
            rng.standard_normal((2, 16, 3, 4, 4)).astype(np.float32))


# name -> (operands, linear_scan options, initial)
CASES = {
    "gated_reset": (_gated_rows, dict(), None),
    "shared_decay": (_shared_decay, dict(axis=0), None),
    "walk": (_walk, dict(axis=1), None),
    "walk_excl_init": (_walk, dict(axis=1, exclusive=True), "state"),
    "walk_rev_excl_init": (_walk, dict(axis=1, reverse=True, exclusive=True), "scalar"),
    "rows_rev_excl_init": (_gated_rows, dict(reverse=True, exclusive=True), "rows"),
    "rows_init": (_gated_rows, dict(), "scalar"),
}


def _initial(kind, b):
    rng = np.random.default_rng(7)
    if kind is None:
        return None
    if kind == "scalar":
        return np.float32(0.7)
    if kind == "rows":
        return rng.standard_normal(b.shape[:-1]).astype(np.float32)
    return rng.standard_normal(b.shape[:1] + b.shape[2:]).astype(np.float32)   # walk


def _weights(shape, seed=11):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(case, method, precision):
    make, kw, init_kind = CASES[case]

    def f(a, b, init, w):
        return jnp.sum(jax_linrec.linear_scan(a, b, method=method, precision=precision,
                                              initial=init, **kw, **KW) * w)
    return jax.jit(jax.grad(f, argnums=(0, 1) if init_kind is None else (0, 1, 2)))


def _hold(got, want):
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL,
                                   atol=ATOL_FRAC * float(np.abs(r).max()))


def _port_grads(a, b, init, w, method, precision, kw):
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    ti = None if init is None else torch.tensor(init, requires_grad=True)
    out = linear_scan(ta, tb, method=method, precision=precision, initial=ti, **kw, **KW)
    (out * torch.from_numpy(w)).sum().backward()
    return (ta.grad, tb.grad) + (() if ti is None else (ti.grad,))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", list(CASES))
def test_linear_scan_grad_matches_jax(case, method):
    make, kw, init_kind = CASES[case]
    a, b = make()
    init = _initial(init_kind, b)
    w = _weights(np.broadcast_shapes(a.shape, b.shape))
    want = _jax_grad_fn(case, method, "highest")(
        jnp.asarray(a), jnp.asarray(b), None if init is None else jnp.asarray(init),
        jnp.asarray(w))
    ops.reset_launch_counts()
    got = _port_grads(a, b, init, w, method, "highest", kw)
    assert not any(ops.launch_counts().values())            # CPU: plain versions only
    assert [tuple(g.shape) for g in got] == [tuple(np.shape(r)) for r in want]
    _hold(got, want)


@pytest.mark.parametrize("method", ("matmul", "kernel", "blocked"))
@pytest.mark.parametrize("case", ["gated_reset", "shared_decay", "walk"])
def test_compensated_grad_matches_jax(case, method):
    """A compensated forward pass gets a compensated adjoint, in both packages
    (on the CPU the column-walk axis takes the rows' split products)."""
    make, kw, _ = CASES[case]
    a, b = make()
    w = _weights(np.broadcast_shapes(a.shape, b.shape))
    want = _jax_grad_fn(case, method, "compensated")(jnp.asarray(a), jnp.asarray(b), None,
                                                     jnp.asarray(w))
    _hold(_port_grads(a, b, None, w, method, "compensated", kw), want)


def test_grad_of_integer_recurrence_is_absent():
    """Integer operands accumulate in fp32 and never require grad."""
    a = torch.tensor([1, 2, 0, 3], dtype=torch.int32)
    out = linear_scan(a, torch.ones(4, dtype=torch.int32), method="kernel")
    assert not out.requires_grad and out.tolist() == [1.0, 3.0, 1.0, 4.0]


@pytest.mark.parametrize("method", METHODS)
def test_gradcheck_rows_float64(method):
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.uniform(0.3, 1.0, (2, 20)), requires_grad=True)
    b = torch.tensor(rng.standard_normal((2, 20)), requires_grad=True)
    init = torch.tensor(rng.standard_normal((2,)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, i: linear_scan(a, b, method=method, initial=i, exclusive=True, **KW),
        (a, b, init))
    assert torch.autograd.gradcheck(
        lambda a, b: linear_scan(a, b, method=method, reverse=True, **KW), (a, b))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("method", ("kernel", "blocked"))
def test_gradcheck_column_walk_float64(method, reverse):
    """The column walk (its plain version on the CPU) under gradcheck, a shared
    decay and an initial state, inclusive and exclusive."""
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.uniform(0.3, 1.0, (2, 6, 3, 1)), requires_grad=True)
    b = torch.tensor(rng.standard_normal((2, 6, 3, 2)), requires_grad=True)
    init = torch.tensor(rng.standard_normal((2, 3, 2)), requires_grad=True)
    for exclusive in (False, True):
        assert torch.autograd.gradcheck(
            lambda a, b, i: linear_scan(a, b, axis=1, method=method, initial=i,
                                        exclusive=exclusive, reverse=reverse, **KW),
            (a, b, init))


def test_column_walk_plain_is_the_recurrence():
    """The walk the adjoint runs backwards: ``linrec_columns_plain(reverse=True)``
    equals the reversed recurrence step by step, in float64."""
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.uniform(0.3, 1.0, (2, 7, 1)))
    b = torch.tensor(rng.standard_normal((2, 7, 3)))
    y, want = torch.zeros(2, 3, dtype=torch.float64), torch.empty(2, 7, 3, dtype=torch.float64)
    for t in reversed(range(7)):
        y = a[:, t] * y + b[:, t]
        want[:, t] = y
    torch.testing.assert_close(linrec_columns_plain(a, b, 1, reverse=True), want,
                               rtol=1e-15, atol=0)


# ---------------------------------------------------------------------------
# the refusal parity
# ---------------------------------------------------------------------------

OFFSETS = np.asarray([0, 10, 30, 64], np.int32)


def _scan_x(seed=6):
    return np.random.default_rng(seed).standard_normal((2, 64)).astype(np.float32)


def _jax_outcome(fn, *args):
    """``jax.grad`` of ``fn`` at ``args``, or None where it fails."""
    try:
        return np.asarray(jax.grad(fn)(*args))
    except Exception:                                        # noqa: BLE001
        return None


def _port_outcome(fn, x):
    xt = torch.tensor(x, requires_grad=True)
    ops.reset_launch_counts()
    try:
        fn(xt).backward()
    except NotImplementedError as e:
        assert "has no gradient" in str(e)
        assert not any(ops.launch_counts().values())
        return None
    return xt.grad.numpy()


def _parity(jax_fn, port_fn, x, method):
    want = _jax_outcome(jax_fn, jnp.asarray(x))
    got = _port_outcome(port_fn, x)
    if want is None:
        assert got is None, f"jax.grad fails on {method!r}; the port must raise"
        return False
    assert got is not None, f"jax.grad differentiates {method!r}; the port must too"
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_FRAC * np.abs(want).max())
    return True


@pytest.mark.parametrize("method", METHODS)
def test_scan_refuses_grad_exactly_where_jax_does(method):
    x = _scan_x()
    w = _weights(x.shape, 12)
    ok = _parity(lambda v: jnp.sum(jax_scan(v, method=method, tile_s=8, block_tiles=2,
                                            exclusive=True, reverse=True) * w),
                 lambda v: (scan(v, method=method, tile_s=8, block_tiles=2, exclusive=True,
                                 reverse=True) * torch.from_numpy(w)).sum(), x, method)
    assert ok == (method in ("vector", "matmul"))


@pytest.mark.parametrize("method", METHODS)
def test_segment_scan_refuses_grad_exactly_where_jax_does(method):
    x = _scan_x(8)[0]
    w = _weights(x.shape, 13)
    off_j, off_t = jnp.asarray(OFFSETS), torch.from_numpy(OFFSETS)
    ok = _parity(lambda v: jnp.sum(jax_seg.segment_scan(v, off_j, method=method, tile_s=8,
                                                        block_tiles=2) * w),
                 lambda v: (segment_scan(v, off_t, method=method, tile_s=8,
                                         block_tiles=2) * torch.from_numpy(w)).sum(),
                 x, method)
    assert ok == (method in ("vector", "matmul"))
    with torch.no_grad():                                    # no grad mode: no refusal
        segment_scan(torch.tensor(x, requires_grad=True), off_t, method=method)


def _ssd_inputs(seed=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 32, 2, 4)).astype(np.float32)
    a = -np.abs(rng.standard_normal((1, 32, 2)) * 0.1).astype(np.float32)
    bm = (rng.standard_normal((1, 32, 2, 4)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((1, 32, 2, 4)) * 0.3).astype(np.float32)
    return x, a, bm, cm


@pytest.mark.parametrize("method", METHODS)
def test_ssd_scan_refuses_grad_exactly_where_jax_does(method):
    """``ssd_scan``'s gradient in the log decays runs through the cumsum ``scan``,
    whose method decides; its gradient in ``x`` does not, and differentiates on
    every method in both packages."""
    x, a, bm, cm = _ssd_inputs()
    xj, bj, cj = jnp.asarray(x), jnp.asarray(bm), jnp.asarray(cm)
    xt, bt, ct = torch.from_numpy(x), torch.from_numpy(bm), torch.from_numpy(cm)
    ok = _parity(lambda v: jnp.sum(jax_ssd.ssd_scan(xj, v, bj, cj, chunk=8,
                                                    scan_method=method) ** 2),
                 lambda v: (ssd_scan(xt, v, bt, ct, chunk=8, scan_method=method) ** 2).sum(),
                 a, method)
    assert ok == (method in ("vector", "matmul"))
    at = torch.from_numpy(a)
    assert _parity(lambda v: jnp.sum(jax_ssd.ssd_scan(v, jnp.asarray(a), bj, cj, chunk=8,
                                                      scan_method=method) ** 2),
                   lambda v: (ssd_scan(v, at, bt, ct, chunk=8, scan_method=method) ** 2).sum(),
                   x, method)


def test_ssd_chunk_scan_refuses_grad_as_jax_does():
    x, a, bm, cm = _ssd_inputs()
    ok = _parity(lambda v: jnp.sum(jax_ssd_kernel(v, jnp.asarray(a), jnp.asarray(bm),
                                                  jnp.asarray(cm), chunk=8)),
                 lambda v: ssd_chunk_scan(v, torch.from_numpy(a), torch.from_numpy(bm),
                                          torch.from_numpy(cm), chunk=8).sum(),
                 x, "kernel")
    assert not ok

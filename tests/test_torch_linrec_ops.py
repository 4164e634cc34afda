"""``cumprod``, ``cummax`` and ``segment_linear_scan`` of the port against the JAX package.

Inputs are drawn with numpy from a seed; the JAX calls are jitted (one
compile each) and run their Pallas kernels in interpret mode on the kernel
methods.  Every payload is integer-valued, so every method is bit-identical
to JAX and to a per-segment loop; ``cummax`` never rounds and is
bit-identical on every dtype.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.core import linrec as jax_linrec
from repro.core import segmented as jax_segmented
from repro_torch.core import autotune, guards
from repro_torch.core.linrec import cummax, cumprod
from repro_torch.core.segmented import SegmentedBatch, segment_linear_scan

METHODS = ("vector", "matmul", "kernel", "blocked")
KW = dict(tile_s=8, block_tiles=2)


def _jit(fn, *args):
    return np.asarray(jax.jit(fn)(*(jnp.asarray(x) for x in args)))


@pytest.mark.parametrize("method", METHODS)
def test_cumprod_matches_jax(method):
    x = np.random.default_rng(2).choice([-1.0, 0.0, 1.0, 2.0], (3, 80)).astype(np.float32)
    want = _jit(lambda v: jax_linrec.cumprod(v, method=method, **KW), x)
    got = cumprod(torch.from_numpy(x), method=method, **KW)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.cumprod(x, -1))
    rev = cumprod(torch.from_numpy(x), axis=0, reverse=True, method=method, **KW)
    np.testing.assert_array_equal(
        rev.numpy(), _jit(lambda v: jax_linrec.cumprod(v, axis=0, reverse=True,
                                                       method=method, **KW), x))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [np.int32, np.int8, np.float32])
def test_cummax_bit_identical_to_jax(method, dtype):
    x = np.random.default_rng(4).integers(-100, 100, (2, 313)).astype(dtype)
    want = np.asarray(jax_linrec.cummax(jnp.asarray(x), method=method, tile_s=8))
    got = cummax(torch.from_numpy(x), method=method, tile_s=8)
    assert str(got.dtype).rsplit(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), cummax(torch.from_numpy(x),
                                                      method="vector").numpy())
    back = cummax(torch.from_numpy(x), axis=0, reverse=True, method=method, tile_s=8)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_linrec.cummax(
        jnp.asarray(x), axis=0, reverse=True, method=method, tile_s=8)))


@pytest.mark.parametrize("method", METHODS)
def test_cummax_bool_and_edges(method):
    out = cummax(torch.tensor([False, False, True, False, True]), method=method, tile_s=2)
    assert out.dtype == torch.bool and out.tolist() == [False, False, True, True, True]
    assert cummax(torch.zeros((2, 0)), method=method).shape == (2, 0)
    with pytest.raises(ValueError, match="unknown scan method"):
        cummax(torch.ones(3), method="nope")
    with pytest.raises(TypeError):
        cummax(torch.ones(3), exclusive=True)


def _loop(a, b, offsets, init=0.0):
    """Per-segment sequential recurrence in fp64."""
    out = np.zeros(a.shape[-1])
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        y = np.float64(init)
        for t in range(lo, hi):
            y = np.float64(a[t]) * y + b[t]
            out[t] = y
    return out


OFFSETS = [[0, 57], [0, 0, 5, 5, 20, 21, 57], [0, 1, 2, 3, 57]]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("offsets", OFFSETS, ids=["one", "empties", "tiny"])
def test_segment_linear_scan_matches_jax_and_loop(method, offsets):
    rng = np.random.default_rng(13)
    a = rng.integers(-1, 2, 57).astype(np.float32)
    b = rng.integers(-3, 4, 57).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    for init in (0.0, 2.0):
        want = _jit(lambda x, y, o: jax_segmented.segment_linear_scan(
            x, y, o, method=method, initial=init, **KW), a, b, off)
        got = segment_linear_scan(torch.from_numpy(a), torch.from_numpy(b), offsets,
                                  method=method, initial=init, **KW)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), _loop(a, b, offsets, init))


@pytest.mark.parametrize("method", METHODS)
def test_segment_linear_scan_exclusive_reverse_and_row_initial(method):
    rng = np.random.default_rng(15)
    a = rng.integers(-1, 2, (3, 31)).astype(np.float32)
    b = rng.integers(-2, 3, (3, 31)).astype(np.float32)
    off = np.asarray([0, 4, 4, 17, 31], np.int32)
    init = np.asarray([1.0, -2.0, 3.0], np.float32)
    for kw in (dict(exclusive=True, initial=3.0), dict(reverse=True),
               dict(initial=init), dict(initial=init, exclusive=True, reverse=True)):
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        want = _jit(lambda x, y, o: jax_segmented.segment_linear_scan(
            x, y, o, method=method, **jkw, **KW), a, b, off)
        got = segment_linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(off), method=method, **tkw, **KW)
        np.testing.assert_array_equal(got.numpy(), want)


def test_segment_linear_scan_batch_empty_and_validation():
    a = torch.full((5,), 2.0)
    batch = SegmentedBatch(a, torch.tensor([0, 2, 5], dtype=torch.int32))
    assert segment_linear_scan(batch, torch.ones(5), method="kernel").tolist() == \
        [1.0, 3.0, 1.0, 3.0, 7.0]
    out = segment_linear_scan(torch.zeros((0,)), torch.zeros((0,)), [0, 0, 0],
                              method="matmul")
    assert out.shape == (0,) and out.dtype == torch.float32
    with pytest.raises(ValueError):
        segment_linear_scan(a, torch.ones(5), [0, 2, 4])
    # the non-finite policies: JAX's outcome, and JAX's values under sanitize
    an = np.asarray([2.0, np.nan, 2.0, np.inf, 0.5], np.float32)
    bn = np.asarray([1.0, 1.0, -np.inf, 1.0, np.nan], np.float32)
    off = np.asarray([0, 2, 5], np.int32)
    with pytest.raises(guards.NonFiniteError):
        segment_linear_scan(torch.from_numpy(an), torch.ones(5), [0, 5], nonfinite="raise")
    with pytest.raises(jax_segmented.guards.NonFiniteError):
        jax_segmented.segment_linear_scan(jnp.asarray(an), jnp.ones(5), jnp.asarray(off),
                                          nonfinite="raise")
    for method in METHODS:
        want = _jit(lambda x, y, o: jax_segmented.segment_linear_scan(
            x, y, o, method=method, nonfinite="sanitize", **KW), an, bn, off)
        got = segment_linear_scan(torch.from_numpy(an), torch.from_numpy(bn),
                                  torch.from_numpy(off), method=method,
                                  nonfinite="sanitize", **KW)
        np.testing.assert_array_equal(got.numpy(), want)


def test_aliases_resolve_through_the_linear_scan_and_segment_scan_rows():
    assert autotune.OP_ALIASES["cumprod"] == autotune.OP_ALIASES["cummax"] == "linear_scan"
    assert autotune.OP_ALIASES["segment_linear_scan"] == "segment_scan"
    for op in ("cumprod", "cummax"):
        assert autotune.resolve_method(op, 1 << 20, torch.float32, backend="cpu") == \
            autotune.resolve_method("linear_scan", 1 << 20, torch.float32, backend="cpu")

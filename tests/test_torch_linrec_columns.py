"""The column walk of B13 and B16 (a short scan axis that is not the last, walked
where it lies) against the JAX package, on the CPU.

``linrec_mm.linrec_columns_plain`` is the walk's plain version: the recurrence
step by step along the axis, one rounding a step as the kernel's ``fmaf``.  It
is held against ``repro.core.linrec.linear_scan(method="kernel")``, whose Pallas
kernel runs in interpret mode, on small SSD-like shapes drawn with numpy from a
seed: the axis at 0, 1 and 2 of 3- to 5-D operands, 2 to 64 steps, a decay
shared by trailing axes and a full one, ``exclusive``, ``reverse`` and
``initial``.  Integer-valued pairs are bit-equal; gated fp32 within
``tests/test_linrec.py``'s 3e-5.  The port's ``linear_scan`` takes the walk on
``"kernel"`` and ``"blocked"`` for such axes, so it must give the plain walk's
bits; and the kernel's ``(outer, n, inner)`` geometry, read back through
``as_strided`` as the kernel reads memory, must give them too.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.core import linrec as jax_linrec
from repro_torch.core.linrec import linear_scan
from repro_torch.kernels import linrec_mm

KW = dict(tile_s=8, block_tiles=2)
# (shape, axis): every n of 2, 3, 16, 17 and 64 at axes 0, 1 and 2 of 3- to 5-D
CASES = [((2, 5, 6), 0), ((4, 3, 5, 6), 1), ((2, 3, 16, 4, 5), 2), ((3, 17, 4), 1),
         ((64, 3, 2, 5), 0), ((2, 2, 64, 3, 4), 2), ((2, 16, 4, 3, 4), 1)]
OPTS = [dict(), dict(exclusive=True), dict(reverse=True), dict(initial=3.0),
        dict(initial="array", exclusive=True, reverse=True)]
OPT_IDS = ["plain", "exclusive", "reverse", "initial", "array_initial_excl_rev"]


def _decay_shape(shape, axis, grouped):
    """Full, or shared over the trailing axes: all but the one after the axis when
    two or more follow it (as the SSD's decay over its (N, P) state), else all."""
    if not grouped:
        return shape
    keep = axis + 2 if len(shape) - axis > 2 else axis + 1
    return shape[:keep] + (1,) * (len(shape) - keep)


def _pairs(shape, axis, grouped, kind, seed):
    rng = np.random.default_rng(seed)
    ash = _decay_shape(shape, axis, grouped)
    if kind == "int":
        return (rng.integers(-1, 2, ash).astype(np.float32),
                rng.integers(-3, 4, shape).astype(np.float32))
    a = np.exp(-rng.random(ash) * 0.1).astype(np.float32)
    a[rng.random(ash) < 0.02] = 0.0
    return a, rng.standard_normal(shape).astype(np.float32)


def _initial(opts, shape, axis, seed):
    init = opts.get("initial")
    if isinstance(init, str):
        rest = shape[:axis] + shape[axis + 1:]
        return np.random.default_rng(seed).integers(-2, 3, rest).astype(np.float32)
    return init


def _jax(a, b, axis, init, opts):
    kw = {k: v for k, v in opts.items() if k != "initial"}
    if init is not None:
        kw["initial"] = jnp.asarray(init) if isinstance(init, np.ndarray) else init
    return np.asarray(jax.jit(lambda x, y: jax_linrec.linear_scan(
        x, y, axis=axis, method="kernel", **KW, **kw))(jnp.asarray(a), jnp.asarray(b)))


def _plain(a, b, axis, init, opts):
    return linrec_mm.linrec_columns_plain(
        torch.from_numpy(a), torch.from_numpy(b), axis, exclusive=opts.get("exclusive", False),
        reverse=opts.get("reverse", False),
        initial=None if init is None else torch.as_tensor(init, dtype=torch.float32))


@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "full"])
@pytest.mark.parametrize("shape,axis", CASES)
def test_integer_pairs_bit_equal_to_jax(shape, axis, grouped, opts):
    a, b = _pairs(shape, axis, grouped, "int", len(shape) + axis)
    init = _initial(opts, shape, axis, 5)
    got = _plain(a, b, axis, init, opts)
    np.testing.assert_array_equal(got.numpy(), _jax(a, b, axis, init, opts))
    kw = {k: v for k, v in opts.items() if k != "initial"}
    tinit = None if init is None else torch.as_tensor(init)
    for method in ("kernel", "blocked"):
        routed = linear_scan(torch.from_numpy(a), torch.from_numpy(b), axis=axis, method=method,
                             initial=tinit, **KW, **kw)
        assert torch.equal(routed, got), method


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "full"])
@pytest.mark.parametrize("shape,axis", CASES)
def test_gated_fp32_close_to_jax(shape, axis, grouped):
    a, b = _pairs(shape, axis, grouped, "gated", 7 * len(shape) + axis)
    got = _plain(a, b, axis, None, {})
    np.testing.assert_allclose(got.numpy(), _jax(a, b, axis, None, {}), rtol=3e-5, atol=3e-5)


def _walk_geometry(a, b, init, axis, reverse, exclusive):
    """The kernel's walk read through ``_column_geometry`` with ``as_strided``, as
    ``csrc/linrec_columns.cuh`` addresses memory, and ``fmaf`` formed in fp64."""
    ae, be, ie, full, g = linrec_mm._column_geometry(a, b, init, axis)
    outer, n, inner, group, a_so, a_sn, a_sg, b_so, b_sn, i_so, i_si = g
    av = torch.as_strided(ae, (outer, n, inner // group), (a_so, a_sn, a_sg),
                          ae.storage_offset()).repeat_interleave(group, dim=2)
    bv = torch.as_strided(be, (outer, n, inner), (b_so, b_sn, 1), be.storage_offset())
    y = (torch.zeros((outer, inner)) if ie is None else
         torch.as_strided(ie, (outer, inner), (i_so, i_si), ie.storage_offset()))
    out = torch.empty((outer, n, inner))
    for s in range(n):
        t = n - 1 - s if reverse else s
        if s == 0 and ie is not None:
            nxt = bv[:, t] + av[:, t] * y
        else:
            nxt = (av[:, t].double() * y.double() + bv[:, t].double()).float()
        out[:, t] = y if exclusive else nxt
        y = nxt
    return out.reshape(full)


@pytest.mark.parametrize("layout", ["contiguous", "b_strided", "a_middle_broadcast",
                                    "a_scalar_along_axis", "ssd"])
@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_kernel_geometry_reads_the_operands(layout, opts):
    """The strides the kernel is given address the right elements, on layouts that
    fit its view (read unbroadcast) and on ones it must copy first."""
    rng = np.random.default_rng(11)
    shape, axis = (3, 6, 4, 5), 1
    b = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    a = torch.from_numpy(rng.integers(-1, 2, (3, 6, 4, 1)).astype(np.float32))
    if layout == "b_strided":          # b a transposed view: copied
        b = torch.from_numpy(rng.integers(-3, 4, (3, 6, 5, 4)).astype(np.float32)).transpose(2, 3)
    elif layout == "a_middle_broadcast":
        a = torch.from_numpy(rng.integers(-1, 2, (3, 6, 1, 5)).astype(np.float32))
    elif layout == "a_scalar_along_axis":
        a = torch.from_numpy(rng.integers(-1, 2, (3, 1, 4, 5)).astype(np.float32))
    elif layout == "ssd":              # the SSD's decay: a strided slice, shared by (N, P)
        shape, axis = (2, 5, 3, 4, 6), 1
        cs = torch.from_numpy(rng.integers(-1, 2, (2, 5, 3, 7)).astype(np.float32))
        a = cs[..., -1][..., None, None]
        b = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    init = _initial(opts, tuple(b.shape), axis, 13)
    init = None if init is None else torch.as_tensor(init, dtype=torch.float32)
    ex, rev = opts.get("exclusive", False), opts.get("reverse", False)
    want = linrec_mm.linrec_columns_plain(a, b, axis, exclusive=ex, reverse=rev, initial=init)
    got = _walk_geometry(a, b, init, axis, rev, ex)
    assert torch.equal(got, want)
    if layout == "ssd":
        g = linrec_mm._column_geometry(a, b, init, axis)[4]
        assert g[3] == 4 * 6 and g[4] == cs.stride(0) and g[6] == cs.stride(2)


def test_column_walk_applies_to_short_non_last_axes():
    applies = linrec_mm.column_walk_applies
    top = linrec_mm.LINREC_COLUMN_MAX
    assert applies("kernel", 5, 1, 16, 16, 8) and applies("blocked", 5, 1, 16, 16, 8)
    assert applies("kernel", 3, 0, top, 8, 2) and not applies("kernel", 3, 0, top + 1, 8, 2)
    assert not applies("kernel", 3, 2, 16, 8, 2)            # the last axis: the rows
    assert not applies("kernel", 3, 1, 1, 8, 2)             # the decode step
    assert not applies("vector", 3, 1, 16, 8, 2) and not applies("matmul", 3, 1, 16, 8, 2)
    # "blocked" only where the axis is one block (B16 alone): 2·2·2 = 8 pairs a block
    assert applies("blocked", 3, 1, 8, 2, 2) and not applies("blocked", 3, 1, 9, 2, 2)

"""The model of B17's chunk-parallel pass against the JAX package, on the CPU.

``ssd_chunk_plain(chained=True)`` computes what the kernel's CTAs compute: every
chunk's ``y_diag`` and local state first, then the states handed on in chunk
order, then the off-diagonal term added after ``y_diag``.  It is held against
JAX's Pallas kernel in interpret mode (``repro.kernels.ops.ssd_kernel``) and the
fp64 oracle within ``tests/test_torch_ssd_chunk.py``'s ``TOL`` (2e-3), against
the Pallas kernel within its ``CLOSE`` (1e-4, the two chunked forms summing the
same fp32 products in other orders), and against the port's Pallas-algebra
plain version within ``CLOSE`` too.  Inputs are drawn with numpy from seeds.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import ssd_kernel as jax_ssd_kernel
from repro_torch.core.ssd import ssd_scan_ref
from repro_torch.kernels.ssd_chunk import ssd_chunk_plain, ssd_workspace_bytes

TOL = 2e-3                   # tests/test_torch_ssd_chunk.py
CLOSE = 1e-4
Q = 16


def _inputs(shape, seed, decays="mild"):
    b, s, h, p, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    if decays == "mild":             # the JAX sweep's -|0.1 g|
        a = -np.abs(rng.standard_normal((b, s, h)) * 0.1).astype(np.float32)
    else:                            # zamba2's init: -linspace(1, 16, H) * softplus(g)
        g = rng.standard_normal((b, s, h))
        a = (-np.linspace(1.0, 16.0, h) * np.log1p(np.exp(g))).astype(np.float32)
    bm = (rng.standard_normal((b, s, h, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, h, n)) * 0.3).astype(np.float32)
    return x, a, bm, cm


def _hold(shape, seed, chunk, decays="mild"):
    args = _inputs(shape, seed, decays)
    targs = [torch.from_numpy(t) for t in args]
    got = ssd_chunk_plain(*targs, chunk=chunk, chained=True)
    want = np.asarray(jax_ssd_kernel(*map(jnp.asarray, args), chunk=chunk))
    ref = ssd_scan_ref(*(t.double() for t in targs)).numpy()
    assert got.dtype == torch.float32 and tuple(got.shape) == args[0].shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CLOSE)
    np.testing.assert_allclose(got.numpy(), ssd_chunk_plain(*targs, chunk=chunk).numpy(),
                               rtol=0, atol=CLOSE)


@pytest.mark.parametrize("s", [1, Q - 1, Q, Q + 1, 3 * Q + 17])
def test_chained_pass_at_the_sequence_edges(s):
    """S of 1, Q - 1, Q, Q + 1 and 3Q + 17 (a ragged last chunk)."""
    _hold((2, s, 3, 8, 4), 100 + s, Q)


@pytest.mark.parametrize("s", [Q + 1, 3 * Q + 17])
def test_chained_pass_under_zamba2_decays(s):
    """zamba2's init decays: a chunk's log-decay cumsum reaches ~10^2, so
    exp(cs_i - cs_j) above the diagonal overflows and the hand-off decays hard."""
    args = _inputs((2, s, 16, 8, 8), 3, decays="zamba2")
    assert (-args[1][:, :Q]).sum(1).max() > 100
    _hold((2, s, 16, 8, 8), 3, Q, decays="zamba2")


def test_chained_pass_one_head_of_64_chunks():
    """A single (batch, head) whose state is handed on 63 times."""
    _hold((1, 64 * Q, 1, 8, 4), 9, Q)


def test_chained_pass_at_the_kernels_widths():
    """zamba2's widths, N = P = 64, at Q = 32 over 3 chunks and a ragged one."""
    _hold((1, 3 * 32 + 5, 2, 64, 64), 21, 32)


def test_workspace_holds_the_handed_on_states():
    """The counter and a flag a chunk (16-byte aligned together) and every chunk's
    state but the last: 63 MB at zamba2's forward shape (B·H = 256, 16 chunks)."""
    assert ssd_workspace_bytes(256, 16, 64, 64) == 8 + 4 * 4096 + 8 + 4 * 256 * 15 * 64 * 64
    assert ssd_workspace_bytes(1, 1, 64, 64) == 16
    assert ssd_workspace_bytes(3, 5, 7, 9) == 80 + 4 * 3 * 4 * 63

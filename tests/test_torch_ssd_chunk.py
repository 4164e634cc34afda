"""The port's SSD chunk kernel module (B17) against the JAX package, on the CPU.

On CPU tensors ``ssd_chunk_scan`` runs its plain version (the Pallas kernel's
algebra in PyTorch); the JAX side runs the Pallas kernel itself in interpret
mode (``repro.kernels.ops.ssd_kernel``, as ``tests/test_kernels.py`` runs it)
and the sequential oracle.  Inputs are drawn with numpy from a seed.  Both
packages and the oracle must agree within ``tests/test_kernels.py``'s 2e-3
(rtol and atol); the two chunked forms sum the same fp32 products in other
orders, so they also agree within ``CLOSE`` of each other.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.kernels.ops import ssd_kernel as jax_ssd_kernel
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro_torch.core.ssd import ssd_scan_ref
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunk import (SSD_SMEM_LIMIT, ssd_check_tile, ssd_chunk_plain,
                                           ssd_chunk_scan, ssd_smem_bytes)

TOL = 2e-3                   # tests/test_kernels.py::test_ssd_kernel_sweep
CLOSE = 1e-4                 # port against the Pallas kernel, absolute, O(1) outputs


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
    got = ssd_chunk_scan(*map(torch.from_numpy, args), chunk=chunk)
    want = np.asarray(jax_ssd_kernel(*map(jnp.asarray, args), chunk=chunk))
    ref = ssd_scan_ref(*(torch.from_numpy(t).double() for t in args)).numpy()
    assert got.dtype == torch.float32 and tuple(got.shape) == args[0].shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CLOSE)
    return got, ref


@pytest.mark.parametrize("shape", [(1, 64, 1, 4, 2), (2, 96, 3, 8, 4), (1, 250, 2, 16, 8)])
def test_ssd_chunk_matches_jax_kernel_and_oracle(shape):
    """The three shapes of the JAX package's sweep at chunk 32 (250: a ragged chunk)."""
    _hold(shape, shape[1], 32)


@pytest.mark.parametrize("shape,chunk", [((2, 20, 3, 8, 4), 32), ((1, 1, 2, 4, 4), 16),
                                         ((1, 48, 8, 16, 8), 16)])
def test_ssd_chunk_short_sequences_and_smoke_shape(shape, chunk):
    """S < chunk runs one chunk of S; (1, 48, 8, 16, 8) at 16 is zamba2 SMOKE's shape."""
    _hold(shape, 7, chunk)


def test_ssd_chunk_strong_decays_stay_finite():
    """zamba2's init decays: a chunk's log-decay cumsum reaches ~10^2-10^3, so
    exp(cs_i - cs_j) above the diagonal overflows; the masked form must not
    turn it into NaN."""
    args = _inputs((2, 128, 16, 8, 8), 3, decays="zamba2")
    assert (-args[1]).reshape(2, 2, 64, 16).sum(2).max() > 200
    _hold((2, 128, 16, 8, 8), 3, 64, decays="zamba2")


def test_ssd_chunk_plain_equals_wrapper_and_reads_strides():
    args = [torch.from_numpy(t) for t in _inputs((2, 40, 3, 8, 4), 5)]
    want = ssd_chunk_plain(*args, chunk=16)
    # the same values through views whose head axis is not next to the last one
    views = [torch.movedim(torch.movedim(t, 2, 0).contiguous(), 0, 2) for t in args]
    assert not views[0].is_contiguous()
    ops.reset_launch_counts()
    got = ssd_chunk_scan(*views, chunk=16)
    assert torch.equal(got, want)
    assert ops.launch_counts()["ssd_chunk"] == 0           # CPU tensors: no launch


def test_ssd_chunk_keeps_the_input_dtype():
    x, a, bm, cm = (torch.from_numpy(t) for t in _inputs((1, 33, 2, 8, 4), 9))
    y16 = ssd_chunk_scan(x.to(torch.bfloat16), a, bm, cm, chunk=16)
    assert y16.dtype == torch.bfloat16
    want = ssd_chunk_scan(x.to(torch.bfloat16).float(), a, bm, cm, chunk=16)
    assert torch.equal(y16, want.to(torch.bfloat16))


def test_ssd_chunk_refuses_grad_and_validates():
    x, a, bm, cm = (torch.from_numpy(t) for t in _inputs((1, 16, 2, 4, 4), 1))
    xg = x.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="ssd_chunk_scan has no gradient"):
        ssd_chunk_scan(xg, a, bm, cm, chunk=8)
    with torch.no_grad():
        assert torch.equal(ssd_chunk_scan(xg, a, bm, cm, chunk=8),
                           ssd_chunk_scan(x, a, bm, cm, chunk=8))
    with pytest.raises(ValueError):
        ssd_chunk_scan(x, a[:, :8], bm, cm)
    with pytest.raises(ValueError):
        ssd_chunk_scan(x, a, bm, cm[..., :2])
    with pytest.raises(ValueError):
        ssd_chunk_scan(x, a, bm, cm, chunk=0)


@pytest.mark.parametrize("q,n,p,fits", [(128, 64, 64, True), (16, 8, 16, True),
                                        (64, 128, 64, True), (256, 64, 64, False),
                                        (128, 64, 128, False), (128, 256, 64, False)])
def test_ssd_chunk_shared_memory_limit(q, n, p, fits):
    """zamba2 (Q 128, N = P = 64) takes 105 KB a CTA, so two CTAs share an SM's
    228 KB (1 KB of it reserved a CTA); a chunk past a CTA's 8 strips of y, 16 tiles
    of the state or 227 KB of shared memory is refused: Q 256 at zamba2's widths."""
    assert ssd_smem_bytes(128, 64, 64) == 107520
    assert 2 * (ssd_smem_bytes(128, 64, 64) + 1024) <= 228 * 1024
    if fits:
        ssd_check_tile(q, n, p)
        assert ssd_smem_bytes(q, n, p) <= SSD_SMEM_LIMIT
    else:
        with pytest.raises(ValueError, match="shared memory"):
            ssd_check_tile(q, n, p)


def test_ssd_chunk_oracle_is_the_jax_oracle():
    args = _inputs((1, 40, 2, 4, 4), 11)
    np.testing.assert_allclose(ssd_scan_ref(*map(torch.from_numpy, args)).numpy(),
                               np.asarray(jax_ssd_ref(*map(jnp.asarray, args))),
                               rtol=1e-5, atol=1e-5)

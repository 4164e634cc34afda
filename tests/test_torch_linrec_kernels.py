"""The port's linear-recurrence kernels (B13–B16) against the JAX package, phase by phase.

Inputs are drawn with numpy from a seed and go through both packages.  The
JAX kernels run in Pallas interpret mode (their own default on the CPU) with
``s=8`` and short rows; the port's wrappers run their plain versions, as
every kernel wrapper does on a CPU tensor.  Tolerances:

* integer-valued pairs (``a ∈ {-1, 0, 1}``, ``b ∈ [-3, 3]``) are bit-identical
  to the JAX result: every product, quotient and sum is an exact small integer;
* gated fp32 (``a = exp(-0.1|g|)``, ``b ~ N(0, 1)``, ~20% zeros in ``a`` for
  the ``zeros`` kind) is within ``rtol = atol = 1e-6``: the same block algebra,
  with products and sums taken in other orders by torch and XLA (the largest
  difference seen is ~2e-7 of the values).
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.kernels import linrec_mm as jax_lin
from repro_torch.kernels import linrec_mm as port_lin

ROWS, N, S = 3, 333, 8                   # ragged: not a multiple of any tile or block
KINDS = ["int", "gated", "zeros"]
TOL = dict(rtol=1e-6, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _pair(kind: str, shape=(ROWS, N), seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return (rng.integers(-1, 2, shape).astype(np.float32),
                rng.integers(-3, 4, shape).astype(np.float32))
    a = np.exp(-np.abs(rng.standard_normal(shape)) * 0.1).astype(np.float32)
    if kind == "zeros":
        a[rng.random(shape) < 0.2] = 0.0
    return a, rng.standard_normal(shape).astype(np.float32)


def _hold(kind: str, got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if kind == "int":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@functools.lru_cache(maxsize=None)
def _blocks(kind: str, block_tiles: int, reps: int = 1):
    """The identity-padded ``(rows, nb, m, s)`` block views of one input, as numpy."""
    a, b = (np.concatenate([x] * reps, -1) for x in _pair(kind))
    n = a.shape[-1]
    m = max(1, min(block_tiles, -(-n // (S * S)))) * S
    nb = -(-n // (m * S))
    pad = nb * m * S - n
    a = np.pad(a, ((0, 0), (0, pad)), constant_values=1.0)
    b = np.pad(b, ((0, 0), (0, pad)))
    return a.reshape(ROWS, nb, m, S), b.reshape(ROWS, nb, m, S)


@pytest.mark.parametrize("kind", KINDS)
def test_b13_scan_tiles_matches_jax(kind):
    a, b = _pair(kind)
    want = jax_lin.linrec_scan_tiles(jnp.asarray(a), jnp.asarray(b), s=S)
    got = port_lin.linrec_scan_tiles(torch.from_numpy(a), torch.from_numpy(b), s=S)
    _hold(kind, got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block_tiles,reps", [(2, 1), (40, 16)])   # m = 16; m = 320 (tall)
def test_b14_b16_phases_match_jax(kind, block_tiles, reps):
    """B14's summaries, B15's carries from them and B16's blocks from those, each
    phase fed the JAX result of the phase before; with ``m > 256`` B16 chains its
    rows through the chunked scan (the tall-block branch)."""
    ab, bb = _blocks(kind, block_tiles, reps)
    ja, jb = jnp.asarray(ab), jnp.asarray(bb)
    ta, tb = torch.from_numpy(ab), torch.from_numpy(bb)
    jp, jl = jax_lin.linrec_block_summaries(ja, jb)
    tp, tl = port_lin.linrec_block_summaries(ta, tb)
    _hold(kind, tp, jp)
    _hold(kind, tl, jl)
    jc = jax_lin.linrec_carry_scan(jp, jl)
    tc = port_lin.linrec_carry_scan(torch.from_numpy(np.array(jp)),
                                    torch.from_numpy(np.array(jl)))
    _hold(kind, tc, jc)
    want = jax_lin.linrec_block_scan_carry(ja, jb, jc)
    got = port_lin.linrec_block_scan_carry(ta, tb, torch.from_numpy(np.array(jc)))
    _hold(kind, got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_b15_many_blocks_matches_jax(kind):
    """Phase 2 over 300 summaries: past one 128-chunk of the chunked scan."""
    p, lv = _pair(kind, shape=(2, 300), seed=5)
    want = jax_lin.linrec_carry_scan(jnp.asarray(p), jnp.asarray(lv))
    got = port_lin.linrec_carry_scan(torch.from_numpy(p), torch.from_numpy(lv))
    _hold(kind, got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block_tiles", [1, 2, 8])      # nb = 6, 3 and 1 (B16 alone)
def test_blocked_pipeline_matches_jax(kind, block_tiles):
    a, b = _pair(kind)
    want = jax_lin.linrec_blocked_scan(jnp.asarray(a), jnp.asarray(b), s=S,
                                       block_tiles=block_tiles)
    got = port_lin.linrec_blocked_scan(torch.from_numpy(a), torch.from_numpy(b), s=S,
                                       block_tiles=block_tiles)
    _hold(kind, got, want)


def _seq64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    y = np.zeros(a.shape[:-1])
    out = np.empty(a.shape)
    for t in range(a.shape[-1]):
        y = a[..., t].astype(np.float64) * y + b[..., t]
        out[..., t] = y
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_follow_the_recurrence(kind):
    """Both plain paths, and the 16-long rows of the SSD shape (one short tile), against
    the fp64 sequential recurrence: exact for integer values, 3e-5 for gated fp32
    (the JAX package's own limit for its gated recurrences)."""
    a, b = _pair(kind)
    ref = _seq64(a, b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got in (port_lin.linrec_scan_tiles(ta, tb, s=S),
                port_lin.linrec_blocked_scan(ta, tb, s=S, block_tiles=2),
                port_lin.linrec_scan_tiles(ta[:, :16], tb[:, :16], s=16),
                port_lin.linrec_blocked_scan(ta[:, :16], tb[:, :16], s=16)):
        want = ref[:, :got.shape[-1]]
        if kind == "int":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def test_wrappers_validate_shapes():
    x = torch.ones((2, 8))
    with pytest.raises(ValueError):
        port_lin.linrec_scan_tiles(x, torch.ones((2, 9)))
    with pytest.raises(ValueError):
        port_lin.linrec_block_summaries(x, x)
    with pytest.raises(ValueError):
        port_lin.linrec_block_scan_carry(x.reshape(1, 2, 2, 4), x.reshape(1, 2, 2, 4),
                                         torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="precision"):
        port_lin.linrec_scan_tiles(x, x, precision="exact")
    assert torch.equal(port_lin.linrec_scan_tiles(x, x, s=2, precision="compensated"),
                       port_lin.linrec_scan_tiles(x, x, s=2))
    assert port_lin.linrec_scan_tiles(torch.ones((3, 0)), torch.ones((3, 0))).shape == (3, 0)

"""The port's xLSTM (xlstm-350m) against the JAX package, on the CPU in fp32.

* ``mlstm_chunked``, the mLSTM cell as two chunked SSD scans, against JAX's on
  ``"vector"``, ``"matmul"``, ``"kernel"`` and ``"blocked"`` (the kernels' plain
  versions here) and against both packages' sequential ``mlstm_ref``, on one
  chunk boundary and a ragged last chunk (chunks of 8), and under
  ``precision="compensated"`` within twice ``"highest"``'s SSD limit of JAX's
  (as ``test_torch_precision.py`` holds ``ssd_scan``);
* the mLSTM and sLSTM blocks and their decode steps with their caches;
* the SMOKE model: ``forward``/``loss``, prefill plus 8 decode steps with the
  greedy stream, and the top-p stream under the JAX engine's uniforms.

The cell divides by ``|q·n| + 1e-6``, and ``q·n`` sums terms of both signs: on
random signed inputs it nearly cancels, so fp32 programs that differ only in
the order of their sums (and in ``exp``'s last bit: XLA's and ATen's differ)
differ far above an ulp of the result.  The cell tests therefore hold the port
within ``CELL_ATOL`` of JAX on inputs with ``q, k >= 0`` (no cancellation), and
on signed inputs no further from the fp64 oracle than ``2×`` JAX's own fp32
result is.  The SMOKE model at random weights meets the same cancellation: its
logits are held within ``XLSTM_ATOL`` of JAX's (measured 3.7e-4 in the forward
and 4.2e-5 in decode; JAX's fp32 logits themselves lie 3.6e-4 from the same JAX
model run under ``jax.enable_x64``), and the port's fp32 logits no further from
that x64 run than JAX's fp32 logits are, plus ``CELL_ATOL``.  ``loss`` within
``LOSS_ATOL``; the greedy and top-p streams equal.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ssd import mlstm_chunked as jax_mlstm_chunked
from repro.core.ssd import mlstm_ref as jax_mlstm_ref
from repro.models import xlstm as jax_xl
from repro.models.layers import use_compute_dtype
from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.ssd import mlstm_chunked, mlstm_ref
from repro_torch.models import xlstm
from repro_torch.models.model import get_config
from torch_family_refs import (LOSS_ATOL, as_jax, batch, check_config, check_greedy_decode,
                               check_params_carry, check_topp_stream, jax_params, jax_train,
                               port_train)

ARCH = "xlstm-350m"
METHODS = ("vector", "matmul", "kernel", "blocked")
CELL_ATOL = 2e-5
XLSTM_ATOL = 1e-3
SSD_REL = 2e-6               # test_torch_precision.py's "highest" limit of ssd_scan
CHUNK = 8


@functools.lru_cache(maxsize=None)
def _cell_inputs(s: int, signed: bool):
    """(q, k, v, i_pre, f_pre) of (2, s, 4, 16); ``signed=False`` takes |q|, |k|."""
    rng = np.random.default_rng(s + 100 * signed)
    q, k, v = (rng.standard_normal((2, s, 4, 16)).astype(np.float32) for _ in range(3))
    if not signed:
        q, k = np.abs(q), np.abs(k)
    i_pre = rng.standard_normal((2, s, 4)).astype(np.float32)
    f_pre = (rng.standard_normal((2, s, 4)) + 3.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


@functools.lru_cache(maxsize=None)
def _jax_cell(s, signed, method, precision="highest"):
    f = jax.jit(functools.partial(jax_mlstm_chunked, chunk=CHUNK, scan_method=method,
                                  precision=precision))
    return np.asarray(f(*map(jnp.asarray, _cell_inputs(s, signed))))


def _port_cell(s, signed, method, precision="highest"):
    return mlstm_chunked(*map(torch.from_numpy, _cell_inputs(s, signed)), chunk=CHUNK,
                         scan_method=method, precision=precision).numpy()


def _oracle64(s, signed):
    return mlstm_ref(*(torch.from_numpy(a).double() for a in _cell_inputs(s, signed))).numpy()


@pytest.mark.parametrize("s", [24, 27], ids=["chunks", "ragged"])
@pytest.mark.parametrize("method", METHODS)
def test_mlstm_chunked_matches_jax_and_the_oracle(method, s):
    got = _port_cell(s, False, method)
    assert got.dtype == np.float32 and got.shape == (2, s, 4, 16)
    np.testing.assert_allclose(got, _jax_cell(s, False, method), rtol=0, atol=CELL_ATOL)
    ref32 = mlstm_ref(*map(torch.from_numpy, _cell_inputs(s, False))).numpy()
    np.testing.assert_allclose(got, ref32, rtol=0, atol=CELL_ATOL)
    jref = np.asarray(jax_mlstm_ref(*map(jnp.asarray, _cell_inputs(s, False))))
    np.testing.assert_allclose(ref32, jref, rtol=0, atol=CELL_ATOL)


@pytest.mark.parametrize("method", METHODS)
def test_mlstm_chunked_on_signed_inputs_no_less_accurate_than_jax(method):
    """Where ``q·n`` cancels, the port's distance to the fp64 oracle is at most
    twice JAX's."""
    ref = _oracle64(27, True)
    port = np.abs(_port_cell(27, True, method) - ref).max()
    jax_err = np.abs(_jax_cell(27, True, method) - ref).max()
    assert port <= 2 * jax_err, (port, jax_err)


@pytest.mark.parametrize("method", ["matmul", "kernel", "blocked"])
def test_mlstm_chunked_precision_within_twice_the_limit_of_jax(method):
    want = _jax_cell(27, False, method, "compensated")
    got = _port_cell(27, False, method, "compensated")
    assert np.abs(got - want).max() <= 2 * SSD_REL * np.abs(want).max()


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _layer_params(sub):
    """Layer 0's mixer of ``stack.sub{i}``: JAX's and the port's."""
    jp = jax.tree.map(lambda a: a[0], jax_params(ARCH)["stack"][sub]["mixer"])
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _block_input(s=20):
    rng = np.random.default_rng(3)
    return rng.standard_normal((2, s, 64)).astype(np.float32)


def _close(got, want, atol=CELL_ATOL):
    """Leaf by leaf within ``atol`` of the larger of 1 and the leaf's max."""
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=atol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_and_step_match_jax(kind):
    """The block over 20 tokens with its cache, then two decode steps from it."""
    jcfg, tcfg = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp, tp = _layer_params("sub0" if kind == "mlstm" else "sub3")
    x = _block_input()
    steps = np.random.default_rng(4).standard_normal((2, 2, 1, 64)).astype(np.float32)
    jfull, jstep = ((jax_xl.mlstm_block, jax_xl.mlstm_block_step) if kind == "mlstm"
                    else (jax_xl.slstm_block, jax_xl.slstm_block_step))
    tfull, tstep = ((xlstm.mlstm_block, xlstm.mlstm_block_step) if kind == "mlstm"
                    else (xlstm.slstm_block, xlstm.slstm_block_step))
    with use_compute_dtype(jnp.float32):
        jy, jc = jax.jit(lambda p, x: jfull(p, x, jcfg, return_cache=True))(jp, jnp.asarray(x))
        jsteps = []
        step = jax.jit(lambda p, x, c: jstep(p, x, jcfg, c))
        for t in steps:
            y, jc = step(jp, jnp.asarray(t), jc)
            jsteps.append((y, jc))
    ty, tc = tfull(tp, torch.from_numpy(x), tcfg, cdt=torch.float32, return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=CELL_ATOL)
    assert tfull(tp, torch.from_numpy(x), tcfg, cdt=torch.float32).equal(ty)
    for t, (y, c) in zip(steps, jsteps):
        ty, tc = tstep(tp, torch.from_numpy(t), tcfg, tc, cdt=torch.float32)
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=0, atol=CELL_ATOL)
        _close(tc, c)
        assert jax.tree.structure(jax.tree.map(np.asarray, c)) == \
            jax.tree.structure(jax.tree.map(lambda a: a.numpy(), tc))


# ---------------------------------------------------------------------------
# the SMOKE model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_jax_config(smoke):
    check_config(ARCH, smoke)


def test_params_carry_across_leaf_for_leaf():
    """Both cells' ``mixer`` leaves (``in_proj``, ``w_if``, ``if_bias``, ``skip``;
    ``w_in``, ``r``, ``gate_bias``, ``ff_up``) come across."""
    check_params_carry(ARCH, {"mixer", "in_proj", "wq", "w_if", "if_bias", "skip",
                              "out_norm", "w_in", "r", "gate_bias", "ff_up", "ff_down"})


@functools.lru_cache(maxsize=None)
def _jax_logits_x64():
    """JAX's SMOKE forward under ``jax.enable_x64`` on fp64 weights (JAX's own
    fp32 constants still round some of it)."""
    cfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype="float64")
    with jax.enable_x64():
        jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jax_params(ARCH))
        return np.asarray(jax.jit(jax_build_model(cfg).forward)(jp, as_jax(batch(ARCH))),
                          np.float64)


def test_forward_and_loss_match_jax():
    got, (total, ce, aux) = port_train(ARCH)
    want, (j_total, j_ce, j_aux) = jax_train(ARCH)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=XLSTM_ATOL)
    wide = _jax_logits_x64()
    assert np.abs(got.numpy() - wide).max() <= np.abs(want - wide).max() + CELL_ATOL
    assert abs(ce - j_ce) <= LOSS_ATOL and abs(total - j_total) <= LOSS_ATOL
    assert aux == j_aux == 0.0


def test_prefill_and_greedy_decode_match_jax():
    """The caches ``{conv, c, n, m}`` (mLSTM) and ``{conv, rec: (c, n, m, h)}``
    (sLSTM) in JAX's layout; each step's logits within ``XLSTM_ATOL``."""
    caches = check_greedy_decode(ARCH, XLSTM_ATOL)
    assert set(caches["stack"]["sub0"]) == {"conv", "c", "n", "m"}
    assert isinstance(caches["stack"]["sub3"]["rec"], tuple)


def test_topp_stream_matches_jax_under_its_uniforms():
    check_topp_stream(ARCH)

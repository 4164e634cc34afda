"""The port's MLA (minicpm3-4b) against the JAX package, on the CPU in fp32.

``mla_full`` (the expanded form of train and prefill) and ``mla_decode`` (the
absorbed-matrix decode over the compressed ``{latent, k_rope}`` cache) each
against JAX's on layer 0's SMOKE weights, their outputs and caches within
``ATOL``; the absorbed decode at position ``s`` against the last row of the
expanded form over the same ``s + 1`` tokens (the two round differently), in
both packages; the SMOKE model's ``forward``/``loss``, prefill plus 8 greedy
decode steps and the top-p stream under the JAX engine's uniforms.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.models import attention as jax_att
from repro.models.layers import use_compute_dtype
from repro.models.model import get_config as jax_get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as att
from repro_torch.models.model import get_config
from torch_family_refs import (LOSS_ATOL, check_config, check_greedy_decode,
                               check_params_carry, check_topp_stream, jax_params, jax_train,
                               port_train)

ARCH = "minicpm3-4b"
ATOL = 2e-5
S, T = 12, 16                # prompt and cache length of the layer tests


def _layer():
    jp = jax.tree.map(lambda a: a[0], jax_params(ARCH)["stack"]["sub0"]["attn"])
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(s, seed=5):
    return np.random.default_rng(seed).standard_normal((2, s, 64)).astype(np.float32)


def _jax_mla(jp, x, n_steps):
    """JAX's expanded prefill of the first ``S`` rows of ``x`` and its absorbed
    decode of the next ``n_steps``."""
    cfg = jax_get_config(ARCH, smoke=True)
    with use_compute_dtype(jnp.float32):
        full = jax.jit(lambda p, x: jax_att.mla_full(
            p, x, cfg, positions=jnp.arange(x.shape[1])[None], return_cache=True,
            cache_len=T))
        dec = jax.jit(lambda p, x, c, pos: jax_att.mla_decode(p, x, cfg, c, pos))
        y, c = full(jp, jnp.asarray(x[:, :S]))
        steps = []
        for i in range(n_steps):
            yi, c = dec(jp, jnp.asarray(x[:, S + i:S + i + 1]), c, jnp.asarray(S + i))
            steps.append(np.asarray(yi))
    return np.asarray(y), steps, jax.tree.map(np.asarray, c)


def test_mla_full_and_decode_match_jax():
    cfg = get_config(ARCH, smoke=True)
    jp, tp = _layer()
    x = _x(S + 3)
    jy, jsteps, jc = _jax_mla(jp, x, 3)
    pos = torch.arange(S, dtype=torch.int32)[None]
    y, cache = att.mla_full(tp, torch.from_numpy(x[:, :S]), cfg, positions=pos,
                            cdt=torch.float32, return_cache=True, cache_len=T)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=ATOL)
    assert set(cache) == {"latent", "k_rope"}
    assert tuple(cache["latent"].shape) == (2, T, cfg.mla.kv_lora_rank)
    assert tuple(cache["k_rope"].shape) == (2, T, cfg.mla.qk_rope_head_dim)
    for i, want in enumerate(jsteps):
        yi, cache = att.mla_decode(tp, torch.from_numpy(x[:, S + i:S + i + 1]), cfg, cache,
                                   S + i, cdt=torch.float32)
        np.testing.assert_allclose(yi.numpy(), want, rtol=0, atol=ATOL)
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(), jc[name], rtol=0, atol=ATOL)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_absorbed_decode_close_to_the_expanded_last_row(package):
    """Decode at position ``S`` after a prefill of ``S`` tokens against row ``S``
    of ``mla_full`` over all ``S + 1``: the same attention, rounded differently."""
    cfg = get_config(ARCH, smoke=True)
    jp, tp = _layer()
    x = _x(S + 1, seed=6)
    if package == "jax":
        _, (dec,), _ = _jax_mla(jp, x, 1)
        with use_compute_dtype(jnp.float32):
            full = np.asarray(jax_att.mla_full(jp, jnp.asarray(x),
                                               jax_get_config(ARCH, smoke=True),
                                               positions=jnp.arange(S + 1)[None]))
    else:
        pos = torch.arange(S, dtype=torch.int32)[None]
        _, cache = att.mla_full(tp, torch.from_numpy(x[:, :S]), cfg, positions=pos,
                                cdt=torch.float32, return_cache=True, cache_len=T)
        dec = att.mla_decode(tp, torch.from_numpy(x[:, S:]), cfg, cache, S,
                             cdt=torch.float32)[0].numpy()
        full = att.mla_full(tp, torch.from_numpy(x), cfg,
                            positions=torch.arange(S + 1, dtype=torch.int32)[None],
                            cdt=torch.float32).numpy()
    np.testing.assert_allclose(dec[:, 0], full[:, S], rtol=0, atol=ATOL)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_jax_config(smoke):
    check_config(ARCH, smoke)


def test_params_carry_across_leaf_for_leaf():
    check_params_carry(ARCH, {"q_a", "q_a_norm", "q_b", "kv_a", "kv_a_norm", "kv_b"})


def test_forward_and_loss_match_jax():
    got, (total, ce, aux) = port_train(ARCH)
    want, (j_total, j_ce, j_aux) = jax_train(ARCH)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert abs(ce - j_ce) <= LOSS_ATOL and abs(total - j_total) <= LOSS_ATOL


def test_prefill_and_greedy_decode_match_jax():
    """The compressed caches in JAX's layout, each step within ``ATOL``."""
    caches = check_greedy_decode(ARCH, ATOL)
    assert set(caches["stack"]["sub0"]) == {"latent", "k_rope"}


def test_topp_stream_matches_jax_under_its_uniforms():
    check_topp_stream(ARCH)

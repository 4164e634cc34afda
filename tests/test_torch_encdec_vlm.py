"""The port's enc-dec (whisper-small) and VLM (paligemma-3b) against the JAX package.

On the CPU in fp32, with the stub ``enc_embed`` and ``img_embed`` drawn with
numpy from a seed: each SMOKE model's ``forward``/``loss`` (the VLM's loss on
its text positions only), prefill plus 8 greedy decode steps (whisper's cross
KV ``xkv`` computed once at prefill and left as it was; the VLM's decode
positions counting its image tokens) and the top-p stream under the JAX
engine's uniforms; the sinusoidal positions against JAX's; the prefix-LM mask's
rows against the dependence JAX's ``attn_full`` shows.

``sinusoidal_pos`` is not bit-equal to JAX's: XLA's fp32 ``exp`` and ATen's
differ in the last bit of 39 of whisper's 384 column rates, and row ``pos``
carries that into its angle ``pos × rate``.  The rates are held within one ulp
of JAX's and the table within ``pos`` ulps of the angle a row.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.models import attention as jax_att
from repro.models.layers import sinusoidal_pos as jax_sinusoidal_pos
from repro.models.layers import use_compute_dtype
from repro.models.model import get_config as jax_get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as att
from repro_torch.models.layers import sinusoid_at, sinusoidal_pos
from repro_torch.models.model import build_model, get_config
from torch_family_refs import (LOSS_ATOL, NEW, P, as_torch, batch, check_config,
                               check_greedy_decode, check_params_carry, check_topp_stream,
                               jax_params, jax_train, port_params, port_train, prompt)

ARCHS = ("whisper-small", "paligemma-3b")
ATOL = 2e-5


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_jax_config(arch, smoke):
    check_config(arch, smoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_leaf_for_leaf(arch):
    want = {"whisper-small": {"enc_stack", "enc_norm", "xattn", "norm_x"},
            "paligemma-3b": {"stack", "attn", "mlp"}}[arch]
    check_params_carry(arch, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    got, (total, ce, aux) = port_train(arch)
    want, (j_total, j_ce, j_aux) = jax_train(arch)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert abs(ce - j_ce) <= LOSS_ATOL and abs(total - j_total) <= LOSS_ATOL


def test_vlm_forward_covers_the_image_and_loss_the_text():
    """paligemma's logits cover its 8 image positions and the text; its loss is
    the text's alone (a text-only mask leaves it unchanged)."""
    arch = "paligemma-3b"
    cfg = get_config(arch, smoke=True)
    b = as_torch({k: v for k, v in batch(arch).items() if k != "loss_mask"})
    tm = build_model(cfg)
    logits = tm.forward(port_params(arch), b)
    assert tuple(logits.shape)[:2] == (2, cfg.n_img_tokens + b["tokens"].shape[1])
    _, parts = tm.loss(port_params(arch), b)
    _, ones = tm.loss(port_params(arch), {**b, "loss_mask": torch.ones_like(b["tokens"])})
    assert float(parts["ce"]) == float(ones["ce"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch):
    caches = check_greedy_decode(arch, ATOL)
    if arch == "whisper-small":
        assert set(caches["stack"]["sub0"]) == {"kv", "xkv"}


def test_whisper_cross_kv_computed_once_at_prefill():
    """The ``xkv`` cache after 8 decode steps is the prefill's, bit for bit, and
    equals ``cross_kv`` of the encoder's output."""
    arch = "whisper-small"
    tm = build_model(get_config(arch, smoke=True))
    tp = port_params(arch)
    _, caches = tm.prefill(tp, as_torch(prompt(arch)), cache_len=P + NEW)
    before = {k: v.clone() for k, v in caches["stack"]["sub0"]["xkv"].items()}
    tok = torch.zeros((2, 1), dtype=torch.int64)
    for i in range(NEW - 1):
        _, caches = tm.decode_step(tp, tok, caches, P + i)
    for k, v in before.items():
        assert torch.equal(caches["stack"]["sub0"]["xkv"][k], v)
    enc = tm._encode(tp, torch.from_numpy(prompt(arch)["enc_embed"]))
    layer0 = {k: v[0] for k, v in tp["stack"]["sub0"]["xattn"].items()}
    xkv = att.cross_kv(layer0, enc, tm.cfg, cdt=torch.float32)
    assert torch.equal(xkv["k"], before["k"][0]) and torch.equal(xkv["v"], before["v"][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_topp_stream_matches_jax_under_its_uniforms(arch):
    check_topp_stream(arch)


@pytest.mark.parametrize("seq,d", [(32, 64), (1500, 768), (256, 2048)])
def test_sinusoidal_pos_matches_jax(seq, d):
    want = np.asarray(jax_sinusoidal_pos(seq, d))
    got = sinusoidal_pos(seq, d).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    rate_j = np.asarray(jnp.exp(jnp.arange(0, d, 2, dtype=jnp.float32)
                                * (-jnp.log(10000.0) / d)))
    rate_t = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                       * (-torch.log(torch.tensor(10000.0)) / d)).numpy()
    np.testing.assert_array_max_ulp(rate_t, rate_j, maxulp=1)
    # an angle's error is pos ulps of its rate (<= 1): at most pos * 2^-23 + 1 ulp
    pos = np.arange(seq, dtype=np.float64)[:, None]
    assert (np.abs(got - want) <= (pos + 1) * 2.0 ** -23 + 2.0 ** -24).all()
    if seq == 32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_decode_position_is_row_pos_of_the_table():
    """The decoder's sinusoid at ``pos`` in decode is row ``pos`` of the train table."""
    table = sinusoidal_pos(64, 64)
    for pos in (0, 7, 63):
        assert torch.equal(sinusoid_at(torch.full((1,), pos), 64)[0], table[pos])


def _dependence(fn, x: np.ndarray) -> np.ndarray:
    """``M[i, j]``: output position ``i`` of ``fn`` changes when input ``j`` does."""
    base = fn(x)
    s = x.shape[1]
    out = np.zeros((s, s), bool)
    for j in range(s):
        xj = x.copy()
        xj[:, j] += 1.0
        out[:, j] = (fn(xj) != base).any(axis=(0, 2))
    return out


def test_prefix_mask_rows_equal_jax():
    """paligemma's layer-0 ``attn_full`` under ``prefix_len = n_img_tokens``: the
    rows of which inputs each output depends on, in JAX and in the port, equal
    the port's ``attn_mask`` (bidirectional over the image, causal after it);
    the outputs within ``ATOL``."""
    arch = "paligemma-3b"
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = jax.tree.map(lambda a: a[0], jax_params(arch)["stack"]["sub0"]["attn"])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    s, pl = 14, cfg.n_img_tokens
    x = np.random.default_rng(8).standard_normal((1, s, 64)).astype(np.float32)
    pos = np.arange(s)[None]
    with use_compute_dtype(jnp.float32):
        jf = jax.jit(lambda p, x: jax_att.attn_full(p, x, jcfg, positions=jnp.asarray(pos),
                                                    prefix_len=pl))

        def jax_fn(x):
            return np.asarray(jf(jp, jnp.asarray(x)))
        jmask = _dependence(jax_fn, x)

    def port_fn(x):
        return att.attn_full(tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
                             cdt=torch.float32, prefix_len=pl).numpy()

    mask = att.attn_mask(s, s, prefix_len=pl).numpy()
    np.testing.assert_array_equal(jmask, mask)
    np.testing.assert_array_equal(_dependence(port_fn, x), mask)
    assert mask[:pl, :pl].all() and not mask[pl - 1, pl:].any()
    np.testing.assert_allclose(port_fn(x), jax_fn(x), rtol=0, atol=ATOL)

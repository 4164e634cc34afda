"""The port's qwen3, gemma2, deepseek-moe and llama4-scout models against the JAX package.

Each JAX SMOKE model is initialised from a fixed key and its parameters carried
across with :func:`repro_torch.convert.params_from_jax`; both packages run the
same numpy prompts on the CPU in fp32.  These configs bring the options of
ROADMAP Queue A items 7.1 and 7.2: qwen3's per-head q/k RMSNorm; gemma2's
local/global layer pattern (a SMOKE window of 16), attention and final
softcaps, sandwich norms, tanh gelu and scaled embeddings; the MoE stacks
(deepseek's leading dense layer, 8 routed experts top-2 and 2 shared; llama4's
4 experts top-1 and 1 shared), whose dispatch is the paper's int8 mask scan.

Logits agree within ``ATOL`` (fp32 products summed in other orders), the loss
within ``LOSS_ATOL`` and the MoE load-balancing ``aux`` within ``AUX_ATOL``.
Greedy streams and top-p streams under the JAX engine's uniforms are equal
over a prefill and 8 decode steps (gemma2's reach past its window).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models.model import build_model, get_config
from repro_torch.serving.engine import ServeEngine

ARCHS = ("qwen3-4b", "gemma2-2b", "deepseek-moe-16b", "llama4-scout-17b-16e")
ATOL = 2e-5
LOSS_ATOL = 1e-5
AUX_ATOL = 1e-6
B, S = 2, 24                 # forward: past gemma2 SMOKE's window of 16
P, NEW = 12, 9               # serving: a prefill and 8 decode steps, to position 20


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.jit(jax_build_model(jax_get_config(arch, smoke=True)).init)(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return params_from_jax(jax.tree.map(np.asarray, _jax_params(arch)), device="cpu")


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.int32)
    return toks, mask


def _uniforms(key, steps: int, b: int) -> np.ndarray:
    """The JAX engine's per-step sampler uniforms, as a (steps, b) array."""
    us = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(k, (b, 1), dtype=jnp.float32)))
    return np.concatenate(us, axis=1).T


@functools.lru_cache(maxsize=None)
def _jax_train(arch, params_key=None):
    """JAX's ``forward`` logits and masked ``loss`` parts, in one jit."""
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    params = _jax_params(arch) if params_key is None else _qk_norm_params()[0]
    toks, mask = _batch()
    batch = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    logits, (total, parts) = jax.jit(lambda p, b: (jm.forward(p, b), jm.loss(p, b)))(
        params, batch)
    return np.asarray(logits), (float(total), float(parts["ce"]), float(parts["aux"]))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_jax_config(arch, smoke):
    j, t = jax_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.padded_vocab == t.padded_vocab and j.head_dim_ == t.head_dim_


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_leaf_for_leaf(arch):
    """``params_from_jax`` keeps every leaf (``pre``, ``experts``, ``shared``,
    ``q_norm``, ``post_norm*``): the port's own init draws the same tree."""
    jl = jax.tree_util.tree_leaves_with_path(_jax_params(arch))
    tp = _port_params(arch)
    assert len(jl) == len(jax.tree.leaves(tp))
    for path, leaf in jl:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    own = build_model(get_config(arch, smoke=True)).init(0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda a: a.shape, _jax_params(arch))
    names = {k.key for path, _ in jl for k in path}
    want = {"qwen3-4b": {"q_norm", "k_norm"}, "gemma2-2b": {"post_norm1", "post_norm2"},
            "deepseek-moe-16b": {"pre", "experts", "shared", "router"},
            "llama4-scout-17b-16e": {"experts", "shared", "router"}}[arch]
    assert want <= names


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    tm = build_model(get_config(arch, smoke=True))
    toks, mask = _batch()
    ops.reset_launch_counts()
    got = tm.forward(_port_params(arch), {"tokens": torch.from_numpy(toks)})
    total, parts = tm.loss(_port_params(arch), {"tokens": torch.from_numpy(toks),
                                                "loss_mask": torch.from_numpy(mask)})
    assert not any(ops.launch_counts().values())            # CPU: plain versions only
    want, (j_total, j_ce, j_aux) = _jax_train(arch)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert abs(float(parts["ce"]) - j_ce) <= LOSS_ATOL
    assert abs(float(parts["aux"]) - j_aux) <= AUX_ATOL
    assert abs(float(total) - j_total) <= LOSS_ATOL
    moe = get_config(arch, smoke=True).moe is not None
    assert (float(parts["aux"]) > 0) == moe                 # summed over the MoE layers
    assert float(total) == float(parts["ce"] + 0.01 * parts["aux"])


@functools.lru_cache(maxsize=None)
def _jax_decode(arch):
    """JAX's prefill and 8 greedy decode steps: (logits of each step, tokens)."""
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    jp = _jax_params(arch)
    toks = _batch()[0][:, :P]
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=P + NEW))
    step = jax.jit(jm.decode_step)
    lg, caches = prefill(jp, jnp.asarray(toks))
    logits, out = [np.asarray(lg)], [np.asarray(jnp.argmax(lg, -1)).astype(np.int32)]
    for i in range(NEW - 1):
        lg, caches = step(jp, jnp.asarray(out[-1][:, None]), caches,
                          jnp.asarray(P + i, jnp.int32))
        logits.append(np.asarray(lg))
        out.append(np.asarray(jnp.argmax(lg, -1)).astype(np.int32))
    return logits, np.stack(out, 1), jax.tree.map(lambda a: a.shape, caches)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch):
    """Each step's logits within ``ATOL``, the greedy stream equal, JAX's cache
    layout (``pre``, ``stack.sub{i}``); gemma2's steps reach position 20, past
    its window of 16."""
    tm = build_model(get_config(arch, smoke=True))
    tp = _port_params(arch)
    want_logits, want_toks, want_layout = _jax_decode(arch)
    lg, caches = tm.prefill(tp, {"tokens": torch.from_numpy(_batch()[0][:, :P])},
                            cache_len=P + NEW)
    assert jax.tree.map(lambda t: tuple(t.shape), caches) == want_layout
    empty = tm.empty_caches(B, P + NEW, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), empty) == want_layout
    toks = [torch.argmax(lg, -1).to(torch.int32)]
    np.testing.assert_allclose(lg.numpy(), want_logits[0], rtol=0, atol=ATOL)
    for i in range(NEW - 1):
        lg, caches = tm.decode_step(tp, toks[-1][:, None], caches, P + i)
        np.testing.assert_allclose(lg.numpy(), want_logits[i + 1], rtol=0, atol=ATOL)
        toks.append(torch.argmax(lg, -1).to(torch.int32))
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), want_toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_topp_stream_matches_jax_under_its_uniforms(arch):
    je = JaxServeEngine(jax_get_config(arch, smoke=True), _jax_params(arch),
                        max_len=P + NEW, sampler="topp_scan", temperature=1.3)
    te = ServeEngine(get_config(arch, smoke=True), _port_params(arch), max_len=P + NEW,
                     sampler="topp_scan", temperature=1.3, device="cpu")
    key = jax.random.PRNGKey(7)
    prompts = _batch()[0][:, :P]
    j = np.asarray(je.generate({"tokens": jnp.asarray(prompts)}, NEW, key))
    t = te.generate({"tokens": prompts}, NEW, uniforms=_uniforms(key, NEW, B))
    np.testing.assert_array_equal(t.numpy(), j)
    assert len(np.unique(j)) > 4            # a real sample, not a constant stream


def test_gemma2_local_layers_cut_at_the_window():
    """gemma2's local layers see 16 positions: past the window its logits differ
    from the same weights with the window removed (which JAX's then also give)."""
    cfg = get_config("gemma2-2b", smoke=True)
    wide = dataclasses.replace(cfg, local_window=None)
    toks = torch.from_numpy(_batch()[0])
    tp = _port_params("gemma2-2b")
    cut, full = build_model(cfg).forward(tp, {"tokens": toks}), \
        build_model(wide).forward(tp, {"tokens": toks})
    w = cfg.local_window
    assert torch.equal(cut[:, :w], full[:, :w])               # inside the window
    assert float((cut[:, w:] - full[:, w:]).abs().max()) > 1e-3
    np.testing.assert_allclose(cut.numpy(), _jax_train("gemma2-2b")[0], rtol=0, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _qk_norm_params():
    """qwen3's SMOKE weights with random q/k norm scales (JAX's, the port's)."""
    rng = np.random.default_rng(9)
    jp = jax.tree.map(np.asarray, _jax_params("qwen3-4b"))
    for name in ("q_norm", "k_norm"):
        g = jp["stack"]["sub0"]["attn"][name]["g"]
        jp["stack"]["sub0"]["attn"][name]["g"] = rng.normal(size=g.shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), params_from_jax(jp, device="cpu")


def test_qwen3_qk_norm_matches_jax():
    """The per-head q/k RMSNorm, with random scales, against JAX; and it matters."""
    cfg = get_config("qwen3-4b", smoke=True)
    toks = torch.from_numpy(_batch()[0])
    tp = _qk_norm_params()[1]
    got = build_model(cfg).forward(tp, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), _jax_train("qwen3-4b", "qk")[0],
                               rtol=0, atol=ATOL)
    plain = build_model(dataclasses.replace(cfg, qk_norm=False)).forward(
        tp, {"tokens": toks})
    assert float((got - plain).abs().max()) > 1e-3

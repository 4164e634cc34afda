"""The port's dense decoder and ServeEngine against the JAX package, end to end.

The JAX ``llama3-8b`` SMOKE model is initialised from a fixed key, its
parameters are carried across with :func:`repro_torch.convert.params_from_jax`,
and both packages run the same prompts on the CPU in fp32.  Logits must agree
within ``ATOL`` (fp32 products summed in other orders by XLA and by torch; the
logits here are O(1), and the observed gap is ~1e-6).  Greedy token streams
must be identical.  Top-p streams must be identical when the port is fed the
JAX engine's per-step uniforms, rebuilt from the engine's key splits
(``serving/engine.py`` splits once for the prefill and once per decode step;
each sampler draws ``jax.random.uniform(key, (B, 1), float32)``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.segmented import SegmentedBatch as JaxSegmentedBatch
from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.core.autotune import method_override
from repro_torch.core.segmented import SegmentedBatch
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import build_model, get_config
from repro_torch.serving.engine import ServeEngine

ATOL = 2e-5
B, S, NEW = 2, 12, 6


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = jax_get_config("llama3-8b", smoke=True)
    return jax_build_model(cfg).init(jax.random.PRNGKey(0))


def _port_params():
    return params_from_jax(jax.tree.map(np.asarray, _jax_params()), device="cpu")


@functools.lru_cache(maxsize=None)
def _prompts() -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (B, S)).astype(np.int32)


def _jax_uniforms(key, steps: int, b: int) -> np.ndarray:
    """The JAX engine's per-step sampler uniforms, as a (steps, b) array."""
    key, k = jax.random.split(key)
    us = [jax.random.uniform(k, (b, 1), dtype=jnp.float32)]
    for _ in range(steps - 1):
        key, k = jax.random.split(key)
        us.append(jax.random.uniform(k, (b, 1), dtype=jnp.float32))
    return np.concatenate([np.asarray(u) for u in us], axis=1).T


def test_config_is_the_jax_config():
    for smoke in (False, True):
        j, t = jax_get_config("llama3-8b", smoke=smoke), get_config("llama3-8b", smoke=smoke)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "rope_theta", "norm_eps", "dtype", "padded_vocab",
                  "head_dim_"):
            assert getattr(j, f) == getattr(t, f), f
    with pytest.raises(ValueError):
        get_config("gemma2-9b")


def test_params_from_jax_keeps_layout_and_values():
    jp = _jax_params()
    tp = _port_params()
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree.leaves(tp))
    for path, leaf in jl:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bf = params_from_jax({"w": np.asarray(jnp.ones((2, 2), jnp.bfloat16))}, device="cpu")
    assert bf["w"].dtype == torch.bfloat16


def test_port_init_has_the_jax_tree():
    cfg = get_config("llama3-8b", smoke=True)
    tp = build_model(cfg).init(0, device="cpu")
    jshapes = jax.tree.map(lambda a: a.shape, _jax_params())
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == jshapes


def test_prefill_and_decode_logits_match_jax():
    cfg = jax_get_config("llama3-8b", smoke=True)
    jm, tm = jax_build_model(cfg), build_model(get_config("llama3-8b", smoke=True))
    jp, tp = _jax_params(), _port_params()
    toks = _prompts()
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=S + 4)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=S + 4)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["stack"]["sub0"][name].numpy(),
                                   np.asarray(jc["stack"]["sub0"][name]), rtol=0, atol=ATOL)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for pos in (S, S + 1):
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]


def _engines(sampler: str, max_len: int = 32, **kw):
    cfg = jax_get_config("llama3-8b", smoke=True)
    je = JaxServeEngine(cfg, _jax_params(), max_len=max_len, sampler=sampler, **kw)
    te = ServeEngine(get_config("llama3-8b", smoke=True), _port_params(), max_len=max_len,
                     sampler=sampler, device="cpu", **kw)
    return je, te


def test_greedy_tokens_match_jax():
    je, te = _engines("greedy")
    key = jax.random.PRNGKey(1)
    j = np.asarray(je.generate({"tokens": jnp.asarray(_prompts())}, NEW, key))
    t = te.generate({"tokens": _prompts()}, NEW)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("sampler", ["topp_scan", "topp_kernel", "topp_blocked",
                                     "topp_segmented", "topp_xla"])
def test_topp_tokens_match_jax_under_its_uniforms(sampler):
    je, te = _engines(sampler, temperature=1.3)
    key = jax.random.PRNGKey(7)
    j = np.asarray(je.generate({"tokens": jnp.asarray(_prompts())}, NEW, key))
    u = _jax_uniforms(key, NEW, B)
    t = te.generate({"tokens": _prompts()}, NEW, uniforms=u)
    np.testing.assert_array_equal(t.numpy(), j)
    assert len(np.unique(j)) > 2            # a real sample, not a constant stream


@pytest.mark.parametrize("method", ["vector", "matmul", "kernel", "blocked"])
def test_sample_packed_matches_jax_under_its_uniforms(method):
    """Ragged per-request logit rows (three lengths, one empty), sampled without
    padding; the port under ``method_override`` on each method against the JAX
    engine's own ``"auto"`` path, fed the uniforms its key draws."""
    je, te = _engines("topp_segmented", temperature=1.3)
    rng = np.random.default_rng(5)
    rows = [(rng.standard_normal(n) * 3).astype(np.float32) for n in (200, 0, 77, 5)]
    key = jax.random.PRNGKey(11)
    j = np.asarray(je.sample_packed(JaxSegmentedBatch.from_ragged(rows), key))
    u = np.asarray(jax.random.uniform(key, (len(rows), 1), dtype=jnp.float32))
    with method_override(method):
        t = te.sample_packed(SegmentedBatch.from_ragged(rows), u=torch.tensor(u))
    assert t.dtype == torch.int32 and t[1] == 0
    np.testing.assert_array_equal(t.numpy(), j)


def test_eos_zero_tokens_and_kv_budget_match_jax():
    je, te = _engines("greedy", max_len=24)
    key = jax.random.PRNGKey(0)
    batch = {"tokens": _prompts()}
    full = te.generate(batch, 8).numpy()
    eos = int(full[0, 2])
    for sync_every in (1, 3):
        j = np.asarray(je.generate({"tokens": jnp.asarray(_prompts())}, 8, key,
                                   eos_id=eos, sync_every=sync_every))
        t = te.generate(batch, 8, eos_id=eos, sync_every=sync_every).numpy()
        np.testing.assert_array_equal(t, j)
    assert te.generate(batch, 0).shape == (B, 0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        te.generate(batch, -1)
    with pytest.raises(ValueError, match="KV cache budget"):
        te.generate(batch, 24 - S + 1)
    with pytest.raises(ValueError, match="uniforms"):
        te.generate(batch, 3, uniforms=np.zeros((2, B), np.float32))


def test_serve_cli_runs_on_the_cpu(capsys):
    toks = serve_cli.main(["--smoke", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "8", "--new-tokens", "3",
                           "--sampler", "topp_kernel"])
    assert tuple(toks.shape) == (2, 3)
    assert "device=cpu" in capsys.readouterr().out

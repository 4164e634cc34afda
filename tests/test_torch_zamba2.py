"""The port's zamba2 hybrid (Mamba2 + shared attention) against the JAX package.

The JAX ``zamba2-1.2b`` SMOKE model is initialised from a fixed key and its
parameters carried across with :func:`repro_torch.convert.params_from_jax`;
both packages run the same 48-token prompts on the CPU in fp32.  With the
SMOKE chunk of 16 that is three chunks, so the SSD's cross-chunk
``linear_scan`` runs (a 16-token prompt would short-circuit it).  Logits must
agree within ``ATOL`` (fp32 products summed in other orders; observed ~1e-5
of O(1) logits), and greedy and injected-uniform top-p streams must be
identical to the JAX ``ServeEngine``'s under the same ``scan_method``.
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

from repro.models.layers import use_compute_dtype
from repro.models.mamba import mamba_full as jax_mamba_full
from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.models import mamba
from repro_torch.models.model import build_model, get_config
from repro_torch.serving.engine import ServeEngine

ARCH = "zamba2-1.2b"
ATOL = 2e-5
B, S, NEW = 2, 48, 5


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax_build_model(jax_get_config(ARCH, smoke=True)).init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params():
    return params_from_jax(jax.tree.map(np.asarray, _jax_params()), device="cpu")


@functools.lru_cache(maxsize=None)
def _prompts() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


def _jax_uniforms(key, steps: int, b: int) -> np.ndarray:
    """The JAX engine's per-step sampler uniforms, as a (steps, b) array."""
    us = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(k, (b, 1), dtype=jnp.float32)))
    return np.concatenate(us, axis=1).T


def test_config_is_the_jax_config():
    for smoke in (False, True):
        j, t = jax_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "shared_attn_interval", "dtype", "padded_vocab"):
            assert getattr(j, f) == getattr(t, f), f
        assert dataclasses.asdict(j.ssm) == dataclasses.asdict(t.ssm)


def test_port_init_has_the_jax_tree():
    tp = build_model(get_config(ARCH, smoke=True)).init(0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == \
        jax.tree.map(lambda a: a.shape, _jax_params())


@pytest.mark.parametrize("method", ["vector", "kernel", "blocked"])
def test_prefill_and_decode_logits_match_jax(method):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), scan_method=method)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), scan_method=method)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp, tp = _jax_params(), _port_params()
    toks = _prompts()
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=S + 4))(
        jp, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=S + 4)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert jax.tree.map(lambda t: tuple(t.shape), tc) == jax.tree.map(lambda a: a.shape, jc)
    for jleaf, tleaf in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf), rtol=0, atol=ATOL)
    step = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos))
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for pos in (S, S + 1):
        jl, jc = step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]


@pytest.mark.parametrize("method", ["vector", "kernel"])
@pytest.mark.parametrize("sampler", ["greedy", "topp_scan"])
def test_streams_match_jax_engine(sampler, method):
    cfg = jax_get_config(ARCH, smoke=True)
    je = JaxServeEngine(cfg, _jax_params(), max_len=S + NEW, sampler=sampler,
                        temperature=1.3, scan_method=method)
    te = ServeEngine(get_config(ARCH, smoke=True), _port_params(), max_len=S + NEW,
                     sampler=sampler, temperature=1.3, scan_method=method, device="cpu")
    assert te.cfg.scan_method == method
    key = jax.random.PRNGKey(7)
    j = np.asarray(je.generate({"tokens": jnp.asarray(_prompts())}, NEW, key))
    t = te.generate({"tokens": _prompts()}, NEW, uniforms=_jax_uniforms(key, NEW, B))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)
    assert len(np.unique(j)) > 2            # a real stream, not a constant one


def test_scan_method_is_validated_and_b17_waits():
    """scan_method is validated; mamba_full(use_kernel=True) under "kernel" (the SSD
    chunk kernel B17, once a refusal) matches the JAX mixer on the same layer."""
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(ValueError, match="scan_method"):
        ServeEngine(cfg, None, device="cpu", scan_method="cube")
    assert ServeEngine(cfg, None, device="cpu", scan_method="auto").cfg.scan_method == "auto"
    assert ServeEngine(cfg, None, device="cpu").cfg is cfg
    p = jax.tree.map(lambda t: t[0], _port_params()["stack"]["sub0"]["mixer"])
    jp = jax.tree.map(lambda t: t[0], _jax_params()["stack"]["sub0"]["mixer"])
    kcfg = dataclasses.replace(cfg, scan_method="kernel")
    x = np.random.default_rng(1).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    got = mamba.mamba_full(p, torch.from_numpy(x), kcfg, cdt=torch.float32, use_kernel=True)
    with use_compute_dtype(jnp.float32):                   # the fp32 SMOKE model's dtype
        want = jax_mamba_full(jp, jnp.asarray(x), dataclasses.replace(
            jax_get_config(ARCH, smoke=True), scan_method="kernel"), use_kernel=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_serve_cli_runs_zamba2_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_SCAN_METHOD", "kernel")
    toks = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "40", "--new-tokens", "3"])
    assert tuple(toks.shape) == (2, 3)
    assert "device=cpu" in capsys.readouterr().out

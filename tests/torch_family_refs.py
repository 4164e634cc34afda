"""The JAX package's SMOKE models as references for the port's model families.

Shared by ``test_torch_xlstm.py``, ``test_torch_mla.py`` and
``test_torch_encdec_vlm.py``.  Each JAX SMOKE model is initialised from a fixed
key and its parameters carried across with
:func:`repro_torch.convert.params_from_jax`; both packages run the same numpy
inputs on the CPU in fp32 (the enc-dec and VLM stub embeddings drawn with
numpy from a seed).  Every JAX model call is jitted once per config and cached.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models.model import build_model, get_config
from repro_torch.serving.engine import ServeEngine

B, S = 2, 24                 # forward
P, NEW = 12, 9               # serving: a prefill and 8 decode steps
LOSS_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax.jit(jax_build_model(jax_get_config(arch, smoke=True)).init)(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return params_from_jax(jax.tree.map(np.asarray, jax_params(arch)), device="cpu")


def offset(arch) -> int:
    """The decode positions' offset: a VLM's cache holds its image tokens first."""
    cfg = jax_get_config(arch, smoke=True)
    return cfg.n_img_tokens if cfg.family == "vlm" else 0


@functools.lru_cache(maxsize=None)
def batch(arch, seq: int = S):
    """Tokens, a loss mask and the family's stub embeddings, from seed 0."""
    cfg = jax_get_config(arch, smoke=True)
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, 256, (B, seq)).astype(np.int32),
           "loss_mask": (rng.random((B, seq)) < 0.7).astype(np.int32)}
    if cfg.family == "encdec":
        out["enc_embed"] = (rng.standard_normal((B, cfg.enc_len, cfg.d_model))
                            * 0.3).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embed"] = (rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model))
                            * 0.3).astype(np.float32)
    return out


def prompt(arch):
    """The serving prompt: the first ``P`` tokens and the stub embeddings."""
    return {k: (v[:, :P] if k == "tokens" else v) for k, v in batch(arch).items()
            if k != "loss_mask"}


def as_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def jax_train(arch):
    """JAX's ``forward`` logits and masked ``loss`` parts, in one jit."""
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    logits, (total, parts) = jax.jit(lambda p, b: (jm.forward(p, b), jm.loss(p, b)))(
        jax_params(arch), as_jax(batch(arch)))
    return np.asarray(logits), (float(total), float(parts["ce"]), float(parts["aux"]))


def port_train(arch):
    """The port's ``forward`` logits and ``loss`` parts; on the CPU no kernel launches."""
    tm = build_model(get_config(arch, smoke=True))
    ops.reset_launch_counts()
    logits = tm.forward(port_params(arch), as_torch(batch(arch)))
    total, parts = tm.loss(port_params(arch), as_torch(batch(arch)))
    assert not any(ops.launch_counts().values())            # CPU: plain versions only
    return logits, (float(total), float(parts["ce"]), float(parts["aux"]))


def check_config(arch, smoke):
    j, t = jax_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.padded_vocab == t.padded_vocab and j.head_dim_ == t.head_dim_


def check_params_carry(arch, want_names):
    """``params_from_jax`` keeps every leaf, the port's own init draws the same
    tree, and the tree holds ``want_names``."""
    jl = jax.tree_util.tree_leaves_with_path(jax_params(arch))
    tp = port_params(arch)
    assert len(jl) == len(jax.tree.leaves(tp))
    for path, leaf in jl:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    own = build_model(get_config(arch, smoke=True)).init(0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda a: a.shape, jax_params(arch))
    names = {k.key for path, _ in jl for k in path}
    assert set(want_names) <= names, set(want_names) - names


def shapes(tree):
    return jax.tree.map(lambda t: tuple(t.shape), tree)


@functools.lru_cache(maxsize=None)
def jax_decode(arch):
    """JAX's prefill and 8 greedy decode steps: (logits of each step, tokens,
    the caches' layout)."""
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    jp, off = jax_params(arch), offset(arch)
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=P + NEW + off))
    step = jax.jit(jm.decode_step)
    lg, caches = prefill(jp, as_jax(prompt(arch)))
    logits, out = [np.asarray(lg)], [np.asarray(jnp.argmax(lg, -1)).astype(np.int32)]
    for i in range(NEW - 1):
        lg, caches = step(jp, jnp.asarray(out[-1][:, None]), caches,
                          jnp.asarray(P + off + i, jnp.int32))
        logits.append(np.asarray(lg))
        out.append(np.asarray(jnp.argmax(lg, -1)).astype(np.int32))
    return logits, np.stack(out, 1), jax.tree.map(lambda a: a.shape, caches)


def check_greedy_decode(arch, atol):
    """Each step's logits within ``atol`` of JAX's, the greedy stream equal, the
    caches in JAX's layout, and ``empty_caches`` of the same layout."""
    tm = build_model(get_config(arch, smoke=True))
    tp, off = port_params(arch), offset(arch)
    want_logits, want_toks, want_layout = jax_decode(arch)
    lg, caches = tm.prefill(tp, as_torch(prompt(arch)), cache_len=P + NEW + off)
    assert shapes(caches) == want_layout
    assert shapes(tm.empty_caches(B, P + NEW + off, device="cpu")) == want_layout
    toks = [torch.argmax(lg, -1).to(torch.int32)]
    np.testing.assert_allclose(lg.numpy(), want_logits[0], rtol=0, atol=atol)
    for i in range(NEW - 1):
        lg, caches = tm.decode_step(tp, toks[-1][:, None], caches, P + off + i)
        np.testing.assert_allclose(lg.numpy(), want_logits[i + 1], rtol=0, atol=atol)
        toks.append(torch.argmax(lg, -1).to(torch.int32))
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), want_toks)
    return caches


def uniforms(key, steps: int, b: int) -> np.ndarray:
    """The JAX engine's per-step sampler uniforms, as a (steps, b) array."""
    us = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(k, (b, 1), dtype=jnp.float32)))
    return np.concatenate(us, axis=1).T


def check_topp_stream(arch):
    """The port's ``topp_scan`` stream under the JAX engine's uniforms equals the
    JAX engine's, the VLM's image tokens counted in ``max_len``."""
    max_len = P + NEW + offset(arch)
    je = JaxServeEngine(jax_get_config(arch, smoke=True), jax_params(arch),
                        max_len=max_len, sampler="topp_scan", temperature=1.3)
    te = ServeEngine(get_config(arch, smoke=True), port_params(arch), max_len=max_len,
                     sampler="topp_scan", temperature=1.3, device="cpu")
    key = jax.random.PRNGKey(7)
    j = np.asarray(je.generate(as_jax(prompt(arch)), NEW, key))
    t = te.generate(prompt(arch), NEW, uniforms=uniforms(key, NEW, B))
    np.testing.assert_array_equal(t.numpy(), j)
    assert len(np.unique(j)) > 4            # a real sample, not a constant stream

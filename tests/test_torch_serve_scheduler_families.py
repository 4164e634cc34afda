"""Continuous batching of the local/global and MoE stacks against the JAX package.

``ContinuousEngine`` serves the gemma2-2b SMOKE model (local layers of window
16 beside global ones) and the deepseek-moe-16b SMOKE model (a leading dense
layer in ``pre``, then MoE layers whose decode drops no token) on the CPU in
fp32, with the JAX parameters carried across by
:func:`repro_torch.convert.params_from_jax`.  One short Poisson trace whose
requests decode past position 16 must give JAX's ``ContinuousEngine`` schedule
(``requests``, ``stats``) and streams exactly: greedy as it is, ``topp_scan``
under each request's JAX uniforms.  The paged caches cover every
``{"k", "v"}`` leaf (``pre``, ``stack.sub{i}``), and every decode step of a
run is bit-equal to its dense replay.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro.serving.scheduler import ContinuousEngine as JaxContinuousEngine
from repro.serving.scheduler import poisson_trace as jax_poisson_trace
from repro_torch.analysis.streams import DenseReplay
from repro_torch.convert import params_from_jax
from repro_torch.models.model import build_model, get_config
from repro_torch.serving import paged_kv
from repro_torch.serving.scheduler import ContinuousEngine, poisson_trace

ARCHS = ("gemma2-2b", "deepseek-moe-16b")
GEOM = dict(max_batch=2, page_size=8, n_pages=9, max_len=24, tick_tokens=4)
TRACE = dict(rate=0.5, seed=3, prompt_len=(9, 14), max_new=(4, 8))
N_REQ = 4


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.jit(jax_build_model(jax_get_config(arch, smoke=True)).init)(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return params_from_jax(jax.tree.map(np.asarray, _jax_params(arch)), device="cpu")


def _jax_uniforms(seed: int, n: int) -> np.ndarray:
    """The uniforms the JAX engine draws for a request keyed ``PRNGKey(seed)``."""
    key = jax.random.PRNGKey(seed)
    us = []
    for _ in range(n):
        key, k = jax.random.split(key)
        us.append(float(jax.random.uniform(k, (1, 1), dtype=jnp.float32)[0, 0]))
    return np.asarray(us, np.float32)


def _trace():
    reqs = poisson_trace(N_REQ, vocab_size=256, **TRACE)
    for r in reqs:
        r.uniforms = _jax_uniforms(r.seed, r.max_new_tokens)
    return reqs


@functools.lru_cache(maxsize=None)
def _jax_run(arch, sampler):
    eng = JaxContinuousEngine(jax_get_config(arch, smoke=True), _jax_params(arch),
                              sampler=sampler, top_p=0.9, **GEOM)
    return eng.run(jax_poisson_trace(N_REQ, vocab_size=256, **TRACE))


def _engine(arch, sampler):
    return ContinuousEngine(get_config(arch, smoke=True), _port_params(arch),
                            sampler=sampler, top_p=0.9, device="cpu", **GEOM)


@pytest.mark.parametrize("sampler", ["greedy", "topp_scan"])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_equals_jax(arch, sampler):
    reqs = _trace()
    assert max(r.tokens.size + r.max_new_tokens for r in reqs) > 16    # past the window
    with DenseReplay(eng := _engine(arch, sampler)) as rep:
        got = eng.run(reqs)
    want = _jax_run(arch, sampler)
    assert got["stats"] == want["stats"]
    assert got["requests"] == want["requests"]
    assert sorted(got["streams"]) == sorted(want["streams"])
    for rid, s in want["streams"].items():
        np.testing.assert_array_equal(got["streams"][rid], np.asarray(s), err_msg=rid)
    out = rep.result()
    assert out["bit_equal"] and out["row_steps"] > 0, out


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_caches_cover_every_attention_leaf(arch):
    model = build_model(get_config(arch, smoke=True))
    caches = paged_kv.build_paged_caches(model, 2, 9, 8, 3, device="cpu")
    dense = model.empty_caches(2, 24, device="meta")
    assert {p: set(c) for p, c in caches.items()} == {p: set(c) for p, c in dense.items()}
    for part, subs in caches.items():
        for sub, leaf in subs.items():
            assert set(leaf) == {"k", "v", "pages"}
            n = dense[part][sub]["k"].shape[0]
            assert tuple(leaf["pages"].shape) == (n, 2, 3)
            assert tuple(leaf["k"].shape) == (n, 9, 8, *dense[part][sub]["k"].shape[3:])
    assert ("pre" in caches) == (arch == "deepseek-moe-16b")
    assert len(caches["stack"]) == len(model.pattern)

"""The port's expert-parallel MoE layer and both serving engines on a grid, in a
gloo world of 8 ranks on ``make_debug_mesh()`` (4 data × 2 model), on the CPU.

One world runs every case once (``tests/torch_mesh_worlds.py``); a MoE layer
of the JAX ``deepseek-moe-16b`` SMOKE config (JAX's ``moe_init``, ``PRNGKey(0)``)
and the whole SMOKE model are carried across with ``params_from_jax``.

* The forward at a capacity factor of 1, where assignments drop: each rank's
  ``y`` (its data shard's rows, its experts' part joined over the model
  group) within ``Y_ATOL`` of its largest magnitude of JAX's meshless
  ``moe_apply`` on that shard's tokens alone (JAX's group-local capacity),
  equal on both model ranks; the data group's mean of the ranks' ``aux``
  within ``AUX_ATOL`` of JAX's on the whole batch.
* On a grid of 8 data ranks and no model axis, ``dispatch_mode="auto"`` takes
  ``"grouped"`` (JAX's choice under data-parallel dispatch groups) and each
  rank's ``y`` is JAX's ``moe_apply`` of its own row alone.
* The gradients at the config's capacity factor of 16 (no drop): the data
  group's mean of the ranks' gradients of ``L_k = D·Σ(y_k ∘ r_k) + aux_k``,
  the experts' from the rank that holds them, within ``GRAD_FRAC · max|g|``
  of the one-device port's gradients of ``Σ(y ∘ r) + aux`` on the whole batch;
  the tokens' gradients too.
* ``ServeEngine`` (greedy, and ``topp_sharded`` on the same uniforms) and
  ``ContinuousEngine`` (greedy) on the grid: every rank returns the same
  tokens, the one-device fp32 stream (``topp_sharded``: the one-device
  ``topp_scan`` stream, as in ``tests/test_torch_dist_ops.py``); each rank
  holds its half of the experts.
* Every call's collectives equal ``analysis/collectives.py``'s closed forms.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.models import moe as jax_moe
from repro.models.layers import use_compute_dtype
from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro_torch.analysis.collectives import (modeled_dist_traffic, modeled_ep_traffic,
                                              sum_forms)
from repro_torch.convert import params_from_jax
from repro_torch.launch.world import run_world
from repro_torch.models import moe
from repro_torch.models.model import get_config
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import ContinuousEngine, Request

HERE = os.path.dirname(__file__)
ARCH = "deepseek-moe-16b"
DATA, MODEL = 4, 2
B, S = 8, 12
Y_ATOL = 1e-5
AUX_ATOL = 1e-6
GRAD_FRAC = 1e-5
PROMPT, NEW = 10, 6
REQUESTS = [dict(rid=f"r{i}", tokens=np.random.default_rng(20 + i).integers(
    0, 256, n).astype(np.int32), max_new_tokens=m, arrival_step=a)
    for i, (n, m, a) in enumerate([(7, 5, 0), (12, 4, 0), (5, 6, 2)])]


@functools.lru_cache(maxsize=None)
def _layer():
    cfg = jax_get_config(ARCH, smoke=True)
    jp = jax.jit(lambda k: jax_moe.moe_init(k, cfg))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


@functools.lru_cache(maxsize=None)
def _params():
    return jax.tree.map(np.asarray, jax_build_model(jax_get_config(ARCH, smoke=True)).init(
        jax.random.PRNGKey(0)))


def _x(seed):
    d = get_config(ARCH, smoke=True).d_model
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


X_DROP, X_GRAD = _x(3), _x(4)
R = np.random.default_rng(6).standard_normal(X_GRAD.shape).astype(np.float32)
PROMPTS = np.random.default_rng(7).integers(0, 256, (B, PROMPT)).astype(np.int32)
UNIFORMS = np.random.default_rng(8).random((NEW, B)).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    return run_world("torch_mesh_worlds:moe_ep_world", DATA * MODEL,
                     dict(layer=_layer(), x_drop=X_DROP, x_grad=X_GRAD, r=R,
                          engines=dict(params=_params(), prompts=PROMPTS, new=NEW,
                                       uniforms=UNIFORMS, requests=REQUESTS)),
                     workdir=tmp / "world8", timeout=400, pythonpath=[HERE])


def _cfgs(capacity_factor):
    jc, tc = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    return (dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                            capacity_factor=capacity_factor)),
            dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                            capacity_factor=capacity_factor)))


@functools.lru_cache(maxsize=None)
def _jax_moe(capacity_factor, shards=DATA):
    """JAX's meshless ``moe_apply`` of each of ``shards`` row blocks of ``X_DROP``
    alone, and its ``aux`` on the whole batch."""
    jc, _ = _cfgs(capacity_factor)
    with use_compute_dtype(jnp.float32):
        fn = jax.jit(lambda p, x: jax_moe.moe_apply(p, x, jc))
        per = B // shards
        ys = [fn(_layer(), jnp.asarray(X_DROP[j * per:(j + 1) * per])) for j in range(shards)]
        _, aux = fn(_layer(), jnp.asarray(X_DROP))
    return [np.asarray(y) for y, _ in ys], float(aux)


def _dropped(capacity_factor):
    """Assignments that each data shard drops, by the port's one-device dispatch."""
    _, tc = _cfgs(capacity_factor)
    p = params_from_jax(_layer(), device="cpu")
    per = B // DATA
    out = []
    for j in range(DATA):
        xt = torch.from_numpy(X_DROP[j * per:(j + 1) * per]).reshape(per * S, -1)
        _, _, idx = moe.route(p, xt, tc, cdt=torch.float32)
        _, keep, _ = moe.dispatch(idx, moe.capacity_of(per * S, tc), tc,
                                  scan_method="vector")
        out.append(int((~keep).sum()))
    return out


def test_ep_forward_matches_jax_group_local_moe(world):
    ys, aux = _jax_moe(1.0)
    assert min(_dropped(1.0)) > 0                       # every shard drops some
    by_data = {}
    for r in world:
        f = r["forward"]
        j = f["coord"]["data"]
        want = ys[j]
        np.testing.assert_allclose(f["y"], want, rtol=0,
                                   atol=Y_ATOL * float(np.abs(want).max()))
        if j in by_data:
            np.testing.assert_array_equal(f["y"], by_data[j]["y"])    # both model ranks
        by_data[j] = f
    got_aux = np.mean([by_data[j]["aux"] for j in range(DATA)])
    assert abs(got_aux - aux) <= AUX_ATOL


def test_data_only_grid_takes_grouped_dispatch(world):
    ys, aux = _jax_moe(1.0, shards=DATA * MODEL)
    cfg = get_config(ARCH, smoke=True)
    form = modeled_ep_traffic(model=1, data=DATA * MODEL, tokens=B // (DATA * MODEL) * S,
                              d_model=cfg.d_model, top_k=cfg.moe.top_k,
                              n_experts=cfg.moe.n_experts, layers=1, itemsize=4,
                              global_aux=True)
    for r in world:
        f = r["dp_forward"]
        assert f["modes"] == ["grouped"]
        want = ys[f["coord"]["data"]]
        np.testing.assert_allclose(f["y"], want, rtol=0,
                                   atol=Y_ATOL * float(np.abs(want).max()))
        c = f["counts"]
        assert {k: v for k, v in c["calls"].items() if v} == form["counts_by_kind"]
        assert {k: v for k, v in c["bytes"].items() if v} == form["bytes_by_kind"]
    assert abs(np.mean([r["dp_forward"]["aux"] for r in world]) - aux) <= AUX_ATOL


def test_ep_forward_collectives(world):
    cfg = get_config(ARCH, smoke=True)
    form = modeled_ep_traffic(model=MODEL, data=DATA, tokens=B // DATA * S,
                              d_model=cfg.d_model, top_k=cfg.moe.top_k,
                              n_experts=cfg.moe.n_experts, layers=1, itemsize=4,
                              global_aux=True)
    for r in world:
        c = r["forward"]["counts"]
        assert {k: v for k, v in c["calls"].items() if v} == form["counts_by_kind"]
        assert {k: v for k, v in c["bytes"].items() if v} == form["bytes_by_kind"]


@functools.lru_cache(maxsize=None)
def _one_device_grads():
    _, tc = _cfgs(16.0)
    p = params_from_jax(_layer(), device="cpu")
    for t in _leaves(p):
        t.requires_grad_()
    x = torch.from_numpy(X_GRAD).requires_grad_()
    y, aux = moe.moe_apply(p, x, tc, cdt=torch.float32)
    (torch.sum(y * torch.from_numpy(R)) + aux).backward()
    return _flat({k: v for k, v in _grad_tree(p).items()}), x.grad.numpy()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.grad


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.numpy() if isinstance(tree, torch.Tensor) else tree}


def test_ep_grads_match_the_one_device_port(world):
    want, want_x = _one_device_grads()
    e_per = get_config(ARCH, smoke=True).moe.n_experts // MODEL
    got = {k: np.zeros_like(v) for k, v in want.items()}
    per = B // DATA
    got_x = np.zeros_like(want_x)
    for r in world:
        g, (j, m) = r["grads"], (r["grads"]["coord"]["data"], r["grads"]["coord"]["model"])
        for k, v in g["grads"].items():
            if "experts" in k:                          # only the rank's own experts
                rows = slice(m * e_per, (m + 1) * e_per)
                assert not v[:rows.start].any() and not v[rows.stop:].any(), k
                got[k][rows] += v[rows] / DATA
            elif m == 0:
                got[k] += v / DATA
        if m == 0:
            got_x[j * per:(j + 1) * per] = g["x_grad"] / DATA
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=GRAD_FRAC * float(np.abs(v).max()),
                                   err_msg=k)
    np.testing.assert_allclose(got_x, want_x, rtol=0,
                               atol=GRAD_FRAC * float(np.abs(want_x).max()))
    cfg = get_config(ARCH, smoke=True)
    form = modeled_ep_traffic(model=MODEL, data=DATA, tokens=per * S, d_model=cfg.d_model,
                              top_k=cfg.moe.top_k, n_experts=cfg.moe.n_experts, layers=1,
                              itemsize=4, global_aux=True, backward=True)
    for r in world:
        c = r["grads"]["counts"]
        assert {k: v for k, v in c["calls"].items() if v} == form["counts_by_kind"]
        assert {k: v for k, v in c["bytes"].items() if v} == form["bytes_by_kind"]


@functools.lru_cache(maxsize=None)
def _one_device_streams():
    cfg = get_config(ARCH, smoke=True)
    tp = params_from_jax(_params(), device="cpu")
    batch = {"tokens": torch.from_numpy(PROMPTS)}
    greedy = ServeEngine(cfg, tp, max_len=PROMPT + NEW, sampler="greedy",
                         device="cpu").generate(batch, NEW).numpy()
    topp = ServeEngine(cfg, tp, max_len=PROMPT + NEW, sampler="topp_scan",
                       device="cpu").generate(batch, NEW,
                                              uniforms=torch.from_numpy(UNIFORMS)).numpy()
    cont = ContinuousEngine(cfg, tp, sampler="greedy", device="cpu", max_batch=2,
                            page_size=8, n_pages=16, tick_tokens=4)
    res = cont.run([Request(**r) for r in REQUESTS])
    return greedy, topp, {rid: t.tolist() for rid, t in res["streams"].items()}


@pytest.mark.parametrize("run", ["greedy", "sharded", "continuous"])
def test_engines_on_the_grid_return_the_one_device_stream(world, run):
    greedy, topp, cont = _one_device_streams()
    want = {"greedy": greedy, "sharded": topp, "continuous": cont}[run]
    cfg = get_config(ARCH, smoke=True)
    for r in world:
        e = r["engines"]
        assert e["expert_block"][1] == cfg.moe.n_experts // MODEL
        if run == "continuous":
            assert e[run] == want
        else:
            assert e[run].shape == (B, NEW) and e[run].dtype == np.int32
            np.testing.assert_array_equal(e[run], want)


@pytest.mark.parametrize("run", ["greedy", "sharded"])
def test_serve_engine_collectives(world, run):
    cfg = get_config(ARCH, smoke=True)
    per = B // DATA
    layers = cfg.n_layers - cfg.moe.first_k_dense
    kw = dict(model=MODEL, data=DATA, d_model=cfg.d_model, top_k=cfg.moe.top_k,
              n_experts=cfg.moe.n_experts, layers=layers, itemsize=4)
    forms = [modeled_ep_traffic(tokens=per * PROMPT, **kw),
             modeled_ep_traffic(tokens=per, passes=NEW - 1, **kw),
             {"counts_by_kind": {"all_gather": 1}, "bytes_by_kind": {"all_gather": 4 * B * NEW},
              "jax_operand_bytes": None}]
    if run == "sharded":
        step = modeled_dist_traffic("dist_top_p_sample", d=MODEL, n=cfg.padded_vocab,
                                    batch=per)
        forms += [step] * NEW
    form = sum_forms(*forms)
    for r in world:
        c = r["engines"][f"{run}_counts"]
        assert {k: v for k, v in c["calls"].items() if v} == form["counts_by_kind"]
        assert {k: v for k, v in c["bytes"].items() if v} == form["bytes_by_kind"]

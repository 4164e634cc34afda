"""The port's MoE layer (``models/moe.py``) against the JAX package, on the CPU.

A MoE layer of the JAX ``deepseek-moe-16b`` and ``llama4-scout-17b-16e``
SMOKE configs is initialised from a fixed key (JAX's ``moe_init``) and carried
across with :func:`repro_torch.convert.params_from_jax`; both packages route
the same numpy-seeded activations in fp32.  The routing, the dispatch
positions (the paper's exclusive int8 mask scan) and the kept mask must be
equal, ``y`` within ``Y_ATOL`` of its largest magnitude (fp32 products summed
in other orders) and ``aux`` within ``AUX_ATOL``.  A router forced onto expert 0 overflows a capacity of
``capacity_factor = 1``: the port must drop exactly JAX's assignments.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro.models.layers import use_compute_dtype
from repro.models.model import get_config as jax_get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.model import get_config

ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-16e")
Y_ATOL = 1e-5
AUX_ATOL = 1e-6
B, S = 2, 12
METHODS = ("vector", "matmul", "kernel", "blocked")


@functools.lru_cache(maxsize=None)
def _layer(arch):
    """One MoE layer's parameters: (JAX tree as numpy, the port's tree)."""
    cfg = jax_get_config(arch, smoke=True)
    jp = jax.jit(lambda k: jax_moe.moe_init(k, cfg))(jax.random.PRNGKey(0))
    p = jax.tree.map(np.asarray, jp)
    return p, params_from_jax(p, device="cpu")


def _cfgs(arch, **moe_kw):
    jc, tc = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if moe_kw:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe_kw))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe_kw))
    return jc, tc


def _x(arch, overflow=False):
    d = get_config(arch, smoke=True).d_model
    x = np.random.default_rng(3).standard_normal((B, S, d)).astype(np.float32)
    if overflow:
        x[..., 0] = 8.0          # with the router's column 0 boosted, every token's first choice
    return x


def _router_to_expert_0(p):
    """A copy of the layer whose router sends (nearly) every token to expert 0."""
    p = dict(p, router={"w": np.array(p["router"]["w"])})
    p["router"]["w"][0, 0] = 4.0
    return p


@functools.lru_cache(maxsize=None)
def _jax_moe(arch, no_drop, overflow):
    jc, _ = _cfgs(arch, capacity_factor=1.0) if overflow else _cfgs(arch)
    jp = _layer(arch)[0]
    if overflow:
        jp = _router_to_expert_0(jp)
    x = jnp.asarray(_x(arch, overflow))
    with use_compute_dtype(jnp.float32):                 # the fp32 SMOKE model's dtype
        y, aux = jax.jit(lambda p, x: jax_moe.moe_apply(p, x, jc, no_drop=no_drop))(jp, x)
        xt = x.reshape(B * S, -1)
        probs = jax.nn.softmax((xt @ jnp.asarray(jp["router"]["w"])).astype(jnp.float32), -1)
        _, idx = jax.lax.top_k(probs, jc.moe.top_k)
        pos = jax_moe._dispatch_positions(idx.reshape(1, -1), jc.moe.n_experts,
                                          scan_method="vector", mode="segmented")[0]
    cap = B * S if no_drop else max(
        int(B * S * jc.moe.top_k * jc.moe.capacity_factor / jc.moe.n_experts), jc.moe.top_k)
    return (np.asarray(y), float(aux), np.asarray(idx), np.asarray(pos),
            np.asarray(pos) < cap)


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("no_drop", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, no_drop, overflow):
    _, tc = _cfgs(arch, capacity_factor=1.0) if overflow else _cfgs(arch)
    p = _layer(arch)[1]
    if overflow:
        p = params_from_jax(_router_to_expert_0(_layer(arch)[0]), device="cpu")
    x = torch.from_numpy(_x(arch, overflow))
    y_j, aux_j, idx_j, pos_j, keep_j = _jax_moe(arch, no_drop, overflow)
    probs, _, idx = moe.route(p, x.reshape(B * S, -1), tc, cdt=torch.float32)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    cap = moe.capacity_of(B * S, tc, no_drop=no_drop)
    pos, keep, dest = moe.dispatch(idx, cap, tc, scan_method="auto")
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), pos_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    assert bool((dest[~keep] == tc.moe.n_experts * cap).all())
    if overflow:
        assert int((idx[:, 0] == 0).sum()) > 0.9 * B * S
        assert keep.all() if no_drop else (~keep).sum() > B * S // 2   # JAX's drops, many
    y, aux = moe.moe_apply(p, x, tc, cdt=torch.float32, no_drop=no_drop)
    assert y.shape == x.shape and y.dtype == torch.float32 and aux.shape == ()
    # fp32 sums in other orders: within Y_ATOL of the output's scale (llama4 SMOKE's
    # experts, drawn at E ** -0.5 = 0.5, give |y| up to ~150, where an ulp is 1.5e-5)
    np.testing.assert_allclose(y.numpy(), y_j, rtol=0,
                               atol=Y_ATOL * max(1.0, float(np.abs(y_j).max())))
    assert abs(float(aux) - aux_j) <= AUX_ATOL
    assert float(aux) == float(moe.load_balance_loss(probs, idx, tc.moe.n_experts))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("arch", ARCHS)
def test_segmented_and_grouped_dispatch_are_bit_equal(arch, method):
    """Both formulations of the mask scan on every method, on the layer's own
    routing and on a skewed one: bit-equal to each other and to an int64 cumsum."""
    _, tc = _cfgs(arch)
    e, k = tc.moe.n_experts, tc.moe.top_k
    _, _, idx = moe.route(_layer(arch)[1], torch.from_numpy(_x(arch)).reshape(B * S, -1),
                          tc, cdt=torch.float32)
    skew = torch.from_numpy(np.random.default_rng(4).choice(
        e, size=(3, 50 * k), p=np.r_[0.6, np.full(e - 1, 0.4 / (e - 1))]))
    for eidx in (idx.reshape(1, -1), skew):
        onehot = torch.nn.functional.one_hot(eidx, e).to(torch.int64)
        ref = torch.gather(torch.cumsum(onehot, 1) - onehot, 2, eidx[..., None])[..., 0]
        ops.reset_launch_counts()
        seg = moe.dispatch_positions(eidx, e, scan_method=method, mode="segmented")
        grp = moe.dispatch_positions(eidx, e, scan_method=method, mode="grouped")
        assert not any(ops.launch_counts().values())         # CPU: plain versions only
        assert seg.dtype == grp.dtype == torch.int32
        assert torch.equal(seg, grp)
        assert torch.equal(seg.to(torch.int64), ref)


def test_dispatch_positions_equal_jax_on_both_modes():
    e = 8
    eidx = np.random.default_rng(5).integers(0, e, (2, 30)).astype(np.int32)
    for mode in ("segmented", "grouped"):
        want = jax_moe._dispatch_positions(jnp.asarray(eidx), e, scan_method="vector",
                                           mode=mode)
        got = moe.dispatch_positions(torch.from_numpy(eidx), e, scan_method="vector",
                                     mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_keeps_jax_order_on_ties():
    probs = np.asarray([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                        [0.1, 0.4, 0.1, 0.4]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist()[1] == [0, 1, 2]


def test_moe_rejects_an_unknown_dispatch_mode():
    _, tc = _cfgs(ARCHS[0])
    with pytest.raises(ValueError, match="dispatch_mode"):
        moe.moe_apply(_layer(ARCHS[0])[1], torch.zeros((1, 2, tc.d_model)), tc,
                      cdt=torch.float32, dispatch_mode="ragged")
    with pytest.raises(ValueError, match="mode"):
        moe.dispatch_positions(torch.zeros((1, 4), dtype=torch.int64), 4,
                               scan_method="vector", mode="ragged")

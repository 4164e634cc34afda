"""The port's training step against ``jax.value_and_grad`` of the JAX package, on the CPU.

The JAX SMOKE models are initialised from a fixed key and their parameters
carried across with :func:`repro_torch.convert.params_from_jax`; both
packages score the same numpy tokens in fp32 on ``scan_method="auto"`` (on
CPU tensors JAX's ``"cpu"`` tuning table in both).  Every JAX call is jitted
once a config and reused.

* llama3-8b, zamba2-1.2b, xlstm-350m and deepseek-moe-16b (the MoE layer:
  the gradient reaches the experts through the gate values of JAX's routing,
  not through the integer dispatch): the loss within ``1e-5`` relative
  and every gradient leaf within ``GRAD_FRAC[arch] · max|g_leaf|`` of JAX's
  (fp32 products summed in other orders through a whole model): ``1e-4``,
  and ``1e-3`` for xlstm-350m, whose mLSTM cell divides by ``|q·n| + 1e-6``
  and cancels on signed random inputs, so its SMOKE logits already lie
  3.7e-4 from JAX's (``tests/test_torch_xlstm.py`` holds them to 1e-3); its
  gradients read 5.3e-4 on layer 0's ``if_bias`` and at most 1.2e-4 elsewhere;
* every one of the ten archs gives a finite, nonzero gradient norm
  (``tests/test_models.py``'s train step);
* a ``"kernel"`` zamba2 step raises before any launch (B17 has no gradient,
  in JAX neither), and remat on and off give the same gradients;
* one ``Trainer.train_step`` gives JAX's ``loss``, ``grad_norm`` and ``lr``
  within ``1e-5`` relative, and the port's ``adamw_update`` fed JAX's
  gradients gives JAX's parameters within ``1e-6`` relative.  Parameters after
  a step are not compared elementwise across packages: in step 1 AdamW moves
  each parameter by ``lr · sign(g)``, so a near-zero gradient that rounds to
  the other sign moves it by ``2·lr``.
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
from repro.training import optimizer as jax_opt
from repro.training.trainer import Trainer as JaxTrainer
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.kernels import ops
from repro_torch.models.model import ARCHS, build_model, get_config, synth_batch
from repro_torch.training.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                            tree_leaves, tree_map)
from repro_torch.training.trainer import Trainer

B, S = 2, 48                 # zamba2 SMOKE's chunk is 16: three chunks
GRAD_FRAC = {"llama3-8b": 1e-4, "zamba2-1.2b": 1e-4, "xlstm-350m": 1e-3,
             "deepseek-moe-16b": 1e-4}
LOSS_RTOL = 1e-5
PARITY = tuple(GRAD_FRAC)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_build_model(jax_get_config(arch, smoke=True)).init(jax.random.PRNGKey(0))


def _port_params(arch, requires_grad=True):
    p = params_from_jax(jax.tree.map(np.asarray, _jax_params(arch)), device="cpu")
    return tree_map(lambda t: t.requires_grad_(requires_grad), p)


@functools.lru_cache(maxsize=None)
def _tokens():
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b)[0]))
    loss, grads = fn(_jax_params(arch), {"tokens": jnp.asarray(_tokens())})
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(cfg, params):
    loss, _ = build_model(cfg).loss(params, {"tokens": torch.from_numpy(_tokens())})
    loss.backward()
    return float(loss.detach()), tree_map(lambda p: p.grad, params)


@pytest.mark.parametrize("arch", PARITY)
def test_loss_and_grads_match_jax(arch):
    want_loss, want = _jax_value_and_grad(arch)
    ops.reset_launch_counts()
    loss, grads = _port_loss_and_grads(get_config(arch, smoke=True), _port_params(arch))
    assert not any(ops.launch_counts().values())            # CPU: plain versions only
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    got_leaves, want_leaves = tree_leaves(grads), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g is not None and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_FRAC[arch] * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_arch_trains(arch):
    """``tests/test_models.py``'s train step: a finite loss and a finite, nonzero
    gradient norm, every parameter reached."""
    cfg = get_config(arch, smoke=True)
    m = build_model(cfg)
    params = tree_map(lambda t: t.requires_grad_(), m.init(1, device="cpu"))
    batch = synth_batch(cfg, ShapeConfig("smoke", 64, 2, "train"),
                        torch.Generator().manual_seed(2))
    loss, _ = m.loss(params, batch)
    loss.backward()
    assert torch.isfinite(loss)
    grads = [p.grad for p in tree_leaves(params)]
    assert all(g is not None for g in grads)
    gnorm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))
    assert np.isfinite(gnorm) and gnorm > 0


def test_kernel_zamba2_step_raises_before_any_launch():
    cfg = dataclasses.replace(get_config("zamba2-1.2b", smoke=True), scan_method="kernel")
    tr = Trainer(cfg, AdamWConfig(), device="cpu")
    state = tr.state_from_params(_port_params("zamba2-1.2b", requires_grad=False))
    ops.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="ssd_chunk_scan has no gradient"):
        tr.train_step(state, {"tokens": _tokens()})
    assert not any(ops.launch_counts().values())
    assert int(state["opt"]["step"]) == 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "llama3-8b"])
def test_remat_gives_the_same_gradients(arch):
    """``cfg.remat`` recomputes each group in the backward pass; the gradients
    are the same bits (the CPU's recomputation is deterministic)."""
    cfg = get_config(arch, smoke=True)
    out = []
    for remat in (False, True):
        params = _port_params(arch)
        loss, grads = _port_loss_and_grads(dataclasses.replace(cfg, remat=remat), params)
        out.append((loss, tree_leaves(grads)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """One JAX ``Trainer.train_step`` of llama3-8b SMOKE, and its state before it."""
    cfg = jax_get_config("llama3-8b", smoke=True)
    opt = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=20)
    tr = JaxTrainer(cfg, opt)
    state = tr.init_state(jax.random.PRNGKey(0))
    before = jax.tree.map(np.asarray, state)
    after, metrics = tr.train_step(state, {"tokens": jnp.asarray(_tokens())})
    return before, jax.tree.map(np.asarray, after), {k: float(v) for k, v in metrics.items()}


def test_train_step_metrics_match_jax():
    before, _, want = _jax_step()
    opt = AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=20)
    tr = Trainer(get_config("llama3-8b", smoke=True), opt, device="cpu")
    state = train_state_from_jax(before, device="cpu")
    state, got = tr.train_step(state, {"tokens": _tokens()})
    assert set(got) == set(want) == {"ce", "aux", "grad_norm", "lr", "loss"}
    for k in ("loss", "grad_norm", "lr"):
        assert float(got[k]) == pytest.approx(want[k], rel=1e-5), k
    assert int(state["opt"]["step"]) == 1


def test_adamw_on_jax_gradients_gives_jax_params():
    """The optimizer half of the step on the same gradients: JAX's parameters
    and moments after one step, within 1e-6 relative."""
    before, after, _ = _jax_step()
    opt = AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=20)
    jm = jax_build_model(jax_get_config("llama3-8b", smoke=True))
    grads = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(
        jax.tree.map(jnp.asarray, before["params"]), {"tokens": jnp.asarray(_tokens())})
    params = params_from_jax(before["params"], device="cpu")
    tgrads = params_from_jax(jax.tree.map(np.asarray, grads), device="cpu")
    new_p, new_opt, _ = adamw_update(opt, tgrads, adamw_init(params), params)
    for got, want in ((new_p, after["params"]), (new_opt["mu"], after["opt"]["mu"]),
                      (new_opt["nu"], after["opt"]["nu"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-9)

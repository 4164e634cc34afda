"""``TransformerLM.forward`` / ``loss`` of the port against the JAX package, on the CPU.

The JAX SMOKE models (``llama3-8b``, ``zamba2-1.2b``) are initialised from a
fixed key and their parameters carried across with
:func:`repro_torch.convert.params_from_jax`; both packages score the same
numpy prompts in fp32.  zamba2 runs under each ``scan_method``: ``"kernel"``
puts its Mamba2 layers on the SSD chunk kernel (B17; the plain version on the
CPU, the Pallas kernel in interpret mode on the JAX side), ``"blocked"`` and
``"vector"`` on ``ssd_scan``.  Logits agree within ``ATOL`` (fp32 products
summed in other orders, as in ``tests/test_torch_zamba2.py``); the loss, a mean
of ``logsumexp`` terms of those logits, within ``LOSS_ATOL``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models.model import build_model, get_config

ATOL = 2e-5
LOSS_ATOL = 1e-5
B, S = 2, 48                 # zamba2 SMOKE's chunk is 16: three chunks
CASES = [("llama3-8b", "auto"), ("zamba2-1.2b", "vector"), ("zamba2-1.2b", "kernel"),
         ("zamba2-1.2b", "blocked")]


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_build_model(jax_get_config(arch, smoke=True)).init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return params_from_jax(jax.tree.map(np.asarray, _jax_params(arch)), device="cpu")


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.int32)
    return toks, mask


def _models(arch, method):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), scan_method=method)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), scan_method=method)
    return jax_build_model(jcfg), build_model(tcfg)


@functools.lru_cache(maxsize=None)
def _jax_outputs(arch, method):
    jm = _models(arch, method)[0]
    toks, mask = _batch()
    logits = np.asarray(jax.jit(jm.forward)(_jax_params(arch), {"tokens": jnp.asarray(toks)}))
    losses = {}
    for masked in (False, True):
        batch = {"tokens": jnp.asarray(toks)}
        if masked:
            batch["loss_mask"] = jnp.asarray(mask)
        total, parts = jax.jit(jm.loss)(_jax_params(arch), batch)
        losses[masked] = (float(total), float(parts["ce"]), float(parts["aux"]))
    return logits, losses


@pytest.mark.parametrize("arch,method", CASES)
def test_forward_logits_match_jax(arch, method):
    tm = _models(arch, method)[1]
    toks, _ = _batch()
    ops.reset_launch_counts()
    got = tm.forward(_port_params(arch), {"tokens": torch.from_numpy(toks)})
    assert not any(ops.launch_counts().values())            # CPU: plain versions only
    want, _ = _jax_outputs(arch, method)
    cfg = tm.cfg
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, cfg.padded_vocab)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch,method", CASES)
def test_loss_matches_jax(arch, method, masked):
    tm = _models(arch, method)[1]
    toks, mask = _batch()
    batch = {"tokens": torch.from_numpy(toks)}
    if masked:
        batch["loss_mask"] = torch.from_numpy(mask)
    total, parts = tm.loss(_port_params(arch), batch)
    assert set(parts) == {"ce", "aux"} and float(parts["aux"]) == 0.0
    assert total.dtype == torch.float32 and total.shape == ()
    assert float(total) == float(parts["ce"])
    want = _jax_outputs(arch, method)[1][masked]
    np.testing.assert_allclose([float(total), float(parts["ce"]), float(parts["aux"])],
                               want, rtol=0, atol=LOSS_ATOL)


def test_loss_mask_weights_the_positions():
    """The masked mean over targets equals the mean of the per-token losses kept."""
    tm = _models("llama3-8b", "auto")[1]
    toks, mask = _batch()
    logits = tm.forward(_port_params("llama3-8b"), {"tokens": torch.from_numpy(toks)})
    lg = logits[:, :-1]
    t = torch.from_numpy(toks[:, 1:]).long()
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, t[..., None])[..., 0]
    keep = torch.from_numpy(mask[:, 1:]).bool()
    _, parts = tm.loss(_port_params("llama3-8b"), {"tokens": torch.from_numpy(toks),
                                                   "loss_mask": torch.from_numpy(mask)})
    assert torch.allclose(parts["ce"], nll[keep].mean(), rtol=1e-6, atol=0)
    _, none = tm.loss(_port_params("llama3-8b"),
                      {"tokens": torch.from_numpy(toks),
                       "loss_mask": torch.zeros((B, S), dtype=torch.int32)})
    assert float(none["ce"]) == 0.0                           # clamp(sum(mask), 1)


@functools.lru_cache(maxsize=None)
def _jax_kernel_grad_error():
    """The exception ``jax.grad`` raises through the "kernel" zamba2 loss (B17)."""
    jm = _models("zamba2-1.2b", "kernel")[0]
    toks, _ = _batch()
    try:
        jax.grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)})[0])(
            _jax_params("zamba2-1.2b"))
    except Exception as e:                                    # noqa: BLE001
        return type(e).__name__
    return None


def test_forward_runs_without_grad_on_params_that_require_it():
    """With grad mode on, the "kernel" zamba2 forward on params that require grad
    raises before any launch, as ``jax.grad`` fails through B17; under
    ``torch.no_grad()`` it runs and equals the forward on plain params."""
    assert _jax_kernel_grad_error() is not None
    tm = _models("zamba2-1.2b", "kernel")[1]
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), _port_params("zamba2-1.2b"))
    toks, _ = _batch()
    ops.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="ssd_chunk_scan has no gradient"):
        tm.forward(params, {"tokens": torch.from_numpy(toks)})
    with pytest.raises(NotImplementedError, match="ssd_chunk_scan has no gradient"):
        tm.loss(params, {"tokens": torch.from_numpy(toks)})
    assert not any(ops.launch_counts().values())
    with torch.no_grad():
        logits = tm.forward(params, {"tokens": torch.from_numpy(toks)})
    assert not logits.requires_grad
    want = tm.forward(_port_params("zamba2-1.2b"), {"tokens": torch.from_numpy(toks)})
    assert torch.equal(logits, want)

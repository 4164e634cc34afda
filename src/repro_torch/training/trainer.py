"""Trainer: the train step with gradient accumulation, checkpoints, resume and
straggler monitoring, on one device.

Port of ``repro/training/trainer.py``.  Where JAX jits ``value_and_grad`` of
the model's loss and donates the state, the step here runs the loss forward
and ``backward()`` on parameter leaves that require grad, then AdamW in place
under ``torch.no_grad()``.  The recurrences differentiate through
``linear_scan``'s analytic adjoint (B13 or B14–B16 launch again in the
backward pass); a method without a gradient raises before any launch.  A
data-parallel mesh (``mesh=``) comes with the mesh slice (ROADMAP Queue A item
11, its launch side).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from repro_torch.core import guards
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.straggler import StragglerMonitor

__all__ = ["Trainer"]

F32 = torch.float32


class Trainer:
    """``Trainer(cfg, opt_cfg, *, ckpt_dir=None, grad_accum=1, param_dtype=fp32,
    device=None)``; ``device=None`` means ``"cuda"`` (raises without a GPU).

    The state is ``{"params", "opt": {"mu", "nu", "step"}}``, the JAX
    package's layout, so its checkpoints restore in either package.
    """

    def __init__(self, cfg, opt_cfg: opt_lib.AdamWConfig, *, mesh=None,
                 ckpt_dir: Optional[str] = None, grad_accum: int = 1,
                 param_dtype=torch.float32, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=): data-parallel training comes with the mesh slice "
                "(ROADMAP Queue A item 11, its launch side); the port trains on one "
                "device")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.device = guards.resolve_device(device, op="Trainer")
        self.model = build_model(cfg)
        self.grad_accum = grad_accum
        self.param_dtype = param_dtype
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.monitor = StragglerMonitor()

    # ---- state ----
    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters from ``seed`` and a fresh AdamW state."""
        return self.state_from_params(
            self.model.init(seed, device=self.device, dtype=self.param_dtype))

    def state_from_params(self, params) -> Dict[str, Any]:
        """A train state around ``params`` (e.g. ``convert.params_from_jax``)."""
        return {"params": params, "opt": opt_lib.adamw_init(params)}

    # ---- step ----
    def grads(self, params, batch):
        """``(loss, metrics, grads)`` of one batch of device tensors, without an
        update: ``grads`` mirrors ``params``, accumulated over ``grad_accum``
        microbatches in fp32 as JAX sums them (the parameters are left requiring
        grad, their ``.grad`` cleared)."""
        leaves = [p for p in opt_lib.tree_leaves(params) if p.is_floating_point()]
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        accum = self.grad_accum
        if accum == 1:
            loss, metrics = self.model.loss(params, batch)
            loss.backward()
            grads = opt_lib.tree_map(
                lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            grads = opt_lib.tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                           device=p.device), params)
            loss = torch.zeros((), dtype=F32, device=self.device)
            for i in range(accum):
                l, _ = self.model.loss(params, {k: v[i] for k, v in micro.items()})
                l.backward()
                opt_lib.tree_map(lambda g, p: None if p.grad is None else g.add_(p.grad),
                                 grads, params)
                for p in leaves:
                    p.grad = None
                loss = loss + l.detach()
            grads = opt_lib.tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = {}
        for p in leaves:
            p.grad = None
        return loss.detach(), metrics, grads

    def train_step(self, state, batch):
        """One optimizer step on ``batch`` (numpy arrays or tensors of ``(B, ...)``,
        ``B`` a multiple of ``grad_accum``): ``(state, metrics)``.

        ``metrics`` holds the model's ``ce``/``aux`` (only when ``grad_accum``
        is 1, as in JAX), ``grad_norm``, ``lr`` and ``loss``, as 0-d tensors on
        the device.  The state is updated in place (JAX donates it).
        """
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        loss, metrics, grads = self.grads(state["params"], batch)
        params, opt, om = opt_lib.adamw_update(self.opt_cfg, grads, state["opt"],
                                               state["params"])
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    # ---- loop with resume ----
    def fit(self, source, steps: int, *, seed: int = 0, log_every: int = 10,
            ckpt_every: int = 0, state=None, log=print) -> Dict[str, Any]:
        """Train to ``steps``, resuming from the latest checkpoint when ``state``
        is None and ``ckpt_dir`` holds one; batches are ``source.batch_at(step)``.

        Returns ``{"state", "losses"}``, the losses of the steps run here.
        """
        start_step = 0
        if state is None:
            state = self.init_state(seed)
            if self.ckpt is not None and self.ckpt.latest_step() is not None:
                start_step = self.ckpt.latest_step()
                state = self.ckpt.restore(start_step, state)
                log(f"[trainer] resumed from step {start_step}")
        losses = []
        for step in range(start_step, steps):
            batch = source.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])                # waits for the step
            dt = time.perf_counter() - t0
            self.monitor.record(0, dt)
            losses.append(loss)
            if log_every and (step + 1) % log_every == 0:
                log(f"[trainer] step {step + 1} loss {loss:.4f} ({dt * 1e3:.1f} ms)")
            if self.ckpt is not None and ckpt_every and (step + 1) % ckpt_every == 0:
                self.ckpt.save(step + 1, state)
        if self.ckpt is not None:
            self.ckpt.wait()
        return {"state": state, "losses": losses}

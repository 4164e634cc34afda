"""Trainer: the train step with gradient accumulation, checkpoints, resume and
straggler monitoring, on one device or a grid of ranks.

Port of ``repro/training/trainer.py``.  Where JAX jits ``value_and_grad`` of
the model's loss and donates the state, the step here runs the loss forward
and ``backward()`` on parameter leaves that require grad, then AdamW in place
under ``torch.no_grad()``.  The recurrences differentiate through
``linear_scan``'s analytic adjoint (B13 or B14–B16 launch again in the
backward pass); a method without a gradient raises before any launch.

With ``mesh=`` (a ``utils.sharding.Grid``, e.g. ``launch.mesh.make_debug_mesh()``)
every rank of the world runs the trainer.  The state is laid out as JAX's
``state_shardings`` lays it out: the parameters, ``mu`` and ``nu`` by
``param_shardings`` (each rank holds its block of each leaf), ``step``
replicated.  A step takes the global batch; each rank keeps its rows of it
(microbatch ``i``'s share of the data axes, as JAX shards each microbatch
of its ``(accum, B/accum, ...)`` reshape), gathers each parameter over the
group that splits it, runs forward and backward on its rows, cuts its block
of each gradient, and averages the blocks over the data group with one
counted ``all_reduce`` (a flat fp32 bucket that also carries the loss terms).
The model group computes redundantly: every model rank runs the whole model
on its data group's rows (Megatron-style tensor-parallel compute is not
ported), except the MoE experts, which run expert-parallel.  Each rank's
loss is its share of the whole batch's (the masked ``ce`` over the global
``Σ mask``, the MoE ``aux`` over the global first-choice fractions), so the
data group's mean is JAX's loss and gradient.  The clip's norm counts every
element once (``optimizer.sharded_global_norm``), then AdamW updates the
rank's blocks.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from repro_torch.core import comm, guards
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.straggler import StragglerMonitor
from repro_torch.utils import sharding

__all__ = ["Trainer"]

F32 = torch.float32


class Trainer:
    """``Trainer(cfg, opt_cfg, *, mesh=None, ckpt_dir=None, grad_accum=1,
    param_dtype=fp32, device=None)``; ``device=None`` means ``"cuda"`` (raises
    without a GPU).

    The state is ``{"params", "opt": {"mu", "nu", "step"}}``, the JAX
    package's layout, so its checkpoints restore in either package; under a
    grid each rank holds its blocks of it (module docstring), and a
    checkpoint is written whole.
    """

    def __init__(self, cfg, opt_cfg: opt_lib.AdamWConfig, *, mesh=None,
                 ckpt_dir: Optional[str] = None, grad_accum: int = 1,
                 param_dtype=torch.float32, device=None):
        if mesh is not None and not isinstance(mesh, sharding.Grid):
            raise TypeError(f"Trainer(mesh=): a utils.sharding.Grid (launch.mesh."
                            f"make_debug_mesh()), got {type(mesh).__name__}")
        if mesh is not None and mesh.is_abstract:
            raise ValueError("Trainer(mesh=): an abstract grid has no ranks to train on")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self._placements = None
        self.device = guards.resolve_device(device, op="Trainer")
        self.model = build_model(cfg)
        self.grad_accum = grad_accum
        self.param_dtype = param_dtype
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.monitor = StragglerMonitor()

    # ---- state ----
    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters from ``seed`` and a fresh AdamW state (under a grid,
        every rank builds the same parameters and keeps its blocks)."""
        return self.state_from_params(
            self.model.init(seed, device=self.device, dtype=self.param_dtype))

    def state_from_params(self, params) -> Dict[str, Any]:
        """A train state around the whole ``params`` (e.g.
        ``convert.params_from_jax``); under a grid, this rank's blocks of it."""
        state = {"params": params, "opt": opt_lib.adamw_init(params)}
        if self.mesh is None:
            return state
        shards = self.state_shardings(state)
        return opt_lib.tree_map(   # a split leaf's block is copied, so the whole one can go
            lambda x, pl: sharding.cut(x, pl).clone() if pl.split_axes() else x, state, shards)

    def state_shardings(self, state=None):
        """JAX's ``state_shardings``: a ``Placement`` a leaf of the state,
        params, ``mu`` and ``nu`` by ``param_shardings``, ``step`` replicated.
        ``state`` holds whole leaves; once a state was laid out, the placements
        are kept and ``state`` may be omitted."""
        if self.mesh is None:
            raise ValueError("Trainer.state_shardings: the trainer has no mesh")
        if state is not None:
            params = sharding.param_shardings(self.mesh, state["params"])
            self._placements = {"params": params,
                                "opt": {"mu": params, "nu": params,
                                        "step": sharding.replicated(self.mesh, ())}}
        if self._placements is None:
            raise ValueError("Trainer.state_shardings: no state laid out yet")
        return self._placements

    def _rows(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch: of each microbatch (rows
        ``[i·B/accum, (i+1)·B/accum)``), the share of its data-axes index, in
        microbatch order."""
        dp = sharding.dp_axes(self.mesh)
        d, j = self.mesh.size_of(dp), self.mesh.index_of(dp)
        accum = self.grad_accum
        out = {}
        for k, v in batch.items():
            if v.shape[0] % (accum * d):
                raise ValueError(f"Trainer: a batch of {v.shape[0]} rows does not split "
                                 f"into {accum} microbatches over {d} data ranks")
            per = v.shape[0] // (accum * d)
            out[k] = v.reshape(accum, d, per, *v.shape[1:])[:, j].reshape(
                accum * per, *v.shape[1:])
        return out

    def _ce_denominators(self, batch):
        """Each microbatch's share of its masked ``ce`` denominator,
        ``max(Σ mask, 1) / data ranks`` over the global batch; None without a
        mask (every rank then holds as many positions)."""
        mask = batch.get("loss_mask")
        if mask is None:
            return [None] * self.grad_accum
        d = self.mesh.size_of(sharding.dp_axes(self.mesh))
        m = mask[:, 1:].to(torch.float32).reshape(self.grad_accum, -1)
        return [torch.clamp(m[i].sum(), min=1.0) / d for i in range(self.grad_accum)]

    # ---- step ----
    def grads(self, params, batch, *, sync: bool = True):
        """``(loss, metrics, grads)`` of one batch of device tensors, without an
        update: ``grads`` mirrors ``params``, accumulated over ``grad_accum``
        microbatches in fp32 as JAX sums them (the parameters are left requiring
        grad, their ``.grad`` cleared).

        Under a grid ``params`` are this rank's blocks and ``batch`` the global
        batch; ``grads`` are the blocks of JAX's gradient (averaged over the
        data group), ``loss`` and ``metrics`` the whole batch's.  With
        ``sync=False`` they are this rank's own share, before the data group's
        mean (what a gradient sync of one's own, e.g.
        ``grad_compression.compressed_grad_sync``, takes).
        """
        if self.mesh is None:
            return self._local_grads(params, batch, [None] * self.grad_accum)
        places = self.state_shardings()["params"]
        whole = opt_lib.tree_map(lambda x, pl: sharding.gather(x.detach(), pl), params,
                                 places)
        dens = self._ce_denominators(batch)
        with sharding.use_mesh(self.mesh):
            loss, metrics, grads = self._local_grads(whole, self._rows(batch), dens)
        blocks = opt_lib.tree_map(sharding.cut, grads, places)
        if not sync:
            return loss, metrics, blocks
        names = sorted(metrics)
        terms = [loss] + [metrics[k] for k in names]
        leaves = opt_lib.tree_leaves(blocks)
        flat = torch.cat([g.reshape(-1).to(F32) for g in leaves]
                         + [t.reshape(1).to(F32) for t in terms])
        dp = sharding.dp_axes(self.mesh)
        d = self.mesh.size_of(dp)
        if d > 1:
            flat = comm.all_reduce(flat, "sum", self.mesh.group(dp)) / d
        out, at = [], 0
        for g in leaves:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        synced = _unflatten_like(blocks, iter(out))
        loss = flat[at]
        metrics = {k: flat[at + 1 + i] for i, k in enumerate(names)}
        return loss, metrics, synced

    def _local_grads(self, params, batch, dens):
        leaves = [p for p in opt_lib.tree_leaves(params) if p.is_floating_point()]
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        accum = self.grad_accum
        if accum == 1:
            loss, metrics = self.model.loss(params, batch, ce_denominator=dens[0])
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
                l, _ = self.model.loss(params, {k: v[i] for k, v in micro.items()},
                                       ce_denominator=dens[i])
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
        ``B`` a multiple of ``grad_accum``, and under a grid of ``grad_accum``
        times the data ranks): ``(state, metrics)``.

        ``metrics`` holds the model's ``ce``/``aux`` (only when ``grad_accum``
        is 1, as in JAX), ``grad_norm``, ``lr`` and ``loss``, as 0-d tensors on
        the device, the whole batch's on every rank.  The state is updated in
        place (JAX donates it).
        """
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        loss, metrics, grads = self.grads(state["params"], batch)
        gnorm = None
        if self.mesh is not None:
            gnorm = opt_lib.sharded_global_norm(grads, self.state_shardings()["params"])
        params, opt, om = opt_lib.adamw_update(self.opt_cfg, grads, state["opt"],
                                               state["params"], grad_norm=gnorm)
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
                shards = self.state_shardings() if self.mesh is not None else None
                state = self.ckpt.restore(start_step, state, shardings=shards)
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
                self.save(step + 1, state)
        if self.ckpt is not None:
            self.ckpt.wait()
        return {"state": state, "losses": losses}

    def save(self, step: int, state) -> None:
        """Checkpoint ``state`` at ``step``: under a grid every rank calls it, the
        leaves are gathered and rank 0 writes them (``CheckpointManager.save``)."""
        shards = self.state_shardings() if self.mesh is not None else None
        self.ckpt.save(step, state, shardings=shards)


def _unflatten_like(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], it) for k in sorted(tree)}
    return next(it)

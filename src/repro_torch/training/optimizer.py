"""AdamW over the port's parameter trees (nested dicts of tensors).

Port of ``repro/training/optimizer.py``.  The moments are fp32; parameters may
be bf16 or fp32, the update is computed in fp32 and cast back; weight decay
applies to matrices (``ndim >= 2``) only; gradients are clipped to a global
norm.  The learning rate is a linear warmup then a cosine decay to
``min_lr_frac · lr``, in fp32 arithmetic as in JAX.  ``opt_state_specs``
gives the moments' specs (ZeRO: also split over a data axis) as JAX does;
under a grid (``Trainer(mesh=)``) the update runs on each rank's blocks, with
the global gradient norm of :func:`sharded_global_norm`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

__all__ = ["AdamWConfig", "lr_at", "adamw_init", "global_norm", "sharded_global_norm",
           "adamw_update", "opt_state_specs", "tree_leaves", "tree_map"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, keys in sorted order (JAX's leaf order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), an fp32 scalar.

    Example:
        >>> cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110)
        >>> [round(float(lr_at(cfg, s)), 4) for s in (5, 10, 110)]
        [0.5, 1.0, 0.1]
    """
    step = torch.as_tensor(step).to(F32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> Dict:
    """Zero fp32 moments shaped like ``params`` and an int32 step of 0, on
    the parameters' device."""
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params),
            "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """``sqrt(Σ x²)`` over every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)))


def sharded_global_norm(blocks, placements) -> torch.Tensor:
    """The global norm of a gradient whose leaves are this rank's blocks.

    Each element must count once: a leaf split over grid axes contributes its
    block's squares summed over those axes' groups (one counted ``all_reduce``
    of one fp32 scalar an axis set, and none over a group of one rank); a
    replicated leaf counts once, from this rank's copy.  The same on every
    rank.  ``placements`` mirrors ``blocks`` (``utils.sharding.Placement``).
    """
    from repro_torch.core import comm

    sums = {}
    for x, pl in zip(tree_leaves(blocks), tree_leaves(placements)):
        key = pl.split_axes()
        part = torch.sum(torch.square(x.to(F32)))
        sums[key] = part if key not in sums else sums[key] + part
    total = None
    for key in sorted(sums, key=lambda k: (len(k), k)):
        s = sums[key]
        for a in key:
            s = comm.all_reduce(s, "sum", pl.grid.group(a))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params, *, grad_norm=None):
    """One AdamW step: ``(params, opt_state, {"grad_norm", "lr"})``.

    The new values are written into the ``params`` and moment tensors, which
    are returned (JAX's trainer donates its state), so a step holds one leaf's
    temporaries at a time instead of a second train state; each leaf's values
    are computed out of place first, in JAX's order of operations.
    ``grad_norm`` (the clip's norm) defaults to :func:`global_norm` of
    ``grads``; a grid's trainer passes :func:`sharded_global_norm`.
    """
    step = opt_state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    sf = step.to(F32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=sf.device), sf)

    def upd(g, m, v, p):
        g = g.to(F32) * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if p.dim() >= 2:                                 # decay matrices only
            delta = delta + cfg.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * delta).to(p.dtype))
        m.copy_(m2)
        v.copy_(v2)
        return p, m, v

    out = tree_map(upd, grads, opt_state["mu"], opt_state["nu"], params)
    new_opt = {"mu": _pick(out, 1), "nu": _pick(out, 2), "step": step}
    return _pick(out, 0), new_opt, {"grad_norm": gnorm, "lr": lr}


def opt_state_specs(param_specs, *, zero_axis: Optional[str] = None) -> Dict:
    """The optimizer state's specs: the moments as their parameters, or with
    ``zero_axis`` also split over that axis along the first dim the
    parameter's spec leaves whole (ZeRO-1; a spec with no such entry is kept);
    the step replicated.  ``param_specs`` holds spec tuples
    (``utils.sharding.param_specs``) or placements
    (``utils.sharding.param_shardings``), and the result holds the same kind.

    Example:
        >>> opt_state_specs({"w": (None, "model")}, zero_axis="data")["mu"]
        {'w': ('data', 'model')}
    """
    def moment_spec(ps):
        if zero_axis is None:
            return ps
        spec = ps.spec if hasattr(ps, "spec") else ps
        parts = list(spec)
        for i, a in enumerate(parts):
            if a is None:
                parts[i] = zero_axis
                spec = tuple(parts)
                break
        return dataclasses.replace(ps, spec=spec) if hasattr(ps, "spec") else spec
    mu = tree_map(moment_spec, param_specs)
    leaves = tree_leaves(param_specs)
    step = ()
    if leaves and hasattr(leaves[0], "spec"):
        step = dataclasses.replace(leaves[0], spec=(), shape=())
    return {"mu": mu, "nu": mu, "step": step}


def _pick(tree, i):
    """Element ``i`` of every ``(p, m, v)`` leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]

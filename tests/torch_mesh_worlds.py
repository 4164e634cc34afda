"""Rank-side cases of the grid tests of the PyTorch port.

The functions here run on every rank of a gloo world started by
``repro_torch.launch.world.run_world``: the data-parallel ``Trainer(mesh=)``
and its checkpoints (``test_torch_mesh_training.py``), the expert-parallel
MoE layer and the engines on a grid (``test_torch_moe_ep.py``), the int8
gradient sync (``test_torch_grad_compression.py``) and the blocks of
``utils.sharding`` (``test_torch_sharding.py``).  They import torch and the
port only, never JAX: the tests build the inputs (JAX's parameters as numpy
trees among them), hand them to every rank, and hold what comes back against
the JAX package in their own process.  Each case returns numpy arrays, plain
numbers and the collective counts of the calls it checks (the counters are
reset just before a call and read just after).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.convert import params_from_jax
from repro_torch.core import comm
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe
from repro_torch.models.model import get_config
from repro_torch.training import grad_compression as gc
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import AdamWConfig, tree_leaves, tree_map
from repro_torch.training.trainer import Trainer
from repro_torch.utils import sharding


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def _counted(fn):
    comm.reset_comm_counts()
    out = fn()
    return out, comm.comm_counts()


def _slices(pl) -> list:
    return [(s.start, s.stop) for s in sharding.block_slices(pl)]


def _blocks(tree, places) -> dict:
    """``{path: (block, slices)}`` of a tree of this rank's blocks."""
    out = {}

    def walk(t, p, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], p[k], path + (k,))
        else:
            out["/".join(path)] = (_np(t), _slices(p))
    walk(tree, places, ())
    return out


def _batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Trainer(mesh=) and checkpoints
# ---------------------------------------------------------------------------


def train_case(arch, params, batch, *, grad_accum=1, steps=0, lr=1e-3, scan_method=None,
               ckpt_dir=None) -> dict:
    """One trainer on the debug grid: the synced gradient blocks and the loss of
    ``grads`` on ``batch``, then ``steps`` train steps on it (their losses, and
    the first step's collectives), and with ``ckpt_dir`` a save after them
    (rank 0 returns the whole state it gathered)."""
    grid = make_debug_mesh()
    cfg = get_config(arch, smoke=True)
    if scan_method:
        cfg = dataclasses.replace(cfg, scan_method=scan_method)
    tr = Trainer(cfg, AdamWConfig(lr=lr), mesh=grid, grad_accum=grad_accum, device="cpu",
                 ckpt_dir=ckpt_dir)
    state = tr.state_from_params(params_from_jax(params, device="cpu"))
    b = _batch(batch)
    (loss, metrics, grads), counts = _counted(lambda: tr.grads(state["params"], b))
    places = tr.state_shardings()["params"]
    out = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": _blocks(grads, places), "grads_counts": counts,
           "coord": dict(grid.coord), "rows": {k: _np(v) for k, v in tr._rows(b).items()},
           "block_elements": sum(x.numel() for x in tree_leaves(grads)),
           "gathered": [math_prod(pl.shape) for pl in tree_leaves(places)
                        if pl.split_axes()],
           "capacity_ok": None}
    if cfg.moe is not None:
        rows = tr._rows(b)["tokens"]
        t = rows.shape[0] // grad_accum * rows.shape[1]
        out["capacity_ok"] = moe.capacity_of(t, cfg) >= t     # no expert can overflow
    losses, norms = [], []
    for i in range(steps):
        (state, m), c = _counted(lambda: tr.train_step(state, b))
        if i == 0:
            out["step_counts"] = c
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["losses"], out["grad_norms"] = losses, norms
    if ckpt_dir is not None:
        tr.save(steps, state)
        whole = tree_map(lambda x, pl: sharding.gather(x, pl), state, tr.state_shardings())
        if comm.axis_index() == 0:
            out["whole_state"] = _flat_np(whole)
    return out


def math_prod(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _flat_np(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _np(tree)}


def restore_case(arch, ckpt_dir, step) -> dict:
    """A checkpoint (written by JAX or by a world) restored into a trainer's
    layout on the debug grid: each rank's blocks with their slices."""
    grid = make_debug_mesh()
    tr = Trainer(get_config(arch, smoke=True), AdamWConfig(), mesh=grid, device="cpu",
                 ckpt_dir=ckpt_dir)
    state = tr.init_state(1)
    state = tr.ckpt.restore(step, state, shardings=tr.state_shardings())
    return _blocks(state, tr.state_shardings())


def elastic_save(ckpt_dir) -> None:
    """JAX's elastic case, saving side: an (8, 8) ``arange`` split by rows over
    a grid of 8 ``data`` ranks, saved at step 1."""
    grid = sharding.Grid((8,), ("data",))
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    pl = sharding.Placement(grid, ("data", None), (8, 8))
    CheckpointManager(ckpt_dir, async_save=False).save(
        1, {"w": sharding.cut(x, pl)}, blocking=True, shardings={"w": pl})


def elastic_restore(ckpt_dir, arch, trainer_dir, trainer_step) -> dict:
    """The restoring side, in a world of 4 on a (2, 2) grid: JAX's case with the
    spec ``("model", "data")``, and the trainer's checkpoint on this layout."""
    grid = sharding.Grid((2, 2), ("data", "model"))
    pl = sharding.Placement(grid, ("model", "data"), (8, 8))
    w = CheckpointManager(ckpt_dir).restore(1, {"w": torch.zeros(())},
                                            shardings={"w": pl})["w"]
    tr = Trainer(get_config(arch, smoke=True), AdamWConfig(), mesh=grid, device="cpu",
                 ckpt_dir=trainer_dir)
    state = tr.ckpt.restore(trainer_step, tr.init_state(1), shardings=tr.state_shardings())
    return {"w": (_np(w), _slices(pl)), "coord": dict(grid.coord),
            "state": _blocks(state, tr.state_shardings())}


def mesh_training_world(cases, ckpt=None, elastic_dir=None) -> dict:
    """The world of 8's whole workload for ``test_torch_mesh_training.py``."""
    out = {name: train_case(**kw) for name, kw in cases.items()}
    if ckpt is not None:
        out["restored"] = restore_case(**ckpt)
    if elastic_dir is not None:
        elastic_save(elastic_dir)
    return out


# ---------------------------------------------------------------------------
# the expert-parallel MoE layer and the engines on a grid
# ---------------------------------------------------------------------------


def _moe_cfg(capacity_factor):
    cfg = get_config("deepseek-moe-16b", smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=capacity_factor))


def ep_forward(layer, x, capacity_factor) -> dict:
    """``moe_apply`` of this rank's data shard of ``x`` (B, S, D) on the debug
    grid (expert-parallel over its model group), without a gradient."""
    grid = make_debug_mesh()
    cfg = _moe_cfg(capacity_factor)
    p = params_from_jax(layer, device="cpu")
    d = grid.shape["data"]
    j = grid.coord["data"]
    per = x.shape[0] // d
    xl = torch.from_numpy(x[j * per:(j + 1) * per])
    with torch.no_grad(), sharding.use_mesh(grid):
        (y, aux), counts = _counted(lambda: moe.moe_apply(p, xl, cfg, cdt=torch.float32))
    return {"y": _np(y), "aux": float(aux), "coord": dict(grid.coord), "counts": counts}


def dp_forward(layer, x, capacity_factor) -> dict:
    """``moe_apply`` of this rank's rows of ``x`` on a grid of 8 data ranks and no
    model axis: no expert parallelism, one of JAX's dispatch groups a rank, and
    the dispatch modes ``"auto"`` chose."""
    grid = sharding.Grid((8, 1), ("data", "model"))
    cfg = _moe_cfg(capacity_factor)
    p = params_from_jax(layer, device="cpu")
    per = x.shape[0] // grid.shape["data"]
    j = grid.coord["data"]
    modes, orig = [], moe.dispatch_positions

    def spy(*a, **kw):
        modes.append(kw["mode"])
        return orig(*a, **kw)
    moe.dispatch_positions = spy
    try:
        with torch.no_grad(), sharding.use_mesh(grid):
            (y, aux), counts = _counted(lambda: moe.moe_apply(
                p, torch.from_numpy(x[j * per:(j + 1) * per]), cfg, cdt=torch.float32))
    finally:
        moe.dispatch_positions = orig
    return {"y": _np(y), "aux": float(aux), "coord": dict(grid.coord), "counts": counts,
            "modes": modes}


def ep_grads(layer, x, r, capacity_factor) -> dict:
    """The gradients of ``L_k = D·Σ(y_k ∘ r_k) + aux_k`` on this rank (its data
    shard of ``x`` and of the weights ``r``), the experts expert-parallel: the
    data group's mean of them is the gradient of ``Σ(y ∘ r) + aux`` on the
    whole batch."""
    grid = make_debug_mesh()
    cfg = _moe_cfg(capacity_factor)
    p = tree_map(lambda t: t.requires_grad_(), params_from_jax(layer, device="cpu"))
    d, j = grid.shape["data"], grid.coord["data"]
    per = x.shape[0] // d
    xl = torch.from_numpy(x[j * per:(j + 1) * per]).requires_grad_()
    rl = torch.from_numpy(r[j * per:(j + 1) * per])

    def run():
        with sharding.use_mesh(grid):
            y, aux = moe.moe_apply(p, xl, cfg, cdt=torch.float32)
        (d * torch.sum(y * rl) + aux).backward()
    _, counts = _counted(run)
    return {"grads": _flat_np(tree_map(lambda t: t.grad, p)), "x_grad": _np(xl.grad),
            "coord": dict(grid.coord), "counts": counts}


def ep_engines(params, prompts, new, uniforms, requests) -> dict:
    """deepseek-moe-16b SMOKE served on the debug grid: ``ServeEngine`` greedy
    and ``topp_sharded`` (with ``uniforms``), and ``ContinuousEngine`` greedy
    over ``requests``."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import ContinuousEngine, Request

    grid = make_debug_mesh()
    cfg = get_config("deepseek-moe-16b", smoke=True)
    tp = params_from_jax(params, device="cpu")
    batch = {"tokens": torch.from_numpy(prompts)}
    max_len = prompts.shape[1] + new
    out = {"coord": dict(grid.coord)}
    eng = ServeEngine(cfg, tp, mesh=grid, max_len=max_len, sampler="greedy", device="cpu")
    out["expert_block"] = list(eng.params["stack"]["sub0"]["moe"]["experts"]["w_gate"].shape)
    toks, out["greedy_counts"] = _counted(lambda: eng.generate(batch, new))
    out["greedy"] = toks.numpy()
    eng = ServeEngine(cfg, tp, mesh=grid, max_len=max_len, sampler="topp_sharded",
                      device="cpu")
    toks, out["sharded_counts"] = _counted(
        lambda: eng.generate(batch, new, uniforms=torch.from_numpy(uniforms)))
    out["sharded"] = toks.numpy()
    cont = ContinuousEngine(cfg, tp, mesh=grid, sampler="greedy", device="cpu",
                            max_batch=2, page_size=8, n_pages=16, tick_tokens=4)
    res = cont.run([Request(**r) for r in requests])
    out["continuous"] = {rid: t.tolist() for rid, t in res["streams"].items()}
    return out


def moe_ep_world(layer, x_drop, x_grad, r, engines) -> dict:
    """The world of 8's whole workload for ``test_torch_moe_ep.py``."""
    return {"forward": ep_forward(layer, x_drop, 1.0),
            "dp_forward": dp_forward(layer, x_drop, 1.0),
            "grads": ep_grads(layer, x_grad, r, 16.0),
            "engines": ep_engines(**engines)}


# ---------------------------------------------------------------------------
# the int8 gradient sync and the blocks
# ---------------------------------------------------------------------------


def compressed_case(g, g2, tree) -> dict:
    """``compressed_psum`` of this rank's row of ``g`` over the world, twice
    (the second step adds the first's error to ``g2``'s row), and
    ``compressed_grad_sync`` of this rank's rows of a tree."""
    me = comm.axis_index()
    e0 = torch.zeros(g.shape[1:], dtype=torch.float32)
    (m1, e1), c1 = _counted(lambda: gc.compressed_psum(torch.from_numpy(g[me]), None, e0))
    m2, e2 = gc.compressed_psum(torch.from_numpy(g2[me]), None, e1)
    q, s = gc.quantize_int8(torch.from_numpy(g[me]))
    grads = {k: torch.from_numpy(v[me]) for k, v in tree.items()}
    (synced, errs), c3 = _counted(
        lambda: gc.compressed_grad_sync(grads, None, gc.init_errors(grads)))
    return {"mean1": _np(m1), "err1": _np(e1), "mean2": _np(m2), "err2": _np(e2),
            "q": _np(q), "scale": float(s), "psum_counts": c1, "sync_counts": c3,
            "synced": {k: _np(v) for k, v in synced.items()},
            "errs": {k: _np(v) for k, v in errs.items()}}


def blocks_case(arrays) -> dict:
    """Every ``(name, array, shape, axes, spec)`` of ``arrays`` cut on its grid
    and gathered back: this rank's block, its slices, the gathered tensor and
    the gathers' collectives."""
    out = {}
    grids = {}
    for name, (arr, shape, axes, spec) in arrays.items():
        key = (tuple(shape), tuple(axes))
        if key not in grids:
            grids[key] = sharding.Grid(shape, axes)
        pl = sharding.Placement(grids[key], tuple(spec), tuple(arr.shape))
        x = torch.from_numpy(arr)
        blk = sharding.cut(x, pl)
        whole, counts = _counted(lambda: sharding.gather(blk, pl))
        out[name] = {"block": _np(blk), "slices": _slices(pl), "whole": _np(whole),
                     "counts": counts, "coord": dict(grids[key].coord)}
    return out


def small_world(compressed=None, blocks=None) -> dict:
    """One world of 8 for the int8 sync and the blocks."""
    out = {}
    if compressed is not None:
        out["compressed"] = compressed_case(**compressed)
    if blocks is not None:
        out["blocks"] = blocks_case(blocks)
    return out

"""Rank-side cases of the distributed tests of the PyTorch port.

The functions here run on every rank of a gloo world started by
``repro_torch.launch.world.run_world`` (one process a rank, a ``file://``
rendezvous).  They import torch and the port only, never JAX: the tests
(``test_torch_dist_ops.py``, ``test_torch_distributed.py``) build the global
inputs with numpy, hand them to every rank, and hold what comes back against
the JAX package in their own process.

Each case shards its global inputs with ``comm.shard_last``, calls one
distributed operator of the port, joins the rank's result with
``comm.gather_last``, and returns the global result with the collective
counts of the operator's call alone (the counters are reset just before it
and read just after, so the gathers that join the result do not count).
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import comm, dist_ops, distributed
from repro_torch.core.primitives import radix_sort
from repro_torch.kernels import ops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
          "uint8": torch.uint8, "int16": torch.int16, "int32": torch.int32}


def _tensor(x, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(DTYPES[dtype]) if dtype else t


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _counted(fn):
    comm.reset_comm_counts()
    out = fn()
    return out, comm.comm_counts()


def run_case(case: dict, group=None) -> dict:
    """One case on this rank: ``{"out": [global numpy results], "counts": ...}``."""
    op, kw = case["op"], dict(case.get("kw", {}))
    d, me = comm.axis_size(group), comm.axis_index(group)

    def shard(x):
        return comm.shard_last(x, d, me)

    if op in ("sort", "topk"):
        x = _tensor(case["x"], case["dtype"])
        n = x.shape[-1]
        if op == "sort":
            (v, i), counts = _counted(
                lambda: dist_ops.dist_radix_sort(shard(x), n, group, **kw))
            out = [comm.gather_last(v, n, group), comm.gather_last(i, n, group)]
        else:
            k = case["k"]
            (v, i), counts = _counted(lambda: dist_ops.dist_topk(shard(x), k, n, group, **kw))
            L = comm.shard_len(n, d)
            out = [comm.gather_last(v, k, group, length=L),
                   comm.gather_last(i, k, group, length=L)]
    elif op == "linrec":
        a, b = _tensor(case["a"], case["dtype"]), _tensor(case["b"], case["dtype"])
        n = a.shape[-1]
        y, counts = _counted(lambda: dist_ops.dist_linear_scan(shard(a), shard(b), n, group,
                                                               **kw))
        out = [comm.gather_last(y, n, group)]
    elif op == "segscan":
        x = _tensor(case["x"], case["dtype"])
        n = x.shape[-1]
        offsets = torch.tensor(case["offsets"], dtype=torch.int32)
        y, counts = _counted(lambda: dist_ops.dist_segment_scan(shard(x), offsets, n, group,
                                                                **kw))
        out = [comm.gather_last(y, n, group)]
    elif op == "topp":
        logits = _tensor(case["logits"])
        n = logits.shape[-1]
        u = _tensor(case["u"])
        tok, counts = _counted(lambda: dist_ops.dist_top_p_sample(shard(logits), n, group,
                                                                  u=u, **kw))
        out = [tok]
    elif op == "mcscan":
        x = _tensor(case["x"], case["dtype"])
        n = x.shape[-1]
        if "accum_dtype" in kw:
            kw["accum_dtype"] = DTYPES[kw["accum_dtype"]]
        y, counts = _counted(lambda: distributed.mcscan(shard(x), group, **kw))
        out = [comm.gather_last(y, n, group)]
    else:
        raise ValueError(f"unknown case op {op!r}")
    return {"out": [_numpy(o) for o in out], "counts": counts}


def run_cases(cases) -> dict:
    """Every case on this rank, keyed by the case's ``id``."""
    return {c["id"]: run_case(c) for c in cases}


def run_grid_mcscan(x, shape, **kw) -> dict:
    """``mcscan`` on a 2-D grid of the world (JAX's ``batch_axis_name``).

    The world is a row-major ``shape = (data, model)`` grid: the last axis of
    ``x`` is sharded over the ``data`` ranks and its rows over the ``model``
    ranks.  Each rank scans its block within its data group; the blocks are
    joined with one all_gather over the world.
    """
    data_group, model_group = comm.grid_groups(shape)
    xt = _tensor(x)
    n = xt.shape[-1]
    di, mi = comm.axis_index(data_group), comm.axis_index(model_group)
    per = xt.shape[0] // shape[1]
    rows = xt[mi * per:(mi + 1) * per]                            # this rank's batch rows
    y, counts = _counted(lambda: distributed.mcscan(comm.shard_last(rows, shape[0], di),
                                                    data_group, **kw))
    L = comm.shard_len(n, shape[0])
    full = torch.zeros(rows.shape[:-1] + (L,), dtype=y.dtype)
    full[..., :y.shape[-1]] = y
    parts = [torch.empty_like(full) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, full)
    blocks = [[parts[i * shape[1] + j] for i in range(shape[0])] for j in range(shape[1])]
    out = torch.cat([torch.cat(row, dim=-1)[..., :n] for row in blocks], dim=0)
    return {"out": [_numpy(out)], "counts": counts}


def run_engine(params, prompts, uniforms, new: int, top_p: float) -> dict:
    """ServeEngine ``topp_sharded`` on the world, and ``topp_scan`` alone, on the
    SMOKE llama3-8b with the given (JAX package) weights and uniforms."""
    from repro_torch.convert import params_from_jax
    from repro_torch.models.model import get_config
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config("llama3-8b", smoke=True)
    tp = params_from_jax(params, device="cpu")
    batch = {"tokens": torch.from_numpy(prompts)}
    max_len = prompts.shape[1] + new
    u = torch.from_numpy(uniforms)
    sharded = ServeEngine(cfg, tp, mesh=dist.group.WORLD, max_len=max_len, top_p=top_p,
                          sampler="topp_sharded", device="cpu")
    toks, counts = _counted(lambda: sharded.generate(batch, new, uniforms=u))
    solo = ServeEngine(cfg, tp, max_len=max_len, top_p=top_p, sampler="topp_scan",
                       device="cpu").generate(batch, new, uniforms=u)
    return {"sharded": toks.numpy(), "solo": solo.numpy(), "counts": counts}


def run_continuous(params, trace, geom) -> dict:
    """ContinuousEngine ``topp_sharded`` on the world's vocab shards over the
    request dicts of ``trace`` (uniforms included), on the SMOKE llama3-8b with the
    given (JAX package) weights: its result and its collective calls."""
    from repro_torch.convert import params_from_jax
    from repro_torch.models.model import get_config
    from repro_torch.serving.scheduler import ContinuousEngine, Request

    eng = ContinuousEngine(get_config("llama3-8b", smoke=True),
                           params_from_jax(params, device="cpu"), mesh=dist.group.WORLD,
                           sampler="topp_sharded", top_p=0.9, device="cpu", **geom)
    res, counts = _counted(lambda: eng.run([Request(**r) for r in trace]))
    return {**res, "collectives": sum(counts["calls"].values())}


def run_world_cases(cases, engine=None, grid=None) -> dict:
    """A world's whole workload: the cases, then the engine run and the 2-D grid."""
    out = {"cases": run_cases(cases)}
    if engine is not None:
        out["engine"] = run_engine(**engine)
    if grid is not None:
        out["grid"] = run_grid_mcscan(**grid)
    return out


def fail_on_rank(rank: int) -> None:
    """Raise on ``rank``; the others wait at a barrier that never completes."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()


def hang_on_rank(rank: int) -> None:
    """Hang on ``rank``; the others wait for it at the world's closing barrier."""
    if dist.get_rank() == rank:
        time.sleep(3600)


def run_cuda_sort(n: int, seed: int) -> dict:
    """``dist_sort(method="kernel")`` of fp32 keys on the card against the local
    kernel sort of the gathered keys, with this rank's kernel launches."""
    d, me = comm.axis_size(), comm.axis_index()
    dev = torch.device("cuda")
    x = torch.randn((2, n), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    ops.reset_launch_counts()
    v, i = dist_ops.dist_sort(comm.shard_last(x, d, me), n, method="kernel")
    launches = ops.launch_counts()
    v, i = comm.gather_last(v, n), comm.gather_last(i, n)
    lv, li = radix_sort(x, method="kernel")
    return {"equal": bool(torch.equal(v, lv) and torch.equal(i, li)), "launches": launches}

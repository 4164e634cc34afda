"""The collectives of the distributed operators, with their counters.

Port of the collectives that ``repro/core/distributed.py`` and
``repro/core/dist_ops.py`` issue inside ``shard_map``.  JAX runs one
controller over a ``Mesh`` and hands each device its shard; the port runs one
process per rank (SPMD), and the counterpart of ``(mesh, axis_name)`` is a
``torch.distributed`` ``ProcessGroup`` (``None`` is the default group).  A
group is what every collective of ``torch.distributed`` takes, and it behaves
the same under gloo on the CPU, gloo with several ranks on one card, and NCCL
across cards; a ``DeviceMesh`` would add named dims, but it also binds each
rank to a device and builds groups of its own.  A 2-D mesh is a grid of
groups (:func:`grid_groups`, :func:`subgrid_group`), which
``repro_torch.utils.sharding.Grid`` names by JAX's mesh axes.  Without an
initialized process group a ``None`` group is a world of one rank, and
nothing here is called.  :func:`psum` and :func:`pbroadcast` are the
collectives with gradients that JAX's ``shard_map`` gives its ``psum`` and
its replicated inputs.

Every collective of the distributed operators goes through this module, and
each call adds to its kind's count of calls and of bytes: the bytes of the
collective's result on this rank (an ``all_gather`` of ``D`` operands counts
all ``D``, an ``all_to_all`` counts what this rank receives).  That is the
counterpart of the JAX package's HLO-parsed ``measure_collectives``, which
does not apply to eager PyTorch; ``repro_torch.analysis.collectives`` holds
the closed forms the counts are held to.

NCCL refuses two ranks on one GPU, so several ranks on one card talk over
gloo.  Gloo is the host's transport: for a gloo group, CUDA operands are
copied to host memory before the collective and the result back after it
(:func:`transport` names the route).  The kernels still run on the card.

:func:`shard_last` and :func:`gather_last` turn a global tensor into a rank's
shard of its last axis and back, in the operators' layout: with ``D`` ranks
and global length ``n``, rank ``d`` holds global positions ``[d·L, min((d+1)·L,
n))`` with ``L = ceil(n / D)``, so the last ranks' shards may be short or
empty.
"""
from __future__ import annotations

import collections
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["KINDS", "comm_counts", "reset_comm_counts", "axis_size", "axis_index",
           "all_gather", "all_reduce", "all_to_all", "transport", "grid_groups",
           "subgrid_group", "psum", "pbroadcast", "barrier", "shard_len", "shard_last",
           "gather_last"]

KINDS = ("all_gather", "all_to_all", "all_reduce")
_CALLS: collections.Counter = collections.Counter()
_BYTES: collections.Counter = collections.Counter()
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
# gloo moves no int16: its bits travel as fp16 in the collectives that only copy
_MOVE_AS = {torch.int16: torch.float16}


def comm_counts() -> Dict[str, Dict[str, int]]:
    """Collective calls and bytes since the last :func:`reset_comm_counts`, by kind.

    Returns:
        ``{"calls": {kind: n}, "bytes": {kind: b}}`` over :data:`KINDS`.
    """
    return {"calls": {k: _CALLS[k] for k in KINDS}, "bytes": {k: _BYTES[k] for k in KINDS}}


def reset_comm_counts() -> None:
    """Set every collective count to zero."""
    _CALLS.clear()
    _BYTES.clear()


def _count(kind: str, result: torch.Tensor) -> None:
    _CALLS[kind] += 1
    _BYTES[kind] += result.numel() * result.element_size()


def axis_size(group=None) -> int:
    """Ranks in ``group``: 1 for the default group of an uninitialized world."""
    if group is None and not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This rank's index in ``group`` (0 in an uninitialized world)."""
    if group is None and not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def transport(group=None, device=None) -> str:
    """How operands on ``device`` travel in ``group``: the backend, and for a
    gloo group with CUDA operands, that they are staged through host memory."""
    backend = dist.get_backend(group)
    if backend == "gloo" and torch.device(device or "cpu").type == "cuda":
        return "gloo, CUDA operands staged through host memory"
    return backend


def _to_host(t: torch.Tensor, group) -> torch.Tensor:
    return t.cpu() if t.is_cuda and _staged(group) else t


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.view(_MOVE_AS[t.dtype]) if t.dtype in _MOVE_AS else t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t``, stacked: ``(D, *t.shape)``, in group-rank order."""
    x = _wire(_to_host(t.contiguous(), group))
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.stack(parts).view(t.dtype).to(t.device)
    _count("all_gather", out)
    return out


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The elementwise ``op`` (``"sum"``, ``"max"`` or ``"min"``) of every rank's ``t``."""
    x = _to_host(t, group).clone()
    dist.all_reduce(x, op=_OPS[op], group=group)
    out = x.to(t.device)
    _count("all_reduce", out)
    return out


def all_to_all(t: torch.Tensor, send_splits: Sequence[int], recv_splits: Sequence[int],
               group=None) -> torch.Tensor:
    """Exchange rows of ``t``: ``send_splits[d]`` consecutive rows go to rank ``d``,
    and the result holds ``recv_splits[s]`` rows from each rank ``s``, in rank order."""
    x = _wire(_to_host(t.contiguous(), group))
    out = torch.empty((sum(recv_splits),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x, list(recv_splits), list(send_splits), group=group)
    out = out.view(t.dtype).to(t.device)
    _count("all_to_all", out)
    return out


def barrier(group=None) -> None:
    """Wait until every rank of ``group`` reaches this call.  It moves no data
    and counts nothing; a world of one rank returns at once."""
    if axis_size(group) > 1:
        dist.barrier(group=group)


def grid_groups(shape: Sequence[int]) -> Tuple:
    """The groups of this rank along each dim of a row-major grid of the world.

    The counterpart of a JAX ``Mesh`` of ``shape``: world rank ``r`` sits at the
    row-major coordinate of ``r``, and the group along dim ``i`` holds the
    ranks that share every other coordinate.  Every rank must call this (it
    creates every group, in one order).

    Example: in a world of 8, ``grid_groups((4, 2))`` gives rank 5 (coordinate
    ``(2, 1)``) the group of ranks ``[1, 3, 5, 7]`` along dim 0 and ``[4, 5]``
    along dim 1.
    """
    return tuple(subgrid_group(shape, (axis,)) for axis in range(len(shape)))


def subgrid_group(shape: Sequence[int], dims: Sequence[int]):
    """This rank's group over several dims of a row-major grid of the world.

    The group holds the ranks that share every coordinate outside ``dims``,
    in row-major order of their coordinates along ``dims`` (the first of
    ``dims`` the major one, as a JAX ``PartitionSpec`` entry of several mesh
    axes orders its devices).  Every rank must call this with the same
    arguments, in one order (it creates every such group of the grid).

    Example: in a world of 8 on the grid ``(2, 2, 2)``, ``subgrid_group((2, 2,
    2), (0, 1))`` gives rank 5 (coordinate ``(1, 0, 1)``) the group of ranks
    ``[1, 3, 5, 7]``.
    """
    world, me = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"grid_groups: a grid of {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, the world has {world}")
    dims = tuple(dims)
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    rest_dims = [i for i in range(len(shape)) if i not in dims]
    found = None
    for rest in itertools.product(*(range(shape[i]) for i in rest_dims)):
        base = sum(c * strides[i] for c, i in zip(rest, rest_dims))
        ranks = [base + sum(c * strides[i] for c, i in zip(inner, dims))
                 for inner in itertools.product(*(range(shape[i]) for i in dims))]
        g = dist.new_group(ranks)
        if me in ranks:
            found = g
    return found


class _Psum(torch.autograd.Function):
    """Sum over ``group`` forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pbroadcast(torch.autograd.Function):
    """The identity forward; the cotangents summed over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.group), None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` (one counted ``all_reduce``), whose
    gradient is the identity.

    This is how JAX's ``psum`` under ``shard_map`` transposes: every rank of
    ``group`` uses the sum identically, so each rank's cotangent is already
    the whole cotangent of its own part.  ``torch.distributed.nn``'s
    ``all_reduce`` sums the cotangents too, which multiplies the parts'
    gradients by the group's size.  A group of one rank issues no call.
    """
    if axis_size(group) == 1:
        return x
    return _Psum.apply(x, group)


def pbroadcast(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as it is, whose gradient is summed over ``group`` (one counted
    ``all_reduce`` in the backward pass).

    The input side of :func:`psum`: a tensor that every rank of ``group``
    holds alike and feeds to its own part of a sum gets each part's cotangent
    on one rank only, and the sum of them is its gradient (JAX's
    ``shard_map`` sums the cotangents of an input that is replicated over an
    axis).  A group of one rank issues no call.
    """
    if axis_size(group) == 1:
        return x
    return _Pbroadcast.apply(x, group)


def shard_len(n: int, d: int) -> int:
    """``L = ceil(n / D)``, the length of a full shard."""
    return -(-n // d) if n else 0


def shard_last(x: torch.Tensor, d: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the last axis of ``x`` among ``d`` ranks."""
    n = x.shape[-1]
    L = shard_len(n, d)
    return x[..., min(rank * L, n):min((rank + 1) * L, n)]


def gather_last(shard: torch.Tensor, n: int, group=None, *,
                length: Optional[int] = None) -> torch.Tensor:
    """The global tensor of length ``n`` from every rank's :func:`shard_last` shard.

    One counted ``all_gather`` of the shards padded to ``L`` (``length``, or
    ``ceil(n / D)``; a top-k result keeps the layout of the ``n`` it was taken
    from).  A world of one rank needs no call.
    """
    d = axis_size(group)
    L = shard_len(n, d) if length is None else length
    pad = L - shard.shape[-1]
    if pad:
        shard = torch.cat([shard, shard.new_zeros(shard.shape[:-1] + (pad,))], dim=-1)
    if d == 1:
        return shard[..., :n]
    parts = all_gather(shard, group)                   # (D, ..., L)
    return torch.cat(list(parts.unbind(0)), dim=-1)[..., :n]

"""int8 gradient all-reduce with error feedback.

Port of ``repro/training/grad_compression.py``.  Each rank quantises its
gradient to int8 on a scale that every rank of the group shares (one
``all_reduce`` max of the absmax), so the int8 payloads sum exactly; the sum
runs on their int32 cast, the mean is formed in fp32, and the quantisation
error is kept on the rank and added to the next step's gradient (error
feedback).  Every collective goes through ``core/comm.py`` and is counted.

The JAX docstring promises "4× less collective traffic", but its ``psum``
runs on the int32 cast, which moves 4 bytes an element, as many as fp32; the
port does the same and counts the bytes as they are (``comm`` counts the
int32 result: ``4·numel`` bytes a tensor, plus 4 for the shared scale).  As
in JAX, the ``Trainer`` does not call it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import comm
from repro_torch.training.optimizer import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum", "compressed_grad_sync",
           "init_errors"]

F32 = torch.float32


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8: ``(q, scale)`` with ``x ≈ q · scale``."""
    absmax = torch.max(torch.abs(x)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compressed_psum(grad: torch.Tensor, group, error: torch.Tensor):
    """One tensor's error-feedback int8 mean over ``group``: ``(mean, new_error)``.

    One ``all_reduce`` max of the local absmax (the shared scale), then one
    ``all_reduce`` sum of the int8 payloads cast to int32; ``mean`` is that
    sum times the scale over the group's size, the same on every rank, and
    ``new_error`` the rank's own quantisation error.
    """
    g = grad.to(F32) + error
    absmax = comm.all_reduce(torch.max(torch.abs(g)), "max", group) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_error = g - q.to(F32) * scale
    tot = comm.all_reduce(q.to(torch.int32), "sum", group)        # int32 on the wire
    mean = tot.to(F32) * scale / comm.axis_size(group)
    return mean, new_error


def compressed_grad_sync(grads, group, errors):
    """:func:`compressed_psum` over every leaf of a nested dict:
    ``(synced_grads, new_errors)``; two collectives a leaf."""
    out = tree_map(lambda g, e: compressed_psum(g, group, e), grads, errors)
    return _pick(out, 0), _pick(out, 1)


def init_errors(grads):
    """Zero fp32 errors shaped like ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads)


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]

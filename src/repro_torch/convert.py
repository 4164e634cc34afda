"""Carry parameters across from the JAX package.

:func:`params_from_jax` takes a JAX parameter pytree already converted to
numpy (nested dicts of arrays, e.g. ``jax.tree.map(np.asarray, params)``) and
returns the port's parameter tree: the same nesting and the same JAX
``(d_in, d_out)`` weight layout, as torch tensors.  Nothing is transposed, so
``linear`` computes ``x @ w`` in both packages.  :func:`train_state_from_jax`
carries a whole JAX train state across (``params``, AdamW's ``opt.mu``,
``opt.nu`` and ``opt.step``), in the layout of ``training.trainer.Trainer``.
Like the other entry points they put the tensors on the GPU unless the caller
asks for the CPU.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import guards

__all__ = ["params_from_jax", "train_state_from_jax"]


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes bfloat16: widen exactly
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))       # a writable copy
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(tree: Any, *, device=None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Convert a numpy parameter tree to torch tensors on ``device``.

    Args:
        tree: Nested dicts of numpy arrays.
        device: Where the tensors go; ``None`` means ``"cuda"``, which raises
            without a GPU.
        dtype: Optional dtype to cast every leaf to.

    Returns:
        The same structure with ``torch.Tensor`` leaves.

    Example:
        >>> p = params_from_jax({"attn": {"wq": np.ones((2, 3), np.float32)}},
        ...                     device="cpu")
        >>> tuple(p["attn"]["wq"].shape), p["attn"]["wq"].dtype
        ((2, 3), torch.float32)
    """
    return _convert(tree, guards.resolve_device(device, op="params_from_jax"), dtype)


def train_state_from_jax(state: Any, *, device=None,
                         param_dtype: Optional[torch.dtype] = None) -> Any:
    """Convert a numpy JAX train state ``{"params", "opt": {"mu", "nu", "step"}}``.

    The parameters keep their dtype unless ``param_dtype`` is given; the
    moments are fp32 and the step an int32 scalar, as AdamW keeps them.

    Example:
        >>> st = {"params": {"w": np.ones((2, 2), np.float32)},
        ...       "opt": {"mu": {"w": np.zeros((2, 2), np.float32)},
        ...               "nu": {"w": np.zeros((2, 2), np.float32)},
        ...               "step": np.asarray(3, np.int32)}}
        >>> int(train_state_from_jax(st, device="cpu")["opt"]["step"])
        3
    """
    dev = guards.resolve_device(device, op="train_state_from_jax")
    opt = state["opt"]
    return {"params": _convert(state["params"], dev, param_dtype),
            "opt": {"mu": _convert(opt["mu"], dev, torch.float32),
                    "nu": _convert(opt["nu"], dev, torch.float32),
                    "step": _tensor(opt["step"], dev, torch.int32)}}


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)

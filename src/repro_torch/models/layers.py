"""Basic layers on plain parameter dicts (the JAX package's pytree layout).

Port of ``repro/models/layers.py``.  Weights keep the JAX ``(d_in, d_out)``
layout, so ``linear`` is ``x @ w``.  The compute dtype ``cdt`` is passed in
explicitly rather than read from a thread-local context.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import on_card

__all__ = ["ninit", "linear", "rmsnorm", "embed_lookup", "unembed", "mlp",
           "rope_freqs", "apply_rope", "sinusoid_at", "sinusoidal_pos", "softcap",
           "matmul_f32", "bmm_f32", "ACTS"]


def ninit(gen: torch.Generator, shape, *, n: Optional[int] = None, scale=None,
          dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal init scaled by ``fan_in ** -0.5`` (``shape[0]``), as the JAX ``ninit``.

    With ``n`` the result is ``n`` independent draws stacked on a leading
    axis (one per layer), made one layer at a time so a full-size init never
    holds more than one layer in fp32.  On the ``"meta"`` device it draws
    nothing and returns the shape alone (``gen`` may be None there).
    """
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape if n is None else (n, *shape), dtype=dtype, device=device)
    scale = scale if scale is not None else shape[0] ** -0.5
    if n is None:
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)
    out = torch.empty((n, *shape), dtype=dtype, device=device)
    for i in range(n):
        out[i] = (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)
    return out


def linear(p, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``x @ w`` in the compute dtype (no fp32 materialisation of the output)."""
    return torch.matmul(x.to(cdt), p["w"].to(cdt))


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with the ``(1 + g)`` scale (zero-initialised ``g``)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + p["g"].to(torch.float32))
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def embed_lookup(p, tokens: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Rows of the embedding table, in the compute dtype."""
    return F.embedding(tokens.to(torch.int64), p["embed"]).to(cdt)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 accumulation and an fp32 result.

    bf16/fp16 operands on the card (and on ``"meta"``, which plans it) use ``torch.mm(..., out_dtype=float32)``
    (the analogue of ``preferred_element_type=float32``), through
    :class:`_MatmulF32` for its gradient; elsewhere the operands are widened
    to fp32 first, which is exact.
    """
    if on_card(a) and a.dtype in (torch.bfloat16, torch.float16) and a.dtype == b.dtype:
        lead = a.shape[:-1]
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*lead, b.shape[-1])
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of bf16/fp16 operands on the card with an fp32 result
    (``torch.mm``/``torch.bmm`` with ``out_dtype``, which have no derivative).

    The backward forms each gradient as the widening path does (and JAX's
    transpose of a ``preferred_element_type`` product): the fp32 cotangent
    against the other operand widened to fp32, cast to the operand's dtype.
    """

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.to(torch.float32).transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.to(torch.float32).transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` (``(E, M, K) @ (E, K, N)``) with fp32 accumulation and an
    fp32 result: :func:`matmul_f32` for a batch of products (the MoE experts)."""
    if on_card(a) and a.dtype in (torch.bfloat16, torch.float16) and a.dtype == b.dtype:
        return _MatmulF32.apply(a, b)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def unembed(p, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """fp32 logits ``x @ E^T`` from compute-dtype operands."""
    return matmul_f32(x.to(cdt), p["embed"].to(cdt).t())


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# JAX's ``jax.nn.gelu(x, approximate=True)`` is the tanh approximation
ACTS = {"silu": F.silu, "gelu": _gelu_tanh, "gelu_nogate": _gelu_tanh, "relu": F.relu}


def mlp(p, x: torch.Tensor, cdt: torch.dtype, act: str = "silu") -> torch.Tensor:
    """Gated MLP ``down(act(gate(x)) * up(x))``; ``down(act(up(x)))`` without a gate."""
    up = linear({"w": p["w_up"]}, x, cdt)
    if "w_gate" in p:
        h = ACTS[act](linear({"w": p["w_gate"]}, x, cdt)) * up
    else:
        h = ACTS[act](up)
    return linear({"w": p["w_down"]}, h, cdt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Half-split RoPE.  ``x``: (B, S, H, D); ``positions``: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    ang = positions.to(torch.float32)[..., None] * freqs    # (B, S, D/2)
    if ang.dim() == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """fp32 ``(len(positions), d)`` absolute positions: sin on the even columns,
    cos on the odd, as JAX's ``sinusoidal_pos`` (its rates in fp32)."""
    dev = positions.device
    rate = -torch.log(torch.full((), 10000.0, dtype=torch.float32, device=dev)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=dev) * rate)
    ang = positions.to(torch.float32)[:, None] * div
    pe = torch.zeros((positions.shape[0], d), dtype=torch.float32, device=dev)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def sinusoidal_pos(seq_len: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``(seq_len, d)`` positions ``0 … seq_len - 1`` of :func:`sinusoid_at`."""
    return sinusoid_at(torch.arange(seq_len, device=device), d).to(dtype)

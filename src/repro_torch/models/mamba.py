"""The Mamba2 mixer of the hybrid models (zamba2): a selective SSM whose sequence
mixing runs through the chunked SSD scan.

Port of ``repro/models/mamba.py``.  Parameters keep the JAX layout
(``in_proj`` packs ``[z, x, B, C, dt]`` along its output axis); the compute
dtype ``cdt`` is passed in explicitly.  The full-sequence mixer
(:func:`mamba_full`) runs :func:`~repro_torch.core.ssd.ssd_scan` under
``cfg.scan_method``, or with ``use_kernel=True`` under ``"kernel"`` the
chunk kernel B17 (:func:`~repro_torch.kernels.ssd_chunk.ssd_chunk_scan`,
the forward pass of ``TransformerLM.forward``/``loss``); decode
(:func:`mamba_step`) updates the state with a length-1 ``linear_scan``, which
is one fused step with no kernel launch on every method.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.linrec import linear_scan
from repro_torch.core.ssd import ssd_scan
from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
from repro_torch.models.layers import linear, ninit, rmsnorm

__all__ = ["mamba_init", "mamba_full", "mamba_step"]

F32 = torch.float32


def mamba_init(gen: torch.Generator, cfg, *, n: int, dtype=torch.float32, device=None):
    """Mixer parameters of ``n`` layers, stacked, with the JAX init's shapes and scales."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    lead = (n,)
    kw = dict(dtype=dtype, device=device)

    def const(v):
        return v.to(**kw).expand(*lead, *v.shape).clone()

    return {
        # order along the output axis: [z (d_inner), x (d_inner), B (g*N), C (g*N), dt (H)]
        "in_proj": ninit(gen, (d, 2 * d_inner + 2 * s.n_groups * s.d_state + s.n_heads),
                         n=n, **kw),
        "conv_w": ninit(gen, (s.conv_kernel, conv_dim), n=n, scale=0.5, **kw),
        "conv_b": torch.zeros((*lead, conv_dim), **kw),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, s.n_heads))),
        "dt_bias": torch.zeros((*lead, s.n_heads), **kw),
        "d_skip": torch.ones((*lead, s.n_heads), **kw),
        "gate_norm": {"g": torch.zeros((*lead, d_inner), **kw)},
        "out_proj": ninit(gen, (d_inner, d), n=n, **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, cache=None):
    """Depthwise causal conv as a sum of shifted products, as the JAX code writes it.

    ``x``: (B, S, C); ``w``: (K, C).  Returns ``(y, new_cache)`` with the last
    ``K - 1`` inputs as the cache.  No convolution library (and so no cuDNN
    TF32) runs.
    """
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
           if cache is None else cache.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                               # (B, S+K-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    return y + b, xp[:, -(k - 1):]


def _project(p, x, cfg, cdt):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    gn = s.n_groups * s.d_state
    zxbcdt = linear({"w": p["in_proj"]}, x, cdt)
    return torch.split(zxbcdt, [d_inner, d_inner, gn, gn, s.n_heads], dim=-1)


def _gates(p, dt):
    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))            # (B, S, H)
    return dt, -torch.exp(p["a_log"].to(F32)) * dt                # log decay


def _mix_in(p, x, cfg, cdt, conv_cache=None):
    """Projection, causal conv and gates shared by prefill and decode."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    gn = s.n_groups * s.d_state
    z, xin, bmat, cmat, dt = _project(p, x, cfg, cdt)
    conv_out, conv_cache = _causal_conv(torch.cat([xin, bmat, cmat], dim=-1),
                                        p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                                        cache=conv_cache)
    xin, bmat, cmat = torch.split(F.silu(conv_out), [d_inner, gn, gn], dim=-1)
    dt, a_log = _gates(p, dt)
    return z, xin, bmat, cmat, dt, a_log, conv_cache


def _mix_out(p, y, z, x, cfg, cdt):
    y = rmsnorm(p["gate_norm"], y.to(x.dtype) * F.silu(z), cfg.norm_eps)
    return linear({"w": p["out_proj"]}, y, cdt)


def mamba_full(p, x: torch.Tensor, cfg, *, cdt, return_cache: bool = False,
               use_kernel: bool = False):
    """Full-sequence Mamba2 mixer.  ``x``: (B, S, D).

    With ``use_kernel`` and ``cfg.scan_method == "kernel"`` the SSD runs on the
    chunk kernel B17, which keeps no final state (as in JAX, the prefill path
    never asks for ``return_cache`` there); otherwise on ``ssd_scan``.

    Returns the mixer output, and with ``return_cache`` the decode cache
    ``{"conv": (B, K-1, C), "ssm": (B, H, N, P) fp32}``.
    """
    s = cfg.ssm
    b, seq, _ = x.shape
    z, xin, bmat, cmat, dt, a_log, conv_cache = _mix_in(p, x, cfg, cdt)
    xh = xin.reshape(b, seq, s.n_heads, s.head_dim) * dt[..., None]   # dt folded in
    rep = s.n_heads // s.n_groups
    bm = torch.repeat_interleave(bmat.reshape(b, seq, s.n_groups, s.d_state), rep, dim=2)
    cm = torch.repeat_interleave(cmat.reshape(b, seq, s.n_groups, s.d_state), rep, dim=2)
    if use_kernel and cfg.scan_method == "kernel":
        y = ssd_chunk_scan(xh.to(F32), a_log, bm.to(F32), cm.to(F32), chunk=s.chunk)
        state = None
    else:
        y, state = ssd_scan(xh.to(F32), a_log, bm.to(F32), cm.to(F32), chunk=s.chunk,
                            scan_method=cfg.scan_method, return_final_state=True)
    y = y + xh * p["d_skip"].to(F32)[:, None]
    out = _mix_out(p, y.reshape(b, seq, -1), z, x, cfg, cdt)
    if return_cache:
        return out, {"conv": conv_cache, "ssm": state.to(F32)}
    return out


def mamba_step(p, x: torch.Tensor, cfg, cache, *, cdt):
    """One decode token.  ``x``: (B, 1, D); ``cache``: ``{conv, ssm}``.

    The state update ``h = exp(a)·h + B ⊗ x`` is a length-1 ``linear_scan``
    under ``cfg.scan_method``: one fused step, bit-identical on every method,
    with no kernel launch.  Returns ``(out, new_cache)``.
    """
    s = cfg.ssm
    b = x.shape[0]
    z, xin, bmat, cmat, dt, a_log, conv_cache = _mix_in(p, x, cfg, cdt,
                                                        conv_cache=cache["conv"])
    xh = (xin.reshape(b, 1, s.n_heads, s.head_dim) * dt[..., None])[:, 0]    # (B,H,P)
    rep = s.n_heads // s.n_groups
    bm = torch.repeat_interleave(bmat.reshape(b, s.n_groups, s.d_state), rep, dim=1)
    cm = torch.repeat_interleave(cmat.reshape(b, s.n_groups, s.d_state), rep, dim=1)
    decay = torch.exp(a_log[:, 0])[..., None, None]                          # (B,H,1,1)
    upd = bm.to(F32)[..., :, None] * xh.to(F32)[..., None, :]                # (B,H,N,P)
    h = linear_scan(decay[..., None], upd[..., None], axis=-1, method=cfg.scan_method,
                    initial=cache["ssm"])[..., 0]
    y = torch.einsum("bhn,bhnp->bhp", cm.to(F32), h)
    y = y + xh.to(F32) * p["d_skip"].to(F32)[:, None]
    out = _mix_out(p, y.reshape(b, 1, -1), z, x, cfg, cdt)
    return out, {"conv": conv_cache, "ssm": h}

"""xLSTM blocks: mLSTM (matrix memory) on the chunked matmul scan, and sLSTM.

Port of ``repro/models/xlstm.py``.  The mLSTM cell is a gated linear
recurrence: its full-sequence pass (:func:`mlstm_block`) is
:func:`~repro_torch.core.ssd.mlstm_chunked`, two chunked SSD scans under
``cfg.scan_method`` (the log-decay cumsum on B1, the cross-chunk states on B13
under ``"kernel"``; B2–B4 and B14–B16 under ``"blocked"``).  Its decode step
(:func:`mlstm_block_step`) updates the joint ``(C | n)`` state with a length-1
``linear_scan``, one fused step with no kernel launch on every method.

The sLSTM cell mixes its hidden state through the recurrent weights ``r``
inside the gates, so its recurrence is not associative and no scan, matmul or
kernel, applies to it: :func:`_slstm_scan` steps through time in a plain Python
loop, as the JAX package runs a sequential ``lax.scan``.

Parameters keep the JAX layout, stacked over ``n`` layers; the compute dtype
``cdt`` is passed in explicitly.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.linrec import linear_scan
from repro_torch.core.ssd import MLSTM_EPS, mlstm_chunked
from repro_torch.models.layers import ACTS, linear, ninit, rmsnorm
from repro_torch.models.mamba import _causal_conv

__all__ = ["mlstm_block_init", "mlstm_block", "mlstm_block_step", "slstm_block_init",
           "slstm_state_init", "slstm_block", "slstm_block_step"]

F32 = torch.float32
NEG = -1e30


def _const(v: torch.Tensor, n: int, kw) -> torch.Tensor:
    return v.to(**kw).expand(n, *v.shape).clone()


def _sqrt32(d: int) -> torch.Tensor:
    """``sqrt(d)`` in fp32, the divisor of JAX's ``x / jnp.sqrt(d)``."""
    return torch.tensor(math.sqrt(d), dtype=F32)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg):
    xl = cfg.xlstm
    d_inner = int(xl.proj_factor * cfg.d_model)
    return xl.n_heads, d_inner, d_inner // xl.n_heads


def mlstm_block_init(gen: torch.Generator, cfg, *, n: int, dtype=torch.float32,
                     device=None):
    """mLSTM mixer parameters of ``n`` layers, with the JAX init's shapes and scales."""
    x = cfg.xlstm
    d = cfg.d_model
    h, d_inner, _ = _mlstm_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": ninit(gen, (d, 2 * d_inner), n=n, **kw),          # (x_in, z)
        "conv_w": ninit(gen, (x.conv_kernel, d_inner), n=n, scale=0.5, **kw),
        "conv_b": torch.zeros((n, d_inner), **kw),
        "wq": ninit(gen, (d_inner, d_inner), n=n, **kw),
        "wk": ninit(gen, (d_inner, d_inner), n=n, **kw),
        "wv": ninit(gen, (d_inner, d_inner), n=n, **kw),
        "w_if": ninit(gen, (d_inner, 2 * h), n=n, scale=0.01, **kw),
        "if_bias": _const(torch.cat([torch.zeros(h), torch.linspace(3.0, 6.0, h)]), n, kw),
        "skip": torch.ones((n, d_inner), **kw),
        "out_norm": {"g": torch.zeros((n, d_inner), **kw)},
        "out_proj": ninit(gen, (d_inner, d), n=n, **kw),
    }


def _mlstm_qkvif(p, x, cfg, cdt, conv_cache=None):
    h, _, hd = _mlstm_dims(cfg)
    b, s, _ = x.shape
    xin, z = torch.chunk(linear({"w": p["in_proj"]}, x, cdt), 2, dim=-1)
    conv_out, conv_cache = _causal_conv(xin, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                                        cache=conv_cache)
    xc = F.silu(conv_out)
    q = linear({"w": p["wq"]}, xc, cdt).reshape(b, s, h, hd)
    k = linear({"w": p["wk"]}, xc, cdt).reshape(b, s, h, hd)
    v = linear({"w": p["wv"]}, xin, cdt).reshape(b, s, h, hd)
    gates = linear({"w": p["w_if"]}, xin, cdt).to(F32) + p["if_bias"].to(F32)
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)                      # (B,S,H)
    return q, k, v, i_pre, f_pre, xc, z, conv_cache


def _mlstm_out(p, h, xc, z, x, cfg, cdt):
    h = h.to(x.dtype) + p["skip"].to(x.dtype) * xc
    h = rmsnorm(p["out_norm"], h, cfg.norm_eps)
    return linear({"w": p["out_proj"]}, h * F.silu(z), cdt)


def mlstm_block(p, x: torch.Tensor, cfg, *, cdt, return_cache: bool = False):
    """Full-sequence mLSTM mixer.  ``x``: (B, S, D).

    The cell runs as :func:`~repro_torch.core.ssd.mlstm_chunked` (chunks of 128
    under ``cfg.scan_method``), stabilised by the sequence's global max of the
    input gate.  With ``return_cache`` the decode state ``{conv, c, n, m}`` comes
    from a replay of the prompt under the running max ``m``, one step a token, as
    the JAX package reconstructs it; the replay's state is ``(B, H, hd, hd)`` fp32.
    """
    b, s, _ = x.shape
    h_, d_inner, hd = _mlstm_dims(cfg)
    q, k, v, i_pre, f_pre, xc, z, conv_cache = _mlstm_qkvif(p, x, cfg, cdt)
    hcell = mlstm_chunked(q, k, v, i_pre, f_pre, chunk=128,
                              scan_method=cfg.scan_method)
    out = _mlstm_out(p, hcell.reshape(b, s, d_inner), xc, z, x, cfg, cdt)
    if not return_cache:
        return out
    kf = k.to(F32) / _sqrt32(hd)
    vf = v.to(F32)
    flog = F.logsigmoid(f_pre)
    c = torch.zeros((b, h_, hd, hd), dtype=F32, device=x.device)
    n = torch.zeros((b, h_, hd), dtype=F32, device=x.device)
    m = torch.full((b, h_), NEG, dtype=F32, device=x.device)
    for t in range(s):
        it, ft = i_pre[:, t], flog[:, t]
        m_new = torch.maximum(ft + m, it)
        fs, is_ = torch.exp(ft + m - m_new), torch.exp(it - m_new)
        c = fs[..., None, None] * c + is_[..., None, None] * \
            (kf[:, t][..., :, None] * vf[:, t][..., None, :])
        n = fs[..., None] * n + is_[..., None] * kf[:, t]
        m = m_new
    return out, {"conv": conv_cache, "c": c, "n": n, "m": m}


def mlstm_block_step(p, x: torch.Tensor, cfg, cache, *, cdt):
    """One decode token with the running-max stabilisation.  ``x``: (B, 1, D).

    ``C = f·C + i·k v^T`` and ``n = f·n + i·k`` are one joint length-1 linear
    recurrence over ``(C | n)`` (the normaliser as an extra memory column),
    run by ``linear_scan`` under ``cfg.scan_method`` with ``initial=`` the
    cached state: one fused step, bit-identical on every method, with no kernel
    launch.  Returns ``(out, new_cache)``.
    """
    b = x.shape[0]
    _, d_inner, hd = _mlstm_dims(cfg)
    q, k, v, i_pre, f_pre, xc, z, conv_cache = _mlstm_qkvif(p, x, cfg, cdt,
                                                            conv_cache=cache["conv"])
    qt = q[:, 0].to(F32) / _sqrt32(hd)
    kt = k[:, 0].to(F32) / _sqrt32(hd)
    vt = v[:, 0].to(F32)
    it, ft = i_pre[:, 0], F.logsigmoid(f_pre[:, 0])
    c, n, m = cache["c"], cache["n"], cache["m"]
    m_new = torch.maximum(ft + m, it)
    fs, is_ = torch.exp(ft + m - m_new), torch.exp(it - m_new)
    cn = torch.cat([c, n[..., None]], dim=-1)                         # (B,H,D,P+1)
    upd = torch.cat([is_[..., None, None] * (kt[..., :, None] * vt[..., None, :]),
                     (is_[..., None] * kt)[..., None]], dim=-1)
    cn = linear_scan(fs[..., None, None, None], upd[..., None], axis=-1,
                     method=cfg.scan_method, initial=cn)[..., 0]
    c, n = cn[..., :-1], cn[..., -1]
    num = torch.einsum("bhd,bhdp->bhp", qt, c)
    den = torch.einsum("bhd,bhd->bh", qt, n)
    hcell = (num / (torch.abs(den) + MLSTM_EPS)[..., None]).reshape(b, 1, d_inner)
    out = _mlstm_out(p, hcell, xc, z, x, cfg, cdt)
    return out, {"conv": conv_cache, "c": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM block (sequential: its recurrence is not associative)
# ---------------------------------------------------------------------------


def slstm_block_init(gen: torch.Generator, cfg, *, n: int, dtype=torch.float32,
                     device=None):
    """sLSTM mixer parameters of ``n`` layers, with the JAX init's shapes and scales."""
    x = cfg.xlstm
    d = cfg.d_model
    hd = d // x.n_heads
    d_ff = int(4 * d / 3)
    kw = dict(dtype=dtype, device=device)
    forget = torch.linspace(3.0, 6.0, x.n_heads)[:, None].expand(x.n_heads, hd).reshape(-1)
    return {
        "conv_w": ninit(gen, (x.conv_kernel, d), n=n, scale=0.5, **kw),
        "conv_b": torch.zeros((n, d), **kw),
        "w_in": ninit(gen, (d, 4 * d), n=n, **kw),                   # z, i, f, o inputs
        "r": ninit(gen, (4, x.n_heads, hd, hd), n=n, scale=hd ** -0.5, **kw),
        "gate_bias": _const(torch.cat([torch.zeros(2 * d), forget, torch.zeros(d)]), n, kw),
        "out_norm": {"g": torch.zeros((n, d), **kw)},
        "ff_up": ninit(gen, (d, 2 * d_ff), n=n, **kw),
        "ff_down": ninit(gen, (d_ff, d), n=n, **kw),
    }


def slstm_state_init(b: int, cfg, device=None):
    """The zero state ``(c, n, m, h)``, each ``(B, H, hd)`` fp32 (``m`` at -1e30)."""
    x = cfg.xlstm
    hd = cfg.d_model // x.n_heads
    z = torch.zeros((b, x.n_heads, hd), dtype=F32, device=device)
    return (z, z.clone(), torch.full((b, x.n_heads, hd), NEG, dtype=F32, device=device),
            z.clone())


def _slstm_scan(p, wx: torch.Tensor, cfg, state):
    """``wx``: (B, S, 4d) gate inputs before the bias.  One Python step a token:
    each step's gates read the previous ``h`` through ``r``, so no scan applies."""
    x = cfg.xlstm
    b, s, _ = wx.shape
    hd = cfg.d_model // x.n_heads
    r = p["r"].to(F32)                                                # (4, H, hd, hd)
    pre = (wx.to(F32) + p["gate_bias"].to(F32)).reshape(b, s, 4, x.n_heads, hd)
    c, n, m, h = state
    ys = []
    for t in range(s):
        g = pre[:, t] + torch.einsum("bhd,ghde->bghe", h, r)         # recurrent mixing
        zt = torch.tanh(g[:, 0])
        it = g[:, 1]                                                  # log-space input gate
        ft = F.logsigmoid(g[:, 2])                                    # log forget gate
        ot = torch.sigmoid(g[:, 3])
        m_new = torch.maximum(ft + m, it)
        ci, cf = torch.exp(it - m_new), torch.exp(ft + m - m_new)
        c = cf * c + ci * zt
        n = cf * n + ci
        h = ot * c / (n + 1e-6)
        m = m_new
        ys.append(h)
    return torch.stack(ys, dim=1), (c, n, m, h)


def slstm_block(p, x: torch.Tensor, cfg, *, cdt, state=None, return_cache: bool = False):
    """The sLSTM mixer over ``x`` (B, S, D), from ``state`` (``{conv, rec}``) or zero.

    The z and o gates see the raw input and the i and f gates the causal conv
    path (the xLSTM convention); a tanh-gelu feed-forward follows the cell.
    Returns the output, and with ``return_cache`` the state ``{conv, rec}``.
    """
    b, s, d = x.shape
    conv_cache = None if state is None else state["conv"]
    st = slstm_state_init(b, cfg, x.device) if state is None else state["rec"]
    conv_out, conv_cache = _causal_conv(x, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                                        cache=conv_cache)
    xc = F.silu(conv_out)
    wx = linear({"w": p["w_in"]}, x, cdt)
    wc = linear({"w": p["w_in"]}, xc, cdt)
    wmix = torch.cat([wx[..., :d], wc[..., d:3 * d], wx[..., 3 * d:]], dim=-1)
    ys, st = _slstm_scan(p, wmix, cfg, st)
    h = rmsnorm(p["out_norm"], ys.reshape(b, s, d).to(x.dtype), cfg.norm_eps)
    up, gate = torch.chunk(linear({"w": p["ff_up"]}, h, cdt), 2, dim=-1)
    out = linear({"w": p["ff_down"]}, up * ACTS["gelu"](gate), cdt)
    if return_cache:
        return out, {"conv": conv_cache, "rec": st}
    return out


def slstm_block_step(p, x: torch.Tensor, cfg, cache, *, cdt):
    """One decode token: :func:`slstm_block` from the cached state."""
    return slstm_block(p, x, cfg, cdt=cdt, state=cache, return_cache=True)

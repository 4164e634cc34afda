"""Mixture-of-Experts layer with scan-based token dispatch.

Port of ``repro/models/moe.py``.  The dispatch offsets (the position in its
expert of every token/expert assignment) are an **exclusive prefix sum over
int8 one-hot masks**: the paper's int8→int32 mask scan (§4.3 / Fig. 9).  They
run through the port's ``segment_scan`` (one packed segmented scan: B9 on
``"kernel"``, B10–B12 on ``"blocked"``) or its batched ``scan`` (B1, B2–B4),
under the config's ``scan_method``, and nothing else computes them.

Routing is a top-k over the router's softmax, with ``jax.lax.top_k``'s order
on ties (the lower expert index first): a stable descending sort, of which
the first ``top_k`` columns are kept.  The expert products (``gecd,edf->gecf``)
are plain batched products, which JAX too computes outside any Pallas kernel;
they accumulate in fp32 as its ``preferred_element_type=float32`` does.

Without a device mesh there is one dispatch group (JAX's ``_dp_groups`` is 1).
The explicit expert-parallel path (``moe_apply_ep``, ``_ep_shard_map_available``)
and data-parallel dispatch groups need a device mesh; they come with the
launch side of training (ROADMAP Queue A item 11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scan import scan
from repro_torch.core.segmented import segment_scan
from repro_torch.models.layers import ACTS, bmm_f32, linear, ninit

__all__ = ["moe_init", "moe_apply", "route", "top_k", "capacity_of", "dispatch",
           "dispatch_positions", "load_balance_loss", "DISPATCH_MODES"]

F32 = torch.float32
DISPATCH_MODES = ("auto", "segmented", "grouped")


def moe_init(gen, cfg, *, n, dtype, device):
    """MoE weights stacked over ``n`` layers, in the JAX tree and layout.

    ``experts`` leaves are ``(E, d, f)`` / ``(E, f, d)``; their init scale is
    ``E ** -0.5``, since JAX's ``ninit`` takes ``fan_in = shape[0]``.
    """
    m, d = cfg.moe, cfg.d_model
    f, e = m.d_ff_expert, m.n_experts
    kw = dict(n=n, dtype=dtype, device=device)
    p = {"router": {"w": ninit(gen, (d, e), scale=d ** -0.5, **kw)},
         "experts": {"w_gate": ninit(gen, (e, d, f), **kw),
                     "w_up": ninit(gen, (e, d, f), **kw),
                     "w_down": ninit(gen, (e, f, d), **kw)}}
    if m.n_shared:
        fs = m.n_shared * f
        p["shared"] = {"w_gate": ninit(gen, (d, fs), **kw),
                       "w_up": ninit(gen, (d, fs), **kw),
                       "w_down": ninit(gen, (fs, d), **kw)}
    return p


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: values and indices, largest first,
    the lower index first among equal values (``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch_positions(eidx: torch.Tensor, n_experts: int, *, scan_method: str,
                       mode: str) -> torch.Tensor:
    """Position in its expert of every (group, assignment): the paper's mask scan.

    ``eidx``: (G, Tg*K) integer expert ids.  ``"grouped"`` builds the
    (G, Tg*K, E) one-hot and runs a batched exclusive int8 scan along axis 1
    (one B1 launch on ``"kernel"``); ``"segmented"`` flattens every assignment
    into one (E, G*Tg*K) one-hot and runs one exclusive segmented scan with the
    group boundaries as CSR offsets (one B9 launch on ``"kernel"``).  Both are
    exact int8→int32 mask scans, so they agree bit for bit.

    Returns (G, Tg*K) int32 positions.
    """
    g, tgk = eidx.shape
    eidx = eidx.to(torch.int64)
    experts = torch.arange(n_experts, device=eidx.device)
    if mode == "grouped":
        onehot8 = (eidx[..., None] == experts).to(torch.int8)        # (G, Tg*K, E)
        pos_all = scan(onehot8, axis=1, exclusive=True, method=scan_method)
        return torch.gather(pos_all, 2, eidx[..., None])[..., 0]
    if mode != "segmented":
        raise ValueError(f"dispatch_positions: unknown mode {mode!r}; expected "
                         "'segmented' or 'grouped'")
    flat = eidx.reshape(g * tgk)
    oh8 = (flat[None, :] == experts[:, None]).to(torch.int8)          # (E, G*Tg*K)
    offsets = torch.arange(g + 1, dtype=torch.int32, device=eidx.device) * tgk
    pos_all = segment_scan(oh8, offsets, exclusive=True, method=scan_method)
    return torch.gather(pos_all, 0, flat[None, :])[0].reshape(g, tgk)


def _expert_ffn(ex_in: torch.Tensor, w: dict, act: str) -> torch.Tensor:
    """Every expert's gated FFN on its ``(E, C, d)`` buffer, products in fp32."""
    dt = ex_in.dtype
    hg = ACTS[act](bmm_f32(ex_in, w["w_gate"].to(dt))).to(dt)
    hu = bmm_f32(ex_in, w["w_up"].to(dt)).to(dt)
    return bmm_f32(hg * hu, w["w_down"].to(dt)).to(dt)


def route(p, xt: torch.Tensor, cfg, *, cdt: torch.dtype):
    """Router softmax and top-k of ``xt`` (T, D): ``(probs (T, E), gate_vals (T, K),
    expert_idx (T, K))``, the gates normalised to sum 1 (``clip(sum, 1e-9)``)."""
    probs = torch.softmax(linear({"w": p["router"]["w"]}, xt, cdt).to(F32), dim=-1)
    gate_vals, expert_idx = top_k(probs, cfg.moe.top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def capacity_of(t: int, cfg, *, no_drop: bool = False) -> int:
    """Slots an expert: JAX's ``max(int(T·K·cf / E), K)`` in Python float
    arithmetic, or ``T`` with ``no_drop`` (decode)."""
    m = cfg.moe
    return t if no_drop else max(int(t * m.top_k * m.capacity_factor / m.n_experts),
                                 m.top_k)


def dispatch(expert_idx: torch.Tensor, capacity: int, cfg, *, scan_method: str,
             dispatch_mode: str = "auto"):
    """``(position, keep, dest)`` of the ``T·K`` assignments, flattened token-major:
    each one's position in its expert (the mask scan), whether it fits the
    capacity, and its row of the ``(E·capacity + 1, D)`` buffer (the last row,
    the sentinel, for the dropped ones)."""
    if dispatch_mode not in DISPATCH_MODES:
        raise ValueError(f"moe_apply: unknown dispatch_mode {dispatch_mode!r}; "
                         f"expected one of {DISPATCH_MODES}")
    e = cfg.moe.n_experts
    flat = expert_idx.reshape(-1)
    mode = "segmented" if dispatch_mode == "auto" else dispatch_mode
    position = dispatch_positions(flat[None, :], e, scan_method=scan_method, mode=mode)[0]
    keep = position < capacity
    dest = torch.where(keep, flat * capacity + position, e * capacity)
    return position, keep, dest


def moe_apply(p, x: torch.Tensor, cfg, *, cdt: torch.dtype, scan_method=None,
              no_drop: bool = False, dispatch_mode: str = "auto"):
    """``x``: (B, S, D) -> ``(y (B, S, D), aux)``: capacity dispatch with scan offsets.

    Capacity is :func:`capacity_of`; assignments whose position reaches it go
    to the sentinel row, which is dropped.  ``dispatch_mode``: ``"segmented"``,
    ``"grouped"``, or ``"auto"`` (segmented, on the one dispatch group).
    ``aux`` is the Switch-style load-balancing loss.
    """
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, expert_idx = route(p, xt, cfg, cdt=cdt)
    capacity = capacity_of(t, cfg, no_drop=no_drop)
    _, _, dest = dispatch(expert_idx, capacity, cfg,
                          scan_method=scan_method or cfg.scan_method,
                          dispatch_mode=dispatch_mode)
    sentinel = e * capacity
    buf = torch.zeros((sentinel + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt.repeat_interleave(k, dim=0)     # dropped ones all land on the sentinel
    ex_out = _expert_ffn(buf[:-1].reshape(e, capacity, d), p["experts"], cfg.act)
    flat_out = torch.cat([ex_out.reshape(sentinel, d),
                          torch.zeros((1, d), dtype=xt.dtype, device=xt.device)])
    weighted = flat_out[dest].to(F32) * gate_vals.reshape(t * k)[:, None]
    y = weighted.reshape(t, k, d).sum(dim=1)

    if m.n_shared:
        sh = p["shared"]
        hg = ACTS[cfg.act](linear({"w": sh["w_gate"]}, xt, cdt))
        hu = linear({"w": sh["w_up"]}, xt, cdt)
        y = y + linear({"w": sh["w_down"]}, hg * hu, cdt).to(F32)

    aux = load_balance_loss(probs, expert_idx, e)
    return y.reshape(b, s, d).to(x.dtype), aux


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: ``E · Σ_e frac_tokens(e) · frac_probs(e)``,
    the tokens counted by their first choice."""
    onehot = F.one_hot(expert_idx[:, 0], n_experts).to(F32)
    return n_experts * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))

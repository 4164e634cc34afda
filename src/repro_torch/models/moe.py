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

Under a grid (``utils.sharding.use_mesh``) each rank holds its own tokens:
its rows of the batch, the tokens of one of JAX's data-parallel dispatch
groups.  With a ``"model"`` axis of more than one rank the layer takes JAX's
explicit expert-parallel path (:func:`moe_apply_ep`): every rank of the model
group routes its tokens, runs the paper's mask scan on them (``scan`` along
the assignments: B1 on ``"kernel"``, B2–B4 on ``"blocked"``), scatters them
locally, runs its ``E/ep`` experts and joins the parts with one all-reduce of
``(T_local, D)`` in the activation dtype (``comm.psum``, whose gradient is
the identity; the tokens and gate values enter through ``comm.pbroadcast``,
whose gradient sums the parts' cotangents, as JAX's ``shard_map`` transposes).
Without it, a data axis of more than one rank makes ``dispatch_mode="auto"``
take ``"grouped"`` as JAX does (``_dp_groups``).  In a training pass
(``global_aux``) the load-balancing loss is made global over the data group:
the first-choice fractions are all-reduced (no gradient) and the router's
mean probabilities stay local, so the data group's mean of the ranks' losses
is JAX's loss on the whole batch, in value and in gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.core.scan import scan
from repro_torch.core.segmented import segment_scan
from repro_torch.models.layers import ACTS, bmm_f32, linear, ninit
from repro_torch.utils import sharding

__all__ = ["moe_init", "moe_apply", "moe_apply_ep", "route", "top_k", "capacity_of",
           "dispatch", "dispatch_positions", "load_balance_loss", "expert_blocks",
           "DISPATCH_MODES"]

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


def _ep_shard_map_available(t: int):
    """``(grid, dp_axes, ep)`` when the expert-parallel path applies: an active
    grid whose ``"model"`` axis holds more than one rank.  (JAX also needs the
    global token count to divide over the data axes; here ``t`` is already
    this rank's share.)"""
    mesh = sharding.current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return None
    ep = mesh.shape["model"]
    if ep <= 1:
        return None
    return mesh, sharding.dp_axes(mesh) or (), ep


def _dp_groups() -> int:
    """JAX's number of data-parallel dispatch groups: the active grid's ranks
    over its batch axes (1 without a grid).  This rank holds one group's tokens."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return 1
    return mesh.size_of(sharding.dp_axes(mesh))


def dispatch(expert_idx: torch.Tensor, capacity: int, cfg, *, scan_method: str,
             dispatch_mode: str = "auto"):
    """``(position, keep, dest)`` of the ``T·K`` assignments, flattened token-major:
    each one's position in its expert (the mask scan), whether it fits the
    capacity, and its row of the ``(E·capacity + 1, D)`` buffer (the last row,
    the sentinel, for the dropped ones).  ``"auto"`` is ``"segmented"`` on one
    dispatch group and ``"grouped"`` under a grid with a data axis of more
    than one rank (JAX's choice; the positions are the same bits either way)."""
    if dispatch_mode not in DISPATCH_MODES:
        raise ValueError(f"moe_apply: unknown dispatch_mode {dispatch_mode!r}; "
                         f"expected one of {DISPATCH_MODES}")
    e = cfg.moe.n_experts
    flat = expert_idx.reshape(-1)
    mode = dispatch_mode
    if mode == "auto":
        mode = "segmented" if _dp_groups() == 1 else "grouped"
    position = dispatch_positions(flat[None, :], e, scan_method=scan_method, mode=mode)[0]
    keep = position < capacity
    dest = torch.where(keep, flat * capacity + position, e * capacity)
    return position, keep, dest


def moe_apply_ep(p, xt: torch.Tensor, cfg, gate_vals: torch.Tensor,
                 expert_idx: torch.Tensor, *, mesh, scan_method: str,
                 no_drop: bool = False) -> torch.Tensor:
    """JAX's explicit expert-parallel MoE, on this rank's tokens ``xt`` (T, D).

    Every rank of the grid's model group holds the same tokens: each routes
    them (done by the caller), runs the paper's exclusive int8 mask scan over
    the ``(T·K, E)`` one-hot along the assignments (``scan(axis=0)``), scatters
    them into the ``(E·C + 1, D)`` buffer, runs its own ``E/ep`` experts (rank
    ``j`` of the model group holds experts ``[j·E/ep, (j+1)·E/ep)``; the
    ``experts`` leaves may be that block or all ``E``), weights its part by the
    gate values (``gate_vals`` in the activation dtype, as JAX casts them) and
    joins the parts with one all-reduce of ``(T, D)`` in the activation dtype
    (``comm.psum``).  ``xt`` and ``gate_vals`` enter through
    ``comm.pbroadcast``, so their gradients hold every rank's part.
    Capacity is :func:`capacity_of` of this rank's ``T``, JAX's group-local
    capacity.  Returns the ``(T, D)`` sum in the activation dtype.
    """
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    t, d = xt.shape
    ep = mesh.shape["model"]
    if e % ep:
        raise ValueError(f"moe_apply_ep: {e} experts do not divide over {ep} ranks")
    e_per, ej = e // ep, mesh.coord["model"]
    group = mesh.group("model")
    xl = comm.pbroadcast(xt, group)
    gv = comm.pbroadcast(gate_vals, group)
    capacity = capacity_of(t, cfg, no_drop=no_drop)
    flat_e = expert_idx.reshape(-1).to(torch.int64)
    onehot8 = (flat_e[:, None] == torch.arange(e, device=xt.device)).to(torch.int8)
    pos_all = scan(onehot8, axis=0, exclusive=True, method=scan_method)
    position = torch.gather(pos_all, 1, flat_e[:, None])[:, 0]
    keep = position < capacity
    sentinel = e * capacity
    dest = torch.where(keep, flat_e * capacity + position, sentinel)
    buf = torch.zeros((sentinel + 1, d), dtype=xl.dtype, device=xl.device)
    buf[dest] = xl.repeat_interleave(k, dim=0)
    mine = buf[:-1].reshape(e, capacity, d)[ej * e_per:(ej + 1) * e_per]
    w = {name: (v[ej * e_per:(ej + 1) * e_per] if v.shape[0] == e else v)
         for name, v in p["experts"].items()}
    out = _expert_ffn(mine, w, cfg.act)                                 # (E/ep, C, D)
    flat_out = torch.cat([out.reshape(e_per * capacity, d),
                          torch.zeros((1, d), dtype=xl.dtype, device=xl.device)])
    local_e = flat_e - ej * e_per
    is_mine = keep & (local_e >= 0) & (local_e < e_per)
    idx = torch.where(is_mine, local_e * capacity + position, e_per * capacity)
    weighted = flat_out[idx].to(F32) * gv.reshape(-1)[:, None]
    y_part = weighted.reshape(t, k, d).sum(dim=1).to(xl.dtype)
    return comm.psum(y_part, group)


def moe_apply(p, x: torch.Tensor, cfg, *, cdt: torch.dtype, scan_method=None,
              no_drop: bool = False, dispatch_mode: str = "auto",
              global_aux: bool = True):
    """``x``: (B, S, D) -> ``(y (B, S, D), aux)``: capacity dispatch with scan offsets.

    Capacity is :func:`capacity_of`; assignments whose position reaches it go
    to the sentinel row, which is dropped.  ``dispatch_mode``: ``"segmented"``,
    ``"grouped"``, or ``"auto"`` (see :func:`dispatch`).  ``aux`` is the
    Switch-style load-balancing loss.  Under a grid with a ``"model"`` axis
    of more than one rank the experts run expert-parallel
    (:func:`moe_apply_ep`); with a data axis of more than one rank and
    ``global_aux``, ``aux`` is this rank's share of the whole batch's loss
    (:func:`load_balance_loss`).
    """
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, expert_idx = route(p, xt, cfg, cdt=cdt)
    mesh = sharding.current_mesh()
    data_group = None
    if global_aux and mesh is not None and _dp_groups() > 1:
        data_group = mesh.group(sharding.dp_axes(mesh))
    ep_ctx = _ep_shard_map_available(t)
    if ep_ctx is not None and e % ep_ctx[2] == 0:
        y = moe_apply_ep(p, xt, cfg, gate_vals.to(xt.dtype), expert_idx, mesh=ep_ctx[0],
                         scan_method=scan_method or cfg.scan_method,
                         no_drop=no_drop).to(F32)
    else:
        capacity = capacity_of(t, cfg, no_drop=no_drop)
        _, _, dest = dispatch(expert_idx, capacity, cfg,
                              scan_method=scan_method or cfg.scan_method,
                              dispatch_mode=dispatch_mode)
        sentinel = e * capacity
        buf = torch.zeros((sentinel + 1, d), dtype=xt.dtype, device=xt.device)
        buf[dest] = xt.repeat_interleave(k, dim=0)  # dropped ones all land on the sentinel
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

    aux = load_balance_loss(probs, expert_idx, e, group=data_group)
    return y.reshape(b, s, d).to(x.dtype), aux


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                      n_experts: int, *, group=None) -> torch.Tensor:
    """Switch-style auxiliary loss: ``E · Σ_e frac_tokens(e) · frac_probs(e)``,
    the tokens counted by their first choice.

    With ``group`` (a data group whose ranks hold equal shares of the batch)
    ``frac_tokens`` is the whole batch's (one counted ``all_reduce`` of ``E``
    fp32 values, no gradient) and ``frac_probs`` this rank's: the group's mean
    of the results is the whole batch's loss, and so is the mean of their
    gradients.
    """
    onehot = F.one_hot(expert_idx[:, 0], n_experts).to(F32)
    frac_tokens = onehot.mean(dim=0)
    if group is not None and comm.axis_size(group) > 1:
        frac_tokens = comm.all_reduce(frac_tokens, "sum", group) / comm.axis_size(group)
    return n_experts * torch.sum(frac_tokens * probs.mean(dim=0))


def expert_blocks(params, mesh, n_experts: int):
    """``params`` with every MoE ``experts`` leaf that holds all ``n_experts``
    cut to this rank's block over ``mesh``'s ``"model"`` axis
    (:func:`moe_apply_ep`'s weights), every other leaf as it is.  The serving
    engines hold the experts so.  Where the experts do not divide over the
    axis, the layer runs them whole (as JAX does) and nothing is cut."""
    ep = mesh.shape.get("model", 1)
    if ep <= 1 or n_experts % ep:
        return params
    places = sharding.param_shardings(mesh, params)

    def walk(tree, pl, in_experts):
        if isinstance(tree, dict):
            return {k: walk(v, pl[k], in_experts or k == "experts") for k, v in tree.items()}
        entries = pl.entries()
        if not in_experts or "model" not in entries:
            return tree
        if tree.shape[entries.index("model")] != n_experts:
            return tree                                     # already this rank's block
        return sharding.cut(tree, pl).clone()               # the whole leaf can be freed
    return walk(params, places, False)

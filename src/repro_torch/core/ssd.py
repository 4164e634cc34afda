"""Chunked gated-linear-recurrence scan ("SSD") on the matmul scan.

Port of ``ssd_scan`` and ``ssd_scan_ref`` of ``repro/core/ssd.py``.  The
recurrence

    h_t = exp(a_t) * h_{t-1} + B_t ⊗ x_t          h: (H, N, P)
    y_t = C_t^T h_t                               y: (H, P)

runs chunk by chunk (``chunk`` = Q tokens):

* the log-decay cumsum ``cs`` of each chunk is a prefix scan
  (:func:`~repro_torch.core.scan.scan`: B1 on ``"kernel"``, B2–B4 on
  ``"blocked"``);
* within a chunk, ``Y_d = (C B^T ∘ L) X`` with ``L[i, j] = exp(cs_i - cs_j)``;
* the chunk states ``S_c = (B ∘ decay-to-end)^T X``;
* across chunks, the length-``S/Q`` recurrence ``S_c = d_c * S_{c-1} + s_c``
  runs through :func:`~repro_torch.core.linrec.linear_scan` under
  ``scan_method`` (B13 on ``"kernel"``, B14–B16 on ``"blocked"``), with the
  decay ``d_c`` shared by the ``(N, P)`` state;
* the off-diagonal term ``Y_o = (C ∘ decay-from-start) H_in``.

The dense within-chunk products contract in fp32; on the card they refuse to
run while TF32 is allowed (``require_ieee_fp32``).  ``precision`` rides into
the two scan-shaped phases, the log-decay cumsum and the cross-chunk
``linear_scan``, which resolve it against ``scan_method`` as their direct
callers would; B17 takes none, as in JAX.

The mLSTM cell of xLSTM (:func:`mlstm_chunked`) is two such scans, its
numerator and its normaliser, with :func:`mlstm_ref` as its sequential
oracle.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.linrec import linear_scan
from repro_torch.core.precision import require_ieee_fp32
from repro_torch.core.scan import scan as mm_scan

__all__ = ["ssd_scan", "ssd_scan_ref", "mlstm_chunked", "mlstm_ref"]

F32 = torch.float32


def _chunk(x: torch.Tensor, q: int) -> torch.Tensor:
    """``(B, S, ...)`` -> ``(B, S/Q, Q, ...)``."""
    return x.reshape(x.shape[0], x.shape[1] // q, q, *x.shape[2:])


def ssd_scan(x: torch.Tensor, a_log: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, *, chunk: int = 128, scan_method: str = "auto",
             precision: str = "highest", initial_state: Optional[torch.Tensor] = None,
             return_final_state: bool = False):
    """Chunked SSD scan.

    Args:
        x: ``(B, S, H, P)`` inputs.
        a_log: ``(B, S, H)`` log decays (``<= 0`` for stability).
        b_mat, c_mat: ``(B, S, H, N)`` input and output projections.
        chunk: Tokens per chunk; a ragged last chunk is zero-padded (decay 1,
            no input), which leaves the state unchanged.
        scan_method: Method of the two scans: the log-decay cumsum and the
            cross-chunk ``linear_scan``.
        precision: ``"highest"``, ``"compensated"`` or ``"fast"``, for the
            two scans (each resolves it against ``scan_method``); the
            within-chunk einsums always contract in fp32.
        initial_state: Optional ``(B, H, N, P)`` state entering the sequence.
        return_final_state: Also return the ``(B, H, N, P)`` fp32 state after
            the last token.

    Returns:
        ``y`` of ``(B, S, H, P)`` in ``x``'s dtype, and the final state if asked.

    Example:
        >>> x, b, c = torch.ones(1, 4, 1, 1), torch.ones(1, 4, 1, 1), torch.ones(1, 4, 1, 1)
        >>> ssd_scan(x, torch.zeros(1, 4, 1), b, c, chunk=2, scan_method="matmul").flatten().tolist()
        [1.0, 2.0, 3.0, 4.0]
    """
    if x.is_cuda:
        require_ieee_fp32()
    bsz, s, h, p = x.shape
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    xc = _chunk(x, q).to(F32)                                    # (B,nc,Q,H,P)
    ac = torch.movedim(_chunk(a_log, q), 3, 2)                    # (B,nc,H,Q)
    bc = _chunk(b_mat, q).to(F32)                                 # (B,nc,Q,H,N)
    cc = _chunk(c_mat, q).to(F32)

    # the cumsum of the log decays, with the matmul scan
    cs = mm_scan(ac.to(F32), axis=-1, method=scan_method, precision=precision)

    # within-chunk decays L[i, j] = exp(cs_i - cs_j) for i >= j; masked before
    # the exp, since for i < j the difference is positive and can overflow
    li = cs[..., :, None] - cs[..., None, :]                      # (B,nc,H,Q,Q)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lmat = torch.exp(torch.where(causal, li, torch.full((), -1e30, device=x.device)))
    scores = torch.einsum("bnqhd,bnkhd->bnhqk", cc, bc)            # C_i · B_j
    y_diag = torch.einsum("bnhqk,bnkhp->bnqhp", scores * lmat, xc)

    # chunk states S_c = Σ_j exp(cs_last - cs_j) B_j ⊗ x_j
    decay_to_end = torch.exp(cs[..., -1:] - cs)                   # (B,nc,H,Q)
    s_c = torch.einsum("bnqhd,bnqhp->bnhdp",
                       bc * torch.movedim(decay_to_end, 3, 2)[..., None], xc)

    # across chunks: S_c = d_c * S_{c-1} + s_c, the initial state folded in
    d_c = torch.exp(cs[..., -1])                                  # (B,nc,H)
    init = initial_state.to(F32) if initial_state is not None else None
    nc = d_c.shape[1]
    s_inc = linear_scan(d_c[..., None, None], s_c, axis=1, method=scan_method,
                        initial=init, tile_s=min(128, max(2, nc)), precision=precision)
    # the state entering chunk c is the inclusive state after chunk c-1
    h0 = init[:, None] if init is not None else torch.zeros_like(s_inc[:, :1])
    h_in = torch.cat([h0.expand(s_inc[:, :1].shape), s_inc[:, :-1]], dim=1)

    y_off = torch.einsum("bnqhd,bnhdp->bnqhp",
                         cc * torch.movedim(torch.exp(cs), 3, 2)[..., None], h_in)
    y = (y_diag + y_off).reshape(bsz, s + pad, h, p)[:, :s]
    if return_final_state:
        return y.to(x.dtype), s_inc[:, -1]
    return y.to(x.dtype)


def ssd_scan_ref(x: torch.Tensor, a_log: torch.Tensor, b_mat: torch.Tensor,
                 c_mat: torch.Tensor, *, initial_state: Optional[torch.Tensor] = None,
                 return_final_state: bool = False):
    """Sequential oracle of :func:`ssd_scan`: one step per token.

    It runs in fp32, as the JAX oracle does, or in fp64 when ``x`` is fp64.
    """
    dt = torch.promote_types(x.dtype, F32)
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    hs = (torch.zeros((bsz, h, n, p), dtype=dt, device=x.device) if initial_state is None
          else initial_state.to(dt))
    xs, al, bm, cm = (t.to(dt) for t in (x, a_log, b_mat, c_mat))
    ys = []
    for t in range(s):
        hs = torch.exp(al[:, t])[..., None, None] * hs + \
            bm[:, t][..., :, None] * xs[:, t][..., None, :]
        ys.append(torch.einsum("bhd,bhdp->bhp", cm[:, t], hs))
    y = (torch.stack(ys, dim=1) if ys else torch.zeros((bsz, 0, h, p), dtype=dt,
                                                       device=x.device)).to(x.dtype)
    if return_final_state:
        return y, hs
    return y


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory cell) on the same chunked scan
# ---------------------------------------------------------------------------
#
# Cell:  C_t = f_t C_{t-1} + i_t k_t v_t^T ;  n_t = f_t n_{t-1} + i_t k_t
#        h_t = (C_t^T q_t) / (|n_t^T q_t| + eps)
# with f_t = sigmoid(f_pre), i_t = exp(i_pre).  Both C and n are scaled by
# exp(-M), M = max(i_pre) over the sequence for each (batch, head), which cancels
# in the division; the stepwise decode shifts by the running max instead.  The
# denominator is ``|den| + MLSTM_EPS``, a documented deviation from xLSTM's
# ``max(|den|, 1)`` floor, kept from the JAX package.  The shift cancels exactly
# only without the epsilon: where ``|den|`` is small, the two stabilisations
# (and the chunked pass over a longer sequence, whose max may come later) differ
# by the epsilon's share of it.

MLSTM_EPS = 1e-6


def _mlstm_gates(q, i_pre, f_pre, dt):
    """The log forget gate, the stabilised input gain and the scaled queries."""
    f_log = F.logsigmoid(f_pre.to(dt))
    i = i_pre.to(dt)
    gain = torch.exp(i - torch.amax(i, dim=1, keepdim=True))          # (B,S,H)
    qs = q.to(dt) / torch.tensor(math.sqrt(q.shape[-1]), dtype=dt)
    return f_log, gain, qs


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  i_pre: torch.Tensor, f_pre: torch.Tensor, *, chunk: int = 128,
                  scan_method: str = "auto", precision: str = "highest") -> torch.Tensor:
    """The mLSTM cell over a whole sequence as two chunked SSD scans.

    Args:
        q, k, v: ``(B, S, H, D)`` queries, keys and values.
        i_pre, f_pre: ``(B, S, H)`` input and forget gate pre-activations.
        chunk: Tokens per chunk of the two scans (a ragged last chunk is padded).
        scan_method: Method of both scans (B1 + B13 on ``"kernel"``, B2–B4 +
            B14–B16 on ``"blocked"``).
        precision: Passed to both scans, as ``ssd_scan`` takes it.

    Returns:
        ``h`` of ``(B, S, H, D)`` in ``q``'s dtype.  The numerator is the SSD
        scan with ``x = gain·v``, ``B = k``, ``C = q/sqrt(D)``; the normaliser the
        same recurrence with ``x = gain`` (``P = 1``).
    """
    f_log, gain, qs = _mlstm_gates(q, i_pre, f_pre, F32)
    kf = k.to(F32)
    num = ssd_scan(v.to(F32) * gain[..., None], f_log, kf, qs, chunk=chunk,
                   scan_method=scan_method, precision=precision)
    den = ssd_scan(gain[..., None], f_log, kf, qs, chunk=chunk,
                   scan_method=scan_method, precision=precision)[..., 0]
    return (num / (torch.abs(den) + MLSTM_EPS)[..., None]).to(q.dtype)


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """Sequential oracle of :func:`mlstm_chunked` with the same global-max
    stabilisation: one step per token, in fp32, or in fp64 when ``q`` is fp64."""
    dt = torch.promote_types(q.dtype, F32)
    bsz, s, h, d = q.shape
    f_log, gain, qs = _mlstm_gates(q, i_pre, f_pre, dt)
    kf, vf = k.to(dt), v.to(dt)
    c = torch.zeros((bsz, h, d, v.shape[-1]), dtype=dt, device=q.device)
    n = torch.zeros((bsz, h, d), dtype=dt, device=q.device)
    ys = []
    for t in range(s):
        fg = torch.exp(f_log[:, t])                                     # (B,H)
        c = fg[..., None, None] * c + kf[:, t][..., :, None] * \
            (vf[:, t] * gain[:, t][..., None])[..., None, :]
        n = fg[..., None] * n + kf[:, t] * gain[:, t][..., None]
        den = torch.einsum("bhd,bhd->bh", n, qs[:, t])
        num = torch.einsum("bhd,bhdp->bhp", qs[:, t], c)
        ys.append(num / (torch.abs(den) + MLSTM_EPS)[..., None])
    return torch.stack(ys, dim=1).to(q.dtype)

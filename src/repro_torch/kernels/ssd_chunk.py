"""B17: the chunked SSD scan, the sequence mixing of a Mamba2 layer.

Port of ``repro/kernels/ssd_chunk.py``.  For each (batch, head) the sequence
runs in chunks of ``Q`` tokens with an ``(N, P)`` fp32 state carried across
them in order:

    cs      = a @ U_Q                      (cumsum of the log decays)
    scores  = (C B^T) ∘ exp(cs_i - cs_j)   masked causal
    y       = scores X + (C ∘ exp(cs)) state
    state   = exp(cs_Q) state + (B ∘ exp(cs_Q - cs))^T X

:func:`ssd_chunk_scan` launches ``csrc/ssd_chunk.cu`` on CUDA tensors (one
CTA per (batch, head) walking its chunks, the inputs read through their
strides) and runs :func:`ssd_chunk_plain` on CPU tensors.  Neither has a
gradient: the JAX package cannot differentiate the Pallas kernel either, so
B17 serves the forward pass and the loss of a ``scan_method="kernel"``
hybrid model.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import guards
from repro_torch.core.precision import require_ieee_fp32
from repro_torch.core.scan import upper_ones
from repro_torch.kernels import _build

__all__ = ["ssd_chunk_scan", "ssd_chunk_plain", "ssd_smem_bytes", "SSD_SMEM_LIMIT"]

F32 = torch.float32
# shared memory one CTA may use on the card (227 KB)
SSD_SMEM_LIMIT = 232448


def ssd_smem_bytes(q: int, n: int, p: int) -> int:
    """Shared memory of one CTA of ``csrc/ssd_chunk.cu`` for chunk ``q``, state ``n`` and
    head width ``p``: the fp64 cumsum, then in fp32 the chunk's X, B and C, its
    ``q × q`` score tile and the state, each row padded to a multiple of 4 plus 4
    floats, and two ``q``-long vectors."""
    qp, np_, pp = (-(-v // 4) * 4 for v in (q, n, p))
    return 8 * qp + 4 * (qp * ((pp + 4) + 2 * (np_ + 4) + (qp + 4)) + np_ * (pp + 4)
                         + 2 * qp)


def ssd_chunk_plain(x: torch.Tensor, a_log: torch.Tensor, b_mat: torch.Tensor,
                    c_mat: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Plain version of the chunk kernel, with the Pallas kernel's algebra.

    fp32 ``(B, S, H, ·)`` operands; ``S`` is zero-padded to whole chunks and the
    head axis moved next to the batch, then the chunks run in order, every
    ``(B·H)`` slice at once: ``cs`` as the product with ``U_Q``, the causal
    exponential masked before ``exp`` (above the diagonal ``cs_i - cs_j`` is
    positive and may overflow), and the three products in fp32.
    """
    if x.is_cuda:
        require_ieee_fp32()
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // q

    def to_bh(t):
        # (B, S, H, F) -> (B·H, nc, Q, F)
        return torch.movedim(t, 2, 1).reshape(bsz * h, nc, q, t.shape[-1])

    xb, bb, cb = to_bh(x), to_bh(b_mat), to_bh(c_mat)
    ab = to_bh(a_log[..., None])[..., 0][:, :, None, :]            # (B·H, nc, 1, Q)
    cs = (ab @ upper_ones(q, F32, x.device))[:, :, 0]               # (B·H, nc, Q)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((bsz * h, n, p), dtype=F32, device=x.device)
    ys = []
    for c in range(nc):
        csc = cs[:, c]
        li = csc[:, :, None] - csc[:, None, :]
        lmat = torch.exp(torch.where(causal, li, torch.full((), -torch.inf, device=x.device)))
        xc, bc, cc = xb[:, c], bb[:, c], cb[:, c]
        scores = (cc @ bc.transpose(1, 2)) * lmat
        y = scores @ xc + (cc * torch.exp(csc)[:, :, None]) @ state
        total = csc[:, -1:]
        decay_to_end = torch.exp(total - csc)
        state = torch.exp(total)[:, :, None] * state + \
            (bc * decay_to_end[:, :, None]).transpose(1, 2) @ xc
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, h, sp, p)
    return torch.movedim(y, 1, 2)[:, :s]


def ssd_chunk_scan(x: torch.Tensor, a_log: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Fused chunked SSD scan: ``y`` of ``(B, S, H, P)`` in ``x``'s dtype.

    Args:
        x: ``(B, S, H, P)`` inputs.
        a_log: ``(B, S, H)`` log decays (``<= 0``; see ``csrc/ssd_chunk.cu`` for
            what a positive one does).
        b_mat, c_mat: ``(B, S, H, N)`` input and output projections.
        chunk: Tokens per chunk ``Q``; ``S < Q`` runs one chunk of ``S``.

    Operands are cast to fp32.  A CUDA tensor launches the kernel, a CPU
    tensor runs :func:`ssd_chunk_plain`.

    Raises:
        NotImplementedError: an input requires grad while grad mode is on.
        ValueError: mismatched shapes, or (on the card) a chunk, state and
            head width whose shared memory exceeds 227 KB.
    """
    guards.refuse_grad(x, a_log, b_mat, c_mat, op="ssd_chunk_scan")
    chunk = guards.validate_positive(chunk, name="chunk", op="ssd_chunk_scan")
    if x.dim() != 4:
        raise ValueError(f"ssd_chunk_scan: x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    guards.validate_same_shape(tuple(a_log.shape), (bsz, s, h), op="ssd_chunk_scan",
                               a_name="a_log", b_name="(B, S, H)")
    if b_mat.dim() != 4 or tuple(b_mat.shape[:3]) != (bsz, s, h):
        raise ValueError(f"ssd_chunk_scan: b_mat must be (B, S, H, N) with x's (B, S, H), "
                         f"got {tuple(b_mat.shape)}")
    guards.validate_same_shape(tuple(b_mat.shape), tuple(c_mat.shape), op="ssd_chunk_scan",
                               a_name="b_mat", b_name="c_mat")
    if len({t.device for t in (x, a_log, b_mat, c_mat)}) != 1:
        raise ValueError("ssd_chunk_scan: inputs live on different devices")
    n = b_mat.shape[-1]
    xf, af, bf, cf = (t.to(F32) for t in (x, a_log, b_mat, c_mat))
    if x.numel() == 0 or n == 0:
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if not x.is_cuda:
        return ssd_chunk_plain(xf, af, bf, cf, chunk=chunk).to(x.dtype)
    q = min(chunk, s)
    smem = ssd_smem_bytes(q, n, p)
    if smem > SSD_SMEM_LIMIT:
        raise ValueError(f"ssd_chunk_scan: chunk {q}, state {n} and head width {p} need "
                         f"{smem} B of shared memory a CTA; the card allows "
                         f"{SSD_SMEM_LIMIT} (227 KB)")
    if bsz * h >= 1 << 31 or s >= 1 << 31:
        raise ValueError("ssd_chunk_scan: B·H and S must be below 2^31")
    xf, bf, cf = (t if t.stride(-1) == 1 else t.contiguous() for t in (xf, bf, cf))
    y = torch.empty((bsz, s, h, p), dtype=F32, device=x.device)
    strides = (ctypes.c_longlong * 12)(*(st for t in (xf, af, bf, cf) for st in t.stride()[:3]))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.launch("ssd_chunk", xf.data_ptr(), af.data_ptr(), bf.data_ptr(), cf.data_ptr(),
                      y.data_ptr(), bsz, s, h, p, n, q, strides, stream)
    return y.to(x.dtype)

"""B17: the chunked SSD scan, the sequence mixing of a Mamba2 layer.

Port of ``repro/kernels/ssd_chunk.py``.  For each (batch, head) the sequence
runs in chunks of ``Q`` tokens with an ``(N, P)`` fp32 state carried across
them in order:

    cs      = a @ U_Q                      (cumsum of the log decays)
    scores  = (C B^T) ∘ exp(cs_i - cs_j)   masked causal
    y       = scores X + (C ∘ exp(cs)) state
    state   = exp(cs_Q) state + (B ∘ exp(cs_Q - cs))^T X

:func:`ssd_chunk_scan` launches ``csrc/ssd_chunk.cu`` on CUDA tensors (one
CTA per (batch·head, chunk), the state handed from chunk to chunk through a
workspace, the inputs read through their strides) and runs
:func:`ssd_chunk_plain` on CPU tensors; ``ssd_chunk_plain(chained=True)``
models the kernel's chunk-parallel pass.  Neither has a gradient: the JAX
package cannot differentiate the Pallas kernel either, so B17 serves the
forward pass and the loss of a ``scan_method="kernel"`` hybrid model, and an
input that requires grad is refused before any launch
(``guards.refuse_grad``); ``ssd_scan`` on ``"vector"``/``"matmul"`` trains.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import guards
from repro_torch.core.precision import require_ieee_fp32
from repro_torch.core.scan import upper_ones
from repro_torch.kernels import _build

__all__ = ["ssd_chunk_scan", "ssd_chunk_plain", "ssd_smem_bytes", "ssd_check_tile",
           "ssd_workspace_bytes", "SSD_SMEM_LIMIT"]

F32 = torch.float32
# shared memory one CTA may use on the card (227 KB)
SSD_SMEM_LIMIT = 232448
# csrc/ssd_chunk.cu: 8 warps a CTA, each holding one 16-row strip of y (64
# columns) and up to two 16 x 32 tiles of the chunk's state
_WARPS, _STRIP_COLS, _STATE_TILES = 8, 64, 2


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def ssd_smem_bytes(q: int, n: int, p: int) -> int:
    """Shared memory of one CTA of ``csrc/ssd_chunk.cu`` for chunk ``q``, state ``n`` and
    head width ``p``: the fp64 cumsum, then in fp32 the chunk's X (``max(q, n)``
    rows: the entering state takes its place), B and C, with ``q`` and ``n``
    rounded up to 16 and ``p`` to 8, and rows padded for conflict-free
    fragment loads (X's to 8 mod 16 floats, B's and C's to 4 mod 8)."""
    qp, np_, pp = _up(q, 16), _up(n, 16), _up(p, 8)
    ldx = pp + 8 if pp % 16 == 0 else pp
    return 8 * qp + 4 * (max(qp, np_) * ldx + 2 * qp * (np_ + 4))


def ssd_check_tile(q: int, n: int, p: int) -> None:
    """Raise ``ValueError`` unless one CTA of ``csrc/ssd_chunk.cu`` holds a chunk of
    ``q`` tokens with state ``n`` and head width ``p``: at most 8 strips of y
    (``⌈q/16⌉·⌈p/64⌉``, one a warp), 16 tiles of the state (``⌈n/16⌉·⌈p/32⌉``)
    and 227 KB of shared memory.  zamba2 (128, 64, 64) takes 105 KB, so two CTAs
    share an SM."""
    smem = ssd_smem_bytes(q, n, p)
    strips = _up(q, 16) // 16 * -(-_up(p, 8) // _STRIP_COLS)
    tiles = _up(n, 16) // 16 * -(-_up(p, 8) // 32)
    if smem > SSD_SMEM_LIMIT or strips > _WARPS or tiles > _WARPS * _STATE_TILES:
        raise ValueError(
            f"ssd_chunk_scan: chunk {q}, state {n} and head width {p} need {smem} B of "
            f"shared memory, {strips} strips of y and {tiles} tiles of the state a CTA; "
            f"the kernel takes at most {SSD_SMEM_LIMIT} B (227 KB), {_WARPS} strips and "
            f"{_WARPS * _STATE_TILES} tiles (chunk <= 128 at head width <= 64)")


def ssd_workspace_bytes(bh: int, nc: int, n: int, p: int) -> int:
    """Bytes of the kernel's workspace for ``bh`` (batch, head) pairs of ``nc``
    chunks: the 8-byte ticket counter and a 4-byte flag a chunk (together rounded up
    to 16 bytes), then the ``(n, p)`` fp32 state each chunk but the last hands on."""
    return _up(8 + 4 * bh * nc, 16) + 4 * bh * (nc - 1) * n * p


def ssd_chunk_plain(x: torch.Tensor, a_log: torch.Tensor, b_mat: torch.Tensor,
                    c_mat: torch.Tensor, *, chunk: int = 128,
                    chained: bool = False) -> torch.Tensor:
    """Plain version of the chunk kernel, with the Pallas kernel's algebra.

    fp32 ``(B, S, H, ·)`` operands; ``S`` is zero-padded to whole chunks and the
    head axis moved next to the batch, then the chunks run in order, every
    ``(B·H)`` slice at once: ``cs`` as the product with ``U_Q``, the causal
    exponential masked before ``exp`` (above the diagonal ``cs_i - cs_j`` is
    positive and may overflow), and the three products in fp32.

    ``chained`` models the kernel's chunk-parallel pass instead: every chunk's
    ``y_diag = G X`` and local state ``S_c = (B ∘ exp(cs_Q - cs))ᵀ X`` at once,
    then the states handed on in chunk order, ``h_{c+1} = exp(cs_Q)·h_c + S_c``
    from ``h_0 = 0``, then the off-diagonal term added after ``y_diag`` as
    ``exp(cs_i)·(C h_c)``.
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
    if chained:
        y = _chained_pass(xb, bb, cb, cs, causal)
        return torch.movedim(y.reshape(bsz, h, sp, p), 1, 2)[:, :s]
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


def _chained_pass(xb, bb, cb, cs, causal):
    """The kernel's pass on ``(B·H, nc, Q, ·)`` chunks and their ``(B·H, nc, Q)`` cumsums."""
    li = cs[..., :, None] - cs[..., None, :]
    lmat = torch.exp(torch.where(causal, li, torch.full((), -torch.inf, device=cs.device)))
    y = ((cb @ bb.transpose(-1, -2)) * lmat) @ xb
    total = cs[..., -1:]
    s_loc = (bb * torch.exp(total - cs)[..., None]).transpose(-1, -2) @ xb
    hs = [torch.zeros_like(s_loc[:, 0])]
    for c in range(cs.shape[1] - 1):
        hs.append(torch.exp(total[:, c])[..., None] * hs[-1] + s_loc[:, c])
    return y + torch.exp(cs)[..., None] * (cb @ torch.stack(hs, dim=1))


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
            head width that one CTA cannot hold (``ssd_check_tile``).
    """
    guards.refuse_grad(x, a_log, b_mat, c_mat, op="ssd_chunk_scan", method="kernel",
                       instead="ssd_scan's scan_method='vector' and 'matmul'")
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
    ssd_check_tile(q, n, p)
    if bsz * h * -(-s // q) >= 1 << 31 or s >= 1 << 31:
        raise ValueError("ssd_chunk_scan: B·H·⌈S/Q⌉ and S must be below 2^31")
    return _ssd_chunk_cuda(xf, af, bf, cf, q).to(x.dtype)


def _ssd_chunk_cuda(xf, af, bf, cf, q, *, ws=None):
    """One launch of B17 on fp32 CUDA operands.  ``ws`` (allocated here if None,
    ``ssd_workspace_bytes`` of it) holds the hand-off; after the launch its first
    word is the number of CTAs that ran, one a chunk."""
    bsz, s, h, p = xf.shape
    n = bf.shape[-1]
    xf, bf, cf = (t if t.stride(-1) == 1 else t.contiguous() for t in (xf, bf, cf))
    if ws is None:
        nbytes = ssd_workspace_bytes(bsz * h, -(-s // q), n, p)
        ws = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=xf.device)
    y = torch.empty((bsz, s, h, p), dtype=F32, device=xf.device)
    strides = (ctypes.c_longlong * 12)(*(st for t in (xf, af, bf, cf) for st in t.stride()[:3]))
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        _build.launch("ssd_chunk", xf.data_ptr(), af.data_ptr(), bf.data_ptr(), cf.data_ptr(),
                      y.data_ptr(), bsz, s, h, p, n, q, strides, ws.data_ptr(),
                      ws.numel() * ws.element_size(), stream)
    return y

"""Grouped-query attention for the decoders: full (prefill) and decode.

Port of ``repro/models/attention.py`` (``_qk``, ``attn_full``, ``attn_decode``,
``attn_decode_paged``) in plain einsum/matmul, with the same ``-1e30``
masking, the per-head q/k RMSNorm of ``qk_norm`` configs (qwen3) and the
sliding ``window=`` of local layers (gemma2): a query at ``i`` sees the keys
``j`` with ``i - window < j <= i``.  Prefix-LM masks and cross-attention (the
VLM and enc-dec families) are not ported yet.  Scores and the probability-value product accumulate in fp32 as the
JAX package's ``preferred_element_type=float32`` does: the bf16 operands are
widened to fp32 first (exact), and the probabilities are rounded to the value
dtype before the second product, as the JAX code casts them.

The KV cache is a pair of ``(B, T, K, D)`` tensors.  ``attn_decode`` writes the
new key and value into it in place (the JAX version returns an updated copy),
which saves a cache-sized copy per layer and step.  ``attn_decode_paged`` does
the same on the paged layout of continuous batching (``serving/paged_kv.py``):
page pools shared by every row and a page table a row.
"""
from __future__ import annotations

import torch

from repro_torch.core import guards
from repro_torch.models.layers import apply_rope, linear, ninit, rmsnorm, softcap

__all__ = ["attn_init", "attn_full", "attn_decode", "attn_decode_paged"]

F32 = torch.float32
NEG = -1e30


def _cache_len(cache_len, s: int, *, op: str) -> int:
    if cache_len is None:
        return s
    clen = guards.validate_positive(cache_len, name="cache_len", op=op)
    if clen < s:
        raise ValueError(f"{op}: cache_len ({clen}) is shorter than the "
                         f"prefill length ({s}); the KV cache must hold at "
                         "least the prompt")
    return clen


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _gqa_scores(q, k, scale, cap):
    """q: (B,S,K,G,D), k: (B,T,K,D) -> (B,K,G,S,T) fp32."""
    s = torch.einsum("bskgd,btkd->bkgst", q.to(F32), k.to(F32)) * scale
    return softcap(s, cap)


def _gqa_out(probs, v):
    """probs: (B,K,G,S,T), v: (B,T,K,D) -> (B,S,K*G,D) fp32."""
    o = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).to(F32), v.to(F32))
    b, s, k, g, d = o.shape
    return o.reshape(b, s, k * g, d)


def _qk(p, x, cfg, positions, cdt):
    hd = cfg.head_dim_
    q = _split_heads(linear({"w": p["wq"]}, x, cdt), cfg.n_heads, hd)
    k = _split_heads(linear({"w": p["wk"]}, x, cdt), cfg.n_kv_heads, hd)
    v = _split_heads(linear({"w": p["wv"]}, x, cdt), cfg.n_kv_heads, hd)
    if cfg.qk_norm:                                   # per head, over head_dim
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_full(p, x, cfg, *, positions, cdt, window=None, return_cache=False,
              cache_len=None):
    """Full-sequence causal attention (prefill); optionally returns a KV cache.

    ``window``: a local layer's window; query ``i`` then sees keys ``j`` with
    ``i - window < j <= i``.  The cache keeps every position, as JAX's does."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    kh, gh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qk(p, x, cfg, positions, cdt)
    scores = _gqa_scores(q.reshape(b, s, kh, gh, hd), k, hd ** -0.5, cfg.attn_softcap)
    i = torch.arange(s, device=x.device)[:, None]
    j = torch.arange(k.shape[1], device=x.device)[None, :]
    mask = j <= i
    if window is not None:
        mask = mask & ((i - j) < window)
    scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, v).to(x.dtype)
    y = linear({"w": p["wo"]}, out.reshape(b, s, -1), cdt)
    if not return_cache:
        return y
    clen = _cache_len(cache_len, s, op="attn_full")
    kc = torch.zeros((b, clen, kh, hd), dtype=x.dtype, device=x.device)
    vc = torch.zeros((b, clen, kh, hd), dtype=x.dtype, device=x.device)
    kc[:, :s] = k.to(x.dtype)
    vc[:, :s] = v.to(x.dtype)
    return y, {"k": kc, "v": vc}


def _decode_attend(q, kc, vc, pos, cfg, x, p, cdt, window):
    """Attention of one query a row over a ``(B, T, K, D)`` cache, masked to
    ``j <= pos`` (``pos``: an int, or a (B,) tensor of each row's position) and,
    with a ``window``, to ``j > pos - window``."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    kh, gh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    scores = _gqa_scores(q.reshape(b, s, kh, gh, hd), kc, hd ** -0.5,
                         cfg.attn_softcap)                        # (B,K,G,1,T)
    j = torch.arange(kc.shape[1], device=x.device)
    if isinstance(pos, torch.Tensor):
        mask = j[None, :] <= pos[:, None]
        if window is not None:
            mask = mask & (j[None, :] > pos[:, None] - window)
        mask = mask[:, None, None, None, :]
    else:
        mask = j <= pos
        if window is not None:
            mask = mask & (j > pos - window)
    scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, vc).to(x.dtype).reshape(b, s, -1)
    return linear({"w": p["wo"]}, out, cdt)


def attn_decode(p, x, cfg, cache, pos, *, cdt, window=None):
    """Single-token decode; updates ``cache`` in place.

    ``x``: (B, 1, D); ``cache["k"/"v"]``: (B, T, K, D).  ``pos`` is an int (every
    row writes and attends at the same position) or a (B,) integer tensor (each
    row at its own depth, as in continuous batching).  ``window``: a local
    layer's window (keys ``j > pos - window`` only).
    """
    b, s, _ = x.shape
    kc, vc = cache["k"], cache["v"]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        pos = pos.to(device=x.device, dtype=torch.int64)
        q, k, v = _qk(p, x, cfg, pos[:, None], cdt)
        rows = torch.arange(b, device=x.device)
        kc[rows, pos] = k[:, 0].to(kc.dtype)
        vc[rows, pos] = v[:, 0].to(vc.dtype)
    else:
        pos = int(pos)
        positions = torch.full((b, s), pos, dtype=torch.int32, device=x.device)
        q, k, v = _qk(p, x, cfg, positions, cdt)
        kc[:, pos:pos + s] = k.to(kc.dtype)
        vc[:, pos:pos + s] = v.to(vc.dtype)
    return _decode_attend(q, kc, vc, pos, cfg, x, p, cdt, window), cache


def attn_decode_paged(p, x, cfg, cache, pos, *, cdt, window=None):
    """Single-token decode against a paged KV cache; updates the pools in place.

    ``cache``: ``{"k"/"v": (P, page, K, D)}`` page pools shared by every row and
    ``"pages": (B, n_blocks)`` int32, each row's page table (logical block
    ``t // page`` -> pool page).  ``pos``: (B,) integer write positions (an int
    is repeated over the rows).  The new k/v go to page ``pages[b, pos // page]``,
    slot ``pos % page``; each row's pages are then gathered back into a
    contiguous ``(B, n_blocks * page, K, D)`` view and attended exactly as
    :func:`attn_decode` attends its cache (the same scores, ``-1e30`` mask and
    softmax), so at equal attention length the two agree bit for bit.  Page 0
    is the allocator's scratch page: table entries not assigned point there, so
    idle rows write there and no row reads it unmasked.  ``window`` masks as in
    :func:`attn_decode`.
    """
    b = x.shape[0]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        pos = pos.to(device=x.device, dtype=torch.int64)
    else:
        pos = torch.full((b,), int(pos), dtype=torch.int64, device=x.device)
    pages = cache["pages"]
    kp, vp = cache["k"], cache["v"]
    page = kp.shape[1]
    q, k, v = _qk(p, x, cfg, pos[:, None], cdt)
    rows = torch.arange(b, device=x.device)
    pid = pages[rows, pos // page].to(torch.int64)
    slot = pos % page
    kp[pid, slot] = k[:, 0].to(kp.dtype)
    vp[pid, slot] = v[:, 0].to(vp.dtype)
    table = pages.to(torch.int64)
    kc = kp[table].reshape(b, -1, *kp.shape[2:])                  # (B, nblk*page, K, D)
    vc = vp[table].reshape(b, -1, *vp.shape[2:])
    return _decode_attend(q, kc, vc, pos, cfg, x, p, cdt, window), cache


def attn_init(gen, cfg, *, n, dtype, device):
    """Stacked attention weights for ``n`` layers, JAX ``(d_in, d_out)`` layout."""
    hd = cfg.head_dim_
    kw = dict(n=n, dtype=dtype, device=device)
    p = {
        "wq": ninit(gen, (cfg.d_model, cfg.n_heads * hd), **kw),
        "wk": ninit(gen, (cfg.d_model, cfg.n_kv_heads * hd), **kw),
        "wv": ninit(gen, (cfg.d_model, cfg.n_kv_heads * hd), **kw),
        "wo": ninit(gen, (cfg.n_heads * hd, cfg.d_model), **kw),
    }
    if cfg.qk_norm:
        lead = () if n is None else (n,)
        p["q_norm"] = {"g": torch.zeros((*lead, hd), dtype=dtype, device=device)}
        p["k_norm"] = {"g": torch.zeros((*lead, hd), dtype=dtype, device=device)}
    return p

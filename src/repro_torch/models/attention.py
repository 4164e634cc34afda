"""Attention: grouped-query (full and decode), cross-attention and MLA.

Port of ``repro/models/attention.py`` in plain einsum/matmul, with the same
``-1e30`` masking, the per-head q/k RMSNorm of ``qk_norm`` configs (qwen3) and
the sliding ``window=`` of local layers (gemma2): a query at ``i`` sees the
keys ``j`` with ``i - window < j <= i``.  ``attn_full`` also takes the
prefix-LM mask of the VLM family (``prefix_len=P``: the first ``P`` positions
see one another both ways), ``causal=False`` (the enc-dec encoder) and
``kv_x=`` (cross-attention onto the encoder's output, unmasked);
``attn_cross_decode`` attends the cross KV that ``cross_kv`` computes once at
prefill.  Scores and the probability-value product accumulate in fp32 as the
JAX package's ``preferred_element_type=float32`` does: the bf16 operands are
widened to fp32 first (exact), and the probabilities are rounded to the value
dtype before the second product, as the JAX code casts them.

The KV cache is a pair of ``(B, T, K, D)`` tensors.  ``attn_decode`` writes the
new key and value into it in place (the JAX version returns an updated copy),
which saves a cache-sized copy per layer and step.  ``attn_decode_paged`` does
the same on the paged layout of continuous batching (``serving/paged_kv.py``):
page pools shared by every row and a page table a row.

MLA (minicpm3) keeps a compressed cache ``{latent (B, T, r), k_rope (B, T,
dr)}``: ``mla_full`` expands it through ``kv_b`` (train and prefill), and
``mla_decode`` attends in the latent space with ``kv_b`` absorbed into the
query and the output (``w_uk``, ``w_uv``).  The two round differently; both
keep JAX's ``(d_in, d_out)`` weight layout.
"""
from __future__ import annotations

import torch

from repro_torch.core import guards
from repro_torch.models.layers import apply_rope, linear, ninit, rmsnorm, softcap

__all__ = ["attn_init", "attn_mask", "attn_full", "attn_decode", "attn_decode_paged",
           "attn_cross_decode", "cross_kv", "mla_init", "mla_full", "mla_decode"]

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


def _qk(p, x, cfg, positions, cdt, kv_x=None, use_rope=True):
    hd = cfg.head_dim_
    src = x if kv_x is None else kv_x
    q = _split_heads(linear({"w": p["wq"]}, x, cdt), cfg.n_heads, hd)
    k = _split_heads(linear({"w": p["wk"]}, src, cdt), cfg.n_kv_heads, hd)
    v = _split_heads(linear({"w": p["wv"]}, src, cdt), cfg.n_kv_heads, hd)
    if cfg.qk_norm:                                   # per head, over head_dim
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope and use_rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_mask(s: int, t: int, *, window=None, prefix_len=None, device=None):
    """The ``(s, t)`` boolean mask of causal self-attention: ``j <= i``, within
    ``window`` if given, and with ``prefix_len=P`` also ``i < P and j < P``."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    mask = j <= i
    if window is not None:
        mask = mask & ((i - j) < window)
    if prefix_len:
        mask = mask | ((i < prefix_len) & (j < prefix_len))
    return mask


def attn_full(p, x, cfg, *, positions, cdt, causal=True, window=None, prefix_len=None,
              kv_x=None, use_rope=True, return_cache=False, cache_len=None):
    """Full-sequence attention (train and prefill); optionally returns a KV cache.

    Self-attention is causal unless ``causal=False``; ``window``: a local layer's
    window (query ``i`` sees keys ``i - window < j <= i``); ``prefix_len``: the
    prefix-LM mask, bidirectional over the first ``prefix_len`` positions.  With
    ``kv_x`` the keys and values come from ``kv_x`` (cross-attention), unmasked;
    ``use_rope=False`` leaves q and k unrotated.  The cache keeps every
    position, as JAX's does."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    kh, gh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qk(p, x, cfg, positions, cdt, kv_x=kv_x, use_rope=use_rope)
    scores = _gqa_scores(q.reshape(b, s, kh, gh, hd), k, hd ** -0.5, cfg.attn_softcap)
    if causal and kv_x is None:
        mask = attn_mask(s, k.shape[1], window=window, prefix_len=prefix_len,
                         device=x.device)
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


# ---------------------------------------------------------------------------
# cross-attention (the enc-dec decoder)
# ---------------------------------------------------------------------------


def attn_cross_decode(p, x, cfg, enc_cache, *, cdt):
    """Cross-attention of the decode tokens ``x`` (B, 1, D) onto the encoder's
    keys and values ``enc_cache`` (``{k, v}`` of (B, T_enc, K, D), from
    :func:`cross_kv` at prefill), unmasked."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    kh, gh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q = _split_heads(linear({"w": p["wq"]}, x, cdt), cfg.n_heads, hd)
    scores = _gqa_scores(q.reshape(b, s, kh, gh, hd), enc_cache["k"], hd ** -0.5,
                         cfg.attn_softcap)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, enc_cache["v"]).to(x.dtype).reshape(b, s, -1)
    return linear({"w": p["wo"]}, out, cdt)


def cross_kv(p, enc_out, cfg, *, cdt):
    """The cross-attention keys and values of the encoder's output, in its dtype."""
    hd = cfg.head_dim_
    k = _split_heads(linear({"w": p["wk"]}, enc_out, cdt), cfg.n_kv_heads, hd)
    v = _split_heads(linear({"w": p["wv"]}, enc_out, cdt), cfg.n_kv_heads, hd)
    return {"k": k.to(enc_out.dtype), "v": v.to(enc_out.dtype)}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, minicpm3)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg, *, n, dtype, device):
    """Stacked MLA weights for ``n`` layers, JAX ``(d_in, d_out)`` layout."""
    m, h = cfg.mla, cfg.n_heads
    dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(n=n, dtype=dtype, device=device)
    lead = () if n is None else (n,)
    return {
        "q_a": ninit(gen, (cfg.d_model, m.q_lora_rank), **kw),
        "q_a_norm": {"g": torch.zeros((*lead, m.q_lora_rank), dtype=dtype, device=device)},
        "q_b": ninit(gen, (m.q_lora_rank, h * dqk), **kw),
        "kv_a": ninit(gen, (cfg.d_model, m.kv_lora_rank + m.qk_rope_head_dim), **kw),
        "kv_a_norm": {"g": torch.zeros((*lead, m.kv_lora_rank), dtype=dtype, device=device)},
        "kv_b": ninit(gen, (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)), **kw),
        "wo": ninit(gen, (h * m.v_head_dim, cfg.d_model), **kw),
    }


def _mla_qkv_latent(p, x, cfg, positions, cdt):
    """The queries' no-rope and rope parts (B, S, H, dn / dr), the normed latent
    (B, S, r) and the rotated ``k_rope`` of the one head all heads share
    (B, S, 1, dr)."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    qa = rmsnorm(p["q_a_norm"], linear({"w": p["q_a"]}, x, cdt), cfg.norm_eps)
    q = linear({"w": p["q_b"]}, qa, cdt).reshape(b, s, h,
                                                m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    kv = linear({"w": p["kv_a"]}, x, cdt)
    latent, k_rope = torch.split(kv, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    latent = rmsnorm(p["kv_a_norm"], latent, cfg.norm_eps)
    k_rope = k_rope[:, :, None, :]                                    # shared head
    if positions is not None:
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, latent, k_rope


def mla_full(p, x, cfg, *, positions, cdt, return_cache=False, cache_len=None):
    """Expanded MLA (train and prefill): ``kv_b`` maps the latent to each head's
    ``k_nope`` and ``v``; the scores add the shared ``k_rope``'s, causally
    masked.  The cache keeps the compressed ``{latent, k_rope}``."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    q_nope, q_rope, latent, k_rope = _mla_qkv_latent(p, x, cfg, positions, cdt)
    kvb = linear({"w": p["kv_b"]}, latent, cdt).reshape(
        b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kvb, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bshd,bthd->bhst", q_nope.to(F32), k_nope.to(F32))
              + torch.einsum("bshd,btkd->bhst", q_rope.to(F32),
                             k_rope[:, :, 0:1].to(F32))) * scale
    scores = torch.where(attn_mask(s, s, device=x.device), scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.to(F32)).to(x.dtype)
    y = linear({"w": p["wo"]}, out.reshape(b, s, -1), cdt)
    if not return_cache:
        return y
    clen = _cache_len(cache_len, s, op="mla_full")
    lat_c = torch.zeros((b, clen, m.kv_lora_rank), dtype=x.dtype, device=x.device)
    kr_c = torch.zeros((b, clen, m.qk_rope_head_dim), dtype=x.dtype, device=x.device)
    lat_c[:, :s] = latent.to(x.dtype)
    kr_c[:, :s] = k_rope[:, :, 0].to(x.dtype)
    return y, {"latent": lat_c, "k_rope": kr_c}


def mla_decode(p, x, cfg, cache, pos, *, cdt):
    """Absorbed-matrix MLA decode at the int position ``pos``; updates ``cache``
    in place.  Attention runs in the latent space: the query absorbs ``w_uk``
    (``kv_b``'s key half as (r, H, dn)), the context is projected by ``w_uv``,
    so the cache stays ``r + dr`` numbers a token instead of ``2·H·hd``."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    pos = int(pos)
    positions = torch.full((b, s), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, latent, k_rope = _mla_qkv_latent(p, x, cfg, positions, cdt)
    lat_c, kr_c = cache["latent"], cache["k_rope"]
    lat_c[:, pos:pos + s] = latent.to(lat_c.dtype)
    kr_c[:, pos:pos + s] = k_rope[:, :, 0].to(kr_c.dtype)
    wub = p["kv_b"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wub[:, :, :m.qk_nope_head_dim]                           # (r, H, dn)
    w_uv = wub[:, :, m.qk_nope_head_dim:]                           # (r, H, dv)
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope.to(F32), w_uk.to(F32))
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bshr,btr->bhst", q_eff, lat_c.to(F32))
              + torch.einsum("bshd,btd->bhst", q_rope.to(F32), kr_c.to(F32))) * scale
    mask = torch.arange(lat_c.shape[1], device=x.device) <= pos
    scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, lat_c.to(F32))
    out = torch.einsum("bshr,rhv->bshv", ctx, w_uv.to(F32)).to(x.dtype)
    return linear({"w": p["wo"]}, out.reshape(b, s, -1), cdt), cache

"""The language models: init, forward, prefill and decode.

Port of ``repro/models/transformer.py`` for all its families.  Parameters keep
the JAX pytree layout:

* decoders (dense, local/global, MoE, MLA, xLSTM, VLM): ``{"embed":
  {"embed"}, "final_norm": {"g"}, "stack": {"sub0": ..., "sub{g-1}": ...}}``,
  one ``sub{i}`` a kind of the layer pattern (:func:`layer_pattern`: the
  config's ``layer_pattern``, e.g. gemma2's ``("local", "global")``;
  ``("mlstm",) * 3 + ("slstm",)`` for xlstm-350m; ``("moe",)`` for the MoE
  family; ``("mla",)`` for MLA configs; else ``("dense",)``), every leaf
  stacked over the ``(n_layers - pre) // g`` pattern groups; MoE configs with
  ``first_k_dense`` layers also hold ``pre``, ``{"sub0": dense block}``
  stacked over those leading layers;
* enc-dec (whisper): ``enc_stack`` (``{"sub0": enc block}`` over
  ``n_enc_layers``), ``enc_norm`` and ``stack`` (``{"sub0": dec block}``);
  a ``dec`` block adds cross-attention (``norm_x``, ``xattn``) onto the
  encoder's output;
* hybrid (zamba2): ``stack`` holds ``n_layers // iv`` groups of Mamba2 blocks
  ``sub0 … sub{iv-1}`` (``iv = shared_attn_interval``), each leaf stacked over
  the groups; ``shared`` is one dense block, unstacked, that runs after every
  group with its own KV cache per invocation; ``tail`` holds the trailing
  Mamba2 blocks (``{"sub0": ...}`` stacked over them).

A block of kind ``local`` attends within ``cfg.local_window``; ``moe`` blocks
replace the MLP with :func:`repro_torch.models.moe.moe_apply` (its dispatch is
the paper's int8 mask scan, under ``cfg.scan_method``), dropping no token in
decode, as JAX's ``_block_apply`` asks; gemma2 configs (keyed on the name, as
in JAX) add the sandwich norms ``post_norm1`` / ``post_norm2``; ``mla`` blocks
run :func:`~repro_torch.models.attention.mla_full` (expanded) in train and
prefill and the absorbed :func:`~repro_torch.models.attention.mla_decode`;
``mlstm`` and ``slstm`` blocks are the xLSTM mixers of
:mod:`repro_torch.models.xlstm` (the mLSTM on two chunked SSD scans under
``cfg.scan_method``, the sLSTM a sequential loop).  The enc-dec decoder adds
sinusoidal absolute positions (``rope=False``); the VLM puts ``img_embed``
before the (scaled) text embeddings and attends bidirectionally over those
``n_img_tokens`` positions (the prefix-LM mask).  The layers run in Python
loops over the stacked axes (the JAX package's ``lax.scan``).

Interface:
  init(seed, device=None, dtype=float32)        -> params
  forward(params, batch)                        -> logits of every position
  loss(params, batch)                           -> (total, {"ce", "aux"})
  prefill(params, batch, cache_len=None)        -> (last-position logits, caches)
  decode_step(params, tokens, caches, pos)      -> (logits, caches)
  empty_caches(batch_size, cache_len)           -> zero decode caches

``batch`` holds ``tokens`` and, by family, ``enc_embed`` (enc-dec: (B, enc_len,
D) stub frame embeddings) or ``img_embed`` (VLM: (B, n_img_tokens, D) stub patch
embeddings); ``input_specs`` in ``models/model.py`` names them.
``decode_step`` takes ``pos`` as an int, or on an attention-only stack a (B,)
tensor of per-row positions, and runs paged attention
(``attn_decode_paged``) when the caches hold a ``"pages"`` table
(``serving/paged_kv.py``), as the JAX package's ``_block`` dispatches on that
leaf.

``forward`` and ``loss`` are the JAX package's ``mode="train"`` pass: no
caches, the hybrid's Mamba2 layers on the SSD chunk kernel B17 under
``scan_method="kernel"``, and the MoE layers' load-balancing losses summed
into ``aux``.  They build the autograd graph when grad mode is on, as
``jax.value_and_grad(loss)`` differentiates JAX's: the recurrences through
``linear_scan``'s analytic adjoint, and a method without a gradient (B17, the
scans on ``"kernel"``/``"blocked"``) raises before it launches.  With
``cfg.remat`` each layer group of a training pass is recomputed in the
backward pass (``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` of the
group body): a pattern group, a hybrid group of Mamba2 blocks and the shared
block, each tail block; the recomputation launches the group's kernels again.
JAX's scanned hybrid stack (``scan_layers``) checkpoints only its tail and its
unrolled one every group; the port's layers are a Python loop, and it
checkpoints every group as the unrolled stack does (the gradients are the
same).  ``prefill`` and ``decode_step`` are inference only and run under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import guards
from repro_torch.models import attention as att
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (ACTS, embed_lookup, mlp, ninit, rmsnorm,
                                       sinusoid_at, sinusoidal_pos, softcap, unembed)
from repro_torch.models.mamba import mamba_full, mamba_init, mamba_step
from repro_torch.models.moe import moe_apply, moe_init

__all__ = ["TransformerLM", "layer_pattern", "ATTENTION_KINDS"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
F32 = torch.float32
# the block kinds whose only decode state is an attention KV cache
ATTENTION_KINDS = frozenset({"dense", "local", "global", "moe"})
# the block kinds of the non-hybrid stacks
BLOCK_KINDS = ATTENTION_KINDS | {"mla", "mlstm", "slstm", "enc", "dec"}
_FAMILIES = ("decoder", "moe", "xlstm", "encdec", "vlm")


def layer_pattern(cfg) -> tuple:
    """The kinds of one pattern group, as JAX's ``TransformerLM._pattern``."""
    if cfg.layer_pattern:
        return tuple(cfg.layer_pattern)
    if cfg.family == "xlstm":
        k = cfg.xlstm.slstm_every
        return tuple(["mlstm"] * (k - 1) + ["slstm"])
    if cfg.family == "moe":
        return ("moe",)
    if cfg.family == "encdec":
        return ("dec",)
    if cfg.mla is not None:
        return ("mla",)
    return ("dense",)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layer(v, i) for v in tree)
    return tree[i]


def _stacked(caches):
    """A list of cache trees as one tree of tensors stacked on a new leading axis."""
    if isinstance(caches[0], dict):
        return {k: _stacked([c[k] for c in caches]) for k in caches[0]}
    if isinstance(caches[0], tuple):
        return tuple(_stacked([c[i] for c in caches]) for i in range(len(caches[0])))
    return torch.stack(caches)


def _write(dst, src) -> None:
    """Copy a block's new decode cache into the stacked cache's views, leaf by
    leaf; a leaf the block already wrote in place (the attention caches) is the
    same tensor and is skipped."""
    if isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    elif isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _write(a, b)
    elif dst is not src:
        dst.copy_(src)


def _depth(tree) -> int:
    """The leading (stacked) axis of a parameter tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _decode_cache_for(kind: str, cfg, n: int, b: int, cache_len: int, dt, dev):
    """Zero decode caches of ``n`` stacked blocks of ``kind``, shaped and typed as
    a prefill builds them (JAX's ``_decode_cache_for``, stacked)."""
    def zeros(*shape, dtype=dt):
        return torch.zeros((n, b, *shape), dtype=dtype, device=dev)

    def kv(t):
        return {"k": zeros(t, cfg.n_kv_heads, cfg.head_dim_),
                "v": zeros(t, cfg.n_kv_heads, cfg.head_dim_)}

    if kind in ATTENTION_KINDS or kind == "enc":
        return kv(cache_len)
    if kind == "mamba":
        s = cfg.ssm
        conv_dim = s.expand * cfg.d_model + 2 * s.n_groups * s.d_state
        return {"conv": zeros(s.conv_kernel - 1, conv_dim),
                "ssm": zeros(s.n_heads, s.d_state, s.head_dim, dtype=F32)}
    if kind == "dec":
        return {"kv": kv(cache_len), "xkv": kv(cfg.enc_len)}
    if kind == "mla":
        m = cfg.mla
        return {"latent": zeros(cache_len, m.kv_lora_rank),
                "k_rope": zeros(cache_len, m.qk_rope_head_dim)}
    x = cfg.xlstm
    if kind == "mlstm":
        d_inner = int(x.proj_factor * cfg.d_model)
        hd = d_inner // x.n_heads
        return {"conv": zeros(x.conv_kernel - 1, d_inner),
                "c": zeros(x.n_heads, hd, hd, dtype=F32),
                "n": zeros(x.n_heads, hd, dtype=F32),
                "m": torch.full((n, b, x.n_heads), xl.NEG, dtype=F32, device=dev)}
    if kind == "slstm":
        hd = cfg.d_model // x.n_heads
        z = zeros(x.n_heads, hd, dtype=F32)
        return {"conv": zeros(x.conv_kernel - 1, cfg.d_model),
                "rec": (z, z.clone(), torch.full_like(z, xl.NEG), z.clone())}
    raise ValueError(kind)


class TransformerLM:
    def __init__(self, cfg):
        self.hybrid = (cfg.family == "hybrid" and cfg.ssm is not None
                       and bool(cfg.shared_attn_interval))
        self.pattern = layer_pattern(cfg)
        stack = (cfg.family in _FAMILIES and cfg.ssm is None
                 and set(self.pattern) <= BLOCK_KINDS
                 and (cfg.moe is not None) == ("moe" in self.pattern)
                 and (cfg.mla is not None) == ("mla" in self.pattern)
                 and (cfg.xlstm is not None) == (cfg.family == "xlstm"))
        if not (stack or self.hybrid) or cfg.act not in ACTS:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r}, pattern {self.pattern} or act "
                f"{cfg.act!r} is not ported; the port builds the families "
                f"{_FAMILIES + ('hybrid',)}, the block kinds {sorted(BLOCK_KINDS)} and "
                f"the activations {sorted(ACTS)}")
        self.cfg = cfg
        self.cdt = _DTYPES[cfg.dtype]
        self.encdec = cfg.family == "encdec"
        self.vlm = cfg.family == "vlm"
        self.n_pre = cfg.moe.first_k_dense if cfg.moe else 0
        self.group = len(self.pattern)
        if not self.hybrid and (cfg.n_layers - self.n_pre) % self.group:
            raise ValueError(f"{cfg.name}: {cfg.n_layers - self.n_pre} layers do not "
                             f"fill groups of the pattern {self.pattern}")

    # ---- init ----
    def init(self, seed: int = 0, *, device=None, dtype=torch.float32) -> Dict:
        """Random parameters from ``seed`` with the JAX init's scales.

        ``device=None`` means ``"cuda"`` (raises without a GPU).  The draws
        come from a ``torch.Generator`` and differ from JAX's; to hold the
        port against the JAX package, convert the JAX parameters with
        :func:`repro_torch.convert.params_from_jax` instead.  Every stacked
        leaf is drawn one layer at a time, so a full-size init in bf16 never
        holds more than one layer of a leaf in fp32.  On ``device="meta"``
        it is the abstract init (JAX's ``jax.eval_shape`` of ``init``): the
        same tree, shapes and dtypes, with no memory and no random draw.
        """
        cfg = self.cfg
        dev = guards.resolve_device(device, op="TransformerLM.init")
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        kw = dict(dtype=dtype, device=dev)
        d = cfg.d_model
        if self.hybrid:
            iv = cfg.shared_attn_interval
            n_groups = cfg.n_layers // iv
            trailing = cfg.n_layers - n_groups * iv
            body = {"stack": {f"sub{i}": self._mamba_init(gen, n_groups, kw)
                              for i in range(iv)},
                    "shared": self._block_init(gen, "dense", None, kw)}
            if trailing:
                body["tail"] = {"sub0": self._mamba_init(gen, trailing, kw)}
        elif self.encdec:
            body = {"enc_stack": {"sub0": self._block_init(gen, "enc", cfg.n_enc_layers, kw)},
                    "stack": {"sub0": self._block_init(gen, "dec", cfg.n_layers, kw)},
                    "enc_norm": {"g": torch.zeros((d,), **kw)}}
        else:
            body = {}
            if self.n_pre:
                body["pre"] = {"sub0": self._block_init(gen, "dense", self.n_pre, kw)}
            n_groups = (cfg.n_layers - self.n_pre) // self.group
            body["stack"] = {f"sub{i}": self._block_init(gen, kind, n_groups, kw)
                             for i, kind in enumerate(self.pattern)}
        return {"embed": {"embed": ninit(gen, (cfg.padded_vocab, d),
                                         scale=d ** -0.5, **kw)},
                "final_norm": {"g": torch.zeros((d,), **kw)}, **body}

    def _block_init(self, gen, kind, n, kw):
        """One block's weights of ``kind``, stacked over ``n`` layers (unstacked
        for None): JAX's ``_block_init``."""
        cfg, d = self.cfg, self.cfg.d_model
        lead = () if n is None else (n,)

        def norm():
            return {"g": torch.zeros((*lead, d), **kw)}

        if kind in ("mlstm", "slstm"):
            init = xl.mlstm_block_init if kind == "mlstm" else xl.slstm_block_init
            return {"norm": norm(), "mixer": init(gen, cfg, n=n, **kw)}
        p = {"norm1": norm(), "norm2": norm(),
             "attn": (att.mla_init if kind == "mla" else att.attn_init)(gen, cfg, n=n,
                                                                          **kw)}
        if kind == "dec":                               # + cross-attention
            p["norm_x"] = norm()
            p["xattn"] = att.attn_init(gen, cfg, n=n, **kw)
        if kind == "moe":
            p["moe"] = moe_init(gen, cfg, n=n, **kw)
        else:
            p["mlp"] = {"w_up": ninit(gen, (d, cfg.d_ff), n=n, **kw),
                        "w_down": ninit(gen, (cfg.d_ff, d), n=n, **kw)}
            if cfg.act != "gelu_nogate":
                p["mlp"]["w_gate"] = ninit(gen, (d, cfg.d_ff), n=n, **kw)
        if cfg.name.startswith("gemma2"):               # sandwich norms
            p["post_norm1"] = norm()
            p["post_norm2"] = norm()
        return p

    def _mamba_init(self, gen, n, kw):
        """A Mamba2 block's weights, stacked over ``n`` layers."""
        return {"norm": {"g": torch.zeros((n, self.cfg.d_model), **kw)},
                "mixer": mamba_init(gen, self.cfg, n=n, **kw)}

    # ---- one residual block ----
    def _xlstm_block(self, p, h, kind, *, mode, cache=None):
        """One xLSTM residual block; returns ``(h, cache, None)``."""
        cfg, cdt = self.cfg, self.cdt
        hin = rmsnorm(p["norm"], h, cfg.norm_eps)
        if mode == "decode":
            step = xl.mlstm_block_step if kind == "mlstm" else xl.slstm_block_step
            y, nc = step(p["mixer"], hin, cfg, cache, cdt=cdt)
        else:
            full = xl.mlstm_block if kind == "mlstm" else xl.slstm_block
            y = full(p["mixer"], hin, cfg, cdt=cdt, return_cache=mode == "prefill")
            y, nc = y if mode == "prefill" else (y, None)
        return h + y, nc, None

    def _block(self, p, h, kind="dense", *, mode, positions=None, cache=None,
               pos=None, cache_len=None, prefix_len=None, enc_out=None, causal=True):
        """One block of ``kind``; returns ``(h, cache, aux)`` (no cache in
        ``"train"``; ``aux`` is the MoE load-balancing loss, else None)."""
        if kind in ("mlstm", "slstm"):
            return self._xlstm_block(p, h, kind, mode=mode, cache=cache)
        cfg, cdt = self.cfg, self.cdt
        window = cfg.local_window if kind == "local" else None
        hin = rmsnorm(p["norm1"], h, cfg.norm_eps)
        self_cache = cache["kv"] if kind == "dec" and cache is not None else cache
        if kind == "mla":
            if mode == "decode":
                y, new_cache = att.mla_decode(p["attn"], hin, cfg, self_cache, pos, cdt=cdt)
            else:
                y = att.mla_full(p["attn"], hin, cfg, positions=positions, cdt=cdt,
                                 return_cache=mode == "prefill", cache_len=cache_len)
                y, new_cache = y if mode == "prefill" else (y, None)
        elif mode == "decode":
            # a "pages" leaf marks the paged KV layout (continuous batching)
            dec = att.attn_decode_paged if "pages" in self_cache else att.attn_decode
            y, new_cache = dec(p["attn"], hin, cfg, self_cache, pos, cdt=cdt,
                               window=window)
        else:
            y = att.attn_full(p["attn"], hin, cfg, positions=positions, cdt=cdt,
                              causal=causal, window=window, prefix_len=prefix_len,
                              return_cache=mode == "prefill", cache_len=cache_len)
            y, new_cache = y if mode == "prefill" else (y, None)
        if "post_norm1" in p:
            y = rmsnorm(p["post_norm1"], y, cfg.norm_eps)
        h = h + y
        if kind == "dec":                               # cross-attention
            hin = rmsnorm(p["norm_x"], h, cfg.norm_eps)
            if mode == "decode":
                y = att.attn_cross_decode(p["xattn"], hin, cfg, cache["xkv"], cdt=cdt)
                new_cache = {"kv": new_cache, "xkv": cache["xkv"]}
            else:
                y = att.attn_full(p["xattn"], hin, cfg, positions=None, cdt=cdt,
                                  kv_x=enc_out, use_rope=False)
                if mode == "prefill":
                    new_cache = {"kv": new_cache,
                                 "xkv": att.cross_kv(p["xattn"], enc_out, cfg, cdt=cdt)}
            h = h + y
        hin = rmsnorm(p["norm2"], h, cfg.norm_eps)
        if kind == "moe":
            y, aux = moe_apply(p["moe"], hin, cfg, cdt=cdt, no_drop=mode == "decode",
                               global_aux=mode == "train")
        else:
            y, aux = mlp(p["mlp"], hin, cdt, act=cfg.act), None
        if "post_norm2" in p:
            y = rmsnorm(p["post_norm2"], y, cfg.norm_eps)
        return h + y, new_cache, aux

    def _part(self, params, h, kinds, *, mode, caches=None, **kw):
        """The pattern groups of one stacked part (``pre``, ``stack`` or
        ``enc_stack``): returns ``(h, caches, aux)``.  Prefill builds the part's
        caches (``sub{i}`` -> the block's cache, stacked over the groups);
        decode writes them into ``caches`` and returns it; ``"train"`` builds
        none.  ``aux`` sums the MoE layers' losses (fp32 scalar)."""
        aux = torch.zeros((), dtype=F32, device=h.device)
        out = {f"sub{i}": [] for i in range(len(kinds))}
        for g in range(_depth(params)):
            def group(h, g=g):
                aux = torch.zeros((), dtype=F32, device=h.device)
                for i, kind in enumerate(kinds):
                    sub = f"sub{i}"
                    c = None if caches is None else _layer(caches[sub], g)
                    h, nc, a = self._block(_layer(params[sub], g), h, kind, mode=mode,
                                           cache=c, **kw)
                    if a is not None:
                        aux = aux + a
                    if c is not None:
                        _write(c, nc)
                    elif mode == "prefill":
                        out[sub].append(nc)
                return h, aux

            h, a = self._remat(group, h, mode)
            aux = aux + a
        if caches is not None:
            return h, caches, aux
        new = {sub: _stacked(cs) for sub, cs in out.items()} if mode == "prefill" else None
        return h, new, aux

    def _stack(self, params, h, *, mode, caches=None, **kw):
        """The decoder's layers: ``pre``, then each pattern group's ``sub{i}``.

        Returns ``(h, caches, aux)``: prefill builds the caches in JAX's layout
        (``pre``/``stack`` -> ``sub{i}`` -> the block's cache stacked over
        layers); decode writes ``caches`` in place and returns them;
        ``"train"`` builds none."""
        aux = torch.zeros((), dtype=F32, device=h.device)
        new = {}
        parts = [("pre", ("dense",))] if "pre" in params else []
        for part, kinds in parts + [("stack", self.pattern)]:
            h, nc, a = self._part(params[part], h, kinds, mode=mode,
                                  caches=None if caches is None else caches[part], **kw)
            aux = aux + a
            new[part] = nc
        if caches is not None:
            return h, caches, aux
        return h, (new if mode == "prefill" else None), aux

    def _remat(self, fn, h, mode):
        """``fn(h)``, recomputed in the backward pass when ``cfg.remat`` and a
        training pass builds a graph (JAX's ``jax.checkpoint`` of a group)."""
        if self.cfg.remat and mode == "train" and torch.is_grad_enabled():
            return checkpoint(fn, h, use_reentrant=False)
        return fn(h)

    def _mamba(self, p, h, *, mode, cache=None):
        """One Mamba2 residual block; returns ``(h, cache)`` (no cache in ``"train"``,
        where the SSD runs on B17 under ``scan_method="kernel"``)."""
        cfg = self.cfg
        hin = rmsnorm(p["norm"], h, cfg.norm_eps)
        if mode == "decode":
            y, new_cache = mamba_step(p["mixer"], hin, cfg, cache, cdt=self.cdt)
        elif mode == "prefill":
            y, new_cache = mamba_full(p["mixer"], hin, cfg, cdt=self.cdt,
                                      return_cache=True)
        else:
            y, new_cache = mamba_full(p["mixer"], hin, cfg, cdt=self.cdt,
                                      use_kernel=cfg.scan_method == "kernel"), None
        return h + y, new_cache

    def _hybrid(self, params, h, *, mode, positions=None, caches=None, pos=None,
                cache_len=None):
        """The hybrid stack: each group of Mamba2 blocks, then the shared block,
        then the tail.  Prefill returns the new caches; decode writes them in
        place; ``"train"`` builds none and returns ``None``."""
        iv = self.cfg.shared_attn_interval
        stack = params["stack"]
        groups, shared, tails = [], [], []

        def mamba(p, h, c, out):
            h, nc = self._mamba(p, h, mode=mode, cache=c)
            if c is not None:
                c["conv"].copy_(nc["conv"])
                c["ssm"].copy_(nc["ssm"])
            elif nc is not None:
                out.append(nc)
            return h

        for g in range(stack["sub0"]["norm"]["g"].shape[0]):
            def group(h, g=g):
                subs = []
                for i in range(iv):
                    c = None if caches is None else _layer(_layer(caches["stack"], g), i)
                    h = mamba(_layer(stack[f"sub{i}"], g), h, c, subs)
                c = None if caches is None else _layer(caches["shared"], g)
                h, nc, _ = self._block(params["shared"], h, mode=mode, positions=positions,
                                       cache=c, pos=pos, cache_len=cache_len)
                if nc is not None and caches is None:
                    groups.append(_stacked(subs))
                    shared.append(nc)
                return h

            h = self._remat(group, h, mode)
        if "tail" in params:
            tail = params["tail"]["sub0"]
            for t in range(tail["norm"]["g"].shape[0]):
                c = None if caches is None else _layer(caches["tail"]["sub0"], t)
                h = self._remat(lambda h, t=t, c=c: mamba(_layer(tail, t), h, c, tails),
                                h, mode)
        if caches is not None:
            return h, caches
        if mode == "train":
            return h, None
        new = {"stack": _stacked(groups), "shared": _stacked(shared)}
        if tails:
            new["tail"] = {"sub0": _stacked(tails)}
        return h, new

    def _embed(self, params, tokens):
        h = embed_lookup(params["embed"], tokens, self.cdt)
        if self.cfg.scale_embed:        # JAX scales by sqrt(d) in the compute dtype
            h = h * torch.tensor(self.cfg.d_model ** 0.5, dtype=h.dtype)
        return h

    def _logits(self, params, h):
        cfg = self.cfg
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = softcap(unembed(params["embed"], h, self.cdt), cfg.final_softcap)
        if cfg.padded_vocab != cfg.vocab_size:      # mask padded vocab rows
            iota = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(iota < cfg.vocab_size, logits, -1e30)
        return logits

    def _encode(self, params, enc_embed):
        """The enc-dec encoder over the stub frame embeddings ``enc_embed``
        (B, enc_len, D): sinusoidal positions, the non-causal ``enc`` stack,
        ``enc_norm``."""
        cfg = self.cfg
        h = enc_embed.to(device=params["enc_norm"]["g"].device, dtype=self.cdt)
        h = h + sinusoidal_pos(h.shape[1], cfg.d_model, h.dtype, h.device)[None]
        h, _, _ = self._part(params["enc_stack"], h, ("enc",), mode="train",
                             positions=None, causal=False)
        return rmsnorm(params["enc_norm"], h, cfg.norm_eps)

    def _run(self, params, batch, *, mode, caches=None, pos=None, cache_len=None):
        """The embeddings and the stack of one pass: ``(h, caches, aux)``.

        The VLM puts ``batch["img_embed"]`` before the text embeddings in train
        and prefill, under the prefix-LM mask over those positions; the enc-dec
        model encodes ``batch["enc_embed"]`` in train and prefill and adds the
        decoder's sinusoidal positions (in decode, row ``pos`` of the same
        table)."""
        cfg = self.cfg
        h = self._embed(params, batch["tokens"])
        prefix_len = enc_out = None
        if self.vlm and mode != "decode":
            img = batch["img_embed"].to(device=h.device, dtype=h.dtype)
            h = torch.cat([img, h], dim=1)
            prefix_len = cfg.n_img_tokens
        if self.encdec:
            if mode == "decode":
                pe = sinusoid_at(torch.full((1,), pos, device=h.device), cfg.d_model)
            else:
                enc_out = self._encode(params, batch["enc_embed"])
                pe = sinusoidal_pos(h.shape[1], cfg.d_model, device=h.device)
            h = h + pe.to(h.dtype)[None]
        positions = (None if mode == "decode" else
                     torch.arange(h.shape[1], dtype=torch.int32, device=h.device)[None, :])
        if self.hybrid:
            h, caches = self._hybrid(params, h, mode=mode, positions=positions,
                                     caches=caches, pos=pos, cache_len=cache_len)
            return h, caches, torch.zeros((), dtype=F32, device=h.device)
        return self._stack(params, h, mode=mode, caches=caches, positions=positions,
                           pos=pos, cache_len=cache_len, prefix_len=prefix_len,
                           enc_out=enc_out)

    # ---- public API ----
    def forward(self, params, batch) -> torch.Tensor:
        """fp32 logits ``(B, S, V)`` of every position of the pass over ``batch``.

        The JAX package's ``mode="train"`` pass: no caches; under
        ``scan_method="kernel"`` each Mamba2 layer runs the SSD chunk kernel
        B17 once, each mLSTM layer two chunked SSD scans (B1 + B13 each) and
        each MoE layer's dispatch one segmented scan (B9).  A VLM's logits
        cover the image positions too (``S = n_img_tokens + text``).  With
        grad mode on and parameters that require grad it builds the graph
        (module docstring); wrap it in ``torch.no_grad()`` for inference.
        """
        h, _, _ = self._run(params, batch, mode="train")
        return self._logits(params, h)

    def loss(self, params, batch, *, ce_denominator=None):
        """Next-token cross-entropy of ``batch["tokens"]``: ``(total, {"ce", "aux"})``.

        ``ce`` is ``logsumexp`` minus the target logit, in fp32, averaged over
        the positions where ``batch["loss_mask"]`` (optional, ``(B, S)``) is
        set at the target; a VLM's image positions predict nothing.  ``aux`` is
        the MoE layers' load-balancing losses summed (0 without MoE layers) and
        ``total = ce + 0.01·aux``.  Differentiable, as ``forward`` is: the
        trainer calls ``total.backward()``.  ``ce_denominator``, when given,
        replaces the masked mean's ``max(Σ mask, 1)``: a data-parallel rank
        passes its share of the whole batch's, so that the ranks' mean is the
        whole batch's ``ce``.
        """
        h, _, aux = self._run(params, batch, mode="train")
        logits = self._logits(params, h)
        if self.vlm:                    # predictions for the text positions only
            logits = logits[:, self.cfg.n_img_tokens:]
        targets = batch["tokens"][:, 1:].to(device=logits.device, dtype=torch.int64)
        lg = logits[:, :-1].to(torch.float32)
        nll = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, targets[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if ce_denominator is not None:
            m = (torch.ones_like(nll) if mask is None
                 else mask[:, 1:].to(device=nll.device, dtype=torch.float32))
            ce = torch.sum(nll * m) / ce_denominator
        elif mask is not None:
            m = mask[:, 1:].to(device=nll.device, dtype=torch.float32)
            ce = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
        else:
            ce = torch.mean(nll)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, params, batch, *, cache_len: Optional[int] = None):
        """Run the prompt ``batch`` (``tokens`` (B, S) and the family's stub
        embeddings); return the last position's logits and the caches.

        Caches keep JAX's layout: ``{"pre"?, "stack": {"sub{i}": cache}}`` (and
        ``enc-dec`` ``{"stack": {"sub0": {"kv", "xkv"}}}``), each leaf stacked
        over the part's layers: ``{"k", "v"}`` of ``(layers, B, cache_len, K,
        D)`` for attention, ``{"latent", "k_rope"}`` for MLA, ``{"conv", "c",
        "n", "m"}`` for mLSTM and ``{"conv", "rec": (c, n, m, h)}`` for sLSTM;
        ``xkv`` is the cross KV of the encoder's output, computed once here.  A
        VLM's cache holds its ``n_img_tokens`` image positions first.  Hybrid
        caches are the JAX package's: ``stack`` ``{"conv", "ssm"}`` of
        ``(groups, iv, B, ...)``, ``shared`` ``{"k", "v"}`` of ``(groups, B,
        cache_len, K, D)`` and ``tail`` ``{"sub0": {"conv", "ssm"}}`` of
        ``(trailing, B, ...)``.
        """
        h, caches, _ = self._run(params, batch, mode="prefill", cache_len=cache_len)
        return self._logits(params, h[:, -1:])[:, -1], caches

    @torch.no_grad()
    def decode_step(self, params, tokens, caches, pos):
        """One token per row (``tokens``: (B, 1)) written at position ``pos``.

        ``pos`` is an int, or on an attention-only stack (``ATTENTION_KINDS``)
        a (B,) integer tensor of per-row positions (continuous batching); a
        VLM's positions count its image tokens.  Decoder caches may be the paged
        layout of ``serving/paged_kv.py``.  Updates ``caches`` in place and
        returns ``(logits (B, V), caches)``.
        """
        cfg = self.cfg
        per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
        if per_row and (self.hybrid or not set(self.pattern) <= ATTENTION_KINDS):
            raise ValueError(
                f"decode_step: {cfg.name} is not an attention-only stack; per-row "
                "positions are for attention-only stacks (its recurrent state, latent "
                "or cross cache has no per-row position)")
        h, caches, _ = self._run(params, {"tokens": tokens}, mode="decode", caches=caches,
                                 pos=pos if per_row else int(pos))
        return self._logits(params, h)[:, -1], caches

    def empty_caches(self, batch_size: int, cache_len: int, *, device=None) -> Dict:
        """Zero decode caches, shaped and typed as :meth:`prefill` returns them
        (JAX's ``empty_caches``: ``_decode_cache_for`` each kind, stacked over
        the layers).  The hybrid stack's are ``stack`` ``{"conv", "ssm"}`` of
        ``(groups, iv, B, ...)``, ``shared`` ``{"k", "v"}`` of ``(groups, B,
        cache_len, K, D)`` and ``tail`` ``{"sub0": {"conv", "ssm"}}`` of
        ``(trailing, B, ...)``.  ``device=None`` means ``"cuda"``; ``"meta"``
        gives the shapes alone."""
        cfg = self.cfg
        dev = guards.resolve_device(device, op="TransformerLM.empty_caches")

        def part(n, kinds):
            return {f"sub{i}": _decode_cache_for(kind, cfg, n, batch_size, cache_len,
                                                 self.cdt, dev)
                    for i, kind in enumerate(kinds)}

        if self.hybrid:
            iv = cfg.shared_attn_interval
            groups = cfg.n_layers // iv
            trailing = cfg.n_layers - groups * iv
            stack = part(groups * iv, ("mamba",))["sub0"]
            c = {"stack": {k: v.unflatten(0, (groups, iv)) for k, v in stack.items()},
                 "shared": part(groups, ("dense",))["sub0"]}
            if trailing:
                c["tail"] = part(trailing, ("mamba",))
            return c
        c = {"pre": part(self.n_pre, ("dense",))} if self.n_pre else {}
        c["stack"] = part((cfg.n_layers - self.n_pre) // self.group, self.pattern)
        return c

"""The decoder LMs: init, prefill and decode.

Port of the ``"dense"`` pattern and the ``"hybrid"`` family of
``repro/models/transformer.py``.  Parameters keep the JAX pytree layout:

* dense: ``{"embed": {"embed"}, "final_norm": {"g"}, "stack": {"sub0": {...}}}``
  with every ``stack`` leaf stacked over a leading ``n_layers`` axis;
* hybrid (zamba2): ``stack`` holds ``n_layers // iv`` groups of Mamba2 blocks
  ``sub0 … sub{iv-1}`` (``iv = shared_attn_interval``), each leaf stacked over
  the groups; ``shared`` is one dense block, unstacked, that runs after every
  group with its own KV cache per invocation; ``tail`` holds the trailing
  Mamba2 blocks (``{"sub0": ...}`` stacked over them).

The layers run in Python loops over those axes (the JAX package's
``lax.scan``).  Other layer kinds (MoE, MLA, xLSTM, enc-dec) raise
``NotImplementedError`` until they are ported.

Interface:
  init(seed, device=None, dtype=float32)        -> params
  forward(params, batch)                        -> logits of every position
  loss(params, batch)                           -> (total, {"ce", "aux"})
  prefill(params, batch, cache_len=None)        -> (last-position logits, caches)
  decode_step(params, tokens, caches, pos)      -> (logits, caches)
  empty_caches(batch_size, cache_len)           -> zero dense caches (dense stack)

``decode_step`` on the dense stack takes ``pos`` as an int or a (B,) tensor
of per-row positions, and runs paged attention (``attn_decode_paged``) when
the caches hold a ``"pages"`` table (``serving/paged_kv.py``), as the JAX
package's ``_block`` dispatches on that leaf.

``forward`` and ``loss`` are the JAX package's ``mode="train"`` pass: no
caches, and the hybrid's Mamba2 layers on the SSD chunk kernel B17 under
``scan_method="kernel"``.  They run under ``torch.no_grad()``: the port has no
gradients yet (training is ROADMAP Queue A item 11).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import guards
from repro_torch.models import attention as att
from repro_torch.models.layers import (ACTS, embed_lookup, mlp, ninit, rmsnorm,
                                       softcap, unembed)
from repro_torch.models.mamba import mamba_full, mamba_init, mamba_step

__all__ = ["TransformerLM"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stacked(caches):
    """A list of cache dicts as one dict of tensors stacked on a new leading axis."""
    if isinstance(caches[0], dict):
        return {k: _stacked([c[k] for c in caches]) for k in caches[0]}
    return torch.stack(caches)


class TransformerLM:
    def __init__(self, cfg):
        dense = cfg.family == "decoder" and cfg.ssm is None
        self.hybrid = (cfg.family == "hybrid" and cfg.ssm is not None
                       and bool(cfg.shared_attn_interval))
        if not (dense or self.hybrid) or cfg.moe or cfg.mla or cfg.xlstm \
                or cfg.layer_pattern or cfg.qk_norm or cfg.local_window \
                or cfg.act not in ACTS:
            raise NotImplementedError(
                f"{cfg.name}: only the llama-style dense decoder and the zamba2-style "
                "hybrid are ported so far")
        self.cfg = cfg
        self.cdt = _DTYPES[cfg.dtype]

    # ---- init ----
    def init(self, seed: int = 0, *, device=None, dtype=torch.float32) -> Dict:
        """Random parameters from ``seed`` with the JAX init's scales.

        ``device=None`` means ``"cuda"`` (raises without a GPU).  The draws
        come from a ``torch.Generator`` and differ from JAX's; to hold the
        port against the JAX package, convert the JAX parameters with
        :func:`repro_torch.convert.params_from_jax` instead.
        """
        cfg = self.cfg
        dev = guards.resolve_device(device, op="TransformerLM.init")
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(dtype=dtype, device=dev)
        if self.hybrid:
            iv = cfg.shared_attn_interval
            n_groups = cfg.n_layers // iv
            trailing = cfg.n_layers - n_groups * iv
            body = {"stack": {f"sub{i}": self._mamba_init(gen, n_groups, kw)
                              for i in range(iv)},
                    "shared": self._dense_init(gen, None, kw)}
            if trailing:
                body["tail"] = {"sub0": self._mamba_init(gen, trailing, kw)}
        else:
            body = {"stack": {"sub0": self._dense_init(gen, cfg.n_layers, kw)}}
        d = cfg.d_model
        return {"embed": {"embed": ninit(gen, (cfg.padded_vocab, d),
                                         scale=d ** -0.5, **kw)},
                "final_norm": {"g": torch.zeros((d,), **kw)}, **body}

    def _dense_init(self, gen, n, kw):
        """A dense block's weights, stacked over ``n`` layers (unstacked for None)."""
        cfg, d = self.cfg, self.cfg.d_model
        lead = () if n is None else (n,)
        return {
            "norm1": {"g": torch.zeros((*lead, d), **kw)},
            "norm2": {"g": torch.zeros((*lead, d), **kw)},
            "attn": att.attn_init(gen, cfg, n=n, **kw),
            "mlp": {"w_up": ninit(gen, (d, cfg.d_ff), n=n, **kw),
                    "w_down": ninit(gen, (cfg.d_ff, d), n=n, **kw),
                    "w_gate": ninit(gen, (d, cfg.d_ff), n=n, **kw)},
        }

    def _mamba_init(self, gen, n, kw):
        """A Mamba2 block's weights, stacked over ``n`` layers."""
        return {"norm": {"g": torch.zeros((n, self.cfg.d_model), **kw)},
                "mixer": mamba_init(gen, self.cfg, n=n, **kw)}

    # ---- one residual block ----
    def _block(self, p, h, *, mode, positions=None, cache=None, pos=None,
               cache_len=None):
        """One dense residual block; returns ``(h, cache)`` (no cache in ``"train"``)."""
        cfg, cdt = self.cfg, self.cdt
        hin = rmsnorm(p["norm1"], h, cfg.norm_eps)
        if mode == "decode":
            # a "pages" leaf marks the paged KV layout (continuous batching)
            dec = att.attn_decode_paged if "pages" in cache else att.attn_decode
            y, new_cache = dec(p["attn"], hin, cfg, cache, pos, cdt=cdt)
        elif mode == "prefill":
            y, new_cache = att.attn_full(p["attn"], hin, cfg, positions=positions,
                                         cdt=cdt, return_cache=True,
                                         cache_len=cache_len)
        else:
            y, new_cache = att.attn_full(p["attn"], hin, cfg, positions=positions,
                                         cdt=cdt), None
        h = h + y
        hin = rmsnorm(p["norm2"], h, cfg.norm_eps)
        return h + mlp(p["mlp"], hin, cdt, act=cfg.act), new_cache

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
            subs = []
            for i in range(iv):
                c = None if caches is None else _layer(_layer(caches["stack"], g), i)
                h = mamba(_layer(stack[f"sub{i}"], g), h, c, subs)
            c = None if caches is None else _layer(caches["shared"], g)
            h, nc = self._block(params["shared"], h, mode=mode, positions=positions,
                                cache=c, pos=pos, cache_len=cache_len)
            if nc is not None and caches is None:
                groups.append(_stacked(subs))
                shared.append(nc)
        if "tail" in params:
            tail = params["tail"]["sub0"]
            for t in range(tail["norm"]["g"].shape[0]):
                c = None if caches is None else _layer(caches["tail"]["sub0"], t)
                h = mamba(_layer(tail, t), h, c, tails)
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
        if self.cfg.scale_embed:
            h = h * self.cfg.d_model ** 0.5
        return h

    def _logits(self, params, h):
        cfg = self.cfg
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = softcap(unembed(params["embed"], h, self.cdt), cfg.final_softcap)
        if cfg.padded_vocab != cfg.vocab_size:      # mask padded vocab rows
            iota = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(iota < cfg.vocab_size, logits, -1e30)
        return logits

    # ---- public API ----
    @torch.no_grad()
    def forward(self, params, batch) -> torch.Tensor:
        """fp32 logits ``(B, S, V)`` of every position of ``batch["tokens"]`` (B, S).

        The JAX package's ``mode="train"`` pass: no caches; under
        ``scan_method="kernel"`` each Mamba2 layer runs the SSD chunk kernel
        B17 once.  Runs under ``torch.no_grad()`` (no gradients yet).
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        h = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=h.device)[None, :]
        if self.hybrid:
            h, _ = self._hybrid(params, h, mode="train", positions=positions)
        else:
            stack = params["stack"]["sub0"]
            for i in range(cfg.n_layers):
                h, _ = self._block(_layer(stack, i), h, mode="train", positions=positions)
        return self._logits(params, h)

    @torch.no_grad()
    def loss(self, params, batch):
        """Next-token cross-entropy of ``batch["tokens"]``: ``(total, {"ce", "aux"})``.

        ``ce`` is ``logsumexp`` minus the target logit, in fp32, averaged over
        the positions where ``batch["loss_mask"]`` (optional, ``(B, S)``) is
        set at the target; ``aux`` is 0 (no MoE layer is ported) and
        ``total = ce + 0.01·aux``.  Runs under ``torch.no_grad()``.
        """
        logits = self.forward(params, batch)
        targets = batch["tokens"][:, 1:].to(torch.int64)
        lg = logits[:, :-1].to(torch.float32)
        nll = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, targets[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is not None:
            m = mask[:, 1:].to(torch.float32)
            ce = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
        else:
            ce = torch.mean(nll)
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch, *, cache_len: Optional[int] = None):
        """Run the prompt ``batch["tokens"]`` (B, S); return the last logits and caches.

        Dense caches are ``{"stack": {"sub0": {"k", "v"}}}`` stacked over
        layers, each ``(n_layers, B, cache_len, K, D)``.  Hybrid caches are the
        JAX package's: ``stack`` ``{"conv", "ssm"}`` of ``(groups, iv, B, ...)``,
        ``shared`` ``{"k", "v"}`` of ``(groups, B, cache_len, K, D)`` and
        ``tail`` ``{"sub0": {"conv", "ssm"}}`` of ``(trailing, B, ...)``.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        h = self._embed(params, tokens)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=h.device)[None, :]
        if self.hybrid:
            h, caches = self._hybrid(params, h, mode="prefill", positions=positions,
                                     cache_len=cache_len)
            return self._logits(params, h[:, -1:])[:, -1], caches
        stack = params["stack"]["sub0"]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            h, c = self._block(_layer(stack, i), h, mode="prefill",
                               positions=positions, cache_len=cache_len)
            ks.append(c["k"])
            vs.append(c["v"])
        caches = {"stack": {"sub0": {"k": torch.stack(ks), "v": torch.stack(vs)}}}
        return self._logits(params, h[:, -1:])[:, -1], caches

    def decode_step(self, params, tokens, caches, pos):
        """One token per row (``tokens``: (B, 1)) written at position ``pos``.

        ``pos`` is an int, or for the dense stack a (B,) integer tensor of
        per-row positions (continuous batching); the hybrid takes an int only.
        Dense caches may be the paged layout of ``serving/paged_kv.py``.
        Updates ``caches`` in place and returns ``(logits (B, V), caches)``.
        """
        cfg = self.cfg
        h = self._embed(params, tokens)
        per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
        if self.hybrid:
            if per_row:
                raise ValueError(
                    f"decode_step: {cfg.name} is a hybrid stack; per-row positions "
                    "are for attention-only stacks (its SSM state has no position)")
            h, _ = self._hybrid(params, h, mode="decode", caches=caches, pos=int(pos))
            return self._logits(params, h)[:, -1], caches
        if not per_row:
            pos = int(pos)
        stack = params["stack"]["sub0"]
        cache = caches["stack"]["sub0"]
        for i in range(cfg.n_layers):
            h, _ = self._block(_layer(stack, i), h, mode="decode",
                               cache=_layer(cache, i), pos=pos)
        return self._logits(params, h)[:, -1], caches

    def empty_caches(self, batch_size: int, cache_len: int, *, device=None) -> Dict:
        """Zero dense decode caches of the dense stack, shaped and typed as
        :meth:`prefill` returns them: ``{"stack": {"sub0": {"k", "v"}}}``, each
        ``(n_layers, batch_size, cache_len, K, D)`` in the config's dtype.
        ``device=None`` means ``"cuda"``; ``"meta"`` gives the shapes alone."""
        cfg = self.cfg
        if self.hybrid:
            raise NotImplementedError(
                f"empty_caches: {cfg.name} is a hybrid stack; only the dense "
                "decoder's caches are built here")
        dev = guards.resolve_device(device, op="TransformerLM.empty_caches")
        shape = (cfg.n_layers, batch_size, cache_len, cfg.n_kv_heads, cfg.head_dim_)
        return {"stack": {"sub0": {name: torch.zeros(shape, dtype=self.cdt, device=dev)
                                   for name in ("k", "v")}}}

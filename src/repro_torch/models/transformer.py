"""The dense decoder LM: init, prefill and decode.

Port of the ``"dense"`` pattern of ``repro/models/transformer.py``.  Parameters
keep the JAX pytree layout: ``{"embed": {"embed"}, "final_norm": {"g"},
"stack": {"sub0": {...}}}`` with every ``stack`` leaf stacked over a leading
``n_layers`` axis.  The layers run in a Python loop over that axis (the JAX
package's ``lax.scan``).  Other layer kinds (MoE, MLA, SSM, xLSTM, enc-dec)
raise ``NotImplementedError`` until they are ported.

Interface:
  init(seed, device=None, dtype=float32)        -> params
  prefill(params, batch, cache_len=None)        -> (last-position logits, caches)
  decode_step(params, tokens, caches, pos)      -> (logits, caches)
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import guards
from repro_torch.models import attention as att
from repro_torch.models.layers import (ACTS, embed_lookup, mlp, ninit, rmsnorm,
                                       softcap, unembed)

__all__ = ["TransformerLM"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class TransformerLM:
    def __init__(self, cfg):
        if cfg.family != "decoder" or cfg.moe or cfg.mla or cfg.ssm or cfg.xlstm \
                or cfg.layer_pattern or cfg.qk_norm or cfg.local_window \
                or cfg.act not in ACTS:
            raise NotImplementedError(
                f"{cfg.name}: only the llama-style dense decoder is ported so far")
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
        n, d = cfg.n_layers, cfg.d_model
        kw = dict(dtype=dtype, device=dev)
        block = {
            "norm1": {"g": torch.zeros((n, d), **kw)},
            "norm2": {"g": torch.zeros((n, d), **kw)},
            "attn": att.attn_init(gen, cfg, n=n, **kw),
            "mlp": {"w_up": ninit(gen, (d, cfg.d_ff), n=n, **kw),
                    "w_down": ninit(gen, (cfg.d_ff, d), n=n, **kw),
                    "w_gate": ninit(gen, (d, cfg.d_ff), n=n, **kw)},
        }
        return {"embed": {"embed": ninit(gen, (cfg.padded_vocab, d),
                                         scale=d ** -0.5, **kw)},
                "final_norm": {"g": torch.zeros((d,), **kw)},
                "stack": {"sub0": block}}

    # ---- one residual block ----
    def _block(self, p, h, *, mode, positions=None, cache=None, pos=None,
               cache_len=None):
        cfg, cdt = self.cfg, self.cdt
        hin = rmsnorm(p["norm1"], h, cfg.norm_eps)
        if mode == "decode":
            y, new_cache = att.attn_decode(p["attn"], hin, cfg, cache, pos, cdt=cdt)
        else:
            y, new_cache = att.attn_full(p["attn"], hin, cfg, positions=positions,
                                         cdt=cdt, return_cache=True,
                                         cache_len=cache_len)
        h = h + y
        hin = rmsnorm(p["norm2"], h, cfg.norm_eps)
        return h + mlp(p["mlp"], hin, cdt, act=cfg.act), new_cache

    def _logits(self, params, h):
        cfg = self.cfg
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = softcap(unembed(params["embed"], h, self.cdt), cfg.final_softcap)
        if cfg.padded_vocab != cfg.vocab_size:      # mask padded vocab rows
            iota = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(iota < cfg.vocab_size, logits, -1e30)
        return logits

    # ---- public API ----
    def prefill(self, params, batch, *, cache_len: Optional[int] = None):
        """Run the prompt ``batch["tokens"]`` (B, S); return the last logits and caches.

        The caches are ``{"stack": {"sub0": {"k", "v"}}}`` stacked over layers,
        each ``(n_layers, B, cache_len, K, D)``.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        h = embed_lookup(params["embed"], tokens, self.cdt)
        if cfg.scale_embed:
            h = h * cfg.d_model ** 0.5
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=h.device)[None, :]
        stack = params["stack"]["sub0"]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            h, c = self._block(_layer(stack, i), h, mode="prefill",
                               positions=positions, cache_len=cache_len)
            ks.append(c["k"])
            vs.append(c["v"])
        caches = {"stack": {"sub0": {"k": torch.stack(ks), "v": torch.stack(vs)}}}
        return self._logits(params, h[:, -1:])[:, -1], caches

    def decode_step(self, params, tokens, caches, pos: int):
        """One token per row (``tokens``: (B, 1)) written at position ``pos``.

        Updates ``caches`` in place and returns ``(logits (B, V), caches)``.
        """
        cfg = self.cfg
        h = embed_lookup(params["embed"], tokens, self.cdt)
        if cfg.scale_embed:
            h = h * cfg.d_model ** 0.5
        stack = params["stack"]["sub0"]
        cache = caches["stack"]["sub0"]
        for i in range(cfg.n_layers):
            h, _ = self._block(_layer(stack, i), h, mode="decode",
                               cache=_layer(cache, i), pos=int(pos))
        return self._logits(params, h)[:, -1], caches

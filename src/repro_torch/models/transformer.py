"""The decoder LMs: init, prefill and decode.

Port of ``repro/models/transformer.py`` for the decoder families (dense,
local/global, MoE) and the ``"hybrid"`` family.  Parameters keep the JAX
pytree layout:

* decoders: ``{"embed": {"embed"}, "final_norm": {"g"}, "stack": {"sub0": ...,
  "sub{g-1}": ...}}``, one ``sub{i}`` a kind of the layer pattern
  (:func:`layer_pattern`: the config's ``layer_pattern``, e.g. gemma2's
  ``("local", "global")``; ``("moe",)`` for the MoE family; else
  ``("dense",)``), every leaf stacked over the ``(n_layers - pre) // g``
  pattern groups; MoE configs with ``first_k_dense`` layers also hold ``pre``,
  ``{"sub0": dense block}`` stacked over those leading layers;
* hybrid (zamba2): ``stack`` holds ``n_layers // iv`` groups of Mamba2 blocks
  ``sub0 … sub{iv-1}`` (``iv = shared_attn_interval``), each leaf stacked over
  the groups; ``shared`` is one dense block, unstacked, that runs after every
  group with its own KV cache per invocation; ``tail`` holds the trailing
  Mamba2 blocks (``{"sub0": ...}`` stacked over them).

A block of kind ``local`` attends within ``cfg.local_window``; ``moe`` blocks
replace the MLP with :func:`repro_torch.models.moe.moe_apply` (its dispatch is
the paper's int8 mask scan, under ``cfg.scan_method``), dropping no token in
decode, as JAX's ``_block_apply`` asks; gemma2 configs (keyed on the name, as
in JAX) add the sandwich norms ``post_norm1`` / ``post_norm2``.  The layers run
in Python loops over the stacked axes (the JAX package's ``lax.scan``).  MLA,
xLSTM, enc-dec and VLM configs raise ``NotImplementedError`` until they are
ported.

Interface:
  init(seed, device=None, dtype=float32)        -> params
  forward(params, batch)                        -> logits of every position
  loss(params, batch)                           -> (total, {"ce", "aux"})
  prefill(params, batch, cache_len=None)        -> (last-position logits, caches)
  decode_step(params, tokens, caches, pos)      -> (logits, caches)
  empty_caches(batch_size, cache_len)           -> zero dense caches (decoders)

``decode_step`` on a decoder takes ``pos`` as an int or a (B,) tensor of
per-row positions, and runs paged attention (``attn_decode_paged``) when the
caches hold a ``"pages"`` table (``serving/paged_kv.py``), as the JAX
package's ``_block`` dispatches on that leaf.

``forward`` and ``loss`` are the JAX package's ``mode="train"`` pass: no
caches, the hybrid's Mamba2 layers on the SSD chunk kernel B17 under
``scan_method="kernel"``, and the MoE layers' load-balancing losses summed
into ``aux``.  They run under ``torch.no_grad()``: the port has no gradients
yet (training is ROADMAP Queue A item 11).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import guards
from repro_torch.models import attention as att
from repro_torch.models.layers import (ACTS, embed_lookup, mlp, ninit, rmsnorm,
                                       softcap, unembed)
from repro_torch.models.mamba import mamba_full, mamba_init, mamba_step
from repro_torch.models.moe import moe_apply, moe_init

__all__ = ["TransformerLM", "layer_pattern", "ATTENTION_KINDS"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
F32 = torch.float32
# the block kinds whose only decode state is an attention KV cache
ATTENTION_KINDS = frozenset({"dense", "local", "global", "moe"})


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
    return tree[i]


def _stacked(caches):
    """A list of cache dicts as one dict of tensors stacked on a new leading axis."""
    if isinstance(caches[0], dict):
        return {k: _stacked([c[k] for c in caches]) for k in caches[0]}
    return torch.stack(caches)


def _depth(tree) -> int:
    """The leading (stacked) axis of a parameter tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


class TransformerLM:
    def __init__(self, cfg):
        self.hybrid = (cfg.family == "hybrid" and cfg.ssm is not None
                       and bool(cfg.shared_attn_interval))
        self.pattern = layer_pattern(cfg)
        decoder = (cfg.family in ("decoder", "moe") and cfg.ssm is None
                   and set(self.pattern) <= ATTENTION_KINDS
                   and (cfg.moe is not None) == ("moe" in self.pattern))
        if not (decoder or self.hybrid) or cfg.mla or cfg.xlstm \
                or cfg.act not in ACTS:
            raise NotImplementedError(
                f"{cfg.name}: MLA, xLSTM, enc-dec and VLM stacks are not ported yet; "
                "the port builds the dense, local/global and MoE decoders and the "
                "zamba2-style hybrid")
        self.cfg = cfg
        self.cdt = _DTYPES[cfg.dtype]
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
        holds more than one layer of a leaf in fp32.
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
                    "shared": self._block_init(gen, "dense", None, kw)}
            if trailing:
                body["tail"] = {"sub0": self._mamba_init(gen, trailing, kw)}
        else:
            body = {}
            if self.n_pre:
                body["pre"] = {"sub0": self._block_init(gen, "dense", self.n_pre, kw)}
            n_groups = (cfg.n_layers - self.n_pre) // self.group
            body["stack"] = {f"sub{i}": self._block_init(gen, kind, n_groups, kw)
                             for i, kind in enumerate(self.pattern)}
        d = cfg.d_model
        return {"embed": {"embed": ninit(gen, (cfg.padded_vocab, d),
                                         scale=d ** -0.5, **kw)},
                "final_norm": {"g": torch.zeros((d,), **kw)}, **body}

    def _block_init(self, gen, kind, n, kw):
        """One attention block's weights of ``kind``, stacked over ``n`` layers
        (unstacked for None): JAX's ``_block_init``."""
        cfg, d = self.cfg, self.cfg.d_model
        lead = () if n is None else (n,)
        p = {"norm1": {"g": torch.zeros((*lead, d), **kw)},
             "norm2": {"g": torch.zeros((*lead, d), **kw)},
             "attn": att.attn_init(gen, cfg, n=n, **kw)}
        if kind == "moe":
            p["moe"] = moe_init(gen, cfg, n=n, **kw)
        else:
            p["mlp"] = {"w_up": ninit(gen, (d, cfg.d_ff), n=n, **kw),
                        "w_down": ninit(gen, (cfg.d_ff, d), n=n, **kw)}
            if cfg.act != "gelu_nogate":
                p["mlp"]["w_gate"] = ninit(gen, (d, cfg.d_ff), n=n, **kw)
        if cfg.name.startswith("gemma2"):               # sandwich norms
            p["post_norm1"] = {"g": torch.zeros((*lead, d), **kw)}
            p["post_norm2"] = {"g": torch.zeros((*lead, d), **kw)}
        return p

    def _mamba_init(self, gen, n, kw):
        """A Mamba2 block's weights, stacked over ``n`` layers."""
        return {"norm": {"g": torch.zeros((n, self.cfg.d_model), **kw)},
                "mixer": mamba_init(gen, self.cfg, n=n, **kw)}

    # ---- one residual block ----
    def _block(self, p, h, kind="dense", *, mode, positions=None, cache=None,
               pos=None, cache_len=None):
        """One attention block of ``kind``; returns ``(h, cache, aux)`` (no cache
        in ``"train"``; ``aux`` is the MoE load-balancing loss, else 0)."""
        cfg, cdt = self.cfg, self.cdt
        window = cfg.local_window if kind == "local" else None
        hin = rmsnorm(p["norm1"], h, cfg.norm_eps)
        if mode == "decode":
            # a "pages" leaf marks the paged KV layout (continuous batching)
            dec = att.attn_decode_paged if "pages" in cache else att.attn_decode
            y, new_cache = dec(p["attn"], hin, cfg, cache, pos, cdt=cdt, window=window)
        elif mode == "prefill":
            y, new_cache = att.attn_full(p["attn"], hin, cfg, positions=positions,
                                         cdt=cdt, window=window, return_cache=True,
                                         cache_len=cache_len)
        else:
            y, new_cache = att.attn_full(p["attn"], hin, cfg, positions=positions,
                                         cdt=cdt, window=window), None
        if "post_norm1" in p:
            y = rmsnorm(p["post_norm1"], y, cfg.norm_eps)
        h = h + y
        hin = rmsnorm(p["norm2"], h, cfg.norm_eps)
        if kind == "moe":
            y, aux = moe_apply(p["moe"], hin, cfg, cdt=cdt, no_drop=mode == "decode")
        else:
            y, aux = mlp(p["mlp"], hin, cdt, act=cfg.act), None
        if "post_norm2" in p:
            y = rmsnorm(p["post_norm2"], y, cfg.norm_eps)
        return h + y, new_cache, aux

    def _stack(self, params, h, *, mode, positions=None, caches=None, pos=None,
               cache_len=None):
        """The decoder's layers: ``pre``, then each pattern group's ``sub{i}``.

        Returns ``(h, caches, aux)``: prefill builds the caches in JAX's layout
        (``pre``/``stack`` -> ``sub{i}`` -> ``{"k", "v"}`` stacked over layers);
        decode writes ``caches`` in place and returns them; ``"train"`` builds
        none.  ``aux`` sums the MoE layers' losses (fp32 scalar)."""
        aux = torch.zeros((), dtype=F32, device=h.device)
        new = {}
        parts = [("pre", ("dense",))] if "pre" in params else []
        for part, kinds in parts + [("stack", self.pattern)]:
            out = {f"sub{i}": [] for i in range(len(kinds))}
            for g in range(_depth(params[part])):
                for i, kind in enumerate(kinds):
                    sub = f"sub{i}"
                    c = None if caches is None else _layer(caches[part][sub], g)
                    h, nc, a = self._block(_layer(params[part][sub], g), h, kind,
                                           mode=mode, positions=positions, cache=c,
                                           pos=pos, cache_len=cache_len)
                    if a is not None:
                        aux = aux + a
                    if mode == "prefill":
                        out[sub].append(nc)
            if mode == "prefill":
                new[part] = {sub: _stacked(cs) for sub, cs in out.items()}
        if caches is not None:
            return h, caches, aux
        return h, (new if mode == "prefill" else None), aux

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
            h, nc, _ = self._block(params["shared"], h, mode=mode, positions=positions,
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

    def _train(self, params, batch):
        """The ``mode="train"`` pass: ``(logits, aux)``."""
        tokens = batch["tokens"]
        h = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=h.device)[None, :]
        if self.hybrid:
            h, _ = self._hybrid(params, h, mode="train", positions=positions)
            aux = torch.zeros((), dtype=F32, device=h.device)
        else:
            h, _, aux = self._stack(params, h, mode="train", positions=positions)
        return self._logits(params, h), aux

    # ---- public API ----
    @torch.no_grad()
    def forward(self, params, batch) -> torch.Tensor:
        """fp32 logits ``(B, S, V)`` of every position of ``batch["tokens"]`` (B, S).

        The JAX package's ``mode="train"`` pass: no caches; under
        ``scan_method="kernel"`` each Mamba2 layer runs the SSD chunk kernel
        B17 once and each MoE layer's dispatch one segmented scan (B9).  Runs
        under ``torch.no_grad()`` (no gradients yet).
        """
        return self._train(params, batch)[0]

    @torch.no_grad()
    def loss(self, params, batch):
        """Next-token cross-entropy of ``batch["tokens"]``: ``(total, {"ce", "aux"})``.

        ``ce`` is ``logsumexp`` minus the target logit, in fp32, averaged over
        the positions where ``batch["loss_mask"]`` (optional, ``(B, S)``) is
        set at the target; ``aux`` is the MoE layers' load-balancing losses
        summed (0 without MoE layers) and ``total = ce + 0.01·aux``.  Runs under
        ``torch.no_grad()``.
        """
        logits, aux = self._train(params, batch)
        targets = batch["tokens"][:, 1:].to(torch.int64)
        lg = logits[:, :-1].to(torch.float32)
        nll = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, targets[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is not None:
            m = mask[:, 1:].to(torch.float32)
            ce = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
        else:
            ce = torch.mean(nll)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch, *, cache_len: Optional[int] = None):
        """Run the prompt ``batch["tokens"]`` (B, S); return the last logits and caches.

        Decoder caches are JAX's: ``{"stack": {"sub{i}": {"k", "v"}}}`` (and
        ``"pre"`` for leading dense layers), each ``(layers, B, cache_len, K,
        D)`` over the part's stacked layers.  Hybrid caches are the JAX
        package's: ``stack`` ``{"conv", "ssm"}`` of ``(groups, iv, B, ...)``,
        ``shared`` ``{"k", "v"}`` of ``(groups, B, cache_len, K, D)`` and
        ``tail`` ``{"sub0": {"conv", "ssm"}}`` of ``(trailing, B, ...)``.
        """
        tokens = batch["tokens"]
        h = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=h.device)[None, :]
        if self.hybrid:
            h, caches = self._hybrid(params, h, mode="prefill", positions=positions,
                                     cache_len=cache_len)
        else:
            h, caches, _ = self._stack(params, h, mode="prefill", positions=positions,
                                       cache_len=cache_len)
        return self._logits(params, h[:, -1:])[:, -1], caches

    def decode_step(self, params, tokens, caches, pos):
        """One token per row (``tokens``: (B, 1)) written at position ``pos``.

        ``pos`` is an int, or for a decoder a (B,) integer tensor of per-row
        positions (continuous batching); the hybrid takes an int only.  Decoder
        caches may be the paged layout of ``serving/paged_kv.py``.  Updates
        ``caches`` in place and returns ``(logits (B, V), caches)``.
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
        h, _, _ = self._stack(params, h, mode="decode", caches=caches,
                              pos=pos if per_row else int(pos))
        return self._logits(params, h)[:, -1], caches

    def empty_caches(self, batch_size: int, cache_len: int, *, device=None) -> Dict:
        """Zero dense decode caches of a decoder, shaped and typed as
        :meth:`prefill` returns them: ``{"pre"?, "stack": {"sub{i}": {"k", "v"}}}``,
        each ``(layers, batch_size, cache_len, K, D)`` in the config's dtype.
        ``device=None`` means ``"cuda"``; ``"meta"`` gives the shapes alone."""
        cfg = self.cfg
        if self.hybrid:
            raise NotImplementedError(
                f"empty_caches: {cfg.name} is a hybrid stack; only the decoders' "
                "caches are built here")
        dev = guards.resolve_device(device, op="TransformerLM.empty_caches")

        def part(n, kinds):
            shape = (n, batch_size, cache_len, cfg.n_kv_heads, cfg.head_dim_)
            return {f"sub{i}": {name: torch.zeros(shape, dtype=self.cdt, device=dev)
                                for name in ("k", "v")} for i in range(len(kinds))}

        c = {"pre": part(self.n_pre, ("dense",))} if self.n_pre else {}
        c["stack"] = part((cfg.n_layers - self.n_pre) // self.group, self.pattern)
        return c

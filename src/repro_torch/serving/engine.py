"""Serving engine: batched prefill + decode with the paper's top-p sampler.

Port of ``repro/serving/engine.py`` ``ServeEngine`` for the samplers
``greedy``, ``topp_auto``, ``topp_scan`` (matmul scans), ``topp_kernel`` (B7
radix passes + the B8 tail), ``topp_blocked`` (every scan of the sampler on
the §4 blocked pipeline, B2–B4), ``topp_segmented`` (the batch's logit rows
packed as segments of one array and sampled by ``segment_top_p_sample``, whose
``method="auto"`` the caller steers with ``method_override``: ``"kernel"``
runs B9, ``"blocked"`` B10–B12), ``topp_sharded`` (the vocab sharded over the
ranks of ``mesh=``, a process group, and sampled by ``dist_top_p_sample``
with ``method="matmul"``; with no group, or a group of one rank, it is the
local matmul sampler that ``topp_scan`` runs) and ``topp_xla`` (a stable
``torch.argsort``; the name matches the JAX package's baseline).

``mesh=`` is a bare process group or a grid (``utils.sharding.Grid``).  With a
process group the model runs whole on every rank and, under
``topp_sharded``, each rank samples its slice of the vocab.  With a grid the
model runs under ``use_mesh(grid)``, as JAX's engine runs it: the MoE layers
take the expert-parallel path (each rank holds its block of every
``experts`` leaf: the engine cuts whole ones, ``moe.expert_blocks``; the
other leaves stay whole), ``topp_sharded`` samples over the grid's
``"model"`` group, and a data axis of more than one rank splits the batch's
rows over the data ranks when they divide (else every rank runs every row);
the tokens are then gathered, so every rank returns the whole ``(B, new)``.
Without ``uniforms=`` a split batch draws each rank's rows from
``generator`` on that rank.  :meth:`ServeEngine.sample_packed`
samples a ragged packed batch of logit rows without padding.  The engine runs
on the card unless it is given ``device="cpu"``.  ``scan_method=`` overrides
the model config's scan method, which the hybrid (zamba2) models' SSD layers
run on: ``"kernel"`` puts their prefill on B1 and B13, ``"blocked"`` on the
§4 pipelines (B4 and B16 at zamba2's shapes); decode's length-1 state
updates launch no kernel on any method.

Under ``REPRO_CHECKS=1`` (or ``guards.checks()``) each decode step asserts
``pos < max_len`` with ``guards.guard_check``; with checks off the check costs
nothing.

``generate(..., uniforms=)`` feeds the sampler's per-step uniforms from
outside, as the operators' ``u=`` does: row ``i`` holds the draws of the
``i``-th sampled token (row 0 samples the prefill's last position).  That is
how the port is held to the JAX engine's token stream, whose uniforms come
from ``jax.random`` bits that no torch generator reproduces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import comm, guards
from repro_torch.core.dist_ops import dist_top_p_sample
from repro_torch.core.primitives import METHODS, top_p_sample
from repro_torch.core.segmented import SegmentedBatch, segment_top_p_sample
from repro_torch.models.model import build_model
from repro_torch.models.moe import expert_blocks
from repro_torch.utils import sharding

__all__ = ["ServeEngine", "sample_tokens", "sampling_group", "grid_params"]


def sampling_group(mesh):
    """The group ``topp_sharded`` samples over: a bare process group (or None)
    as it is; a grid's ``"model"`` group, or None (the local sampler) when
    that axis holds one rank or is missing, as JAX degrades."""
    if isinstance(mesh, sharding.Grid):
        return mesh.group("model") if mesh.shape.get("model", 1) > 1 else None
    return mesh


def grid_params(cfg, params, mesh):
    """The parameters an engine holds on ``mesh``: under a grid with a
    ``"model"`` axis of more than one rank, the MoE experts cut to this rank's
    block; otherwise ``params`` as they are."""
    if isinstance(mesh, sharding.Grid) and cfg.moe is not None:
        return expert_blocks(params, mesh, cfg.moe.n_experts)
    return params


def _grid(mesh):
    return mesh if isinstance(mesh, sharding.Grid) else None


def sample_tokens(sampler: str, logits: torch.Tensor, u=None, generator=None, *, mesh=None,
                  top_p: float, temperature: float, bits_per_pass: int) -> torch.Tensor:
    """One token a row of ``logits`` (B, V) by ``sampler`` (a ``ServeEngine.SAMPLERS``
    name), row ``r`` from the uniform ``u[r, 0]`` when ``u`` is given, else from
    ``generator``.  Both ``ServeEngine`` and ``ContinuousEngine`` sample here."""
    if sampler == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    group = sampling_group(mesh)
    if sampler == "topp_sharded" and group is not None and comm.axis_size(group) > 1:
        v = logits.shape[-1]
        shard = comm.shard_last(logits, comm.axis_size(group), comm.axis_index(group))
        return dist_top_p_sample(shard, v, group, generator=generator, p=top_p,
                                 temperature=temperature, method="matmul",
                                 bits_per_pass=bits_per_pass, u=u)
    if sampler == "topp_segmented":
        b, v = logits.shape
        offsets = torch.arange(b + 1, dtype=torch.int32, device=logits.device) * v
        return segment_top_p_sample(logits.reshape(b * v), offsets, generator,
                                    p=top_p, temperature=temperature,
                                    bits_per_pass=bits_per_pass, u=u)
    method = {"topp_kernel": "kernel", "topp_blocked": "blocked",
              "topp_auto": "auto"}.get(sampler, "matmul")
    sort_method = "xla" if sampler == "topp_xla" else "radix"
    return top_p_sample(logits, generator, p=top_p, temperature=temperature,
                        method=method, sort_method=sort_method,
                        bits_per_pass=bits_per_pass, u=u)


class ServeEngine:
    SAMPLERS = ("greedy", "topp_auto", "topp_scan", "topp_kernel", "topp_blocked",
                "topp_segmented", "topp_sharded", "topp_xla")

    def __init__(self, cfg, params, *, mesh=None, max_len: int = 512, top_p: float = 0.9,
                 temperature: float = 1.0, sampler: str = "topp_scan",
                 bits_per_pass: int = 4, scan_method: Optional[str] = None, device=None):
        self.sampler = guards.validate_choice(sampler, self.SAMPLERS,
                                              name="sampler", op="ServeEngine")
        self.bits_per_pass = guards.validate_bits_per_pass(bits_per_pass,
                                                           op="ServeEngine")
        guards.validate_probability(top_p, name="top_p", op="ServeEngine")
        guards.validate_temperature(temperature, op="ServeEngine")
        self.max_len = guards.validate_positive(max_len, name="max_len",
                                                op="ServeEngine")
        self.device = guards.resolve_device(device, op="ServeEngine")
        if scan_method is not None:
            if scan_method != "auto" and scan_method not in METHODS:
                raise ValueError(f"unknown scan_method {scan_method!r}; "
                                 f"expected one of {METHODS + ('auto',)}")
            cfg = dataclasses.replace(cfg, scan_method=scan_method)
        self.cfg = cfg
        self.params = grid_params(cfg, params, mesh)
        self.mesh = mesh
        self.top_p = top_p
        self.temperature = temperature
        self.model = build_model(cfg)

    def _sample(self, logits: torch.Tensor, generator, u) -> torch.Tensor:
        return sample_tokens(self.sampler, logits, u, generator, mesh=self.mesh,
                             top_p=self.top_p, temperature=self.temperature,
                             bits_per_pass=self.bits_per_pass)

    @torch.inference_mode()
    def sample_packed(self, packed: SegmentedBatch,
                      generator: Optional[torch.Generator] = None, *,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Top-p sample every segment of a packed ragged batch of logit rows.

        Args:
            packed: Per-request logit slices as segments (rows may differ in
                length, e.g. per-request vocabulary masks; empties allowed).
            generator: Source of the uniforms when ``u`` is not given.
            u: Optional ``(num_segments, 1)`` uniforms.

        Returns:
            ``(num_segments,)`` int32 segment-local token ids, with no padding
            to the longest row.
        """
        return segment_top_p_sample(packed, None, generator, p=self.top_p,
                                    temperature=self.temperature,
                                    bits_per_pass=self.bits_per_pass, u=u)

    @torch.inference_mode()
    def generate(self, batch: Dict, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None, *,
                 eos_id: Optional[int] = None, sync_every: int = 8,
                 uniforms=None) -> torch.Tensor:
        """Generate up to ``max_new_tokens`` tokens per row.

        Args:
            batch: Model inputs including ``"tokens"`` of shape (B, S), and the
                family's stub embeddings (``"enc_embed"``, ``"img_embed"``),
                moved to the engine's device.
            max_new_tokens: Number of tokens to decode (>= 0).
            generator: Source of the sampler's uniforms (on the engine's
                device) when ``uniforms`` is not given.
            eos_id: Optional end-of-sequence id; rows that emit it keep
                emitting it, and decoding stops once every row has finished.
            sync_every: How often (in tokens) the all-rows-done mask is read
                on the host when ``eos_id`` is set.  The returned tokens are
                the same for every ``sync_every >= 1``.
            uniforms: Optional ``(max_new_tokens, B)`` uniforms, one row per
                sampled token.

        Returns:
            ``(B, new_tokens)`` int32 on the engine's device.

        Raises:
            ValueError: If ``max_new_tokens`` is negative, ``sync_every`` is
                not positive, ``uniforms`` has the wrong shape, or the request
                overflows the KV budget (``prompt_len + cache_offset +
                max_new_tokens > max_len``, the offset a VLM's
                ``n_img_tokens``).
        """
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        tokens = batch["tokens"]
        b, s = tokens.shape
        off = self.cfg.n_img_tokens if self.cfg.family == "vlm" else 0
        if max_new_tokens < 0:
            raise ValueError(
                f"generate: max_new_tokens must be >= 0, got {max_new_tokens}")
        sync_every = guards.validate_positive(sync_every, name="sync_every",
                                              op="generate")
        if s + off + max_new_tokens > self.max_len:
            raise ValueError(
                f"generate: prompt ({s} tokens) + cache offset ({off}) + "
                f"max_new_tokens ({max_new_tokens}) = {s + off + max_new_tokens} "
                f"overflows the KV cache budget (max_len={self.max_len}); raise "
                "max_len= at engine construction or shorten the request")
        if max_new_tokens == 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        if uniforms is not None:
            uniforms = torch.as_tensor(uniforms, dtype=torch.float32,
                                       device=self.device)
            if tuple(uniforms.shape) != (max_new_tokens, b):
                raise ValueError(f"generate: uniforms must be ({max_new_tokens}, "
                                 f"{b}), got {tuple(uniforms.shape)}")

        grid = _grid(self.mesh)
        dp = sharding.dp_axes(grid) if grid is not None else None
        split = dp is not None and grid.size_of(dp) > 1 and b % grid.size_of(dp) == 0
        if split:
            per = b // grid.size_of(dp)
            lo = grid.index_of(dp) * per
            batch = {k: v[lo:lo + per] for k, v in batch.items()}
            if uniforms is not None:
                uniforms = uniforms[:, lo:lo + per]
        with sharding.use_mesh(grid):
            res = self._generate_rows(batch, max_new_tokens, generator, eos_id,
                                      sync_every, uniforms, s + off)
        if split:
            if eos_id is not None and res.shape[1] < max_new_tokens:
                pad = torch.full((res.shape[0], max_new_tokens - res.shape[1]), eos_id,
                                 dtype=res.dtype, device=res.device)
                res = torch.cat([res, pad], dim=1)
            parts = comm.all_gather(res, grid.group(dp))
            res = parts.reshape(b, res.shape[1])
        return _trim_finished(res, eos_id)

    def _generate_rows(self, batch, max_new_tokens, generator, eos_id, sync_every,
                       uniforms, pos):
        """Prefill and decode of this rank's rows, untrimmed: ``(rows, new)``,
        fewer columns when every row emitted ``eos_id`` early."""
        def u_at(i):
            return None if uniforms is None else uniforms[i][:, None]

        logits, caches = self.model.prefill(self.params, batch, cache_len=self.max_len)
        tok = self._sample(logits, generator, u_at(0))
        done = (tok == eos_id) if eos_id is not None else None
        out = [tok]
        for i in range(max_new_tokens - 1):
            if done is not None and i % sync_every == 0 and bool(done.all()):
                break  # every row emitted eos_id
            guards.guard_check(lambda: pos + i < self.max_len,
                               "decode: pos must stay below max_len (the KV cache "
                               "budget) — raise max_len= at engine construction")
            logits, caches = self.model.decode_step(self.params, tok[:, None],
                                                    caches, pos + i)
            tok = self._sample(logits, generator, u_at(i + 1))
            if done is not None:
                tok = torch.where(done, torch.full_like(tok, eos_id), tok)
                done = done | (tok == eos_id)
            out.append(tok)
        return torch.stack(out, dim=1)


def _trim_finished(res: torch.Tensor, eos_id) -> torch.Tensor:
    """Drop the columns decoded after every row had emitted ``eos_id``, so the
    result does not depend on ``sync_every``."""
    if eos_id is not None and res.shape[1] > 1:
        col_done = torch.cummax((res == eos_id).to(torch.int32), dim=1)
        hits = torch.nonzero(col_done.values.all(dim=0))
        if hits.numel():
            res = res[:, :int(hits[0, 0]) + 1]
    return res

"""Continuous-batching scheduler: FCFS admission, paged KV, ticks of decode steps.

Port of ``repro/serving/scheduler.py``.  ``ContinuousEngine.run(requests)``
serves a ragged trace of variable-length requests through a fixed decode
batch of ``max_batch`` rows:

* **admission**: strict FCFS over arrived requests.  A request is admitted
  when a batch row is free and the :class:`~repro_torch.serving.paged_kv.
  PageAllocator` can cover ``prompt + max_new_tokens`` positions; the head of
  the queue is never bypassed, so admission order replays under page pressure;
* **prefill**: each admitted request prefills alone (batch 1) into
  ``m * page_size`` positions, and its dense cache is scattered into its ``m``
  pages;
* **decode**: the running rows step together in ticks of ``tick_tokens``
  eager decode steps on device tensors.  Every tick runs all its steps (rows
  that are done keep stepping with their position frozen, writing only their
  own last slot or the scratch page); the step after which every row was done
  is found on the device, and the host reads the tick's results once, so a
  tick costs one host sync where the JAX package's ``lax.while_loop`` costs
  one;
* **eviction**: rows that emit their eos or exhaust their budget release
  their pages at the tick boundary, their page table cleared to the scratch
  page before the pages can be handed out again, and the row is refilled FCFS.

The virtual clock (``steps``) advances by the JAX loop's step count, the
first step after which every row is done or ``tick_tokens``, so the schedule
and every statistic of ``run``'s result equal the JAX engine's for the same
trace.

**Randomness.**  A JAX :class:`Request` carries a PRNG key; here it carries a
``seed`` and optional ``uniforms`` of shape ``(max_new_tokens,)``.  At
admission the request's whole uniform stream is drawn in one call from a
``torch.Generator`` on the engine's device seeded with ``seed`` (or taken from
``uniforms``) and consumed one uniform a sampled token, the first by the
prefill's sample.  A solo :meth:`ServeEngine.generate
<repro_torch.serving.engine.ServeEngine.generate>` given the same stream as
``uniforms[:, None]`` and ``max_len = n_blocks * page_size`` (equal attention
length) emits the same tokens, as far as the model's GEMMs give a row the same
bits at batch 1 and at ``max_batch``.

``count_while_loops`` and ``decode_n_jaxpr`` are JAX tracing tools and are
not ported; the host syncs a tick take their place as the measure of how the
tick is staged.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import guards
from repro_torch.models.model import build_model
from repro_torch.models.transformer import ATTENTION_KINDS, layer_pattern
from repro_torch.serving import paged_kv
from repro_torch.serving.engine import grid_params, sample_tokens
from repro_torch.utils import sharding

__all__ = ["Request", "RequestState", "poisson_trace", "ContinuousEngine"]


@dataclasses.dataclass
class Request:
    """One serving request.

    ``seed`` seeds the request's own uniform stream (see the module's
    docstring); ``uniforms``, when given, is that stream, ``(max_new_tokens,)``
    float32.  ``arrival_step`` is in virtual decode steps.
    """
    rid: str
    tokens: np.ndarray
    max_new_tokens: int
    seed: int = 0
    eos_id: Optional[int] = None
    arrival_step: int = 0
    uniforms: Optional[np.ndarray] = None


@dataclasses.dataclass
class RequestState:
    """Scheduler-side state of an admitted request."""
    request: Request
    slot: int
    page_ids: np.ndarray
    admit_step: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_step: Optional[int] = None


def poisson_trace(n_requests: int, *, rate: float, vocab_size: int, seed: int,
                  prompt_len=(4, 12), max_new=(2, 8),
                  eos_id: Optional[int] = None) -> List[Request]:
    """Synthetic Poisson arrival trace (deterministic in ``seed``).

    Inter-arrival gaps are exponential with mean ``1/rate`` (in virtual decode
    steps); prompt lengths and decode budgets are uniform over the given
    inclusive ranges.  The arrivals, prompts and budgets are the JAX package's
    for the same arguments; request ``i`` gets ``seed * 7919 + i``, the number
    the JAX trace makes its key from.
    """
    guards.validate_positive(n_requests, name="n_requests", op="poisson_trace")
    rng = np.random.default_rng(seed)
    arrivals = np.floor(np.cumsum(rng.exponential(1.0 / rate,
                                                  n_requests))).astype(int)
    reqs = []
    for i in range(n_requests):
        s = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        n = int(rng.integers(max_new[0], max_new[1] + 1))
        toks = rng.integers(0, vocab_size, size=s).astype(np.int32)
        reqs.append(Request(rid=f"req{i}", tokens=toks, max_new_tokens=n,
                            seed=seed * 7919 + i, eos_id=eos_id,
                            arrival_step=int(arrivals[i])))
    return reqs


class ContinuousEngine:
    """Continuous-batching engine over a paged KV cache.

    Restricted to attention-only decoder stacks (dense, local, global and moe
    layers, JAX's ``_KINDS``): the paged layout pages the attention time
    axis, and recurrent state (SSM, xLSTM), MLA latents and cross-attention
    caches have no page-table form, so those stacks are refused at
    construction.  ``alloc_method`` is the allocator's
    ``compress`` method (``"kernel"``: one B5 launch an allocation).  The
    engine runs on the card unless it is given ``device="cpu"``.

    ``mesh=`` is a bare process group (``topp_sharded`` samples the vocab over
    it) or a grid (``utils.sharding.Grid``): the prefills and decode steps then
    run under ``use_mesh(grid)`` as JAX's do, the MoE layers expert-parallel
    (each rank holds its block of the experts) and ``topp_sharded`` over the
    grid's ``"model"`` group.  The schedule is host logic that every rank runs
    alike, so a data axis does not split the rows: each data rank runs every
    row.  (JAX splits a batch-1 prefill's tokens over its data axes; the two
    differ only where a MoE layer's group-local capacity drops assignments.)
    """

    SAMPLERS = ("greedy", "topp_scan", "topp_sharded", "topp_xla")

    def __init__(self, cfg, params, *, mesh=None, max_batch: int = 4,
                 page_size: int = 8, n_pages: int = 64,
                 max_len: Optional[int] = None, top_p: float = 0.9,
                 temperature: float = 1.0, sampler: str = "greedy",
                 bits_per_pass: int = 4, tick_tokens: int = 8,
                 alloc_method: str = "auto", device=None):
        op = "ContinuousEngine"
        self.sampler = guards.validate_choice(sampler, self.SAMPLERS,
                                              name="sampler", op=op)
        guards.validate_probability(top_p, name="top_p", op=op)
        guards.validate_temperature(temperature, op=op)
        self.bits_per_pass = guards.validate_bits_per_pass(bits_per_pass, op=op)
        self.max_batch = guards.validate_positive(max_batch, name="max_batch", op=op)
        self.page_size = guards.validate_positive(page_size, name="page_size", op=op)
        self.tick_tokens = guards.validate_positive(tick_tokens, name="tick_tokens",
                                                    op=op)
        kinds = set(layer_pattern(cfg))
        if cfg.family not in ("decoder", "moe") or not kinds <= ATTENTION_KINDS:
            raise ValueError(
                f"{op}: {cfg.name!r} (family={cfg.family!r}, pattern={sorted(kinds)}) "
                "is not an attention-only decoder stack — the paged KV layout pages "
                "the attention time axis only; serve it with the dense ServeEngine "
                "instead")
        self.device = guards.resolve_device(device, op=op)
        self.alloc_method = alloc_method
        self.alloc = paged_kv.PageAllocator(n_pages, method=alloc_method,
                                            device=self.device)
        self.n_pages = self.alloc.n_pages
        if max_len is None:
            max_len = self.alloc.capacity * self.page_size
        self.max_len = guards.validate_positive(max_len, name="max_len", op=op)
        self.n_blocks = paged_kv.pages_needed(self.max_len, self.page_size)
        self.top_p = top_p
        self.temperature = temperature
        self.cfg = cfg
        self.params = grid_params(cfg, params, mesh)
        self.mesh = mesh
        self._grid = mesh if isinstance(mesh, sharding.Grid) else None
        self.model = build_model(cfg)
        self.caches = paged_kv.build_paged_caches(
            self.model, self.max_batch, self.n_pages, self.page_size, self.n_blocks,
            device=self.device)
        self._reset_rows()

    # ---- per-row decode state, on the device ----
    def _reset_rows(self) -> None:
        """Every row idle: done, at position 0, with nothing left to emit."""
        b, dev = self.max_batch, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self._tok = torch.zeros(b, **i32)
        self._pos = torch.zeros(b, dtype=torch.int64, device=dev)
        self._done = torch.ones(b, dtype=torch.bool, device=dev)
        self._rem = torch.zeros(b, **i32)
        self._eos = torch.full((b,), -1, **i32)
        self._budget = torch.zeros(b, dtype=torch.int64, device=dev)
        self._u = torch.zeros((b, self.max_len), dtype=torch.float32, device=dev)

    # ---- sampling: every row at once, each with its own uniform ----
    def _sample_rows(self, logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One token a row, row ``r`` from the uniform ``u[r, 0]``: the sampler
        that a solo ``ServeEngine`` of that row runs."""
        return sample_tokens(self.sampler, logits, u, mesh=self.mesh, top_p=self.top_p,
                             temperature=self.temperature,
                             bits_per_pass=self.bits_per_pass).to(torch.int32)

    def _uniforms(self, req: Request) -> torch.Tensor:
        """The request's whole uniform stream, ``(max_new_tokens,)`` on the device."""
        if req.uniforms is not None:
            return torch.as_tensor(np.asarray(req.uniforms, np.float32),
                                   device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(int(req.seed))
        return torch.rand((req.max_new_tokens,), generator=gen, device=self.device,
                          dtype=torch.float32)

    # ---- prefill (one request alone, batch 1) ----
    def _prefill(self, toks: np.ndarray, u0: torch.Tensor, cache_len: int):
        tokens = torch.as_tensor(toks, device=self.device)[None, :]
        with sharding.use_mesh(self._grid):
            logits, dense = self.model.prefill(self.params, {"tokens": tokens},
                                               cache_len=cache_len)
        return self._sample_rows(logits, u0.reshape(1, 1))[0], dense

    # ---- one tick: up to n_steps decode steps ----
    def _decode_n(self, n_steps: int):
        """``n_steps`` decode steps of every row; returns the host's copy of
        ``(out (B, n_steps), steps, done (B,), rem (B,))`` after one sync.

        ``steps`` is the JAX loop's count: the first step after which every
        row was done, else ``n_steps``.  A done row keeps stepping with its
        position, remaining budget and uniform frozen, and emits its eos (0
        without one) into the slots that the caller does not harvest.  Under
        ``REPRO_CHECKS=1`` (or ``guards.checks()``) it first asserts that no
        running row would write past its page budget (one host read); with
        checks off that adds nothing.
        """
        cap = self.n_blocks * self.page_size
        guards.guard_check(
            lambda: torch.all(torch.where(
                self._done, 0, self._pos + torch.clamp(self._rem, max=n_steps)) <= cap),
            "decode_n: a row's write positions would overrun its page budget "
            "(n_blocks * page_size) — admission must bound prompt + max_new_tokens "
            "by max_len")
        b = self.max_batch
        out = torch.zeros((b, n_steps), dtype=torch.int32, device=self.device)
        steps = torch.full((), n_steps, dtype=torch.int32, device=self.device)
        tok, pos, done, rem = self._tok, self._pos, self._done, self._rem
        eos = self._eos
        last = self._u.shape[1] - 1
        for i in range(n_steps):
            with sharding.use_mesh(self._grid):
                logits, self.caches = self.model.decode_step(self.params, tok[:, None],
                                                             self.caches, pos)
            idx = torch.clamp(self._budget - rem, max=last)
            u = torch.gather(self._u, 1, idx[:, None])
            new = self._sample_rows(logits, u)
            new = torch.where(done, torch.clamp(eos, min=0), new)
            out[:, i] = new
            rem = torch.where(done, rem, rem - 1)
            done2 = done | ((new == eos) & (eos >= 0)) | (rem <= 0)
            pos = torch.where(done2, pos, pos + 1)
            steps = torch.where((steps == n_steps) & done2.all(),
                                torch.full_like(steps, i + 1), steps)
            tok, done = new, done2
        self._tok, self._pos, self._done, self._rem = tok, pos, done, rem
        host = torch.cat([out.reshape(-1), steps.reshape(1), done.to(torch.int32),
                          rem]).cpu().numpy()                       # the tick's one sync
        k = b * n_steps
        return (host[:k].reshape(b, n_steps), int(host[k]),
                host[k + 1:k + 1 + b].astype(bool), host[k + 1 + b:])

    # ---- request validation (eager: fail before touching the model) ----
    def _validate(self, req: Request) -> np.ndarray:
        toks = np.asarray(req.tokens, np.int32)
        if toks.ndim != 1 or toks.size == 0:
            raise ValueError(f"run: request {req.rid!r} has a zero-length or "
                             f"non-1D prompt (shape {toks.shape}) — every "
                             "request needs at least one prompt token")
        if req.max_new_tokens < 1:
            raise ValueError(f"run: request {req.rid!r} asks for "
                             f"{req.max_new_tokens} tokens; continuous "
                             "batching serves requests with "
                             "max_new_tokens >= 1")
        total = toks.size + req.max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"run: request {req.rid!r} needs {total} positions "
                f"(prompt {toks.size} + max_new_tokens "
                f"{req.max_new_tokens}) > max_len={self.max_len} — it can "
                "never be admitted; raise max_len/n_pages or shorten it")
        if paged_kv.pages_needed(total, self.page_size) > self.alloc.capacity:
            raise ValueError(
                f"run: request {req.rid!r} needs "
                f"{paged_kv.pages_needed(total, self.page_size)} pages > "
                f"pool capacity {self.alloc.capacity}")
        if req.uniforms is not None and np.shape(req.uniforms) != (req.max_new_tokens,):
            raise ValueError(f"run: request {req.rid!r} has uniforms of shape "
                             f"{np.shape(req.uniforms)}; expected "
                             f"({req.max_new_tokens},), one a sampled token")
        return toks

    # ---- the run loop ----
    @torch.inference_mode()
    def run(self, requests: Sequence[Request], *, max_ticks: int = 100_000) -> Dict:
        """Serve ``requests`` to completion; returns streams and schedule stats.

        One host sync a decode tick, plus those of each admission (the
        allocator's pick and the prefill's first token).  Replaying the same
        trace on the same engine gives the identical result dict (virtual
        clock, FCFS admission, lowest-page-first allocation).
        """
        reqs = [(self._validate(r), r) for r in requests]
        order = sorted(range(len(reqs)), key=lambda i: (reqs[i][1].arrival_step, i))
        queue = collections.deque(reqs[i] for i in order)

        b = self.max_batch
        # reset page tables: stale tables from a previous run must not alias
        # freshly allocated pages
        for r in range(b):
            paged_kv.clear_page_table(self.caches, r)
        self.alloc = paged_kv.PageAllocator(self.n_pages, method=self.alloc_method,
                                            device=self.device)
        self._reset_rows()

        slots: List[Optional[RequestState]] = [None] * b
        rem = np.zeros(b, np.int32)
        step = 0
        ticks = 0
        finished: List[RequestState] = []

        def admit(toks_np, req):
            total = toks_np.size + req.max_new_tokens
            m = paged_kv.pages_needed(total, self.page_size)
            slot = next((i for i, s in enumerate(slots) if s is None), None)
            if slot is None:
                return False
            pages = self.alloc.alloc(m)
            if pages is None:
                return False
            u = self._uniforms(req)
            t0, dense = self._prefill(toks_np, u[:1], m * self.page_size)
            paged_kv.insert_request(self.caches, dense, slot, pages)
            st = RequestState(request=req, slot=slot, page_ids=pages,
                              admit_step=step, tokens=[int(t0)])
            e = -1 if req.eos_id is None else int(req.eos_id)
            if (e >= 0 and st.tokens[0] == e) or req.max_new_tokens <= 1:
                st.finish_step = step
                self.alloc.release(pages)
                paged_kv.clear_page_table(self.caches, slot)
                finished.append(st)
                return True
            slots[slot] = st
            self._tok[slot] = t0
            self._pos[slot] = toks_np.size
            self._done[slot] = False
            self._rem[slot] = req.max_new_tokens - 1
            self._eos[slot] = e
            self._budget[slot] = req.max_new_tokens
            self._u[slot, :req.max_new_tokens] = u
            rem[slot] = req.max_new_tokens - 1
            return True

        while queue or any(s is not None for s in slots):
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"run: exceeded max_ticks={max_ticks} — "
                                   "scheduler is not draining")
            # strict FCFS admission of arrived requests
            while queue and queue[0][1].arrival_step <= step:
                if not admit(*queue[0]):
                    break
                queue.popleft()
            if all(s is None for s in slots):
                if queue:       # idle: fast-forward to the next arrival
                    step = max(step, queue[0][1].arrival_step)
                continue

            rem_before = rem.copy()
            out, nsteps, done, rem = self._decode_n(self.tick_tokens)
            base = step
            step += nsteps
            for r, st in enumerate(slots):
                if st is None:
                    continue
                emitted = int(rem_before[r] - rem[r])
                st.tokens.extend(int(t) for t in out[r, :emitted])
                if done[r]:
                    st.finish_step = base + emitted
                    self.alloc.release(st.page_ids)
                    paged_kv.clear_page_table(self.caches, r)
                    finished.append(st)
                    slots[r] = None

        finished.sort(key=lambda st: (st.finish_step, st.request.rid))
        total_tokens = sum(len(st.tokens) for st in finished)
        return {
            "streams": {st.request.rid: np.asarray(st.tokens, np.int32)
                        for st in finished},
            "requests": {st.request.rid: {
                "arrival_step": st.request.arrival_step,
                "admit_step": st.admit_step,
                "finish_step": st.finish_step,
                "n_tokens": len(st.tokens),
                "latency_steps": st.finish_step - st.request.arrival_step,
                "per_token_latency_steps":
                    (st.finish_step - st.request.arrival_step)
                    / max(len(st.tokens), 1),
            } for st in finished},
            "stats": {
                "steps": step,
                "ticks": ticks,
                "total_tokens": total_tokens,
                "reqs": len(finished),
                "peak_pages": self.alloc.peak_in_use,
                "pool_capacity": self.alloc.capacity,
                "peak_util": self.alloc.peak_in_use / self.alloc.capacity,
            },
        }

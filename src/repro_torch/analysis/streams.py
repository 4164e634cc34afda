"""How far a sampled step lies from going another way: the divergence rule for
token streams whose logits differ in rounding.

A row decoded at batch 1 and the same row decoded inside a larger batch can
get logits that differ in their last bits, because a GEMM may sum in another
order for another number of rows (cuBLAS and the CPU BLAS both do).  Two such
streams may then part, but only at a step whose decision a change of the
logits that small can flip.  :func:`step_margin` measures that distance for
one step of a sampler, in logit units, from the logits of one of the two runs;
:func:`first_divergence` finds where two streams part.  A divergence is
explained when the step's margin is at most the measured logit difference.

:class:`DenseReplay` holds a ``ContinuousEngine``'s paged decode to the dense
decode path bit for bit, at the engine's own batch, so that no rounding
stands between the two.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.serving import paged_kv

__all__ = ["step_margin", "first_divergence", "DenseReplay"]


def first_divergence(a, b) -> Optional[int]:
    """The first index where the token streams ``a`` and ``b`` differ, or None."""
    a, b = np.asarray(a), np.asarray(b)
    n = min(a.size, b.size)
    diff = np.nonzero(a[:n] != b[:n])[0]
    if diff.size:
        return int(diff[0])
    return None if a.size == b.size else n


def step_margin(logits: torch.Tensor, u: float, *, sampler: str, top_p: float = 0.9,
                temperature: float = 1.0, other: Optional[int] = None) -> float:
    """The least max-abs change of ``logits`` (one row) that can change the token.

    * ``"greedy"``: half the gap between the two largest logits.
    * top-p (``"topp_scan"``, ``"topp_sharded"``; ``"topp_xla"`` sorts the fp32
      probabilities instead of their bf16 keys): a change of at most ``d`` in
      every logit moves every probability by a factor within ``e^{±2d}``, so
      every partial sum of the sorted probabilities, the cut's preceding masses
      and ``theta = u * mass`` each by at most ``e^{2d} - 1 ~ 2d`` of the total.
      The margin is a quarter of the least distance, in probability, between
      ``theta`` and a CDF step of the nucleus, or between ``top_p`` and a
      token's preceding mass; and where ``other`` is given, a quarter of the log
      ratio of the probabilities of the token sampled here and ``other`` (two
      near-equal tokens may change places in the sort).

    Computed in fp64 from the logits given.
    """
    lg = logits.detach().to(torch.float64).cpu().reshape(-1)
    if sampler == "greedy":
        top = torch.topk(lg, 2).values
        return float(top[0] - top[1]) / 2
    probs = torch.softmax(lg / temperature, dim=-1)
    if sampler == "topp_xla":
        keys = probs.to(torch.float32)
    else:
        keys = probs.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    order = torch.sort(keys, descending=True, stable=True).indices
    sp = probs[order].numpy()
    cum = np.cumsum(sp)
    before = cum - sp
    kept = max(int(np.count_nonzero(before <= top_p)), 1)
    theta = u * cum[kept - 1]
    d = min(float(np.min(np.abs(cum[:kept] - theta))),
            float(np.min(np.abs(before - top_p))))
    margin = d / 4
    if other is not None:
        j = int(np.searchsorted(cum[:kept], theta, "left"))
        mine = int(order[min(j, kept - 1)])
        pa, pb = float(probs[mine]), float(probs[int(other)])
        if pa > 0 and pb > 0:
            margin = min(margin, abs(math.log(pa / pb)) / 4)
    return margin


class DenseReplay:
    """Repeats a ``ContinuousEngine``'s decode steps on a dense cache of its own.

    Used as a context manager around ``engine.run``.  Each request that the
    engine inserts into its pages is also copied, from the same prefill cache,
    into row ``slot`` of a dense ``(max_batch, n_blocks * page_size)`` cache;
    each decode step is recorded (tokens, per-row positions, logits and which
    rows hold a request) and later repeated on the dense cache through the
    model's dense ``decode_step``.  The dense cache is fed only from the
    prefills and its own decode writes, so a page read that is stale or wrong,
    or a page written by another row, shows as a difference.  Equal attention
    length and equal batch give equal bits, so every row that holds a request
    must get the same logits from both (``bit_equal``; ``max_abs_diff`` is the
    largest difference).

    The repeat runs outside the engine's ticks (before the next insertion and
    on exit), and compares on the device, so a tick's work and host syncs are
    the engine's own.  While active it replaces ``paged_kv.insert_request``
    and the engine model's ``decode_step``.
    """

    def __init__(self, engine):
        self.eng = engine
        self.dense = engine.model.empty_caches(
            engine.max_batch, engine.n_blocks * engine.page_size, device=engine.device)
        self.pending = []
        self.steps = 0
        self._rows = torch.zeros((), dtype=torch.int64, device=engine.device)
        self._diff = torch.zeros((), dtype=torch.float32, device=engine.device)
        self._unequal = torch.zeros((), dtype=torch.bool, device=engine.device)

    def __enter__(self):
        self._insert, self._step = paged_kv.insert_request, self.eng.model.decode_step
        paged_kv.insert_request = self._on_insert
        self.eng.model.decode_step = self._on_step
        return self

    def __exit__(self, *exc):
        paged_kv.insert_request = self._insert
        del self.eng.model.decode_step
        if exc[0] is None:
            self._flush()
        return False

    def _on_insert(self, caches, dense, row, page_ids):
        self._flush()

        def copy(dst, src):                  # every {"k", "v"} leaf of the caches
            for key, val in src.items():
                if isinstance(val, dict):
                    copy(dst[key], val)
                else:
                    dst[key][:, row, :val.shape[2]] = val[:, 0]

        copy(self.dense, dense)
        return self._insert(caches, dense, row, page_ids)

    def _on_step(self, params, tokens, caches, pos):
        logits, caches = self._step(params, tokens, caches, pos)
        # every layer holds the same page table; page 0: no request
        held = caches["stack"]["sub0"]["pages"][0, :, 0] != 0
        self.pending.append((tokens, pos, logits, held))
        return logits, caches

    def _flush(self):
        for tokens, pos, logits, held in self.pending:
            ref, self.dense = self._step(self.eng.params, tokens, self.dense, pos)
            rows = held[:, None]
            self._diff = torch.maximum(
                self._diff, torch.where(rows, (logits - ref).abs(), 0).amax().float())
            self._unequal |= ((logits != ref) & rows).any()
            self._rows += held.sum()
        self.steps += len(self.pending)
        self.pending = []

    def result(self) -> dict:
        """``steps`` repeated, ``row_steps`` compared, ``bit_equal`` and
        ``max_abs_diff`` (NaN when either side gave a NaN)."""
        diff = float(self._diff)
        return {"steps": self.steps, "row_steps": int(self._rows),
                "bit_equal": not bool(self._unequal) and diff == 0.0,
                "max_abs_diff": diff}

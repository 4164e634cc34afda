"""Deterministic, restart-safe data pipeline: the port's own copy.

Port of ``repro/data/pipeline.py``, which is numpy on the host: the same code,
so a batch is bit-equal to the JAX package's for the same ``(seed, step,
shard)``; the trainer moves it to the device.

Batches are a pure function of ``(seed, step, shard)`` — a restarted or elastically
resized job replays the exact stream with no data loss or duplication (the Trainer
persists only the step counter in the checkpoint).  Two sources:

  * ``SyntheticLM``: a fixed-order Markov-ish token stream (structured enough for a
    ~100M model to visibly learn within a few hundred steps);
  * ``ByteCorpus``: byte-level tokens from a text file, chunked deterministically;
  * ``PackedSyntheticLM``: the packed-sequence mode — variable-length documents
    packed back to back into one fixed token budget with CSR-style offsets, the
    layout the segmented-scan subsystem (``repro_torch.core.segmented``) consumes.

Host-side prefetch keeps ``prefetch`` batches in flight (overlap input with step).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Sequence

import numpy as np


def pack_ragged(seqs: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    """Pack variable-length token sequences into CSR-style (values, offsets).

    Returns ``{"tokens": (n,), "offsets": (len(seqs)+1,), "segment_ids": (n,)}``
    — the host-side mirror of ``repro_torch.core.segmented.SegmentedBatch`` (empty
    sequences become repeated offsets).
    """
    arrs = [np.asarray(s).reshape(-1) for s in seqs]
    lens = np.asarray([a.shape[0] for a in arrs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    tokens = (np.concatenate(arrs) if arrs and offsets[-1]
              else np.zeros((0,), np.int32))
    seg_ids = np.repeat(np.arange(len(arrs), dtype=np.int32), lens)
    return {"tokens": tokens.astype(np.int32), "offsets": offsets,
            "segment_ids": seg_ids}


class SyntheticLM:
    """Deterministic synthetic language: a noisy affine bigram chain.

    ``x[t+1] = (a·x[t] + c) mod V`` with fixed (a, c); 10% of tokens are replaced
    by noise (and the chain continues from the observed token), so next-token is
    a *bigram* function predictable 90% of the time — CE drops toward
    ``0.1·ln(V) + H(0.9/0.1)`` within tens of steps once the model learns the
    token map, giving a cheap end-to-end training signal.
    """

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, a: int = 5, c: int = 17):
        self.vocab = int(vocab_size)
        self.seq = int(seq_len)
        self.batch = int(batch_size)
        self.seed = int(seed)
        self.a, self.c = a, c

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1) -> Dict:
        rows = self.batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        toks = np.empty((rows, self.seq), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, rows)
        noise = rng.random((rows, self.seq)) < 0.1
        rand = rng.integers(0, self.vocab, (rows, self.seq))
        for t in range(1, self.seq):
            nxt = (self.a * toks[:, t - 1] + self.c) % self.vocab
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PackedSyntheticLM:
    """Packed variable-length batches: ragged documents in one fixed budget.

    Every batch holds exactly ``tokens_per_batch // num_shards`` tokens split
    into ``num_docs`` variable-length documents (CSR offsets; empty documents
    are legal and do occur) — the continuous-batching / packed-pretraining
    layout, sharded over the token budget like the sibling sources shard over
    rows.
    Each document is an independent ``SyntheticLM``-style affine bigram chain
    restarting at its boundary, and batches are a pure function of
    ``(seed, step, shard)`` like every other source here, so shapes are static
    under jit while the segment layout stays ragged.
    """

    def __init__(self, vocab_size: int, tokens_per_batch: int, num_docs: int,
                 seed: int = 0, a: int = 5, c: int = 17):
        assert num_docs >= 1 and tokens_per_batch >= 1
        self.vocab = int(vocab_size)
        self.budget = int(tokens_per_batch)
        self.num_docs = int(num_docs)
        self.seed = int(seed)
        self.a, self.c = a, c

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1) -> Dict:
        budget = max(self.budget // num_shards, 1)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        cuts = np.sort(rng.integers(0, budget + 1, self.num_docs - 1))
        offsets = np.concatenate([[0], cuts, [budget]]).astype(np.int32)
        lens = offsets[1:] - offsets[:-1]
        # one row-vectorized chain per document (as SyntheticLM does across
        # batch rows), packed afterwards — no per-token Python loop
        width = int(lens.max())
        rows = np.empty((self.num_docs, width), np.int64)
        noise = rng.random((self.num_docs, width)) < 0.1
        rand = rng.integers(0, self.vocab, (self.num_docs, width))
        rows[:, 0] = rand[:, 0]                        # fresh chain per doc
        for t in range(1, width):
            nxt = (self.a * rows[:, t - 1] + self.c) % self.vocab
            rows[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        toks = rows[np.arange(width)[None, :] < lens[:, None]]
        seg_ids = np.repeat(np.arange(self.num_docs, dtype=np.int32), lens)
        return {"tokens": toks.astype(np.int32), "offsets": offsets,
                "segment_ids": seg_ids}

    def __iter__(self) -> Iterator[Dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ByteCorpus:
    """Byte-level LM batches from a local file, deterministic in (seed, step)."""

    def __init__(self, path: str, seq_len: int, batch_size: int, seed: int = 0):
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8)
        assert len(self.data) > seq_len + 1, "corpus too small"
        self.seq = seq_len
        self.batch = batch_size
        self.seed = seed

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1) -> Dict:
        rows = self.batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        starts = rng.integers(0, len(self.data) - self.seq - 1, rows)
        toks = np.stack([self.data[s:s + self.seq] for s in starts])
        return {"tokens": toks.astype(np.int32)}


class Prefetcher:
    """Background-thread prefetch of ``source.batch_at(step)``."""

    def __init__(self, source, start_step: int = 0, prefetch: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.source.batch_at(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def stop(self):
        self._stop.set()

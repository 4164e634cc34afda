"""Paged KV cache for continuous batching.

Port of ``repro/serving/paged_kv.py``.  The dense serving path gives every row
a rectangular ``(max_len, K, D)`` cache whether its request uses it or not.
Here the time axis is cut into ``page_size`` blocks drawn from a shared pool:

* one ``(n_pages, page_size, K, D)`` pool for k and one for v a layer, stacked
  over the layers as the dense caches are (``{"stack": {"sub{i}": {"k", "v",
  "pages"}}}``, and ``"pre"`` for a MoE stack's leading dense layers);
* a ``"pages"`` leaf of ``(n_layers, B, n_blocks)`` int32 beside them: each
  row's page table, mapping logical block ``t // page_size`` to a pool page
  (the same table in every layer);
* a free-list allocator that picks the lowest free page ids with the paper's
  ``compress`` over the free mask.

Page 0 is reserved scratch: it is never handed out, every unassigned table
entry points at it, and idle rows of the decode batch write their discarded
k/v there without touching live pages.

The paged layout is a layout, not another attention: gathering a row's pages
back along time gives the dense ``(B, T, K, D)`` view, so at equal attention
length paged and dense decode agree bit for bit (``gather_dense`` and the
parity tests pin it).  Unlike the JAX package's functional updates,
``with_page_table``, ``clear_page_table`` and ``insert_request`` write the
caches in place and return them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import guards
from repro_torch.core.primitives import compress

__all__ = ["pages_needed", "PageAllocator", "build_paged_caches", "with_page_table",
           "clear_page_table", "insert_request", "gather_dense"]


def pages_needed(tokens: int, page_size: int) -> int:
    """Number of ``page_size`` blocks covering ``tokens`` positions."""
    return -(-tokens // page_size)


def _is_kv(node) -> bool:
    return isinstance(node, dict) and set(node) == {"k", "v"}


def _is_paged(node) -> bool:
    return isinstance(node, dict) and set(node) == {"k", "v", "pages"}


class PageAllocator:
    """Host-side free list over the physical page pool.

    The free mask lives on the host (allocation is control-plane work between
    scheduler ticks), but page selection runs the paper's ``compress`` over
    ``arange(n_pages)`` on ``device``: pack the free page ids left and take the
    first ``n``, lowest id first, so replays are deterministic and the pool is
    used densely.  ``method="kernel"`` makes each :meth:`alloc` one launch of
    SplitInd (B5); ``device=None`` means ``"cuda"``.  ``calls`` counts the
    :meth:`alloc` calls and ``refused`` those that found too few free pages.
    """

    def __init__(self, n_pages: int, *, method: str = "auto", device=None):
        n_pages = guards.validate_positive(n_pages, name="n_pages", op="PageAllocator")
        if n_pages < 2:
            raise ValueError("PageAllocator: n_pages must be >= 2 (page 0 is "
                             "the reserved scratch page)")
        self.n_pages = n_pages
        self.method = method
        self.device = guards.resolve_device(device, op="PageAllocator")
        self.free = np.ones(n_pages, dtype=bool)
        self.free[0] = False                      # reserved scratch page
        self.peak_in_use = 0
        self.calls = self.refused = 0
        self._ids = torch.arange(n_pages, dtype=torch.int32, device=self.device)

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the reserved scratch page)."""
        return self.n_pages - 1

    @property
    def in_use(self) -> int:
        return self.capacity - int(self.free.sum())

    def alloc(self, n: int) -> Optional[np.ndarray]:
        """Take the ``n`` lowest free page ids, or None if they don't fit."""
        n = guards.validate_positive(n, name="n", op="PageAllocator.alloc")
        mask = torch.from_numpy(self.free).to(self.device)
        ids, count = compress(self._ids, mask, method=self.method)
        self.calls += 1
        if int(count) < n:
            self.refused += 1
            return None
        taken = ids[:n].cpu().numpy().copy()
        self.free[taken] = False
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return taken

    def release(self, ids) -> None:
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return
        if np.any(ids <= 0) or np.any(ids >= self.n_pages):
            raise ValueError(f"PageAllocator.release: page ids {ids.tolist()} "
                             f"outside the allocatable range [1, {self.n_pages})")
        if np.any(self.free[ids]):
            raise ValueError("PageAllocator.release: double free of pages "
                             f"{ids[self.free[ids]].tolist()}")
        self.free[ids] = True


def build_paged_caches(model, batch_size: int, n_pages: int, page_size: int,
                       n_blocks: int, *, device=None) -> Dict:
    """Zero paged decode caches matching ``model``'s dense cache structure.

    Every dense ``{"k", "v"}`` leaf of shape ``(*lead, B, clen, K, D)`` becomes
    ``{"k"/"v": (*lead, n_pages, page_size, K, D), "pages": (*lead, B,
    n_blocks)}``.  Raises for models whose caches are not attention k/v alone
    (the hybrid's SSM states): the paged layout pages the attention time axis
    only.  ``device=None`` means ``"cuda"``.
    """
    dev = guards.resolve_device(device, op="build_paged_caches")
    if getattr(model, "hybrid", False):
        raise ValueError(
            f"build_paged_caches: {model.cfg.name!r} keeps SSM state beside its "
            "attention caches, which is not an attention {k, v} pair — the paged "
            "KV layout supports attention-only decoders")
    tmpl = model.empty_caches(batch_size, page_size, device="meta")

    def walk(node, path):
        if _is_kv(node):
            *lead, b, _, kh, hd = node["k"].shape
            pool = (*lead, n_pages, page_size, kh, hd)
            return {"k": torch.zeros(pool, dtype=node["k"].dtype, device=dev),
                    "v": torch.zeros(pool, dtype=node["v"].dtype, device=dev),
                    "pages": torch.zeros((*lead, b, n_blocks), dtype=torch.int32,
                                         device=dev)}
        if isinstance(node, dict):
            return {key: walk(val, f"{path}/{key}") for key, val in node.items()}
        raise ValueError(
            f"build_paged_caches: cache leaf at {path!r} is not an attention "
            "{k, v} pair — the paged KV layout supports attention-only decoders")

    return walk(tmpl, "caches")


def with_page_table(caches, row: int, page_ids) -> Dict:
    """Set row ``row``'s page table in every layer, in place.

    ``page_ids``: 1-D ints, the pages of the row's leading blocks; the
    trailing table entries go back to the scratch page 0.
    """
    page_ids = np.asarray(page_ids, dtype=np.int32)

    def walk(node):
        if _is_paged(node):
            table = np.zeros(node["pages"].shape[-1], np.int32)
            table[:page_ids.size] = page_ids
            node["pages"][..., row, :] = torch.from_numpy(table).to(node["pages"].device)
            return
        for val in node.values():
            walk(val)

    walk(caches)
    return caches


def clear_page_table(caches, row: int) -> Dict:
    """Reset row ``row``'s page table to the scratch page (eviction), in place."""
    return with_page_table(caches, row, np.zeros(0, np.int32))


def insert_request(caches, dense_caches, row: int, page_ids) -> Dict:
    """Scatter a request's dense prefill cache into its pages, in place.

    ``dense_caches``: the model's dense caches for the request alone (batch 1)
    with ``cache_len == len(page_ids) * page_size``; leaf shapes ``(*lead, 1,
    m*page_size, K, D)``.  Also installs the row's page table.
    """
    page_ids = np.asarray(page_ids, dtype=np.int64)

    def walk(pn, dn):
        if _is_paged(pn):
            ps = pn["k"].shape[-3]
            ids = torch.from_numpy(page_ids).to(pn["k"].device)
            for name in ("k", "v"):
                leaf = dn[name]
                *lead, _, t, kh, hd = leaf.shape
                if t != page_ids.size * ps:
                    raise ValueError(
                        f"insert_request: dense cache length {t} != "
                        f"{page_ids.size} pages x page_size {ps}")
                blocks = leaf.reshape(*lead, page_ids.size, ps, kh, hd)
                pn[name][..., ids, :, :, :] = blocks.to(pn[name].dtype)
            return
        for key in pn:
            walk(pn[key], dn[key])

    walk(caches, dense_caches)
    return with_page_table(caches, row, page_ids)


def gather_dense(caches) -> Dict:
    """The dense ``(*lead, B, n_blocks*page_size, K, D)`` view of paged caches.

    A parity helper: the gathered view is exactly what ``attn_decode_paged``
    attends over, so comparing it with a dense cache checks the layout.
    """

    def gather(pool, pages):
        nlead = pages.dim() - 2
        lead = pages.shape[:nlead]
        pl = pool.reshape((-1,) + tuple(pool.shape[nlead:]))
        pg = pages.reshape((-1,) + tuple(pages.shape[nlead:])).to(torch.int64)
        out = torch.stack([p[t] for p, t in zip(pl, pg)])   # (lead*, B, nblk, ps, K, D)
        b, nblk, ps = out.shape[1], out.shape[2], out.shape[3]
        return out.reshape(tuple(lead) + (b, nblk * ps) + tuple(out.shape[4:]))

    def walk(node):
        if _is_paged(node):
            return {"k": gather(node["k"], node["pages"]),
                    "v": gather(node["v"], node["pages"])}
        return {key: walk(val) for key, val in node.items()}

    return walk(caches)

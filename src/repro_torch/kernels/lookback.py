"""The decoupled look-back of B1 and B9 (``csrc/lookback.cuh``), in plain PyTorch.

The kernels cut each row into tiles, one CTA a tile, and give tile ``j`` the
exclusive prefix of the tiles before it.  That prefix is the strict
left-to-right fold of the tiles' aggregates ``A_0 … A_{j-1}`` under the scan's
operator: the sum, or the segmented-pair operator ``c ⊕ a = a.h ? a.v :
c + a.v``.  On the card a tile starts its fold from the nearest predecessor
``k`` that has published its inclusive prefix ``P_k`` when it looks back, and
folds ``A_{k+1} … A_{j-1}`` onto it.  Each ``P_k`` is itself
``P_{k-1} ⊕ A_k``, so every such ``k`` gives the same chain of operations and
the same bits.  :func:`fold_exclusive` evaluates the fold under any such
schedule, so the tests can show it; :func:`workspace` allocates the kernels'
status words.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["fold_exclusive", "workspace"]


def _fold(c: torch.Tensor, v: torch.Tensor, h: Optional[torch.Tensor]) -> torch.Tensor:
    return c + v if h is None else torch.where(h, v, c + v)


def fold_exclusive(values: torch.Tensor, flags: Optional[torch.Tensor] = None,
                   stops: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Each tile's exclusive prefix, as the look-back folds it.

    Args:
        values: ``(b, T)`` tile aggregates, one row of tiles a row.
        flags: ``(b, T)`` bool, the aggregates' has-flag bits under the
            segmented operator; ``None`` for the plain sum.
        stops: For each tile ``j``, the predecessor ``k < j`` whose inclusive
            prefix it found published (``-1``: none, so it folds from the row
            start's 0); ``None`` takes ``j - 1`` everywhere.  Under the
            segmented operator the kernel may also stop at a flagged aggregate
            between ``k`` and ``j``; folding through it gives the same value.

    Returns:
        ``(b, T)`` exclusive prefixes; tile 0's is 0.
    """
    b, ntiles = values.shape
    zero = torch.zeros((b,), dtype=values.dtype, device=values.device)
    out = torch.empty_like(values)
    inclusive = []
    for j in range(ntiles):
        k = j - 1 if stops is None else int(stops[j])
        if not -1 <= k < j:
            raise ValueError(f"fold_exclusive: tile {j} cannot stop at {k}")
        c = inclusive[k] if k >= 0 else zero
        for i in range(k + 1, j):
            c = _fold(c, values[:, i], None if flags is None else flags[:, i])
        out[:, j] = c
        inclusive.append(_fold(c, values[:, j], None if flags is None else flags[:, j]))
    return out


def workspace(tiles: int, device) -> torch.Tensor:
    """The look-back's workspace for ``tiles`` tiles over all rows: one 8-byte
    status word a tile, then the tile counter.  The C entry point zeroes it on
    the launch's stream."""
    return torch.empty(tiles + 1, dtype=torch.int64, device=device)

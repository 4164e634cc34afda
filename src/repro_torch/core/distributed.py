"""MCScan — the paper's multi-core scan (Alg. 3) with a rank as the "core".

Port of ``repro/core/distributed.py``.  The JAX package applies the
algorithm across the devices of a mesh under ``shard_map``; the port runs one
process per rank (SPMD, ``repro_torch.core.comm``), so each function here
takes the calling rank's shard of the last axis and a process group, and
returns the rank's shard of the result.

* Phase 1: the shard's block reduction is an *independent* sum (not the last
  element of the local scan), gathered with one small ``all_gather`` of the
  ``D`` block sums; the local scan of the shard runs on any
  :func:`~repro_torch.core.scan.scan` method (``"blocked"``, the fused §4
  pipeline B2–B4, by default).
* Phase 2: the exclusive prefix of the earlier ranks' block sums is this
  rank's offset.
* Phase 3: the offset is added to the local scan.

Global traffic is 2N + D elements, as in the paper.  The shards may differ in
length: each rank's offset is the sum of whole earlier shards.

JAX's ``batch_axis_name`` (the leading dim sharded over a second mesh axis)
needs no argument here: a rank already holds only its batch rows, and every
collective stays inside ``group``, so a 2-D mesh is a grid of groups
(:func:`repro_torch.core.comm.grid_groups`) and each rank passes the group of
its scanned axis.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import comm
from repro_torch.core.scan import accum_dtype_for, scan

__all__ = ["mcscan_local", "mcscan"]


def mcscan_local(x: torch.Tensor, group=None, *, method: str = "blocked",
                 variant: str = "scanul1", tile_s: int = 128, block_tiles: int = 8,
                 exclusive: bool = False,
                 accum_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-rank body of MCScan: one collective, whatever the group's size.

    Args:
        x: This rank's shard ``(..., n_local)`` of the scanned (last) axis.
        group: Process group the scanned axis is sharded over.
        method: Local scan strategy (see :func:`repro_torch.core.scan.scan`).
        variant: Tile algebra, ``"scanu"`` or ``"scanul1"``.
        tile_s: Tile side ``s`` for the matmul scans.
        block_tiles: Tiles per block for ``method="blocked"``.
        exclusive: Exclusive local scan (the offset is unchanged: it is the
            sum of *whole* earlier shards).
        accum_dtype: Accumulation dtype; defaults to ``accum_dtype_for(x.dtype)``.

    Returns:
        The globally scanned shard, shaped like ``x``, in the accumulation dtype.
    """
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(x.dtype)
    # phase 1, "vector units": the block reduction, independent of the scan
    r = comm.all_gather(torch.sum(x.to(acc), dim=-1, dtype=acc), group)     # (D, ...)
    offset = torch.zeros_like(r[0])
    for d in range(comm.axis_index(group)):              # exclusive block prefix
        offset = offset + r[d]
    y = scan(x, axis=-1, method=method, variant=variant, tile_s=tile_s,
             block_tiles=block_tiles, exclusive=exclusive, accum_dtype=acc)
    return y + offset[..., None]


def mcscan(x: torch.Tensor, group=None, *, method: str = "blocked",
           variant: str = "scanul1", tile_s: int = 128, block_tiles: int = 8,
           exclusive: bool = False, accum_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Scan the last axis, sharded over the ranks of ``group``.

    Each rank runs the local pipeline on its shard while the ``D`` block sums
    travel in one small ``all_gather``.  On a group of one rank (or with no
    process group at all) it is the local :func:`~repro_torch.core.scan.scan`,
    with no collective.

    Args:
        x: This rank's shard ``(..., n_local)``; see :func:`mcscan_local`.
        group: Process group of the scanned axis (``None``: the default group).
        method, variant, tile_s, block_tiles, exclusive, accum_dtype: As
            :func:`mcscan_local`.

    Returns:
        This rank's shard of the global scan, in the accumulation dtype.

    Example:
        >>> mcscan(torch.ones((1, 8), dtype=torch.int8), method="vector")[0].tolist()
        [1, 2, 3, 4, 5, 6, 7, 8]
    """
    if comm.axis_size(group) == 1:
        return scan(x, axis=-1, method=method, variant=variant, tile_s=tile_s,
                    block_tiles=block_tiles, exclusive=exclusive, accum_dtype=accum_dtype)
    return mcscan_local(x, group, method=method, variant=variant, tile_s=tile_s,
                        block_tiles=block_tiles, exclusive=exclusive,
                        accum_dtype=accum_dtype)

"""Production and debug grids of the current world (functions only: importing
builds no group).

Port of ``repro/launch/mesh.py``: the same shapes and axis names, as
``utils.sharding.Grid`` over the ``torch.distributed`` world.  A world of
another size raises (``comm.grid_groups``); every rank must build the same grid.
"""
from __future__ import annotations

from repro_torch.utils.sharding import Grid

__all__ = ["make_production_mesh", "make_debug_mesh", "PRODUCTION", "DEBUG"]

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
DEBUG = {False: ((4, 2), ("data", "model")),
         True: ((2, 2, 2), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Grid:
    """16×16 = 256 ranks; 2 pods = 512 ranks when ``multi_pod``."""
    return Grid(*PRODUCTION[multi_pod])


def make_debug_mesh(*, multi_pod: bool = False) -> Grid:
    """The small grid of 8 ranks that the CPU tests run: (4 data, 2 model), or
    (2 pod, 2 data, 2 model) when ``multi_pod``."""
    return Grid(*DEBUG[multi_pod])

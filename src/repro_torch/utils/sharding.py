"""A named grid of ranks, and JAX's path rules as layouts over its groups.

Port of ``repro/utils/sharding.py``.  JAX's ``Mesh`` names the axes of a grid
of devices and a ``NamedSharding`` says which dims of an array split over
which axes; one controller holds the global array.  The port runs one process
a rank, so the counterpart of a mesh is :class:`Grid`: the axis names, the
shape (a dict, as ``mesh.shape``), this rank's coordinate, and each axis's
``torch.distributed`` group (``core/comm.py`` ``grid_groups``: world rank
``r`` at the row-major coordinate of ``r``, as JAX lays devices out).  The
counterpart of a ``NamedSharding`` is a :class:`Placement`: a grid, JAX's
``PartitionSpec`` entries (the same tuples: an axis name, a tuple of names, or
``None``) and the global shape.  Each rank holds its block of a placed tensor
(:func:`cut`); :func:`gather` joins the blocks back with counted
``all_gather`` calls.  A dim that the axes do not divide is laid out as
``comm.shard_len`` lays out the distributed operators' shards: blocks of
``L = ceil(n / parts)``, the last ones short or empty.

The rule tables (``_RULES``, :func:`spec_for_path`) are copied from the JAX
package, not imported; :func:`param_specs` walks the port's nested dicts with
keys joined by ``/`` as JAX's ``_path_str`` does.  :func:`use_mesh` and
:func:`current_mesh` keep the active grid thread-local, as JAX does; the MoE
layer reads it to take its expert-parallel path and its dispatch groups.
:func:`constrain` is the identity: under a grid each rank holds its own
activations, so there is no global array to constrain.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import comm

__all__ = ["Grid", "Placement", "current_mesh", "use_mesh", "dp_axes", "mdl_axis",
           "constrain", "spec_for_path", "param_specs", "param_shardings", "replicated",
           "cut", "gather", "block_slices", "norm_entry", "tree_map_with_path"]

_STATE = threading.local()


class Grid:
    """A named row-major grid of the world's ranks (JAX's ``Mesh``).

    ``Grid(shape, axis_names)`` needs an initialized world of
    ``prod(shape)`` ranks (a grid of one rank needs none) and must be built
    on every rank, in one order: it creates every axis's group, and the group
    over the batch axes ``("pod", "data")`` when both are present.
    :meth:`Grid.abstract` ``(shape, axis_names)`` is the layout alone (JAX's
    ``AbstractMesh``): names and shape, no rank and no group, enough for the
    spec functions.

    Example:
        >>> g = Grid.abstract((4, 2), ("data", "model"))
        >>> g.shape, g.axis_names, g.size
        ({'data': 4, 'model': 2}, ('data', 'model'), 8)
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 _abstract: bool = False):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"Grid: {len(shape)} dims {shape} need as many distinct "
                             f"axis names, got {names}")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.size = math.prod(shape)
        self.is_abstract = _abstract
        self.coord: Dict[str, int] = {}
        self._groups: Dict[Tuple[str, ...], Any] = {}
        if _abstract:
            return
        world = comm.axis_size()
        if world != self.size:
            raise ValueError(f"grid_groups: a grid of {shape} needs {self.size} ranks, "
                             f"the world has {world}")
        me = comm.axis_index()
        for i, name in enumerate(names):
            self.coord[name] = (me // math.prod(shape[i + 1:])) % shape[i]
        if self.size == 1:
            return
        for name, g in zip(names, comm.grid_groups(shape)):
            self._groups[(name,)] = g
        dp = dp_axes(self)
        if dp and len(dp) > 1:
            self._groups[dp] = comm.subgrid_group(shape, [names.index(a) for a in dp])

    @classmethod
    def abstract(cls, shape: Sequence[int], axis_names: Sequence[str]) -> "Grid":
        """The layout alone: names and shape, no rank and no group."""
        return cls(shape, axis_names, _abstract=True)

    def __repr__(self) -> str:
        where = "abstract" if self.is_abstract else f"coord={self.coord}"
        return f"Grid({self.shape}, {where})"

    def axes(self, entry) -> Tuple[str, ...]:
        """The axis names of one spec entry (a name, a tuple of names or None)."""
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def size_of(self, entry) -> int:
        """Ranks along the axes of ``entry`` (1 for None; a missing axis counts 1)."""
        return math.prod(self.shape.get(a, 1) for a in self.axes(entry))

    def index_of(self, entry, coord: Optional[Dict[str, int]] = None) -> int:
        """The row-major index of ``coord`` (this rank's by default) over the axes
        of ``entry``, the first axis the major one."""
        coord = self.coord if coord is None else coord
        idx = 0
        for a in self.axes(entry):
            idx = idx * self.shape[a] + coord[a]
        return idx

    def group(self, entry):
        """This rank's process group over the axes of ``entry`` (a name, or a
        tuple of names that the grid built a group for).  An axis of size 1
        has a group of one rank, over which ``comm`` issues no collective; a
        grid of one rank returns None, the world of one rank."""
        if self.is_abstract:
            raise ValueError("Grid.group: an abstract grid has no process groups")
        if self.size == 1:
            return None
        axes = self.axes(entry)
        if len(axes) > 1:
            axes = tuple(a for a in axes if self.shape[a] > 1) or axes[:1]
        if axes in self._groups:
            return self._groups[axes]
        raise ValueError(f"Grid.group: no group over {axes}; a grid builds one a single "
                         f"axis and one over its batch axes {dp_axes(self)}")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor's blocks live on a grid (JAX's ``NamedSharding``).

    ``spec`` holds JAX's ``PartitionSpec`` entries (shorter than the tensor's
    rank means the trailing dims are whole); ``shape`` is the global shape.
    """
    grid: Grid
    spec: Tuple
    shape: Tuple[int, ...]

    def entries(self) -> Tuple:
        """The spec padded with None to the tensor's rank."""
        return tuple(self.spec) + (None,) * (len(self.shape) - len(self.spec))

    def split_axes(self) -> Tuple[str, ...]:
        """Every grid axis of size > 1 that splits some dim, in spec order."""
        return tuple(a for e in self.entries() for a in self.grid.axes(e)
                     if self.grid.shape.get(a, 1) > 1)

    def block_shape(self, coord: Optional[Dict[str, int]] = None) -> Tuple[int, ...]:
        """The shape of the block at ``coord`` (this rank's by default)."""
        return tuple(s.stop - s.start for s in block_slices(self, coord))


def norm_entry(entry):
    """A spec entry as JAX's ``PartitionSpec`` keeps it: a tuple of one axis
    becomes the axis name, an empty tuple None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


def replicated(grid: Grid, shape: Sequence[int]) -> Placement:
    """A tensor held whole by every rank (JAX's ``P()``)."""
    return Placement(grid, (), tuple(shape))


# ---------------------------------------------------------------------------
# the active grid
# ---------------------------------------------------------------------------


def current_mesh() -> Optional[Grid]:
    """The grid of the innermost :func:`use_mesh` on this thread, or None."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Grid]):
    """Make ``mesh`` the active grid on this thread for the block's duration."""
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def dp_axes(mesh) -> Optional[Tuple[str, ...]]:
    """The batch ("data-parallel") axes: ``('pod', 'data')`` when pods exist."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names) or None


def mdl_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The identity.  JAX's ``with_sharding_constraint`` tells one controller
    how to lay out a global activation; under a grid each rank already holds
    only its own activations, so there is nothing to constrain."""
    return x


# ---------------------------------------------------------------------------
# parameter rules (matched against '/'-joined param paths), copied from JAX
# ---------------------------------------------------------------------------
# (regex, spec builder); specs are for the *unstacked* tensor — a leading
# layer-stack dimension is detected by rank and padded with None.

_RULES = [
    # embeddings / lm head: (vocab, d) — shard vocab over model
    (re.compile(r"(embed|lm_head|unembed)"), ("model", None)),
    # MoE experts: (E, d, f) / (E, f, d) — expert-parallel over model
    (re.compile(r"experts.*w_(gate|up)$"), ("model", None, None)),
    (re.compile(r"experts.*w_down$"), ("model", None, None)),
    (re.compile(r"router/w$"), (None, None)),
    # attention projections
    (re.compile(r"(wq|wk|wv|wqkv|q_b|kv_b|w_qkv)$"), (None, "model")),
    (re.compile(r"(wo|out_proj)$"), ("model", None)),
    (re.compile(r"(q_a|kv_a)$"), (None, None)),          # MLA low-rank: small, replicate
    # mlp
    (re.compile(r"(w_gate|w_up|w_in|in_proj)$"), (None, "model")),
    (re.compile(r"(w_down|w_out|down_proj)$"), ("model", None)),
    # mamba / xlstm projections
    (re.compile(r"(conv_w|conv_b|a_log|dt_bias|d_skip)$"), None),
    # biases on model-sharded outputs
    (re.compile(r"(wq|wk|wv|w_gate|w_up|w_in)_b$"), ("model",)),
]


def spec_for_path(path: str, ndim: int) -> Tuple:
    """JAX's ``spec_for_path``: the first rule whose regex matches ``path``,
    padded on the left to ``ndim`` (a layer stack) or cut to its last ``ndim``
    entries; ``()`` (replicated) when no rule matches.

    Example:
        >>> spec_for_path("stack/sub0/attn/wq", 3)
        (None, None, 'model')
    """
    for rx, spec in _RULES:
        if rx.search(path):
            if spec is None:
                return ()
            spec = tuple(spec)
            if len(spec) < ndim:
                spec = (None,) * (ndim - len(spec)) + spec
            elif len(spec) > ndim:
                spec = spec[-ndim:]
            return spec
    return ()


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts (and lists), ``path`` the tuple of
    keys from the root (list indices as ints)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def param_specs(params) -> Any:
    """The spec of every leaf of a parameter tree, by path rules."""
    return tree_map_with_path(lambda p, x: spec_for_path(_path_str(p), x.dim()), params)


def param_shardings(mesh: Grid, params) -> Any:
    """A :class:`Placement` a leaf: its rule's spec with the axes ``mesh``
    lacks dropped (None), as JAX's ``param_shardings`` ``fix`` does."""
    def place(path, x):
        spec = spec_for_path(_path_str(path), x.dim())
        cleaned = tuple(a if (a is None or a in mesh.axis_names) else None for a in spec)
        return Placement(mesh, cleaned, tuple(x.shape))
    return tree_map_with_path(place, params)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def block_slices(placement: Placement, coord: Optional[Dict[str, int]] = None):
    """The global slices of the block at ``coord`` (this rank's by default):
    along a dim split into ``P`` parts, part ``j`` is ``[j·L, min((j+1)·L, n))``
    with ``L = ceil(n / P)`` (``comm.shard_len``), so the last parts may be
    short or empty."""
    g = placement.grid
    out = []
    for n, entry in zip(placement.shape, placement.entries()):
        parts = g.size_of(entry)
        if parts == 1:
            out.append(slice(0, n))
            continue
        L = comm.shard_len(n, parts)
        j = g.index_of(entry, coord)
        out.append(slice(min(j * L, n), min((j + 1) * L, n)))
    return tuple(out)


def cut(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` (a view when it can be)."""
    if tuple(x.shape) != tuple(placement.shape):
        raise ValueError(f"cut: a tensor of {tuple(x.shape)} for a placement of "
                         f"{placement.shape}")
    return x[block_slices(placement)]


def gather(block: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The global tensor from every rank's :func:`cut` block.

    Along each split dim, one counted ``all_gather`` a grid axis of size > 1
    over that axis's group, the minor axis first, of the blocks padded to
    ``L``; the result is cut back to the global length.  A placement that
    splits nothing returns ``block`` and issues no call.
    """
    g = placement.grid
    out = block
    for dim, (n, entry) in enumerate(zip(placement.shape, placement.entries())):
        parts = g.size_of(entry)
        if parts == 1:
            continue
        L = comm.shard_len(n, parts)
        pad = L - out.shape[dim]
        if pad:
            widths = [0, 0] * (out.dim() - dim - 1) + [0, pad]
            out = torch.nn.functional.pad(out, widths)
        for a in reversed(g.axes(entry)):
            if g.shape[a] == 1:
                continue
            stacked = comm.all_gather(out, g.group(a))              # (ranks, ...)
            out = torch.cat(list(stacked.unbind(0)), dim=dim)
        out = out.narrow(dim, 0, n)
    return out

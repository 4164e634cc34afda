"""Cell-level sharding plans: the batch's and the decode caches' placements.

Port of ``repro/launch/sharding_plan.py``: the same rules (``_CACHE_RULES``
copied), over a ``utils.sharding.Grid`` (an abstract one suffices), returning
``Placement``\\ s whose ``spec`` is JAX's ``PartitionSpec`` tuple.
"""
from __future__ import annotations

import re

from repro_torch.utils.sharding import (Placement, dp_axes, norm_entry,
                                        tree_map_with_path)

__all__ = ["batch_specs", "cache_specs"]


def batch_specs(mesh, batch_tree):
    """Each batch leaf split over the batch axes along its first dim, or
    replicated when that dim does not divide (batch 1, long context)."""
    dp = dp_axes(mesh)
    dp_size = 1
    for a in (dp or ()):
        dp_size *= mesh.shape[a]

    def spec(path, x):
        shape = tuple(x.shape)
        if not shape or shape[0] % dp_size:
            return Placement(mesh, (), shape)
        return Placement(mesh, (norm_entry(dp),) + (None,) * (len(shape) - 1), shape)
    return tree_map_with_path(spec, batch_tree)


# Decode-cache rules, matched on the flattened path ('/'-joined dict keys).
# Each rule lists CANDIDATE specs in preference order (the tensor's own, unstacked
# layout; leading layer-stack dims are padded with None).  The first candidate whose
# sharded axes all divide evenly is chosen — e.g. GQA caches put kv-heads on
# "model" when n_kv_heads ≥ TP degree, else fall back to sharding the cache
# *sequence* axis over "model".
# seq mode (batch==1 long-context) shards the time axis over "data" (SP).
_CACHE_RULES = [
    (re.compile(r"(^|/)(k|v)$"),
     {"batch": [("dp", None, "model", None), ("dp", "model", None, None)],
      "seq": [(None, "data", "model", None), (None, ("data", "model"), None, None)]}),
    (re.compile(r"latent$"), {"batch": [("dp", None, None)],
                              "seq": [(None, "data", None)]}),
    (re.compile(r"k_rope$"), {"batch": [("dp", None, None)],
                              "seq": [(None, "data", None)]}),
    (re.compile(r"ssm$"), {"batch": [("dp", "model", None, None)],
                           "seq": [(None, "model", None, None)]}),
    (re.compile(r"conv$"), {"batch": [("dp", None, "model")],
                            "seq": [(None, None, "model")]}),
    (re.compile(r"(^|/)c$"),
     {"batch": [("dp", "model", None, None), ("dp", None, "model", None)],
      "seq": [(None, "model", None, None), (None, None, "model", None)]}),
    (re.compile(r"(^|/)n$"),
     {"batch": [("dp", "model", None), ("dp", None, "model")],
      "seq": [(None, "model", None), (None, None, "model")]}),
    (re.compile(r"(^|/)m$"), {"batch": [("dp", "model"), ("dp", None)],
                              "seq": [(None, "model"), (None, None)]}),
    (re.compile(r"rec"),
     {"batch": [("dp", "model", None), ("dp", None, "model")],
      "seq": [(None, "model", None), (None, None, "model")]}),
]


def _axis_size(mesh, a) -> int:
    if a is None:
        return 1
    if isinstance(a, tuple):
        n = 1
        for x in a:
            n *= mesh.shape.get(x, 1)
        return n
    return mesh.shape.get(a, 1)


def cache_specs(mesh, cache_tree, *, seq_sharded: bool):
    """A placement a cache leaf: the first candidate of its rule whose split axes
    all divide (else the first candidate with the non-dividing entries whole)."""
    dp = dp_axes(mesh)
    mode = "seq" if seq_sharded else "batch"

    def resolve(spec, shape):
        """Pad to rank, drop missing axes, null non-divisible entries."""
        ndim = len(shape)
        spec = tuple(dp if a == "dp" else a for a in spec)
        if len(spec) < ndim:
            spec = (None,) * (ndim - len(spec)) + spec
        elif len(spec) > ndim:
            spec = spec[-ndim:]
        out = []
        clean = True
        for dim, a in zip(shape, spec):
            if a is not None and not isinstance(a, tuple) \
                    and a not in mesh.axis_names:
                a = None
            if isinstance(a, tuple):
                a = tuple(x for x in a if x in mesh.axis_names) or None
            if a is not None and dim % _axis_size(mesh, a):
                a = None
                clean = False
            out.append(a)
        return tuple(out), clean

    def leaf_spec(path, x):
        path_s = "/".join(str(k) for k in path)
        shape = tuple(x.shape)
        for rx, table in _CACHE_RULES:
            if rx.search(path_s):
                chosen = None
                for cand in table[mode]:
                    spec, clean = resolve(cand, shape)
                    if chosen is None:
                        chosen = spec
                    if clean:
                        chosen = spec
                        break
                return Placement(mesh, tuple(norm_entry(a) for a in chosen), shape)
        return Placement(mesh, (), shape)

    return tree_map_with_path(leaf_spec, cache_tree)

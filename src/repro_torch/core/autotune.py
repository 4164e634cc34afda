"""``method="auto"`` resolution from the committed tuning table.

Port of the resolution chain of ``repro/core/autotune.py`` (``resolve_method``
and ``maybe_resolve``).  The chain, in order:

1. an active :func:`method_override` context wins;
2. else the ``REPRO_SCAN_METHOD`` environment variable, if set (and not
   ``"auto"``), wins;
3. else the table entry for ``(backend, op, dtype)`` picks the bucket with
   the largest breakpoint ``<= n`` (lengths below the smallest breakpoint use
   the first bucket);
4. a missing dtype falls to ``"float32"``, then to the entry's first dtype;
5. a missing backend warns once and falls to the table's ``default_backend``;
6. a missing op warns once and falls to the table's ``fallbacks`` entry, else
   to ``"vector"``;
7. an unloadable table warns once and resolves everything to ``"vector"``.

The table is the port's own copy of ``configs/tuning/default.json``, shipped as
package data of ``repro_torch.configs``.  It has only a ``"cpu"`` backend, so
CUDA tensors resolve through rule 5 with a warning.  Building and validating
tables is not ported yet.
"""
from __future__ import annotations

import contextlib
import json
import os
import warnings
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["resolve_method", "maybe_resolve", "method_override", "load_table",
           "AutotuneFallbackWarning", "OP_ALIASES", "AUTO", "ENV_VAR",
           "dtype_name"]

AUTO = "auto"
ENV_VAR = "REPRO_SCAN_METHOD"
SCHEMA_VERSION = 1
CONCRETE_METHODS = ("matmul", "vector", "kernel", "blocked")

OP_ALIASES: Dict[str, str] = {
    "cumsum": "scan",
    "weighted_sample": "scan",
    "compress": "split",
    "multi_split": "split",
    "radix_sort": "sort",
    "topk": "sort",
    "cumprod": "linear_scan",
    "cummax": "linear_scan",
    # every segment_* op is built from segmented mask / prefix scans
    "segment_cumsum": "segment_scan",
    "segment_sums": "segment_scan",
    "segment_softmax": "segment_scan",
    "segment_compress": "segment_scan",
    "segment_sort": "segment_scan",
    "segment_topk": "segment_scan",
    "segment_top_p_sample": "segment_scan",
    "segment_linear_scan": "segment_scan",
    "segment_ids": "segment_scan",
    # the distributed siblings resolve on the per-shard length, with the local
    # family's crossovers (each shard runs the same mask and prefix scans)
    "dist_sort": "sort",
    "dist_top_p_sample": "top_p_sample",
    "dist_linear_scan": "linear_scan",
    "dist_segment_scan": "segment_scan",
}


class AutotuneFallbackWarning(UserWarning):
    """Emitted (once per key) when ``"auto"`` resolution degrades."""


_WARNED: set = set()
_OVERRIDE: List[str] = []
_TABLE_CACHE: List[Optional[dict]] = []  # one-slot cache; [] = not loaded


def _warn_once(key: str, message: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(message, AutotuneFallbackWarning, stacklevel=3)


def _reset_for_testing() -> None:
    """Clear the warn-once state and the table cache (tests only)."""
    _WARNED.clear()
    _TABLE_CACHE.clear()


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the table's dtype keys)."""
    return str(dtype).rsplit(".", 1)[-1]


def load_table() -> Optional[dict]:
    """Load (and cache) the port's tuning table from package data."""
    if _TABLE_CACHE:
        return _TABLE_CACHE[0]
    table: Optional[dict] = None
    try:
        from importlib import resources
        data = (resources.files("repro_torch") / "configs" / "tuning" /
                "default.json").read_text()
        table = json.loads(data)
        if table.get("schema_version") != SCHEMA_VERSION:
            _warn_once("schema", "tuning table schema_version "
                       f"{table.get('schema_version')!r} != {SCHEMA_VERSION}; "
                       "method='auto' resolves to 'vector'")
            table = None
    except (OSError, ValueError) as e:
        _warn_once("load", f"could not load the tuning table ({e}); "
                   "method='auto' resolves to 'vector'")
        table = None
    _TABLE_CACHE.append(table)
    return table


@contextlib.contextmanager
def method_override(method: str):
    """Force every ``method="auto"`` resolution to ``method`` inside the block."""
    if method != AUTO and method not in CONCRETE_METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{CONCRETE_METHODS + (AUTO,)}")
    _OVERRIDE.append(method)
    try:
        yield
    finally:
        _OVERRIDE.pop()


def _env_override() -> Optional[str]:
    m = os.environ.get(ENV_VAR)
    if not m or m == AUTO:
        return None
    if m not in CONCRETE_METHODS:
        raise ValueError(
            f"{ENV_VAR}={m!r} is not a known method; expected one of "
            f"{CONCRETE_METHODS} (or 'auto' to defer to the tuning table)")
    return m


def _pick_bucket(entries: Sequence[Sequence], n: int) -> str:
    chosen = entries[0][1]
    for min_n, m in entries:
        if n >= min_n:
            chosen = m
        else:
            break
    return chosen


def resolve_method(op: str, n: int, dtype: torch.dtype, *, backend: str) -> str:
    """Resolve ``method="auto"`` for one call of ``op`` on ``n`` elements.

    Args:
        op: Entry-point operator name (collapsed through ``OP_ALIASES``).
        n: Length of the scanned axis.
        dtype: Input dtype.
        backend: ``"cpu"`` or ``"cuda"`` — the device type of the input.

    Example:
        >>> resolve_method("scan", 1 << 20, torch.float32, backend="cpu")
        'matmul'
    """
    op = OP_ALIASES.get(op, op)
    if _OVERRIDE and _OVERRIDE[-1] != AUTO:
        return _OVERRIDE[-1]
    env = _env_override()
    if env is not None:
        return env
    table = load_table()
    if table is None:
        return "vector"
    backends = table.get("backends", {})
    btab = backends.get(backend)
    if btab is None:
        default_bk = table.get("default_backend")
        btab = backends.get(default_bk)
        _warn_once(f"backend:{backend}",
                   f"tuning table has no entries for backend {backend!r}; "
                   f"falling back to "
                   f"{'backend ' + repr(default_bk) if btab is not None else 'method vector'}")
        if btab is None:
            return "vector"
    optab = btab.get(op)
    if not optab:
        fb = table.get("fallbacks", {}).get(op)
        if fb in CONCRETE_METHODS:
            return fb
        _warn_once(f"op:{op}", f"tuning table has no entry or fallback for "
                   f"op {op!r}; method='auto' resolves to 'vector'")
        return "vector"
    entries = optab.get(dtype_name(dtype))
    if not entries:
        entries = optab.get("float32") or optab[sorted(optab)[0]]
    m = _pick_bucket(entries, int(n))
    if m not in CONCRETE_METHODS:
        _warn_once(f"method:{op}:{m}", f"tuning table names unknown method "
                   f"{m!r} for op {op!r}; method='auto' resolves to 'vector'")
        return "vector"
    return m


def maybe_resolve(method: str, op: str, n: int, dtype: torch.dtype, *,
                  device: torch.device) -> str:
    """Return ``method`` unless it is ``"auto"``; then resolve it for ``device``."""
    if method != AUTO:
        return method
    return resolve_method(op, n, dtype, backend=torch.device(device).type)

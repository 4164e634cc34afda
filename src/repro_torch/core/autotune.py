"""``method="auto"`` resolution from the committed tuning table.

Port of ``repro/core/autotune.py``: the resolution chain (``resolve_method``
and ``maybe_resolve``) and the table's builder and validator
(``parse_bench_rows``, ``build_table``, ``validate_table``).  The chain, in
order:

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

Whatever the source of the method, :func:`maybe_resolve` passes a
``"kernel"`` or ``"blocked"`` result through the backend probe
(:func:`repro_torch.core.guards.ensure_available`), which raises when the
family's CUDA libraries cannot be built or loaded; it never picks another
method.

The table is the port's own ``configs/tuning/default.json``, shipped as
package data of ``repro_torch.configs``.  Its ``"cpu"`` backend and every
key but ``backends["cuda"]`` and ``provenance["cuda"]`` are the JAX
package's; the ``"cuda"`` backend is built by :func:`build_table` from the
rows of ``configs/tuning/cuda_sweep.json``, which ``repro_torch.tools.sweep``
measured on the card, and put beside the ``"cpu"`` one by
:func:`merge_backend` (``python -m repro_torch.tools.tune``).
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

__all__ = ["resolve_method", "maybe_resolve", "method_override", "load_table",
           "build_table", "parse_bench_rows", "validate_table", "merge_backend",
           "default_table_path", "AutotuneFallbackWarning", "TUNED_OPS", "OP_ALIASES",
           "AUTO", "SCHEMA_VERSION", "ENV_VAR", "dtype_name"]

AUTO = "auto"
ENV_VAR = "REPRO_SCAN_METHOD"
SCHEMA_VERSION = 1
CONCRETE_METHODS = ("matmul", "vector", "kernel", "blocked")

# the tuned operator families: every backend of the table has an entry for each
TUNED_OPS = ("scan", "split", "sort", "top_p_sample", "segment_scan",
             "linear_scan")

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


def default_table_path() -> str:
    """Filesystem path of the committed tuning table inside the package.

    ``python -m repro_torch.tools.tune`` rewrites the table there; loading at
    run time goes through ``importlib.resources`` (:func:`load_table`).
    """
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "tuning", "default.json")


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
    """Return ``method`` unless it is ``"auto"``; then resolve it for ``device``.

    A ``"kernel"`` or ``"blocked"`` result, explicit or resolved, passes the
    backend probe (:func:`repro_torch.core.guards.ensure_available`), as in
    the JAX package; the probe raises where JAX degrades.

    Raises:
        KernelUnavailableError: The method's CUDA libraries cannot be built or
            loaded for ``device``.
    """
    device = torch.device(device)
    # "meta" plans the card's program (the dry run), so it takes the "cuda" table
    backend = "cuda" if device.type == "meta" else device.type
    m = method if method != AUTO else resolve_method(op, n, dtype, backend=backend)
    if m in ("kernel", "blocked"):
        from repro_torch.core import guards  # local import: guards imports this module
        guards.ensure_available(m, op, device=device)
    return m


# ---------------------------------------------------------------------------
# Building and validating tables (the CLI is repro_torch.tools.tune)
# ---------------------------------------------------------------------------


def parse_bench_rows(rows: Iterable[dict]) -> List[Tuple[str, str, int, str, float]]:
    """Extract ``(op, dtype, n, method, us_per_call)`` tuples from sweep rows.

    Reads the row names of the JAX package's ``benchmarks/run.py`` sweep
    sections, which ``repro_torch.tools.sweep`` writes too (``scan_pipeline``,
    ``ops``, ``sort``, ``segscan``, ``linrec``); other rows (``memcpy``,
    ``pass_count``, ``method="auto"``, unmeasured ones) are skipped, and
    ``sort`` rows are kept only at the default ``bits_per_pass=4``.

    Example:
        >>> parse_bench_rows([{"name": "scan_pipeline/kernel/int8/n=4096",
        ...                    "us_per_call": 12.5, "derived": ""}])
        [('scan', 'int8', 4096, 'kernel', 12.5)]
    """
    out = []
    for r in rows:
        parts = r["name"].split("/")
        us = float(r.get("us_per_call", 0.0))
        if us <= 0.0:
            continue
        derived = dict(kv.split("=", 1) for kv in r.get("derived", "").split(";")
                       if "=" in kv)
        rec = None
        sec = parts[0]
        if sec == "scan_pipeline" and parts[1] in CONCRETE_METHODS:
            rec = ("scan", parts[2], int(parts[3][2:]), parts[1])
        elif sec == "ops" and len(parts) == 5 and parts[4] in CONCRETE_METHODS:
            if parts[1] == "split":
                rec = ("split", parts[2], int(parts[3][2:]), parts[4])
            elif parts[1] == "sort":
                rec = ("sort", parts[2], int(parts[3][2:]), parts[4])
            elif parts[1] == "top_p":
                rec = ("top_p_sample", "float32", int(parts[3][2:]), parts[4])
        elif (sec == "sort" and len(parts) == 5 and parts[1] != "pass_count"
              and parts[3] in CONCRETE_METHODS and parts[4] == "k=4"):
            rec = ("sort", parts[1], int(parts[2][2:]), parts[3])
        elif sec == "segscan" and parts[1] in CONCRETE_METHODS and "n" in derived:
            rec = ("segment_scan", "float32", int(derived["n"]), parts[1])
        elif sec == "linrec" and parts[1] in CONCRETE_METHODS:
            rec = ("linear_scan", parts[2], int(parts[4][2:]), parts[1])
        if rec is not None:
            out.append(rec + (us,))
    return out


def build_table(rows: Iterable[dict], *, backend: str,
                provenance: Optional[dict] = None) -> dict:
    """Derive a one-backend tuning table from sweep rows.

    Per ``(op, dtype)`` the fastest method wins each measured length (ties go
    to the earlier method of ``CONCRETE_METHODS``; a repeated measurement
    keeps its best time), and runs of equal winners collapse into
    ``[min_length, method]`` breakpoints.  A tuned op without rows gets a
    ``"vector"`` entry in ``fallbacks``.  The result depends on the rows
    alone, which is what ``tools.tune --check`` relies on.

    Example:
        >>> t = build_table([
        ...     {"name": "scan_pipeline/vector/float32/n=512", "us_per_call": 1.0},
        ...     {"name": "scan_pipeline/kernel/float32/n=512", "us_per_call": 9.0},
        ...     {"name": "scan_pipeline/vector/float32/n=8192", "us_per_call": 9.0},
        ...     {"name": "scan_pipeline/kernel/float32/n=8192", "us_per_call": 1.0},
        ... ], backend="cuda")
        >>> t["backends"]["cuda"]["scan"]["float32"]
        [[512, 'vector'], [8192, 'kernel']]
        >>> t["fallbacks"]["split"]
        'vector'
    """
    best: Dict[Tuple[str, str, int, str], float] = {}
    for op, dt, n, m, us in parse_bench_rows(rows):
        k = (op, dt, n, m)
        if k not in best or us < best[k]:
            best[k] = us
    grouped: Dict[Tuple[str, str], Dict[int, Dict[str, float]]] = {}
    for (op, dt, n, m), us in best.items():
        grouped.setdefault((op, dt), {}).setdefault(n, {})[m] = us
    btab: Dict[str, Dict[str, list]] = {}
    for (op, dt), by_n in sorted(grouped.items()):
        entries = []
        for n in sorted(by_n):
            times = by_n[n]
            winner = min(times, key=lambda m: (times[m], CONCRETE_METHODS.index(m)))
            if not entries or entries[-1][1] != winner:
                entries.append([n, winner])
        btab.setdefault(op, {})[dt] = entries
    fallbacks = {op: "vector" for op in TUNED_OPS if op not in btab}
    return {
        "schema_version": SCHEMA_VERSION,
        "provenance": provenance or {},
        "default_backend": backend,
        "backends": {backend: btab},
        "fallbacks": fallbacks,
    }


def validate_table(table: dict) -> List[str]:
    """Structural checks on a table; the problems found (empty when valid).

    Checked: the schema version; dtype keys that name a torch dtype;
    breakpoint lists that are non-empty, integer, strictly ascending and name
    concrete methods; fallbacks that name concrete methods; every tuned op
    covered by an entry or a fallback in the default backend.

    Example:
        >>> validate_table(build_table([], backend="cpu"))
        []
    """
    probs = []
    if table.get("schema_version") != SCHEMA_VERSION:
        probs.append(f"schema_version {table.get('schema_version')!r} != "
                     f"{SCHEMA_VERSION}")
    backends = table.get("backends")
    if not isinstance(backends, dict) or not backends:
        return probs + ["no 'backends' section"]
    default_bk = table.get("default_backend")
    if default_bk not in backends:
        probs.append(f"default_backend {default_bk!r} has no backends entry")
    for bk, btab in backends.items():
        for op, optab in btab.items():
            if not isinstance(optab, dict) or not optab:
                probs.append(f"{bk}/{op}: empty op entry")
                continue
            for dt, entries in optab.items():
                if not isinstance(getattr(torch, dt, None), torch.dtype):
                    probs.append(f"{bk}/{op}/{dt}: not a dtype name")
                if not entries:
                    probs.append(f"{bk}/{op}/{dt}: empty bucket list")
                    continue
                mins = [e[0] for e in entries]
                if mins != sorted(mins) or len(set(mins)) != len(mins):
                    probs.append(f"{bk}/{op}/{dt}: breakpoints not strictly "
                                 f"ascending: {mins}")
                for e in entries:
                    if (len(e) != 2 or not isinstance(e[0], int)
                            or e[1] not in CONCRETE_METHODS):
                        probs.append(f"{bk}/{op}/{dt}: bad bucket {e!r}")
    for op, m in table.get("fallbacks", {}).items():
        if m not in CONCRETE_METHODS:
            probs.append(f"fallbacks/{op}: unknown method {m!r}")
    covered = set(backends.get(default_bk, {})) | set(table.get("fallbacks", {}))
    for op in TUNED_OPS:
        if op not in covered:
            probs.append(f"tuned op {op!r} has neither a table entry nor an "
                         "explicit fallback")
    return probs


def merge_backend(table: dict, built: dict) -> dict:
    """``table`` with the backends of ``built`` (a :func:`build_table` result) in it.

    Each ``built["backends"][b]`` replaces ``table["backends"][b]`` and
    ``built["provenance"]`` goes under ``table["provenance"][b]``; every other
    key of ``table`` (its schema version, default backend, fallbacks, the
    other backends and their provenance) stays as it was.  ``table`` itself
    is not modified.

    Example:
        >>> t = merge_backend(build_table([], backend="cpu"),
        ...                   build_table([], backend="cuda", provenance={"card": "x"}))
        >>> sorted(t["backends"]), t["default_backend"], t["provenance"]
        (['cpu', 'cuda'], 'cpu', {'cuda': {'card': 'x'}})
    """
    out = copy.deepcopy(table)
    for b, btab in built["backends"].items():
        out["backends"][b] = copy.deepcopy(btab)
        out.setdefault("provenance", {})[b] = copy.deepcopy(built.get("provenance", {}))
    return out

"""The tuning sweep behind ``method="auto"`` on the card.

    PYTHONPATH=src python3 -m repro_torch.tools.tune --run-sweep --backend cuda

Port of the tuning sections of the JAX package's ``benchmarks/run.py``
(``scan_pipeline_sweep``, ``sort_sweep`` at ``k=4``, ``segscan_sweep``,
``linrec_sweep``, ``ops_split``, ``ops_sort``, ``ops_top_p``).  It times every
op of ``TUNED_OPS`` on every method, dtype and length, and returns rows
``{"name", "us_per_call", "derived"}`` under the JAX package's row names, so
that :func:`repro_torch.core.autotune.parse_bench_rows` reads them unchanged
and :func:`~repro_torch.core.autotune.build_table` turns them into the
table's ``"cuda"`` backend.

How a point is timed:

* on the card only: without CUDA :func:`run_sweep` raises, and it never times
  the CPU in the card's place;
* eagerly, as users call the operators: a call is the host clock from the
  call to a ``torch.cuda.synchronize()`` after it, so the host time of a small
  call counts as it does for a user;
* the methods in turns inside the one process (one call of each, ``REPS``
  times over, after a warm-up call of each), and a row is the median of its
  ``REPS`` calls;
* a method whose median passes ``CUTOFF_S`` at one length, or which runs out
  of device memory there, is not timed at longer lengths of that op and
  dtype; its rows say so in ``derived`` and carry no time.

What is timed: rows of 4 (``ROWS``) at lengths 2^10 to 2^24 in steps of 4x
(``LENGTHS``); scan, split and sort on float32, bfloat16 and int8,
linear_scan on float32 and bfloat16, top_p_sample and segment_scan on
float32 (segment_scan on one packed row of segments of mean length
``SEG_MEAN``).  Also the lengths the repository's own callers use: the
vocabularies of llama3-8b (128256) and zamba2 (32000) for sort and top-p, the
page allocator's 129 pages on split, and the SSD's two scans at zamba2's
prefill shape: the chunk cumsum (length 128, (4, 16, 64, 128)) on scan and
the cross-chunk states (length 16 along axis 1 of (4, 16, 64, 64, 64), the
decay shared by the 64 x 64 states) on linear_scan, in the row named
``S=1048576/L=16``.

The table keys on length alone.  So the bucket that the SSD's 2^20 columns of
16 steps chose is also what a 16-long call on a few rows gets, and the bucket
at 128 is the one the chunk cumsum's 2^19 elements chose.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core.autotune import CONCRETE_METHODS

__all__ = ["run_sweep", "time_in_turns", "LENGTHS", "ROWS", "REPS", "CUTOFF_S", "SEG_MEAN"]

LENGTHS = tuple(1 << k for k in range(10, 25, 2))     # 2^10 .. 2^24, 4x apart
ROWS = 4
REPS = 20
CUTOFF_S = 1.0
SEG_MEAN = 1024
VOCABS = (32000, 128256)                              # zamba2's and llama3-8b's
PAGES = 129                                           # the page allocator's compress
SSD_CHUNK_CUMSUM = (4, 16, 64, 128)                   # (batch, chunks, heads, chunk)
SSD_STATES = (4, 16, 64, 64, 64)                      # (batch, chunks, heads, P, N)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}

# (row name for a method, callable of a method) at one length
Point = Tuple[Callable[[str], str], Callable[[str], Callable[[], object]]]


def _payload(gen, dt: str, shape, dev):
    if dt == "int8":
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int16).to(torch.int8)
    return torch.randn(shape, generator=gen, device=dev).to(DTYPES[dt])


def _scan_point(gen, dev, dt: str, n: int) -> Point:
    from repro_torch.core.scan import scan
    shape = SSD_CHUNK_CUMSUM if n == SSD_CHUNK_CUMSUM[-1] else (ROWS, n)
    if dt == "int8":
        x = torch.randint(-3, 4, shape, generator=gen, device=dev).to(torch.int8)
    else:
        x = _payload(gen, dt, shape, dev)
    return (lambda m: f"scan_pipeline/{m}/{dt}/n={n}",
            lambda m: (lambda: scan(x, method=m)))


def _split_point(gen, dev, dt: str, n: int) -> Point:
    from repro_torch.core.primitives import split
    x = _payload(gen, dt, (ROWS, n), dev)
    flags = torch.rand((ROWS, n), generator=gen, device=dev) < 0.5
    return (lambda m: f"ops/split/{dt}/n={n}/{m}",
            lambda m: (lambda: split(x, flags, method=m)))


def _sort_point(gen, dev, dt: str, n: int) -> Point:
    from repro_torch.core.primitives import radix_sort
    x = _payload(gen, dt, (ROWS, n), dev)
    return (lambda m: f"sort/{dt}/n={n}/{m}/k=4",
            lambda m: (lambda: radix_sort(x, method=m, bits_per_pass=4)))


def _top_p_point(gen, dev, dt: str, n: int) -> Point:
    from repro_torch.core.primitives import top_p_sample
    logits = torch.randn((ROWS, n), generator=gen, device=dev) * 3
    g = torch.Generator(device=dev).manual_seed(0)
    return (lambda m: f"ops/top_p/b={ROWS}/v={n}/{m}",
            lambda m: (lambda: top_p_sample(logits, g, p=0.9, method=m)))


def _segscan_point(gen, dev, dt: str, n: int) -> Point:
    from repro_torch.core.segmented import segment_scan
    segs = max(1, n // SEG_MEAN)
    cuts = torch.sort(torch.randint(0, n + 1, (segs - 1,), generator=gen, device=dev)).values
    zero_n = torch.tensor([0, n], device=dev)
    offsets = torch.cat([zero_n[:1], cuts, zero_n[1:]]).to(torch.int32)
    x = torch.randn((n,), generator=gen, device=dev)
    return (lambda m: f"segscan/{m}/S={segs}/L={n // segs}",
            lambda m: (lambda: segment_scan(x, offsets, method=m)))


def _linrec_point(gen, dev, dt: str, n: int) -> Point:
    from repro_torch.core.linrec import linear_scan
    if n == SSD_STATES[1]:          # the SSD's cross-chunk states, as core/ssd.py calls it
        a = torch.exp(-torch.rand(SSD_STATES[:3] + (1, 1), generator=gen, device=dev))
        b = torch.randn(SSD_STATES, generator=gen, device=dev)
        cols = math.prod(SSD_STATES) // n
        return (lambda m: f"linrec/{m}/{dt}/S={cols}/L={n}",
                lambda m: (lambda: linear_scan(a, b, axis=1, method=m, tile_s=n)))
    g = torch.randn((ROWS, n), generator=gen, device=dev)
    a = torch.exp(-g.abs() * 0.05).to(DTYPES[dt])
    b = torch.randn((ROWS, n), generator=gen, device=dev).to(DTYPES[dt])
    return (lambda m: f"linrec/{m}/{dt}/S={ROWS}/L={n}",
            lambda m: (lambda: linear_scan(a, b, method=m)))


# (op, dtype names, extra lengths, point maker), in the JAX sweep's section order
SERIES = (
    ("scan", ("float32", "bfloat16", "int8"), (SSD_CHUNK_CUMSUM[-1],), _scan_point),
    ("sort", ("float32", "bfloat16", "int8"), VOCABS, _sort_point),
    ("segment_scan", ("float32",), (), _segscan_point),
    ("linear_scan", ("float32",), (SSD_STATES[1],), _linrec_point),
    ("linear_scan", ("bfloat16",), (), _linrec_point),
    ("split", ("float32", "bfloat16", "int8"), (PAGES,), _split_point),
    ("top_p_sample", ("float32",), VOCABS, _top_p_point),
)


def time_in_turns(calls: Dict[str, Callable[[], object]], reps: int):
    """Seconds of ``reps`` eager calls of each method, the methods in turns.

    Returns ``(times, out_of_memory)``: the methods whose warm-up call ran out
    of device memory are not timed.
    """
    out_of_memory = []
    for m in list(calls):                          # warm-up: first-call costs
        try:
            calls[m]()
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            out_of_memory.append(m)
            del calls[m]
            torch.cuda.empty_cache()
    times: Dict[str, list] = {m: [] for m in calls}
    for _ in range(reps):
        for m, fn in calls.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[m].append(time.perf_counter() - t0)
    return times, out_of_memory


def run_sweep(*, log: Callable[[str], None] = print, lengths=LENGTHS, reps: int = REPS,
              seed: int = 0) -> Dict[str, object]:
    """Time every tuned op on every method on the card.

    Returns:
        ``{"rows": [...], "seconds": s, "build_seconds": s}``, the rows under
        the JAX package's names (module docstring).

    Raises:
        RuntimeError: No CUDA device is available.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("the tuning sweep times the card, and no CUDA device is "
                           "available; it never times the CPU in its place")
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    build_s = _build.build_all()
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows: List[dict] = []
    for op, dtypes, extra, make in SERIES:
        for dt in dtypes:
            stopped: Dict[str, str] = {}
            for n in sorted(set(lengths) | set(extra)):
                name, call = make(gen, dev, dt, n)
                live = {m: call(m) for m in CONCRETE_METHODS if m not in stopped}
                times, oom = time_in_turns(live, reps)
                for m in oom:
                    stopped[m] = f"out_of_memory_at_n={n}"
                for m in CONCRETE_METHODS:
                    if m not in times:
                        rows.append({"name": name(m), "us_per_call": 0.0,
                                     "derived": f"n={n};not_timed={stopped[m]}"})
                        continue
                    ts = times[m]
                    med = statistics.median(ts)
                    rows.append({"name": name(m), "us_per_call": med * 1e6,
                                 "derived": f"n={n};reps={len(ts)};"
                                            f"min_us={min(ts) * 1e6:.1f};"
                                            f"max_us={max(ts) * 1e6:.1f}"})
                    if med > CUTOFF_S:
                        stopped[m] = f"over_{CUTOFF_S:g}s_at_n={n}"
                log(f"{op} {dt} n={n}: " + ", ".join(
                    f"{m} {statistics.median(ts) * 1e3:.4g} ms" for m, ts in times.items())
                    + "".join(f", {m} not timed ({stopped[m]})" for m in CONCRETE_METHODS
                              if m not in times))
                del name, call, live
                torch.cuda.empty_cache()
    return {"rows": rows, "seconds": time.perf_counter() - t_start,
            "build_seconds": build_s}

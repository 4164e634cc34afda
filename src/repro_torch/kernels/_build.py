"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Libraries go to
``build/repro_torch/`` under the repository root, named by a hash of their
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  :func:`build_all` starts one ``nvcc`` per source, all at once.

:func:`launch` is the one place a kernel is launched from Python: it calls the
C entry point, raises on a non-zero ``cudaError_t`` and then adds one to the
kernel's count in :data:`LAUNCHES`.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["SOURCES", "ENTRIES", "BUILD_DIR", "LAUNCHES", "build_all", "load", "launch",
           "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# library -> (C entry point, argtypes)
SOURCES: Dict[str, tuple] = {
    "scan_mm": ("repro_scan_tiles", [_P, _P, _I, _L, _I, _I, _I, _P, _L, _P]),
    "radix_pass": ("repro_radix_pass", [_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P]),
    "radix_pass_hist": ("repro_radix_pass_hist",
                        [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P]),
    "topp_tail": ("repro_topp_tail", [_P, _L, _P, _P, _I, _L, _F, _P]),
    "block_sums": ("repro_block_sums", [_P, _P, _I, _L, _I, _L, _I, _P]),
    "carry_scan": ("repro_carry_scan", [_P, _P, _I, _L, _I, _P]),
    "block_scan": ("repro_block_scan", [_P, _P, _P, _I, _L, _I, _L, _I, _I, _I, _P]),
    "split": ("repro_split", [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P]),
    "seg_scan": ("repro_seg_scan", [_P, _P, _L, _P, _I, _L, _I, _P, _L, _P]),
    "seg_summaries": ("repro_seg_summaries", [_P, _P, _L, _P, _P, _I, _L, _I, _L, _I, _P]),
    "seg_carry": ("repro_seg_carry", [_P, _P, _P, _I, _L, _I, _P, _L, _P]),
    "seg_block_scan": ("repro_seg_block_scan", [_P, _P, _L, _P, _P, _I, _L, _I, _L, _I, _P]),
    "linrec_scan": ("repro_linrec_scan", [_P, _P, _P, _I, _L, _P, _L, _P]),
    "linrec_summaries": ("repro_linrec_summaries", [_P, _P, _P, _P, _I, _L, _I, _L, _P]),
    "linrec_carry": ("repro_linrec_carry", [_P, _P, _P, _I, _L, _P]),
    "linrec_block_scan": ("repro_linrec_block_scan", [_P, _P, _P, _P, _I, _L, _I, _L, _P]),
    "multi_split": ("repro_multi_split", [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _P]),
    "ssd_chunk": ("repro_ssd_chunk",
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _L, _P]),
}

# second entry points of a library: (library, C entry point) -> argtypes; a
# launch through one counts as its library's
ENTRIES: Dict[tuple, list] = {
    ("linrec_scan", "repro_linrec_scan_columns"): [_P, _P, _P, _P, _P, _P],
    ("linrec_block_scan", "repro_linrec_block_scan_columns"): [_P, _P, _P, _P, _P, _P],
    ("seg_summaries", "repro_seg_summaries_design"):
        [_P, _P, _L, _P, _P, _I, _L, _I, _L, _I, _I, _I, _P],
    ("topp_tail", "repro_topp_tail_design"): [_P, _L, _P, _P, _I, _L, _F, _I, _I, _P],
}

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, ``PATH``, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built with it at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return name, proc, tmp, out


def build_all(names: Iterable[str] = tuple(SOURCES)) -> float:
    """Compile every missing library (one ``nvcc`` each, run together) and load all.

    Returns:
        Seconds spent (0 when every library was already built and loaded).
    """
    t0 = time.perf_counter()
    names = list(names)
    with _LOCK:
        missing = [n for n in names if n not in _LIBS and not _lib_path(n).exists()]
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            jobs = [_start(n) for n in missing]
            errors: List[str] = []
            for name, proc, tmp, out in jobs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, out)
            if errors:
                raise RuntimeError("\n".join(errors))
        for n in names:
            _load_locked(n)
    return time.perf_counter() - t0 if missing else 0.0


def _load_locked(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn_name, argtypes = SOURCES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        for (lib_name, entry), types in ENTRIES.items():
            if lib_name == name:
                getattr(lib, entry).argtypes = types
                getattr(lib, entry).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib


def launch(name: str, *args, entry: str | None = None) -> None:
    """Call kernel ``name``'s C entry point (or its second one, ``entry``, from
    :data:`ENTRIES`); raise on a CUDA error, else count a launch of ``name``."""
    lib = load(name)
    rc = getattr(lib, entry or SOURCES[name][0])(*args)
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1

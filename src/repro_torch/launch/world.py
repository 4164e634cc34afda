"""Run one function on every rank of a ``torch.distributed`` world, a process each.

    from repro_torch.launch.world import run_world
    results = run_world("my_module:my_fn", 4, {"n": 13}, workdir=tmp_path)

:func:`run_world` starts ``world`` fresh interpreters (no ``fork``: CUDA does
not survive one), each running this module as its entry point::

    python -m repro_torch.launch.world --rank R --world D --workdir DIR \\
        --fn my_module:my_fn [--backend gloo] [--timeout SECONDS]

Each rank joins the process group through a ``file://`` rendezvous in
``workdir``, calls ``my_fn(**kwargs)`` (the keyword arguments travel through
``workdir/kwargs.pt``) and saves what it returns to ``workdir/rank<R>.pt``,
which :func:`run_world` loads and returns in rank order.  Every rank gets a
deadline: when one fails or the deadline passes, every rank is killed and
:func:`run_world` raises with the end of each rank's log, so that a hung
collective fails instead of waiting forever.

Several ranks may share one GPU: their collectives then go over gloo
(``repro_torch.core.comm``), since NCCL refuses two ranks on one card.  With
``backend="nccl"`` rank ``r`` takes card ``r % device_count``; that path is
written but has not been run yet.  Whatever the ranks build must be built
before they start (``repro_torch.kernels._build.build_all``), so that no two ranks
compile at once.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["run_world", "main"]

_SRC = str(Path(__file__).resolve().parents[2])


def run_world(fn: str, world: int, kwargs: Optional[Dict] = None, *, workdir,
              timeout: float = 300.0, backend: str = "gloo",
              pythonpath: Sequence[str] = ()) -> List:
    """Run ``fn`` (``"module:function"``) on ``world`` ranks and return their results.

    Args:
        fn: The function each rank calls, as ``"module:function"``; the module
            must import without JAX and be on ``pythonpath`` (this package's
            ``src`` is always there).
        world: Number of ranks.
        kwargs: Keyword arguments for ``fn``, saved with ``torch.save``.
        workdir: An empty directory for the rendezvous, logs and results.
        timeout: Seconds for the whole world, startup included.
        backend: The process group's backend.
        pythonpath: Further import paths for the ranks.

    Returns:
        What each rank's ``fn`` returned, in rank order.

    Raises:
        RuntimeError: A rank exited with an error, or the deadline passed.
    """
    import torch

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(dict(kwargs or {}), workdir / "kwargs.pt")
    (workdir / "rendezvous").unlink(missing_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([_SRC, *pythonpath] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // world))  # cores shared out
    procs, logs = [], []
    deadline = time.monotonic() + timeout
    try:
        for r in range(world):
            log = open(workdir / f"rank{r}.log", "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.world", "--rank", str(r),
                 "--world", str(world), "--workdir", str(workdir), "--fn", fn,
                 "--backend", backend, "--timeout", str(timeout)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        while True:
            codes = [p.poll() for p in procs]
            bad = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
            if bad is not None:
                raise RuntimeError(f"run_world({fn}): rank {bad} exited with {codes[bad]}\n"
                                   f"{_tails(workdir, world)}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"run_world({fn}): the world of {world} did not finish "
                                   f"within {timeout} s\n{_tails(workdir, world)}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _tails(workdir: Path, world: int, nbytes: int = 3000) -> str:
    out = []
    for r in range(world):
        path = workdir / f"rank{r}.log"
        text = path.read_bytes()[-nbytes:].decode(errors="replace") if path.exists() else ""
        out.append(f"--- rank {r} ---\n{text}")
    return "\n".join(out)


def main(argv=None) -> int:
    """The entry point of one rank (see the module docstring)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--fn", required=True)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    if args.backend == "nccl":                  # one card a rank
        torch.cuda.set_device(args.rank % torch.cuda.device_count())
    workdir = Path(args.workdir)
    dist.init_process_group(args.backend, init_method=f"file://{workdir / 'rendezvous'}",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=args.timeout))
    module, name = args.fn.split(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(**torch.load(workdir / "kwargs.pt", weights_only=False))
    torch.save(result, workdir / f"rank{args.rank}.pt.tmp")
    os.replace(workdir / f"rank{args.rank}.pt.tmp", workdir / f"rank{args.rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

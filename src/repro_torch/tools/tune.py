"""Regenerate or check the port's ``method="auto"`` tuning table.

    python -m repro_torch.tools.tune --run-sweep --backend cuda   # on the card
    python -m repro_torch.tools.tune --rows ROWS.json --backend cuda
    python -m repro_torch.tools.tune --check                      # anywhere

Port of the JAX package's ``tools/tune.py``.  Three modes:

* ``--run-sweep --backend cuda`` runs :func:`repro_torch.tools.sweep.run_sweep`
  on the card, writes its rows and their provenance (the card's ``nvidia-smi``
  name and power limit, torch, CUDA, the git revision) to
  ``configs/tuning/cuda_sweep.json``, and merges ``build_table(rows,
  backend="cuda")`` into ``configs/tuning/default.json`` with
  :func:`~repro_torch.core.autotune.merge_backend`: the other backends and
  keys of the table stay as they are.
* ``--rows FILE`` does the same from rows already taken (a file in the form
  of ``cuda_sweep.json``, or a plain list of rows), without timing anything.
* ``--check`` is the drift gate, on any machine.  It passes when
  ``validate_table`` finds no problem, every backend has an entry for every op
  of ``TUNED_OPS``, the table loaded from package data equals the file, and
  ``build_table`` on the committed ``cuda_sweep.json`` reproduces the
  committed ``"cuda"`` backend with no fallback.  It re-reads the committed
  rows and never times anything again.

Exit status 0 on success, 1 on any problem.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

from repro_torch.core.autotune import (
    SCHEMA_VERSION, TUNED_OPS, _reset_for_testing, build_table, default_table_path,
    load_table, merge_backend, validate_table,
)

SWEEP_BACKEND = "cuda"


def sweep_path(table_path: str) -> str:
    """The committed sweep rows beside the table."""
    return os.path.join(os.path.dirname(table_path), f"{SWEEP_BACKEND}_sweep.json")


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")


def _git_rev() -> Optional[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(["git", "-C", here, "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def card_provenance(git_rev: Optional[str]) -> dict:
    """The card, software and revision the sweep ran on."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return {"nvidia_smi": smi[0] if smi else None,
            "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
            "cuda": torch.version.cuda, "git_rev": git_rev or _git_rev()}


def write_backend(rows: List[dict], provenance: dict, backend: str,
                  table_path: str) -> List[str]:
    """Merge ``build_table(rows, backend=backend)`` into the table file.

    Returns:
        The merged table's problems (``validate_table``), empty when valid.
    """
    built = build_table(rows, backend=backend, provenance=provenance)
    problems = [f"{backend} has no rows for {op!r}" for op in built["fallbacks"]]
    table = merge_backend(_read_json(table_path), built)
    _write_json(table_path, table)
    return problems + validate_table(table)


def check(table_path: str) -> int:
    """The drift gate: see the module docstring."""
    problems: List[str] = []
    try:
        committed = _read_json(table_path)
    except (OSError, ValueError) as e:
        print(f"FAIL: cannot read the table {table_path}: {e}")
        return 1
    problems += [f"schema: {p}" for p in validate_table(committed)]
    for bk, btab in committed.get("backends", {}).items():
        problems += [f"coverage: backend {bk!r} has no entry for {op!r}"
                     for op in TUNED_OPS if op not in btab]
    _reset_for_testing()
    loaded = load_table()
    if loaded != committed:
        problems.append(f"package: the table loaded from package data differs from "
                        f"{table_path}")
    try:
        sweep = _read_json(sweep_path(table_path))
    except (OSError, ValueError) as e:
        problems.append(f"drift: cannot read the committed sweep rows: {e}")
    else:
        regen = build_table(sweep["rows"], backend=SWEEP_BACKEND)
        if regen["fallbacks"]:
            problems.append(f"drift: the sweep rows leave {sorted(regen['fallbacks'])} "
                            "unmeasured")
        if regen["backends"][SWEEP_BACKEND] != committed.get("backends", {}).get(
                SWEEP_BACKEND):
            problems.append(f"drift: build_table on {sweep_path(table_path)} does not "
                            f"reproduce the committed {SWEEP_BACKEND!r} backend")
    for p in problems:
        print(f"FAIL({p.split(':', 1)[0]}):{p.split(':', 1)[1]}")
    if problems:
        return 1
    print(f"OK: schema v{SCHEMA_VERSION}, backends {sorted(committed['backends'])} "
          f"each cover {len(TUNED_OPS)} tuned ops, package data equals the file, "
          f"no drift from {os.path.basename(sweep_path(table_path))}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", default=default_table_path(),
                    help="the table to check or merge into")
    ap.add_argument("--backend", default=SWEEP_BACKEND,
                    help="backend label of the measurements")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--run-sweep", action="store_true",
                      help="time the sweep on the card, then write rows and table")
    mode.add_argument("--rows", help="build the backend from rows already taken")
    mode.add_argument("--check", action="store_true",
                      help="validate the table and gate drift against the rows")
    ap.add_argument("--git-rev", help="revision to record (default: git rev-parse)")
    args = ap.parse_args(argv)

    if args.check:
        return check(args.table)
    if args.run_sweep:
        if args.backend != SWEEP_BACKEND:
            ap.error(f"--run-sweep measures the card: --backend {SWEEP_BACKEND}")
        from repro_torch.tools.sweep import run_sweep
        res = run_sweep(log=lambda s: print(s, flush=True))
        prov = dict(card_provenance(args.git_rev), sweep_seconds=res["seconds"],
                    build_seconds=res["build_seconds"])
        _write_json(sweep_path(args.table), {"provenance": prov, "rows": res["rows"]})
        print(f"wrote {sweep_path(args.table)} ({len(res['rows'])} rows, "
              f"{res['seconds']:.1f} s)")
        rows = res["rows"]
    else:
        data = _read_json(args.rows)
        rows, prov = (data["rows"], data.get("provenance", {})) \
            if isinstance(data, dict) else (data, {})
    problems = write_backend(rows, prov, args.backend, args.table)
    for p in problems:
        print(f"FAIL: {p}")
    print(f"wrote {args.table}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())

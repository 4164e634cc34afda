"""Compare the linear-recurrence pipeline of two trees on one card, in one call.

Each tree is a checkout of this repository (the parent unpacked with ``git archive``
into a directory that ``.gitignore`` lists, say ``build/ab/parent``).  The trees run
in the order parent, change, change, parent, each in a process of its own that
imports that tree's ``chip_smoke.py``, builds its kernels, and runs its
``time_linrec`` and its ``adjoint_check`` of ``linear_scan(method="blocked")`` at
``SCAN_SHAPE`` (the launches a tree's own pipeline makes: B14 and B16, with B15
where the tree has no ``linrec_mm.fuses_carries``).  Each run's results go to
``OUT/ab_<label>_<i>.json``.

    python3 tools/chip_ab.py build/ab/parent . --out build/ab
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

_RUN = r'''
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as c
from repro_torch.kernels import linrec_mm

label, out = sys.argv[1], sys.argv[2]
t0 = time.time()
c._build.build_all()
gen = torch.Generator(device="cuda").manual_seed(1234)
timing = c.time_linrec(gen)
gen = torch.Generator(device="cuda").manual_seed(99)
a, b = c.lin_inputs(gen, c.SCAN_SHAPE)["random"]
g = torch.randn(c.SCAN_SHAPE, generator=gen, device="cuda")
want = {"linrec_summaries": 1, "linrec_block_scan": 1}
if not hasattr(linrec_mm, "fuses_carries"):
    want["linrec_carry"] = 1
adjoint = c.adjoint_check(a, b, g, -1, "blocked", want)
res = {"label": label, "seconds": time.time() - t0, "time_linrec": timing,
       "adjoint_blocked": {"shape": list(c.SCAN_SHAPE), **adjoint}}
with open(out, "w") as f:
    json.dump(res, f, indent=1)
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="the parent tree")
    ap.add_argument("change", help="the changed tree")
    ap.add_argument("--out", default="build/ab", help="directory for the results")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for i, label in enumerate(("parent", "change", "change", "parent"), 1):
        tree = Path(getattr(args, label)).resolve()
        dest = out / f"ab_{label}_{i}.json"
        env = {**os.environ, "PYTHONPATH": str(tree / "src")}
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", _RUN, label, str(dest)], cwd=tree, env=env,
                       check=True)
        print(json.dumps({"label": label, "run": i, "seconds": time.perf_counter() - t0,
                          "results": str(dest)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

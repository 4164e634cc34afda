"""Summarize the port's dry-run JSON records into roofline tables.

Port of ``repro/analysis/report.py`` over the records of
``launch/dryrun.py`` (``--out``), under the H100's HBM rate and bf16 peak
(``analysis/roofline.py``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
    PYTHONPATH=src python -m repro_torch.analysis.report [--dir experiments/dryrun]

The table is JAX's, row for row in ``ARCH_ORDER`` × ``SHAPE_ORDER``:
``compute``, ``mem(hlo)`` (the port's counted bytes, not an HLO's),
``mem(lb)`` (arguments + outputs over HBM), ``collective``, the bottleneck of
the three with the lower bound in memory's place, MFU at that bound and
``useful_fraction`` (MODEL/HLO).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.analysis.roofline import BF16_OPS_PER_S, HBM_BYTES_PER_S

__all__ = ["ARCH_ORDER", "SHAPE_ORDER", "load", "fmt_s", "derived_terms", "table", "main"]

ARCH_ORDER = ["whisper-small", "gemma2-2b", "qwen3-4b", "minicpm3-4b",
              "llama3-8b", "paligemma-3b", "zamba2-1.2b",
              "llama4-scout-17b-16e", "deepseek-moe-16b", "xlstm-350m"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(d, prefer: str = "experiments/final"):
    """Load records; cells re-measured with the final code (``prefer`` dir)
    override the originals."""
    by_cell = {}
    for src in (d, prefer):
        if not os.path.isdir(src):
            continue
        for f in glob.glob(os.path.join(src, "dryrun_*.json")):
            with open(f) as fh:
                r = json.load(fh)
            if r.get("status") == "fail" and (r["arch"], r["shape"],
                                              r["mesh"]) in by_cell:
                continue
            by_cell[(r["arch"], r["shape"], r["mesh"])] = r
    recs = list(by_cell.values())

    def key(r):
        return (ARCH_ORDER.index(r["arch"]) if r["arch"] in ARCH_ORDER
                else 99, SHAPE_ORDER.index(r["shape"]), r["mesh"])
    return sorted(recs, key=key)


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}µs"


def derived_terms(r):
    """The memory lower bound (arguments + outputs over the H100's HBM rate),
    the bottleneck with it in memory's place, and MFU at that bound: the
    model's flops a chip over the bf16 peak, over the bound's step time."""
    bpd = r["bytes_per_device"]
    mem_lb = (bpd["arguments"] + bpd["output"]) / HBM_BYTES_PER_S
    ro = r["roofline"]
    step = max(ro["compute_s"], mem_lb, ro["collective_s"])
    ideal = r["model_flops_per_chip"] / BF16_OPS_PER_S
    terms = {"compute": ro["compute_s"], "memory(lb)": mem_lb,
             "collective": ro["collective_s"]}
    return mem_lb, max(terms, key=terms.get), (ideal / step if step else 0.0)


def table(recs, mesh):
    print(f"\n### Roofline — {mesh} pod mesh "
          f"({'2×16×16 = 512' if mesh == 'multi' else '16×16 = 256'} chips)\n")
    print("| arch | shape | compute | mem(hlo) | mem(lb) | collective | "
          "bottleneck | MFU@bound | MODEL/HLO | args GB/dev |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skip":
            print(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                  f"skipped: {r['reason'][:40]} | — | — | — |")
            continue
        if r["status"] != "ok":
            print(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                  f"**FAIL** {r['error'][:38]} | — | — | — |")
            continue
        ro = r["roofline"]
        bpd = r["bytes_per_device"]
        mem_lb, bneck, mfu = derived_terms(r)
        print(f"| {r['arch']} | {r['shape']} | {fmt_s(ro['compute_s'])} | "
              f"{fmt_s(ro['memory_s'])} | {fmt_s(mem_lb)} | "
              f"{fmt_s(ro['collective_s'])} | {bneck} | {mfu:.3f} | "
              f"{r['useful_fraction']:.2f} | "
              f"{bpd['arguments'] / 2**30:.2f} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="both")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    ok = sum(r["status"] == "ok" for r in recs)
    skip = sum(r["status"] == "skip" for r in recs)
    fail = len(recs) - ok - skip
    print(f"{len(recs)} records: {ok} ok, {skip} skipped (documented), "
          f"{fail} failed")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for m in meshes:
        table(recs, m)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

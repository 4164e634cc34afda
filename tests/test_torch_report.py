"""The port's dry-run report (``repro_torch.analysis.report``) against JAX's.

The port's dry run writes records (``launch/dryrun.py --out``) of three archs
on the DEBUG grids of one and two pods, a skipped cell among them, plus a
failed record; both packages' ``table`` render them.  The port's table has
JAX's layout: the same heading and header lines, the same rows in
``ARCH_ORDER`` × ``SHAPE_ORDER``, and the same cells but those that hold the
card's constants (``mem(lb)``, the bottleneck read with it and MFU), which
:func:`~repro_torch.analysis.report.derived_terms` gives under the H100's HBM
rate and bf16 peak, by formula.
"""
from __future__ import annotations

import json
import os

import pytest
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.analysis import report as jax_report
from repro_torch.analysis import report
from repro_torch.analysis.roofline import BF16_OPS_PER_S, HBM_BYTES_PER_S
from repro_torch.launch import dryrun

ARCHS = ("whisper-small", "llama3-8b", "zamba2-1.2b")
CARD_COLUMNS = (5, 7, 8)            # mem(lb), bottleneck, MFU@bound (after the leading "")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    for arch in ARCHS:
        assert dryrun.main(["--arch", arch, "--all", "--mesh", "both", "--debug-mesh",
                            "--out", str(out)]) == 0
    with open(out / "dryrun_xlstm-350m_train_4k_single.json", "w") as f:
        json.dump({"arch": "xlstm-350m", "shape": "train_4k", "mesh": "single",
                   "status": "fail", "error": "RuntimeError: planted"}, f)
    return out


def _rows(text):
    return [line for line in text.splitlines() if line.startswith("|")]


def test_load_orders_jax_s_way(records):
    recs = report.load(str(records), prefer=str(records / "none"))
    want = jax_report.load(str(records), prefer=str(records / "none"))
    assert [(r["arch"], r["shape"], r["mesh"]) for r in recs] == \
        [(r["arch"], r["shape"], r["mesh"]) for r in want]
    assert {r["status"] for r in recs} == {"ok", "skip", "fail"}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_table_has_jax_s_layout(records, mesh, capsys):
    recs = report.load(str(records), prefer=str(records / "none"))
    report.table(recs, mesh)
    ours = capsys.readouterr().out
    jax_report.table(recs, mesh)
    theirs = capsys.readouterr().out
    assert ours.splitlines()[:4] == theirs.splitlines()[:4]       # heading and header
    ours_rows, theirs_rows = _rows(ours), _rows(theirs)
    assert len(ours_rows) == len(theirs_rows) > 2
    for a, b in zip(ours_rows, theirs_rows):
        ca, cb = a.split("|"), b.split("|")
        assert len(ca) == len(cb)
        if "—" in a:                                              # skipped or failed
            assert a == b
            continue
        assert [c for i, c in enumerate(ca) if i not in CARD_COLUMNS] == \
            [c for i, c in enumerate(cb) if i not in CARD_COLUMNS]


def test_derived_terms_are_the_formula(records):
    for r in report.load(str(records), prefer=str(records / "none")):
        if r["status"] != "ok":
            continue
        by, ro = r["bytes_per_device"], r["roofline"]
        mem_lb = (by["arguments"] + by["output"]) / HBM_BYTES_PER_S
        terms = {"compute": ro["compute_s"], "memory(lb)": mem_lb,
                 "collective": ro["collective_s"]}
        step = max(terms.values())
        assert report.derived_terms(r) == (
            mem_lb, max(terms, key=terms.get),
            r["model_flops_per_chip"] / BF16_OPS_PER_S / step)


def test_cli_renders_the_records(records, capsys):
    cwd = os.getcwd()
    os.chdir(records)                       # no experiments/final here
    try:
        assert report.main(["--dir", str(records)]) == 0
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    assert "skipped (documented), 1 failed" in out
    assert "### Roofline — single pod mesh" in out and "### Roofline — multi pod mesh" in out
    assert "**FAIL** RuntimeError: planted" in out

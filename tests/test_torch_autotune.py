"""``method="auto"`` in the port: the table's builder, the committed table, the probe.

Held against the JAX package on the same inputs: ``parse_bench_rows``,
``build_table`` and ``validate_table`` on seeded synthetic rows and on JAX's
bad tables, ``_probe_family`` on every op.  The committed table keeps JAX's
keys and ``"cpu"`` backend and adds a ``"cuda"`` backend that ``build_table``
reproduces from the committed sweep rows (``tools.tune --check``).  The
backend probe raises ``KernelUnavailableError`` where JAX degrades: JAX's
probe tests (``tests/test_guards.py``, ``tests/test_faults.py``) as raises.
"""
from __future__ import annotations

import json
import pathlib
import warnings

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.core import autotune as jax_autotune
from repro.core import guards as jax_guards
from repro_torch.analysis import faults
from repro_torch.core import autotune, guards
from repro_torch.core.primitives import split
from repro_torch.core.scan import scan
from repro_torch.kernels import _build
from repro_torch.tools import tune

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_TABLE = ROOT / "src" / "repro_torch" / "configs" / "tuning" / "default.json"
JAX_TABLE = ROOT / "src" / "repro" / "configs" / "tuning" / "default.json"
SWEEP = ROOT / "src" / "repro_torch" / "configs" / "tuning" / "cuda_sweep.json"
CPU = torch.device("cpu")
METHODS = ("matmul", "vector", "kernel", "blocked")
ALL_OPS = sorted(set(autotune.TUNED_OPS) | set(autotune.OP_ALIASES))


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    autotune._reset_for_testing()
    guards._reset_probes_for_testing()
    yield
    autotune._reset_for_testing()
    guards._reset_probes_for_testing()


def _committed():
    return json.loads(PORT_TABLE.read_text())


# ---- the builder, against JAX's on the same rows ----


def synthetic_rows(seed: int) -> list:
    """Rows of every section form JAX's parser reads, and of those it skips."""
    rng = np.random.default_rng(seed)
    us = lambda: float(rng.choice([0.0, 1.0, 2.0, 5.0, 9.0])) if rng.random() < 0.1 \
        else float(rng.uniform(1.0, 1e4))
    rows = []
    for n in (128, 1024, 4096, 16384, 1 << 20):
        for dt in ("float32", "bfloat16", "int8"):
            for m in METHODS + ("auto", "memcpy"):
                rows.append({"name": f"scan_pipeline/{m}/{dt}/n={n}", "us_per_call": us(),
                             "derived": "GB/s=1.0"})
                rows.append({"name": f"ops/split/{dt}/n={n}/{m}", "us_per_call": us()})
                rows.append({"name": f"ops/sort/{dt}/n={n}/{m}", "us_per_call": us()})
                for k in (1, 2, 4, 8):
                    rows.append({"name": f"sort/{dt}/n={n}/{m}/k={k}", "us_per_call": us()})
            rows.append({"name": f"sort/pass_count/{dt}/k=4", "us_per_call": 0.0,
                         "derived": "passes=4;expected=4"})
            rows.append({"name": f"sort/pass_count/{dt}/n={n}/k=4", "us_per_call": us()})
        for m in METHODS + ("auto",):
            rows.append({"name": f"ops/top_p/b=4/v={n}/{m}", "us_per_call": us()})
            rows.append({"name": f"segscan/{m}/S={n // 64}/L=64", "us_per_call": us(),
                         "derived": f"n={n};GB/s=1.0"})
            rows.append({"name": f"segscan/{m}/S=2/L=3", "us_per_call": us(),
                         "derived": "GB/s=1.0"})                    # no n: skipped
            for dt in ("float32", "bfloat16"):
                rows.append({"name": f"linrec/{m}/{dt}/S=4/L={n}", "us_per_call": us()})
    rows += [{"name": "fig3/scanu/n=4096", "us_per_call": 3.0},
             {"name": "ops/split/float32/n=64", "us_per_call": 3.0},   # 4 parts: skipped
             {"name": "precision/scan/kernel/highest/n=2048", "us_per_call": 3.0}]
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_builder_equals_the_jax_package_on_the_same_rows(seed):
    rows = synthetic_rows(seed)
    got = autotune.parse_bench_rows(rows)
    assert got == jax_autotune.parse_bench_rows(rows) and got
    assert {r[3] for r in got} <= set(METHODS)       # memcpy and auto rows never count
    for backend in ("cpu", "cuda"):
        prov = {"seed": seed}
        t = autotune.build_table(rows, backend=backend, provenance=prov)
        assert t == jax_autotune.build_table(rows, backend=backend, provenance=prov)
        assert autotune.validate_table(t) == jax_autotune.validate_table(t) == []
    # a section left out gets an explicit fallback, in both packages
    part = [r for r in rows if not r["name"].startswith("linrec/")]
    t = autotune.build_table(part, backend="cuda")
    assert t == jax_autotune.build_table(part, backend="cuda")
    assert t["fallbacks"] == {"linear_scan": "vector"}


def _bad_tables():
    base = {"schema_version": 1, "provenance": {}, "default_backend": "cpu",
            "backends": {"cpu": {"scan": {"float32": [[1024, "vector"], [8192, "matmul"]],
                                          "int8": [[1024, "kernel"]]},
                                 "sort": {"float32": [[512, "blocked"]]}}},
            "fallbacks": {"linear_scan": "matmul", "split": "vector",
                          "top_p_sample": "vector", "segment_scan": "vector"}}

    def edit(fn):
        t = json.loads(json.dumps(base))
        fn(t)
        return t

    cpu = lambda t: t["backends"]["cpu"]
    return {
        "schema": {"schema_version": 99},
        "descending": edit(lambda t: cpu(t)["scan"].__setitem__(
            "float32", [[8192, "matmul"], [1024, "vector"]])),
        "unknown_fallback": edit(lambda t: t["fallbacks"].__setitem__("linear_scan", "warp")),
        "not_a_dtype": edit(lambda t: cpu(t)["scan"].__setitem__("float33", [[1, "vector"]])),
        "empty_buckets": edit(lambda t: cpu(t)["sort"].__setitem__("float32", [])),
        "empty_op": edit(lambda t: cpu(t).__setitem__("split", {})),
        "bad_bucket": edit(lambda t: cpu(t)["sort"].__setitem__("float32", [[1.5, "v"]])),
        "repeated_breakpoint": edit(lambda t: cpu(t)["sort"].__setitem__(
            "float32", [[512, "vector"], [512, "kernel"]])),
        "no_default_backend": edit(lambda t: t.__setitem__("default_backend", "tpu")),
        "no_backends": edit(lambda t: t.__setitem__("backends", {})),
        "uncovered": edit(lambda t: t.__setitem__("fallbacks", {})),
        "ok": base,
    }


@pytest.mark.parametrize("name", sorted(_bad_tables()))
def test_validate_table_equals_the_jax_package(name):
    table = _bad_tables()[name]
    got = autotune.validate_table(table)
    assert got == jax_autotune.validate_table(table)
    assert bool(got) == (name != "ok")
    if name == "descending":
        assert any("ascending" in p for p in got)
    if name == "unknown_fallback":
        assert any("warp" in p for p in got)


def test_merge_backend_keeps_every_other_key():
    table = _committed()
    built = autotune.build_table(synthetic_rows(0), backend="cuda", provenance={"p": 1})
    merged = autotune.merge_backend(table, built)
    assert merged["backends"]["cuda"] == built["backends"]["cuda"]
    assert merged["provenance"]["cuda"] == {"p": 1}
    for k in ("schema_version", "default_backend", "fallbacks"):
        assert merged[k] == table[k]
    assert merged["backends"]["cpu"] == table["backends"]["cpu"]
    assert table == _committed()                       # the input is not modified


# ---- the committed table ----


def test_committed_table_is_valid_and_every_backend_covers_the_tuned_ops():
    table = _committed()
    assert autotune.validate_table(table) == []
    assert set(table["backends"]) == {"cpu", "cuda"}
    for btab in table["backends"].values():
        assert set(autotune.TUNED_OPS) <= set(btab)
    assert autotune.load_table() == table             # package data is the file


def test_committed_cuda_backend_is_rebuilt_from_the_committed_sweep():
    sweep = json.loads(SWEEP.read_text())
    built = autotune.build_table(sweep["rows"], backend="cuda")
    assert built["fallbacks"] == {}
    assert built["backends"]["cuda"] == _committed()["backends"]["cuda"]
    prov = sweep["provenance"]
    assert prov["nvidia_smi"] and "H100" in prov["nvidia_smi"]
    assert _committed()["provenance"]["cuda"]["nvidia_smi"] == prov["nvidia_smi"]


def test_committed_table_without_cuda_is_the_jax_package_copy():
    ours = _committed()
    del ours["backends"]["cuda"], ours["provenance"]["cuda"]
    assert ours == json.loads(JAX_TABLE.read_text())


def test_tune_check_passes(capsys):
    assert tune.main(["--check"]) == 0
    assert "OK" in capsys.readouterr().out


def test_tune_check_catches_drift(tmp_path, capsys):
    table = _committed()
    ops = table["backends"]["cuda"]["scan"]["float32"]
    ops[0][1] = next(m for m in METHODS if m != ops[0][1])
    path = tmp_path / "default.json"
    path.write_text(json.dumps(table))
    (tmp_path / "cuda_sweep.json").write_text(SWEEP.read_text())
    assert tune.main(["--check", "--table", str(path)]) == 1
    out = capsys.readouterr().out
    assert "FAIL(drift)" in out and "FAIL(package)" in out


# ---- resolution ----


def _family_dtypes(table, op):
    return sorted(table["backends"]["cuda"][autotune.OP_ALIASES.get(op, op)])


@pytest.mark.parametrize("op", ALL_OPS)
def test_cuda_resolves_without_a_warning(op):
    table = _committed()
    fam = autotune.OP_ALIASES.get(op, op)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for dt in _family_dtypes(table, op):
            entries = table["backends"]["cuda"][fam][dt]
            for n in sorted({1} | {b for b, _ in entries} | {max(b - 1, 1) for b, _ in entries}):
                want = entries[0][1]
                for b, m in entries:
                    if n >= b:
                        want = m
                got = autotune.resolve_method(op, n, getattr(torch, dt), backend="cuda")
                assert got == want, (op, dt, n)


def test_unknown_backend_still_warns_once_and_falls_to_cpu():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = [autotune.resolve_method("scan", 1 << 20, torch.float32, backend="xpu")
             for _ in range(2)]
    assert m[0] == m[1] == autotune.resolve_method("scan", 1 << 20, torch.float32,
                                                   backend="cpu")
    hits = [x for x in w if issubclass(x.category, autotune.AutotuneFallbackWarning)]
    assert len(hits) == 1 and "'xpu'" in str(hits[0].message)


def test_the_overrides_beat_the_cuda_table(monkeypatch):
    table = _committed()["backends"]["cuda"]["scan"]["float32"]
    n = table[-1][0]
    other = next(m for m in ("matmul", "vector") if m != table[-1][1])
    monkeypatch.setenv(autotune.ENV_VAR, other)
    assert autotune.resolve_method("scan", n, torch.float32, backend="cuda") == other
    with autotune.method_override("blocked"):
        assert autotune.resolve_method("scan", n, torch.float32, backend="cuda") == "blocked"
    monkeypatch.setenv(autotune.ENV_VAR, "auto")
    assert autotune.resolve_method("scan", n, torch.float32, backend="cuda") == table[-1][1]


# ---- the backend probe: a raise where JAX degrades ----


def test_probe_passes_on_the_cpu_without_building(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built on the CPU"))
    assert guards.probe_build("scan", "kernel", device=CPU) is None
    assert guards.ensure_available("kernel", "scan", device=CPU) == "kernel"
    assert guards._PROBE_CACHE == {}


def test_probe_on_a_card_loads_the_family_once(monkeypatch):
    loaded = []
    monkeypatch.setattr(_build, "load", loaded.append)
    for _ in range(3):
        assert guards.ensure_available("blocked", "segment_sort",
                                       device=torch.device("cuda")) == "blocked"
    assert loaded == list(guards.PROBE_LIBRARIES[("segment_scan", "blocked")])
    assert guards._PROBE_CACHE == {("segment_scan", "blocked"): None}


def test_a_failed_build_raises_and_names_op_method_family_and_nvcc(monkeypatch):
    calls = []

    def fail(name):
        calls.append(name)
        raise RuntimeError(f"nvcc failed for {name}.cu:\nerror: identifier undefined")

    monkeypatch.setattr(_build, "load", fail)
    for _ in range(2):
        with pytest.raises(guards.KernelUnavailableError) as e:
            guards.ensure_available("kernel", "topk", device=torch.device("cuda"))
    msg = str(e.value)
    assert "topk" in msg and "'kernel'" in msg and "'sort'" in msg
    assert "nvcc failed for radix_pass.cu" in msg and "identifier undefined" in msg
    assert calls == ["radix_pass"]                    # tried once a process
    assert isinstance(e.value, RuntimeError)


def test_forced_probe_failure_raises_on_explicit_and_resolved_calls():
    x = torch.tensor([3, 1, 4, 1, 5], dtype=torch.int32)
    f = torch.tensor([1, 0, 1, 0, 1], dtype=torch.bool)
    with guards.force_probe_failure("scan", "kernel"):
        with pytest.raises(guards.KernelUnavailableError, match="'kernel'"):
            guards.ensure_available("kernel", "scan", device=CPU)
        with pytest.raises(guards.KernelUnavailableError):
            scan(x.float(), method="kernel")
        with autotune.method_override("kernel"):           # "auto" resolved to kernel
            with pytest.raises(guards.KernelUnavailableError):
                scan(x.float())
        assert guards.ensure_available("blocked", "scan", device=CPU) == "blocked"
    assert guards.ensure_available("kernel", "scan", device=CPU) == "kernel"
    with guards.force_probe_failure():
        for m in ("kernel", "blocked"):
            with pytest.raises(guards.KernelUnavailableError):
                split(x, f, method=m)


def test_forced_probe_failure_raises_on_a_table_resolved_call(monkeypatch):
    table = _committed()
    table["backends"]["cpu"]["scan"] = {"float32": [[1, "blocked"]]}
    monkeypatch.setattr(autotune, "_TABLE_CACHE", [table])
    assert autotune.maybe_resolve("auto", "scan", 8, torch.float32, device=CPU) == "blocked"
    with guards.force_probe_failure():
        with pytest.raises(guards.KernelUnavailableError, match="'blocked'"):
            scan(torch.ones(8))


def test_matmul_and_vector_never_probe(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("probed"))
    x = torch.arange(8.0)
    with guards.force_probe_failure():
        for m in ("matmul", "vector"):
            assert guards.ensure_available(m, "scan", device=torch.device("cuda")) == m
            assert torch.equal(scan(x, method=m), torch.cumsum(x, 0))


def test_probe_bypassed_under_guards_disabled():
    with guards.force_probe_failure():
        with guards.guards_disabled():
            assert guards.ensure_available("kernel", "scan", device=CPU) == "kernel"
            assert scan(torch.ones(4), method="kernel").tolist() == [1, 2, 3, 4]


@pytest.mark.parametrize("op", ALL_OPS + ["not_an_op"])
def test_probe_family_equals_the_jax_package(op):
    for m in ("kernel", "blocked"):
        fam = guards._probe_family(op, m)
        assert fam == jax_guards._probe_family(op, m)
        assert all(lib in _build.SOURCES for lib in guards.PROBE_LIBRARIES[(fam, m)])


def test_lowering_failure_raises_through_classify():
    """JAX's ``test_lowering_failure_degrades_scan``: ``"degraded"`` there, a raise here."""
    assert "degraded" not in faults.OUTCOMES
    with guards.force_probe_failure():
        with pytest.raises(guards.KernelUnavailableError):
            faults.classify(scan, torch.arange(5.0), method="kernel")
    assert faults.classify(scan, torch.arange(5.0), method="kernel")[0] == "ok"


def test_lowering_failure_gives_no_result():
    """JAX's ``test_lowering_failure_result_matches_fallback``: no fallback result."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, 9, 64), dtype=torch.int32)
    f = torch.as_tensor(np.random.default_rng(1).integers(0, 2, 64).astype(bool))
    with guards.force_probe_failure():
        with pytest.raises(guards.KernelUnavailableError):
            split(x, f, method="kernel")
    z, ind, cnt = split(x, f, method="kernel")
    zr, indr, cntr = split(x, f, method="vector")
    assert torch.equal(z, zr) and torch.equal(ind, indr) and int(cnt) == int(cntr)


def test_the_sweep_refuses_to_run_without_a_card(monkeypatch):
    from repro_torch.tools import sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never times the CPU"):
        sweep.run_sweep()

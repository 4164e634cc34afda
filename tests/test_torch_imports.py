"""Guards of the PyTorch port: import boundary, device defaults, CPU fallbacks.

The port (``src/repro_torch``, the rank entry point of its distributed
worlds ``launch/world.py`` included), ``chip_smoke.py`` and the rank-side
cases of the distributed tests (``tests/torch_dist_worlds.py``,
``tests/torch_mesh_worlds.py``) import
neither JAX nor the JAX package; its entry points default to the GPU and refuse to carry on
quietly without one; its kernel wrappers take the plain path only for CPU
tensors, and then count no launch.
"""
from __future__ import annotations

import ast
import json
import os
import pathlib
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig, ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import autotune, guards, precision
from repro_torch.kernels import (_build, linrec_mm, ops, scan_mm, scan_pipeline, segscan_mm,
                                 split_mm, ssd_chunk)
from repro_torch.models.model import build_model, get_config, synth_batch
from repro_torch.serving.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_worlds.py",
    ROOT / "tests" / "torch_mesh_worlds.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "repro"), f"{path} imports {mod}"


def test_port_has_every_kernel_source():
    names = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert names == set(_build.SOURCES) == set(ops.KERNELS)


def test_engine_and_init_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU refusal cannot be shown here")
    cfg = get_config("llama3-8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        guards.resolve_device("cuda", op="t")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.ones((2, 2), np.float32)})
    assert guards.resolve_device("cpu", op="t") == torch.device("cpu")


def test_cpu_wrappers_take_the_plain_path_and_count_nothing():
    ops.reset_launch_counts()
    x = torch.arange(300, dtype=torch.int32).reshape(3, 100)
    scan_mm.scan_tiles(x, s=8)
    ops.radix_sort_enc_kernel(x.to(torch.int16), bits=16, bits_per_pass=4)
    split_mm.radix_pass_multibit(x, x, shift=4, pass_bits=4, with_counts=True)
    split_mm.topp_mask_sample_tiles(torch.full((2, 5), 0.2), torch.full((2, 1), 0.5), p=0.9)
    scan_pipeline.blocked_scan(torch.ones((2, 5000)), s=8, block_tiles=1)   # nb > 1
    split_mm.split_tiles(x, x % 3 == 0)
    segscan_mm.seg_scan_tiles(x, x % 7 == 0, s=8)
    segscan_mm.seg_blocked_scan(torch.ones((2, 5000)), torch.arange(5000) % 900 == 0, s=8,
                                block_tiles=1)                              # nb > 1
    a = torch.full((2, 5000), 0.5)
    linrec_mm.linrec_scan_tiles(a, torch.ones((2, 5000)), s=8)
    linrec_mm.linrec_blocked_scan(a, torch.ones((2, 5000)), s=8, block_tiles=1)  # nb > 1
    blocks = a.reshape(2, 5, 1000, 1)
    prods, lasts = linrec_mm.linrec_block_summaries(blocks, blocks)
    linrec_mm.linrec_block_scan_carry(blocks, blocks, linrec_mm.linrec_carry_scan(prods, lasts))
    split_mm.multi_split_tiles(x, x % 5, num_buckets=5)
    ssd_chunk.ssd_chunk_scan(torch.ones((1, 40, 2, 4)), -torch.ones((1, 40, 2)),
                             torch.ones((1, 40, 2, 3)), torch.ones((1, 40, 2, 3)), chunk=16)
    assert ops.launch_counts() == {"scan_mm": 0, "radix_pass": 0, "radix_pass_hist": 0,
                                   "topp_tail": 0,
                                   "block_sums": 0, "carry_scan": 0, "block_scan": 0,
                                   "split": 0, "seg_scan": 0, "seg_summaries": 0,
                                   "seg_carry": 0, "seg_block_scan": 0, "linrec_scan": 0,
                                   "linrec_summaries": 0, "linrec_carry": 0,
                                   "linrec_block_scan": 0, "multi_split": 0, "ssd_chunk": 0}


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_paths_are_keyed_by_source_hash():
    p = _build._lib_path("scan_mm")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("scan_mm_")
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


_BASE = dict(n_layers=2, d_model=8, n_heads=2, n_kv_heads=2, d_ff=16, vocab_size=32)
_FAMILIES = {"mla": "minicpm3-4b", "xlstm": "xlstm-350m", "encdec": "whisper-small",
             "vlm": "paligemma-3b"}


@pytest.mark.parametrize("kind", ["mla", "xlstm", "encdec", "vlm", "act"])
def test_transformer_rejects_unported_kinds(kind):
    """MLA, xLSTM, enc-dec and VLM, once refused here, build since their port,
    and their SMOKE ``forward`` gives one row of logits a position; what is still
    unported, an activation outside ``ACTS``, is refused."""
    if kind == "act":
        with pytest.raises(NotImplementedError, match="not ported"):
            build_model(ModelConfig(name="act", family="decoder", act="swish", **_BASE))
        return
    cfg = get_config(_FAMILIES[kind], smoke=True)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    batch = synth_batch(cfg, ShapeConfig("smoke", 12, 2, "train"), gen)
    logits = model.forward(model.init(0, device="cpu"), batch)
    assert tuple(logits.shape) == (2, 12, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    # the MoE family, once refused here, builds since the MoE layer was ported
    build_model(ModelConfig(name="moe", family="moe", moe=MoEConfig(
        n_experts=2, top_k=1, d_ff_expert=8), **_BASE))


# ---- validation guards ----


@pytest.mark.parametrize("kw,exc", [
    (dict(sampler="beam"), ValueError),
    (dict(bits_per_pass=9), ValueError),
    (dict(top_p=1.5), ValueError),
    (dict(temperature=-1.0), ValueError),
    (dict(temperature=float("nan")), ValueError),
    (dict(max_len=0), ValueError),
])
def test_engine_validates_arguments(kw, exc):
    with pytest.raises(exc):
        ServeEngine(get_config("llama3-8b", smoke=True), None, device="cpu", **kw)


def test_guard_helpers():
    assert guards.validate_axis(-1, 3, op="t") == 2
    with pytest.raises(ValueError):
        guards.validate_axis(3, 3, op="t")
    with pytest.raises(ValueError):
        guards.validate_axis(0, 0, op="t")
    with pytest.raises(ValueError):
        guards.validate_probability(float("nan"), op="t")
    with pytest.raises(ValueError):
        guards.validate_same_shape((2, 3), (3, 2), op="t")
    assert guards.resolve_nonfinite("sanitize", op="t") == "sanitize"
    assert guards.resolve_nonfinite("raise", op="t") == "raise"
    with pytest.raises(ValueError):
        guards.resolve_nonfinite("ignore", op="t")


def test_precision_highest_only_and_no_tf32():
    assert precision.resolve_precision("compensated", method="matmul") == "compensated"
    with pytest.raises(ValueError):
        precision.resolve_precision("fast", method="vector")
    with pytest.raises(ValueError, match="unknown precision"):
        precision.resolve_precision("exact", method="matmul")
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            precision.require_ieee_fp32()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    precision.require_ieee_fp32()


def test_pdot_widens_int8_before_the_product():
    a = torch.full((1, 4), 100, dtype=torch.int8)
    assert (a @ a.t()).item() != 40000                   # torch's own int8 product wraps
    assert precision.pdot(a, a.t(), acc=torch.int32).item() == 40000


# ---- method="auto" resolution chain ----


def test_autotune_chain(monkeypatch):
    autotune._reset_for_testing()
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    table = autotune.load_table()
    assert table["schema_version"] == 1 and "cpu" in table["backends"]
    assert autotune.resolve_method("scan", 100, torch.float32, backend="cpu") == "vector"
    assert autotune.resolve_method("cumsum", 1 << 20, torch.float32,
                                   backend="cpu") == "matmul"
    # missing dtype -> float32 entry
    assert autotune.resolve_method("scan", 1 << 20, torch.int16, backend="cpu") == "matmul"
    monkeypatch.setenv(autotune.ENV_VAR, "vector")
    assert autotune.resolve_method("scan", 1 << 20, torch.float32, backend="cpu") == "vector"
    with autotune.method_override("kernel"):
        assert autotune.resolve_method("scan", 8, torch.float32, backend="cpu") == "kernel"
    monkeypatch.setenv(autotune.ENV_VAR, "cube")
    with pytest.raises(ValueError):
        autotune.resolve_method("scan", 8, torch.float32, backend="cpu")


def test_autotune_cuda_falls_back_to_the_default_backend_once(monkeypatch):
    """A backend the table lacks warns once and resolves through ``default_backend``;
    ``"cuda"`` has its own measured backend and resolves with no warning."""
    autotune._reset_for_testing()
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m1 = autotune.resolve_method("scan", 1 << 20, torch.float32, backend="xpu")
        m2 = autotune.resolve_method("scan", 1 << 20, torch.float32, backend="xpu")
    assert m1 == m2 == autotune.resolve_method("scan", 1 << 20, torch.float32,
                                               backend="cpu")
    hits = [x for x in w if issubclass(x.category, autotune.AutotuneFallbackWarning)]
    assert len(hits) == 1 and "'xpu'" in str(hits[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert autotune.resolve_method("scan", 1 << 20, torch.float32,
                                       backend="cuda") in autotune.CONCRETE_METHODS


def test_autotune_table_matches_the_jax_package_copy():
    """The port's table is JAX's with a ``"cuda"`` backend and its provenance added."""
    ours = json.loads((ROOT / "src" / "repro_torch" / "configs" / "tuning" /
                       "default.json").read_text())
    theirs = json.loads((ROOT / "src" / "repro" / "configs" / "tuning" /
                         "default.json").read_text())
    assert "cuda" not in theirs["backends"] and "cuda" in ours["backends"]
    del ours["backends"]["cuda"], ours["provenance"]["cuda"]
    assert ours == theirs


def test_ulp_copy_matches_the_jax_package_oracle():
    from repro.analysis import ulp as jax_ulp
    from repro_torch.analysis import ulp as port_ulp
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 300)).astype(np.float32)
    got = np.cumsum(x, -1, dtype=np.float32)
    assert port_ulp.ulp_bound("highest", 300) == jax_ulp.ulp_bound("highest", 300)
    assert port_ulp.max_ulp(got, port_ulp.scan_ref(x), port_ulp.scan_scale(x)) == \
        jax_ulp.max_ulp(got, jax_ulp.scan_ref(x), jax_ulp.scan_scale(x))

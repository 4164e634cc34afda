"""The port's examples (``examples/torch_*.py``) on the CPU, held to the JAX package.

Each example's ``main([..., "--device", "cpu"])`` runs in-process at small
arguments and every check it prints holds.  Where an example's inputs come
from numpy (``torch_quickstart.py``, ``torch_scan_operators.py``), its results
are held to JAX's library calls on the same inputs and, for the samplers, the
same uniforms (``u=``): integers, sorts, permutations and sampled tokens
bit-equal, float scans within twice ``ulp_bound("highest", n)`` of JAX's.
Each JAX call is jitted (one compile, cheaper than its eager primitives).
"""
from __future__ import annotations

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.analysis.ulp import max_ulp, scan_scale, segment_scan_scale, ulp_bound
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import (SegmentedBatch as JaxSegmentedBatch, compress as jax_compress,
                        radix_sort as jax_radix_sort, scan as jax_scan,
                        segment_cumsum as jax_segment_cumsum,
                        segment_sort as jax_segment_sort,
                        segment_top_p_sample as jax_segment_top_p_sample,
                        segment_topk as jax_segment_topk, split as jax_split,
                        top_p_sample as jax_top_p_sample, topk as jax_topk,
                        weighted_sample as jax_weighted_sample)
from repro.models.model import build_model as jax_build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The examples' CPU work is small: one torch thread, not a pool that
    contends with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _example(name: str):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _run(name: str, *argv: str) -> dict:
    out = _example(name).main([*argv, *CPU])
    assert out["checks"] and all(out["checks"].values()), out["checks"]
    return out


def _jax(fn, *args):
    """``fn(*args)`` of JAX arrays, jitted, as numpy (a tuple for a tuple)."""
    out = jax.jit(fn)(*args)
    return tuple(map(np.asarray, out)) if isinstance(out, tuple) else np.asarray(out)


def _ulp_close(got, want, x, scale=None):
    scale = scan_scale(x) if scale is None else scale
    assert max_ulp(got, want, scale) <= 2 * ulp_bound("highest", x.shape[-1])


# ---- torch_quickstart.py ----


def test_quickstart_scans_match_jax():
    out = _run("quickstart")
    x = np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
    jx = jnp.asarray(x)
    vec = _jax(lambda v: jax_scan(v, method="vector"), jx)
    _ulp_close(out["y_vec"], vec, x)
    _ulp_close(out["y_mm"], _jax(lambda v: jax_scan(v, method="matmul", variant="scanul1",
                                                    tile_s=128), jx), x)
    _ulp_close(out["y_auto"], _jax(jax_scan, jx), x)
    _ulp_close(out["y_blocked"], vec, x)
    _ulp_close(out["y_kernel"], vec[:16384], x[:16384])


def test_quickstart_integers_sorts_and_samples_equal_jax():
    out = _run("quickstart")
    mask = jnp.asarray(np.random.default_rng(1).random(10_000) < 0.3, jnp.int8)
    jpos = _jax(lambda m: jax_scan(m, exclusive=True), mask)
    assert out["positions"].dtype == np.int32
    np.testing.assert_array_equal(out["positions"], jpos)
    assert out["n_true"] == int(jpos[-1] + np.asarray(mask)[-1])
    vals = jnp.asarray(np.random.default_rng(2).standard_normal(4096), jnp.float16)
    sv, order = _jax(lambda v: jax_radix_sort(v, descending=True), vals)
    np.testing.assert_array_equal(out["sorted"], sv)
    np.testing.assert_array_equal(out["order"], order)
    kept, count = _jax(lambda v: jax_compress(v, v > 0), vals)
    np.testing.assert_array_equal(out["kept"], kept)
    assert out["count"] == int(count)
    tv, ti = _jax(lambda v: jax_topk(v, 5), vals)
    np.testing.assert_array_equal(out["topk_values"], tv)
    np.testing.assert_array_equal(out["topk_indices"], ti)
    logits = jnp.asarray(np.random.default_rng(3).standard_normal((2, 1000)) * 2,
                         jnp.float32)
    toks = _jax(lambda lg, u: jax_top_p_sample(lg, jax.random.PRNGKey(0), p=0.9, u=u),
                logits, jnp.asarray(out["u"]))
    np.testing.assert_array_equal(out["top_p"], toks)


# ---- torch_scan_operators.py ----


def test_scan_operators_equal_jax():
    out = _run("scan_operators")
    rng = np.random.default_rng(0)
    T, E = 8192, 64
    expert_of = jnp.asarray(rng.integers(0, E, T), jnp.int32)
    onehot = (expert_of[:, None] == jnp.arange(E)[None, :]).astype(jnp.int8)
    np.testing.assert_array_equal(out["pos_in_expert"],
                                  _jax(lambda h: jax_scan(h, axis=0, exclusive=True), onehot))
    scores = jnp.asarray(rng.standard_normal(T), jnp.float32)
    kept, n = _jax(lambda v: jax_compress(v, v > 1.0), scores)
    np.testing.assert_array_equal(out["kept"], kept)
    assert out["n_kept"] == int(n)
    logits = jnp.asarray(rng.standard_normal(4096), jnp.float16)
    v, i = _jax(lambda lg: jax_topk(lg, 8), logits)
    np.testing.assert_array_equal(out["topk_values"], v)
    np.testing.assert_array_equal(out["topk_indices"], i)
    w = jnp.asarray(rng.random(100_000), jnp.float32)
    samples = _jax(lambda w, u: jax_weighted_sample(jnp.broadcast_to(w, (8, w.shape[0])),
                                                    None, u=u),
                   w, jnp.asarray(out["weighted_u"]))
    np.testing.assert_array_equal(out["weighted"], samples)
    x = jnp.arange(10, dtype=jnp.float32)
    z, ind, nt = _jax(lambda x: jax_split(x, x % 3 == 0), x)
    np.testing.assert_array_equal(out["split"], z)
    np.testing.assert_array_equal(out["split_indices"], ind)
    assert out["split_n_true"] == int(nt)


def test_scan_operators_segmented_equal_jax():
    out = _run("scan_operators")
    sb = JaxSegmentedBatch.from_ragged(out["docs"])
    vals, offsets = sb.values, sb.offsets
    assert max_ulp(out["segment_cumsum"], _jax(jax_segment_cumsum, vals, offsets),
                   segment_scan_scale(np.asarray(vals), np.asarray(offsets))) <= \
        2 * ulp_bound("highest", vals.size)
    sv, sperm = _jax(lambda v, o: jax_segment_sort(v, o, bits_per_pass=4), vals, offsets)
    np.testing.assert_array_equal(out["segment_sort"], sv)
    np.testing.assert_array_equal(out["segment_perm"], sperm)
    tv, ti, tc = _jax(lambda v, o: jax_segment_topk(v, o, k=2), vals, offsets)
    np.testing.assert_array_equal(out["segment_topk_values"], tv)
    np.testing.assert_array_equal(out["segment_topk_indices"], ti)
    np.testing.assert_array_equal(out["segment_topk_counts"], tc)
    tok = _jax(lambda v, o, u: jax_segment_top_p_sample(v * 3, o, None, p=0.9, u=u),
               vals, offsets, jnp.asarray(out["segment_u"]))
    np.testing.assert_array_equal(out["segment_top_p"], tok)


# ---- the serving and training examples ----


def test_serve_topp_runs_every_sampler():
    out = _run("serve_topp", "--batch", "2", "--prompt-len", "8", "--new-tokens", "4")
    toks = out["tokens"]
    assert list(toks) == ["topp_scan", "topp_kernel", "topp_blocked", "topp_segmented",
                          "topp_xla", "greedy"]
    # one set of uniforms: the scan-built top-p samplers give one stream
    for name in ("topp_kernel", "topp_blocked", "topp_segmented"):
        np.testing.assert_array_equal(toks[name], toks["topp_scan"], err_msg=name)


def test_serve_continuous_streams_match_solo_decode():
    out = _run("serve_continuous")
    st = out["stats"]
    assert st["reqs"] == 6 and st["total_tokens"] == sum(len(s) for s in
                                                         out["streams"].values())
    assert out["host_syncs"] is None                    # measured on the card only


def test_train_lm_trains_and_generates(tmp_path):
    ex = _example("train_lm")
    first = ex.main(["--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
                     str(tmp_path), *CPU])
    assert all(first["checks"].values()) and len(first["losses"]) == 2
    for size in ("10m", "100m"):
        cfg = ex.make_cfg(size)
        model = jax_build_model(JaxModelConfig(**{f: getattr(cfg, f) for f in (
            "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab_size", "dtype", "remat")}))
        n = sum(x.size for x in jax.tree.leaves(
            jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))))
        assert cfg.param_count() == n
    assert first["n_params"] == ex.make_cfg("10m").param_count()


@pytest.mark.parametrize("name", ["quickstart", "scan_operators", "serve_topp",
                                  "serve_continuous", "train_lm"])
def test_examples_name_their_jax_namesake(name):
    """Each example is the counterpart of the JAX example of the same name."""
    assert (ROOT / "examples" / f"{name}.py").exists()
    assert f"examples/{name}.py" in (_example(name).__doc__ or "")

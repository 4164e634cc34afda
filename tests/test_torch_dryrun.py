"""The dry run on the ``"meta"`` device (``repro_torch.launch.dryrun``) against
JAX's ``repro.launch.dryrun``, without compiling.

JAX's side of each cell is built as its ``lower_cell`` builds it, up to the
lowering: ``abstract_state`` (``jax.eval_shape`` of ``init`` and
``adamw_init``), ``jax.eval_shape`` of ``empty_caches``, JAX's own
``param_shardings``, ``batch_specs`` and ``cache_specs`` on an
``AbstractMesh`` of the cell's grid, and each leaf's ``shard_shape`` bytes
(``ceil(dim / n)`` where a split is uneven, which XLA pads to).  Every
(arch, shape) cell on the production and debug grids of one and two pods
gives the port's ``status``, skip reason, ``n_params``, ``model_flops_*``
and ``bytes_per_device.arguments`` equal to JAX's.  JAX traces each arch's
init and caches once (``lru_cache``).  Also here: the abstract init of every
arch, the hybrid stack's ``empty_caches`` and a decode step from them, the
CLI through ``runpy`` as ``tests/test_distributed.py`` runs JAX's, and the
collectives CLI.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import runpy
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jax_dryrun  # noqa: E402  (sets XLA_FLAGS on import)

if _XLA_FLAGS is None:              # keep this process on its own CPU device
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro.analysis import roofline as jax_roofline  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch.sharding_plan import batch_specs as jax_batch_specs  # noqa: E402
from repro.launch.sharding_plan import cache_specs as jax_cache_specs  # noqa: E402
from repro.models.model import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.model import cell_supported as jax_cell_supported  # noqa: E402
from repro.models.model import get_config as jax_get_config  # noqa: E402
from repro.models.model import input_specs as jax_input_specs  # noqa: E402
from repro.utils.sharding import param_shardings as jax_param_shardings  # noqa: E402
from repro_torch.analysis import collectives  # noqa: E402
from repro_torch.configs.base import SHAPES, SMOKE_SHAPE  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import DEBUG, PRODUCTION  # noqa: E402
from repro_torch.models.model import ARCHS, build_model, get_config  # noqa: E402

GRIDS = {"prod-single": ("single", False), "prod-multi": ("multi", False),
         "debug-single": ("single", True), "debug-multi": ("multi", True)}
HYBRID = "zamba2-1.2b"


def _abstract_mesh(mesh_kind, debug, mesh_shape=None):
    if mesh_shape is not None:
        return AbstractMesh(tuple(mesh_shape), ("data", "model"))
    shape, names = (DEBUG if debug else PRODUCTION)[mesh_kind == "multi"]
    return AbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    cfg = jax_get_config(arch)
    return cfg, jax_build_model(cfg)


@functools.lru_cache(maxsize=None)
def _jax_state(arch, param_dtype):
    return jax_dryrun.abstract_state(_jax_model(arch)[1], param_dtype=param_dtype)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_dryrun.abstract_state(_jax_model(arch)[1], opt=False)


@functools.lru_cache(maxsize=None)
def _jax_caches(arch, b, seq):
    return jax.eval_shape(lambda: _jax_model(arch)[1].empty_caches(b, seq))


def _leaf_bytes(sds, sharding) -> int:
    try:
        shape = sharding.shard_shape(sds.shape)
    except ValueError:                  # an uneven split: XLA pads to ceil(dim / n)
        spec = tuple(sharding.spec) + (None,) * (len(sds.shape) - len(sharding.spec))
        shape = [math.ceil(d / math.prod(sharding.mesh.shape[a] for a in
                                         ((e,) if isinstance(e, str) else e or ())))
                 for d, e in zip(sds.shape, spec)]
    return math.prod(shape) * jnp.dtype(sds.dtype).itemsize


def _tree_bytes(tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    specs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(specs)
    return sum(_leaf_bytes(x, s) for x, s in zip(leaves, specs))


def _jax_zero_shard(mesh):
    """JAX's ``lower_cell`` ``zero_shard``, copied (it is a closure there)."""
    def zero_shard(sds, ns):
        parts = list(tuple(ns.spec) + (None,) * (len(sds.shape) - len(ns.spec)))
        for i, (dim, a) in enumerate(zip(sds.shape, parts)):
            if a is None and dim % mesh.shape["data"] == 0 and dim >= mesh.shape["data"]:
                parts[i] = "data"
                break
        return NamedSharding(mesh, P(*parts))
    return zero_shard


def _jax_record(arch, shape_name, mesh, *, zero=False, param_dtype="float32"):
    """JAX's record of the cell, as far as it needs no compiler."""
    cfg, model = _jax_model(arch)
    shape = JAX_SHAPES[shape_name]
    ok, why = jax_cell_supported(cfg, shape)
    if not ok:
        return {"status": "skip", "reason": why}
    if shape.kind == "train":
        state = _jax_state(arch, param_dtype)
        pspecs = jax_param_shardings(mesh, state["params"])
        mspecs = jax_param_shardings(mesh, state["opt"]["mu"])
        if zero:
            mspecs = jax.tree.map(_jax_zero_shard(mesh), state["opt"]["mu"], mspecs)
        batch = jax_input_specs(cfg, shape)
        args = (_tree_bytes(state["params"], pspecs) + 2 * _tree_bytes(state["opt"]["mu"],
                                                                      mspecs)
                + 4 + _tree_bytes(batch, jax_batch_specs(mesh, batch)))
        params = state["params"]
    else:
        params = _jax_params(arch)
        args = _tree_bytes(params, jax_param_shardings(mesh, params))
        if shape.kind == "prefill":
            batch = jax_input_specs(cfg, shape)
            args += _tree_bytes(batch, jax_batch_specs(mesh, batch))
        else:
            b = shape.global_batch
            caches = _jax_caches(arch, b, shape.seq_len)
            tokens = {"tokens": jax.ShapeDtypeStruct((b, 1), jnp.int32)}
            args += (_tree_bytes(caches, jax_cache_specs(mesh, caches, seq_sharded=b == 1))
                     + _tree_bytes(tokens, jax_batch_specs(mesh, tokens)) + 4)
    n_params = sum(x.size for x in jax.tree.leaves(params))
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    flops = jax_roofline.model_flops(n_params, tokens, shape.kind)
    return {"status": "ok", "n_params": n_params, "arguments": args,
            "model_flops_global": flops, "model_flops_per_chip": flops / mesh.size}


def _port_record(arch, shape_name, mesh_kind, debug, **kw):
    try:
        return dryrun.run_cell(arch, shape_name, mesh_kind, debug=debug, **kw)
    except dryrun.SkipCell as e:
        return {"status": "skip", "reason": str(e)}


def _assert_same(got, want):
    assert got["status"] == want["status"]
    if want["status"] == "skip":
        assert got["reason"] == want["reason"]
        return
    assert got["n_params"] == want["n_params"]
    assert got["bytes_per_device"]["arguments"] == want["arguments"]
    assert got["model_flops_global"] == want["model_flops_global"]
    assert got["model_flops_per_chip"] == want["model_flops_per_chip"]


def test_the_cell_vocabulary_is_jax_s():
    assert list(ARCHS) == list(JAX_ARCHS)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    from repro.configs.base import SMOKE_SHAPE as JAX_SMOKE
    assert dataclasses.astuple(SMOKE_SHAPE) == dataclasses.astuple(JAX_SMOKE)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cell_matches_jax(arch, shape_name, grid):
    mesh_kind, debug = GRIDS[grid]
    want = _jax_record(arch, shape_name, _abstract_mesh(mesh_kind, debug))
    got = _port_record(arch, shape_name, mesh_kind, debug)
    _assert_same(got, want)
    if got["status"] == "ok":
        by = got["bytes_per_device"]
        assert by["output"] > 0
        assert by["temp"] is None and by["alias"] is None and by["code"] is None
        assert got["chips"] == _abstract_mesh(mesh_kind, debug).size


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch,option", [("llama3-8b", "zero"), ("deepseek-moe-16b", "zero"),
                                         ("gemma2-2b", "bf16"), (HYBRID, "bf16")])
def test_train_options_match_jax(arch, option, grid):
    """``--zero`` and ``--param-dtype bfloat16`` on the train cell."""
    mesh_kind, debug = GRIDS[grid]
    kw = {"zero": True} if option == "zero" else {"param_dtype": "bfloat16"}
    want = _jax_record(arch, "train_4k", _abstract_mesh(mesh_kind, debug), **kw)
    got = _port_record(arch, "train_4k", mesh_kind, debug, overrides=kw)
    _assert_same(got, want)
    plain = _port_record(arch, "train_4k", mesh_kind, debug)
    assert got["bytes_per_device"]["arguments"] < plain["bytes_per_device"]["arguments"]


def test_an_uneven_grid_holds_the_largest_block():
    """On a 3×5 grid (no production shape) the vocab rows (model: 5) and the batch
    (data: 3) do not divide: a device holds ceil(dim / n) of each split dim."""
    want = _jax_record("llama3-8b", "prefill_32k", _abstract_mesh("single", False, (3, 5)))
    got = _port_record("llama3-8b", "prefill_32k", "single", False, mesh_shape=(3, 5))
    _assert_same(got, want)
    cfg = get_config("llama3-8b")
    params = build_model(cfg).init(device="meta")
    grid = dryrun.make_grid("single", mesh_shape=(3, 5))
    from repro_torch.utils.sharding import param_shardings
    pl = param_shardings(grid, params)["embed"]["embed"]
    assert dryrun.leaf_bytes(params["embed"]["embed"], pl) == \
        math.ceil(cfg.padded_vocab / 5) * cfg.d_model * 4


def test_cli_runs_every_cell_of_both_pod_counts(tmp_path, capsys):
    assert dryrun.main(["--all", "--mesh", "both", "--out", str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("dryrun_*.json"))]
    assert len(recs) == len(ARCHS) * len(SHAPES) * 2
    assert {r["status"] for r in recs} <= {"ok", "skip"}
    assert "cells passed" in capsys.readouterr().out


def test_cli_through_runpy_on_the_debug_grids(monkeypatch, capsys):
    """As ``tests/test_distributed.py::test_dryrun_debug_mesh_cells`` runs JAX's."""
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "gemma2-2b", "--shape",
                                      "decode_32k", "--mesh", "both", "--debug-mesh"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)     # the module is imported already
        with pytest.raises(SystemExit) as e:
            runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.count("[dryrun] OK") == 2 and "2/2 cells passed" in out


def test_modeled_calls_sum_to_the_closed_forms():
    """Every cell's listed calls sum, kind by kind, to its closed form."""
    for arch in ARCHS:
        for shape_name in SHAPES:
            for mesh_kind, debug in GRIDS.values():
                try:
                    plan = dryrun.plan_cell(arch, shape_name,
                                            dryrun.make_grid(mesh_kind, debug=debug))
                except dryrun.SkipCell:
                    continue
                form, calls = plan["collectives"]
                counts, nbytes = {}, {}
                for kind, _, b, _ in calls:
                    counts[kind] = counts.get(kind, 0) + 1
                    nbytes[kind] = nbytes.get(kind, 0) + b
                assert counts == form["counts_by_kind"], (arch, shape_name, mesh_kind)
                assert nbytes == form["bytes_by_kind"], (arch, shape_name, mesh_kind)


def test_collectives_cli(capsys):
    assert collectives.main(["--arch", "deepseek-moe-16b", "--shape", "train_4k",
                             "--debug-mesh", "--top", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("deepseek-moe-16b × train_4k × single:") and len(out) == 4
    assert "all_reduce" in "".join(out[1:])


# ---- the abstract init and the hybrid caches ----


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def _jax_flat(tree):
    return {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_meta_init_is_jax_s_abstract_init(arch):
    """``init(device="meta")`` gives JAX's tree, shapes and dtypes (fp32 and bf16),
    takes no memory and draws nothing from torch's generators."""
    model = build_model(get_config(arch))
    rng = torch.get_rng_state()
    for dt, jdt in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        got = model.init(device="meta", dtype=dt)
        assert all(t.is_meta for t in _leaves(got))
        want = _jax_flat(jax_dryrun.abstract_state(_jax_model(arch)[1], opt=False,
                                                   param_dtype=jdt))
        assert _flat(got) == want
    assert torch.equal(torch.get_rng_state(), rng)
    sizes = [math.prod(x.shape) for x in jax.tree.leaves(_jax_params(arch))]
    assert get_config(arch).param_count() == sum(sizes)
    # JAX's own ``ModelConfig.param_count`` multiplies each leaf's dims in int32
    # (``jnp.prod``), so it wraps for a leaf of 2^31 elements or more (llama4-scout's
    # and deepseek-moe-16b's stacked experts); the dry run sums ``x.size``, as here
    wrapped = sum((n + 2 ** 31) % 2 ** 32 - 2 ** 31 for n in sizes)
    assert _jax_model(arch)[0].param_count() == wrapped


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("where", ["smoke-cpu", "full-meta"])
def test_hybrid_empty_caches_have_jax_s_layout(where):
    smoke = where == "smoke-cpu"
    b, seq = (2, 64) if smoke else (1, 524288)
    model = build_model(get_config(HYBRID, smoke=smoke))
    got = model.empty_caches(b, seq, device="cpu" if smoke else "meta")
    jm = jax_build_model(jax_get_config(HYBRID, smoke=smoke))
    if smoke:
        want = jm.empty_caches(b, seq)
        jflat = jax.tree_util.tree_leaves_with_path(want)
        assert _flat(got) == _jax_flat(want)
        for (_, jx), tx in zip(jflat, _leaves_sorted(got, jflat)):
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    else:
        assert _flat(got) == _jax_flat(jax.eval_shape(lambda: jm.empty_caches(b, seq)))
    assert set(got) == {"stack", "shared", "tail"}


def _leaves_sorted(tree, jflat):
    """The port's leaves in the order of JAX's flattened paths."""
    out = []
    for path, _ in jflat:
        t = tree
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        out.append(t)
    return out


def test_hybrid_decode_from_empty_caches_is_the_first_position():
    """A SMOKE zamba2 decode step at position 0 from ``empty_caches`` gives the
    logits of the first position of ``forward``, and JAX's ``decode_step`` from
    its own empty caches, within 2e-5."""
    cfg = get_config(HYBRID, smoke=True)
    jm = jax_build_model(jax_get_config(HYBRID, smoke=True))
    model = build_model(cfg)
    tp = model.init(0, device="cpu")
    # the same weights in JAX's tree (one layout in both packages)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    with torch.no_grad():
        full = model.forward(tp, {"tokens": torch.from_numpy(toks)})
    caches = model.empty_caches(2, 8, device="cpu")
    step, _ = model.decode_step(tp, torch.from_numpy(toks[:, :1]), caches, 0)
    np.testing.assert_allclose(step.numpy(), full[:, 0].numpy(), rtol=0, atol=2e-5)
    jstep, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, :1]), jm.empty_caches(2, 8),
                                       jnp.asarray(0, jnp.int32))
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=0, atol=2e-5)
    assert float(caches["shared"]["k"][:, :, 0].abs().max()) > 0    # written in place
    assert float(caches["shared"]["k"][:, :, 1:].abs().max()) == 0

"""The port's data-parallel ``Trainer(mesh=)``, its checkpoints and
``launch/train.py --mesh`` in gloo worlds, against the JAX package's
one-device step, on the CPU.

One world of 8 ranks on ``make_debug_mesh()`` (4 data × 2 model) runs every
trainer case once (``tests/torch_mesh_worlds.py``): JAX's parameters (SMOKE,
``PRNGKey(0)``) carried across, the global batch handed to every rank.  Held
against ``jax.value_and_grad`` of JAX's loss on the whole batch (a mean over
the microbatches under ``grad_accum``, as JAX's ``Trainer`` sums them), jitted
once a case:

* the loss (``grads``' and the first step's) within ``LOSS_RTOL`` relative,
  the ``ce``/``aux`` metrics too, and the synced gradients, assembled from
  every rank's blocks (the ranks that share a block must agree bit for
  bit), within ``GRAD_FRAC · max|g|`` of each leaf (1e-4, the limit of
  ``tests/test_torch_train_step.py``;
  2e-4 for zamba2-1.2b on ``"vector"`` at this batch, where the one-device
  port itself reads 1.05e-4 on one element of ``stack/sub1/mixer/in_proj``:
  its log-step doubling and JAX's ``associative_scan`` round apart, 3.1e-5
  to 1.05e-4 over four batches); and within ``GRID_FRAC · max|g|`` of the
  one-device port's ``Trainer.grads`` on the same batch, which is what the
  grid adds (the data group's sum in another order); the clip's norm within
  ``LOSS_RTOL``;
* qwen3-4b SMOKE (JAX's own case, ``tests/test_distributed.py:47``): three
  steps on one batch, the loss falling; zamba2-1.2b SMOKE on ``"vector"``;
  deepseek-moe-16b SMOKE with its ``aux`` (the experts expert-parallel over
  the model axis; at its capacity factor of 16 no expert can overflow, which
  the ranks assert), alone and with ``grad_accum=2``; qwen3 with a
  ``loss_mask`` that differs by row;
* each rank's rows are JAX's: microbatch ``i``'s share of its data index;
* every step's and ``grads``' collectives equal to
  ``analysis/collectives.py``'s closed forms (the parameter gathers, the
  gradient bucket, the clip's norm, the MoE combines);
* checkpoints: the world's save (rank 0 writes the gathered state) restores
  on one device bit-equal to the state the world gathered; a checkpoint
  written by JAX's ``CheckpointManager`` restores into the world with every
  block equal to its slice; and a world of 4 on a (2, 2) grid restores JAX's
  elastic case (``tests/test_distributed.py:76``: an (8, 8) ``arange`` saved
  by 8 ``data`` ranks, restored as ``("model", "data")``) and the trainer's
  checkpoint on that layout.

``launch/train.py --mesh debug`` starts its own world of 8; its first loss
is the one-device launcher's within ``LOSS_RTOL``.  Parameters after a step
are not compared across packages (AdamW's first step moves each by
``lr·sign(g)``; ``tests/test_torch_train_step.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro.training.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.analysis.collectives import (modeled_dp_step_traffic, modeled_ep_traffic,
                                              sum_forms)
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.launch.world import run_world
from repro_torch.models.model import get_config
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import AdamWConfig, tree_leaves
from repro_torch.training.trainer import Trainer
from repro_torch.utils import sharding

HERE = os.path.dirname(__file__)
LOSS_RTOL = 1e-5
GRAD_FRAC = {"qwen3-4b": 1e-4, "deepseek-moe-16b": 1e-4, "zamba2-1.2b": 2e-4}
GRID_FRAC = 1e-5
DATA, MODEL = 4, 2
JAX_CKPT_STEP = 7


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.tree.map(np.asarray, jax_build_model(jax_get_config(arch, smoke=True)).init(
        jax.random.PRNGKey(0)))


def _tokens(rows, seq, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (rows, seq)).astype(np.int32)


def _uneven_mask(rows, seq):
    """Row ``r`` keeps a different share of its positions: every rank's ``Σ mask``
    differs from the others'."""
    keep = np.random.default_rng(5).random((rows, seq)) < np.linspace(0.1, 0.95, rows)[:, None]
    return keep.astype(np.float32)


CASES = {
    "qwen3": dict(arch="qwen3-4b",
                  batch=SyntheticLM(256, 32, 8).batch_at(0), steps=3),
    "zamba2_vector": dict(arch="zamba2-1.2b", batch={"tokens": _tokens(8, 32, 1)},
                          scan_method="vector"),
    "deepseek_aux": dict(arch="deepseek-moe-16b", batch={"tokens": _tokens(8, 16, 2)},
                         steps=1),
    "masked": dict(arch="qwen3-4b", batch={"tokens": _tokens(8, 32, 3),
                                           "loss_mask": _uneven_mask(8, 32)}),
    "accum2": dict(arch="deepseek-moe-16b", batch={"tokens": _tokens(16, 16, 4)},
                   grad_accum=2, steps=1),
}


def _jax_state(arch):
    """A JAX train state with moments that are not zero, as JAX's manager saves it."""
    p = _jax_params(arch)
    rng = np.random.default_rng(9)
    mu = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), p)
    nu = jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32), p)
    return {"params": p, "opt": {"mu": mu, "nu": nu, "step": np.asarray(JAX_CKPT_STEP,
                                                                       np.int32)}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_training")
    trainer_dir, jax_dir, elastic_dir = (str(tmp / n) for n in ("trainer", "jax", "elastic"))
    JaxCheckpointManager(jax_dir, async_save=False).save(JAX_CKPT_STEP, _jax_state("qwen3-4b"),
                                                         blocking=True)
    cases = {name: dict(c, params=_jax_params(c["arch"])) for name, c in CASES.items()}
    cases["qwen3"]["ckpt_dir"] = trainer_dir
    w8 = run_world("torch_mesh_worlds:mesh_training_world", DATA * MODEL,
                   dict(cases=cases, ckpt=dict(arch="qwen3-4b", ckpt_dir=jax_dir,
                                               step=JAX_CKPT_STEP),
                        elastic_dir=elastic_dir),
                   workdir=tmp / "world8", timeout=400, pythonpath=[HERE])
    w4 = run_world("torch_mesh_worlds:elastic_restore", 4,
                   dict(ckpt_dir=elastic_dir, arch="qwen3-4b", trainer_dir=trainer_dir,
                        trainer_step=CASES["qwen3"]["steps"]),
                   workdir=tmp / "world4", timeout=240, pythonpath=[HERE])
    return {"w8": w8, "w4": w4, "trainer_dir": trainer_dir}


def _jax_cfg(arch, scan_method=None):
    cfg = jax_get_config(arch, smoke=True)
    return dataclasses.replace(cfg, scan_method=scan_method) if scan_method else cfg


@functools.lru_cache(maxsize=None)
def _jax_vg(arch, scan_method):
    m = jax_build_model(_jax_cfg(arch, scan_method))
    return jax.jit(jax.value_and_grad(lambda p, b: m.loss(p, b), has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """JAX's loss, metrics and gradient of the case's whole batch (a mean over
    its microbatches, as JAX's ``Trainer`` with ``grad_accum``)."""
    c = CASES[name]
    fn = _jax_vg(c["arch"], c.get("scan_method"))
    p = _jax_params(c["arch"])
    accum = c.get("grad_accum", 1)
    b = {k: np.asarray(v) for k, v in c["batch"].items()}
    per = next(iter(b.values())).shape[0] // accum
    loss, metrics, grads = 0.0, [], None
    for i in range(accum):
        (l, m), g = fn(p, {k: jnp.asarray(v[i * per:(i + 1) * per]) for k, v in b.items()})
        loss += float(l) / accum
        metrics.append({k: float(v) for k, v in m.items()})
        g = jax.tree.map(lambda x: np.asarray(x, np.float64) / accum, g)
        grads = g if grads is None else jax.tree.map(np.add, grads, g)
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat["/".join(path)] = t
    walk(grads, ())
    return loss, metrics[0] if accum == 1 else {}, flat


@functools.lru_cache(maxsize=None)
def _port_reference(name):
    """The one-device port's ``Trainer.grads`` of the case's whole batch."""
    c = CASES[name]
    cfg = get_config(c["arch"], smoke=True)
    if c.get("scan_method"):
        cfg = dataclasses.replace(cfg, scan_method=c["scan_method"])
    tr = Trainer(cfg, AdamWConfig(), grad_accum=c.get("grad_accum", 1), device="cpu")
    params = params_from_jax(_jax_params(c["arch"]), device="cpu")
    _, _, grads = tr.grads(params, {k: torch.from_numpy(np.asarray(v))
                                    for k, v in c["batch"].items()})
    return {k: v.numpy() for k, v in _flat(grads).items()}


def _assemble(world, name):
    """The whole synced gradient of every leaf from every rank's blocks; ranks
    that hold the same block must agree bit for bit."""
    out = {}
    for r in world:
        for path, (blk, sl) in r[name]["grads"].items():
            full = out.setdefault(path, {})
            key = tuple(map(tuple, sl))
            if key in full:
                np.testing.assert_array_equal(blk, full[key], err_msg=path)
            full[key] = blk
    whole = {}
    for path, blocks in out.items():
        hi = [max(k[d][1] for k in blocks) for d in range(len(next(iter(blocks))))]
        arr = np.zeros(hi, np.float32)
        for k, blk in blocks.items():
            arr[tuple(slice(a, b) for a, b in k)] = blk
        whole[path] = arr
    return whole


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_synced_grads_match_jax(worlds, name):
    want_loss, want_metrics, want = _jax_reference(name)
    w = worlds["w8"]
    for r in w:
        assert r[name]["loss"] == w[0][name]["loss"]
        assert r[name]["loss"] == pytest.approx(want_loss, rel=LOSS_RTOL)
        for k, v in want_metrics.items():
            assert r[name]["metrics"][k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-7), k
    got = _assemble(w, name)
    assert sorted(got) == sorted(want)
    one = _port_reference(name)
    frac = GRAD_FRAC[CASES[name]["arch"]]
    for path, g in want.items():
        assert got[path].shape == g.shape, path
        np.testing.assert_allclose(got[path], g, rtol=0,
                                   atol=frac * float(np.abs(g).max()), err_msg=path)
        np.testing.assert_allclose(got[path], one[path], rtol=0,
                                   atol=GRID_FRAC * float(np.abs(g).max()), err_msg=path)
    if CASES[name].get("steps"):
        norm = float(np.sqrt(sum(np.sum(g ** 2) for g in want.values())))
        assert w[0][name]["grad_norms"][0] == pytest.approx(norm, rel=LOSS_RTOL)
        assert w[0][name]["losses"][0] == pytest.approx(want_loss, rel=LOSS_RTOL)


def test_three_steps_lower_the_loss(worlds):
    losses = worlds["w8"][0]["qwen3"]["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(r["qwen3"]["losses"] == losses for r in worlds["w8"])


@pytest.mark.parametrize("name", ["deepseek_aux", "accum2"])
def test_moe_cases_drop_nothing(worlds, name):
    assert all(r[name]["capacity_ok"] for r in worlds["w8"])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_takes_jax_rows(worlds, name):
    c = CASES[name]
    accum = c.get("grad_accum", 1)
    for r in worlds["w8"]:
        j = r[name]["coord"]["data"]
        for k, v in c["batch"].items():
            v = np.asarray(v)
            per = v.shape[0] // (accum * DATA)
            want = np.concatenate([v[i * per * DATA + j * per:i * per * DATA + (j + 1) * per]
                                   for i in range(accum)])
            np.testing.assert_array_equal(r[name]["rows"][k], want)


def _step_forms(name):
    """The closed forms of the case's ``grads`` call and of one train step."""
    c = CASES[name]
    cfg = get_config(c["arch"], smoke=True)
    grid = sharding.Grid.abstract((DATA, MODEL), ("data", "model"))
    places = tree_leaves(sharding.param_shardings(grid, params_from_jax(
        _jax_params(c["arch"]), device="meta")))
    coord = {"data": 0, "model": 0}
    blocks = sum(int(np.prod(pl.block_shape(coord))) for pl in places)
    gathered = [int(np.prod(pl.shape)) for pl in places if pl.split_axes()]
    accum = c.get("grad_accum", 1)
    terms = 3 if accum == 1 else 1
    forms = [modeled_dp_step_traffic(data=DATA, block_elements=blocks, terms=terms,
                                     gathered=gathered)]
    if cfg.moe is not None:
        rows, seq = np.asarray(c["batch"]["tokens"]).shape
        forms.append(modeled_ep_traffic(
            model=MODEL, data=DATA, tokens=rows // (DATA * accum) * seq,
            d_model=cfg.d_model, top_k=cfg.moe.top_k, n_experts=cfg.moe.n_experts,
            layers=cfg.n_layers - cfg.moe.first_k_dense, itemsize=4, passes=accum,
            global_aux=True, backward=True, remat=cfg.remat))
    norm = modeled_dp_step_traffic(data=1, block_elements=0, norm_sets=1)
    return sum_forms(*forms), sum_forms(*forms, norm)


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_equal_the_closed_forms(worlds, name):
    grads_form, step_form = _step_forms(name)
    for r in worlds["w8"]:
        got = r[name]["grads_counts"]
        assert {k: v for k, v in got["calls"].items() if v} == grads_form["counts_by_kind"]
        assert {k: v for k, v in got["bytes"].items() if v} == grads_form["bytes_by_kind"]
        if CASES[name].get("steps"):
            got = r[name]["step_counts"]
            assert {k: v for k, v in got["calls"].items() if v} == step_form["counts_by_kind"]
            assert {k: v for k, v in got["bytes"].items() if v} == step_form["bytes_by_kind"]


def _one_device_template(arch):
    tr = Trainer(get_config(arch, smoke=True), AdamWConfig(), device="cpu")
    return tr.state_from_params(params_from_jax(_jax_params(arch), device="cpu"))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_world_checkpoint_restores_on_one_device(worlds):
    whole = worlds["w8"][0]["qwen3"]["whole_state"]
    step = CASES["qwen3"]["steps"]
    got = _flat(CheckpointManager(worlds["trainer_dir"]).restore(
        step, _one_device_template("qwen3-4b")))
    assert sorted(got) == sorted(whole)
    for k, v in whole.items():
        assert got[k].numpy().tobytes() == v.tobytes(), k
    assert int(got["opt/step"]) == step


def test_jax_checkpoint_restores_into_the_world(worlds):
    want = _flat(_jax_state("qwen3-4b"))
    for r in worlds["w8"]:
        blocks = r["restored"]
        assert sorted(blocks) == sorted(want)
        for k, (blk, sl) in blocks.items():
            full = np.asarray(want[k])
            np.testing.assert_array_equal(blk, full[tuple(slice(a, b) for a, b in sl)],
                                          err_msg=k, strict=True)


def test_elastic_restore_onto_another_layout(worlds):
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    seen = set()
    whole = worlds["w8"][0]["qwen3"]["whole_state"]
    for r in worlds["w4"]:
        blk, sl = r["w"]
        i, j = r["coord"]["model"], r["coord"]["data"]
        assert sl == [(4 * i, 4 * i + 4), (4 * j, 4 * j + 4)]       # ("model", "data")
        np.testing.assert_array_equal(blk, x[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        seen.add((i, j))
        for k, (b, s) in r["state"].items():
            np.testing.assert_array_equal(b, whole[k][tuple(slice(a, c) for a, c in s)],
                                          err_msg=k, strict=True)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_train_launcher_on_the_debug_mesh(tmp_path):
    """``--mesh debug`` trains in a world of 8 (its first loss the one-device
    launcher's), and a second run resumes from the world's checkpoint with
    shardings: its step is the uninterrupted run's, bit for bit."""
    argv = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--batch", "8",
            "--seq", "32", "--mesh", "debug"]
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "1"]
    whole = train_cli.main(argv + ["--steps", "3", "--world-dir", str(tmp_path / "w0")])
    first = train_cli.main(argv + ckpt + ["--steps", "2", "--world-dir", str(tmp_path / "w1")])
    resumed = train_cli.main(argv + ckpt + ["--steps", "3", "--world-dir",
                                            str(tmp_path / "w2")])
    one = train_cli.main(argv[:-2] + ["--steps", "1"])
    assert len(whole["losses"]) == 3 and all(np.isfinite(whole["losses"]))
    assert whole["losses"][0] == pytest.approx(one["losses"][0], rel=LOSS_RTOL)
    assert first["losses"] == whole["losses"][:2]
    assert resumed["losses"] == whole["losses"][2:]
    assert "resumed from step 2" in (tmp_path / "w2" / "rank0.log").read_text()

"""The port's training substrate against the JAX package's, on the CPU.

AdamW against the numpy reference of ``tests/test_training.py`` and against
JAX's ``adamw_update`` over three steps; ``lr_at`` at warmup, peak and floor;
gradient accumulation against the full batch; the trainer's falling loss and
its resume from a checkpoint; the checkpoint's atomic publish, crc refusal and
retention, and a checkpoint written by JAX's ``CheckpointManager`` restored in
the port; the straggler monitor; and the data pipeline, bit-equal to JAX's for
the same ``(seed, step, shard)``.  Tolerances are stated at each check: the
optimizer's fp32 arithmetic matches JAX's within ``1e-6`` relative, the
tolerances of ``tests/test_training.py`` elsewhere.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.training import optimizer as jax_opt
from repro.training import straggler as jax_straggler
from repro.training.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.training.trainer import Trainer as JaxTrainer
from repro.models.model import get_config as jax_get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.data.pipeline import (ByteCorpus, PackedSyntheticLM, Prefetcher,
                                       SyntheticLM, pack_ragged)
from repro_torch.launch import train as train_cli
from repro_torch.models.model import get_config
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                            global_norm, lr_at, tree_leaves)
from repro_torch.training.straggler import StragglerConfig, StragglerMonitor
from repro_torch.training.trainer import Trainer
from repro_torch.utils import sharding

CPU = "cpu"


def _numpy_adamw(cfg, g, m, v, p, step):
    """``tests/test_training.py``'s reference step."""
    gn = np.sqrt(np.sum(g ** 2))
    g = g * min(1.0, cfg.grad_clip / (gn + 1e-9))
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mh = m / (1 - cfg.b1 ** step)
    vh = v / (1 - cfg.b2 ** step)
    lr = float(lr_at(cfg, step))
    return p - lr * (mh / (np.sqrt(vh) + cfg.eps) + cfg.weight_decay * p), m, v


def test_adamw_matches_numpy_reference():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=100, min_lr_frac=1.0)
    rng = np.random.default_rng(0)
    p = rng.standard_normal((4, 8)).astype(np.float32)
    params = {"w": torch.from_numpy(p.copy())}
    opt = adamw_init(params)
    pn, mn, vn = p.copy(), np.zeros_like(p), np.zeros_like(p)
    for step in range(1, 4):
        g = rng.standard_normal((4, 8)).astype(np.float32)
        params, opt, _ = adamw_update(cfg, {"w": torch.from_numpy(g)}, opt, params)
        pn, mn, vn = _numpy_adamw(cfg, g, mn, vn, pn, step)
        np.testing.assert_allclose(params["w"].numpy(), pn, rtol=1e-5, atol=1e-6)
    assert int(opt["step"]) == 3 and opt["step"].dtype == torch.int32


def test_adamw_matches_jax_over_three_steps():
    """Nested params (a matrix decays, a vector does not, a bf16 leaf casts back),
    clipping active: params, moments and metrics within 1e-6 relative of JAX's."""
    cfg = AdamWConfig(lr=3e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    rng = np.random.default_rng(1)
    p = {"a": {"w": rng.standard_normal((3, 5)).astype(np.float32)},
         "b": rng.standard_normal((5,)).astype(np.float32),
         "c": rng.standard_normal((2, 2)).astype(np.float32)}
    jp = {"a": {"w": jnp.asarray(p["a"]["w"])}, "b": jnp.asarray(p["b"]),
          "c": jnp.asarray(p["c"], jnp.bfloat16)}
    tp = {"a": {"w": torch.from_numpy(p["a"]["w"].copy())},
          "b": torch.from_numpy(p["b"].copy()), "c": torch.from_numpy(p["c"]).to(torch.bfloat16)}
    jo, to = jax_opt.adamw_init(jp), adamw_init(tp)
    for _ in range(3):
        g = {"a": {"w": rng.standard_normal((3, 5)).astype(np.float32)},
             "b": rng.standard_normal((5,)).astype(np.float32),
             "c": rng.standard_normal((2, 2)).astype(np.float32)}
        jg = jax.tree.map(jnp.asarray, g)
        jg["c"] = jg["c"].astype(jnp.bfloat16)
        tg = {"a": {"w": torch.from_numpy(g["a"]["w"])}, "b": torch.from_numpy(g["b"]),
              "c": torch.from_numpy(g["c"]).to(torch.bfloat16)}
        jp, jo, jm = jax_opt.adamw_update(cfg, jg, jo, jp)
        tp, to, tm = adamw_update(cfg, tg, to, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for a, b in zip(tree_leaves(tp) + tree_leaves(to["mu"]) + tree_leaves(to["nu"]),
                        jax.tree.leaves(jp) + jax.tree.leaves(jo["mu"])
                        + jax.tree.leaves(jo["nu"])):
            assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16 else torch.float32)
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                       rtol=1e-6, atol=1e-7)
    assert int(to["step"]) == int(jo["step"]) == 3


def test_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"x": rng.standard_normal((7, 3)).astype(np.float32),
            "y": {"z": rng.standard_normal((11,)).astype(np.float32)}}
    want = float(jax_opt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(global_norm({"x": torch.from_numpy(tree["x"]),
                             "y": {"z": torch.from_numpy(tree["y"]["z"])}}))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 109, 110, 500])
def test_lr_schedule_matches_jax(step):
    """Warmup (0–10), peak (10), the cosine (11–109) and the floor (110 on),
    in fp32 as JAX computes it: the same bits."""
    cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    got = lr_at(cfg, torch.tensor(step, dtype=torch.int32))
    want = np.asarray(jax_opt.lr_at(cfg, jnp.asarray(step, jnp.int32)))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()
    if step == 10:
        assert float(got) == pytest.approx(3e-3, rel=1e-7)
    if step >= 110:
        assert float(got) == pytest.approx(3e-4, rel=1e-6)


def test_grad_accum_matches_full_batch():
    """``tests/test_training.py``'s check: accumulating 4 microbatches gives the
    full batch's loss and update (fp32 sums in another order)."""
    cfg = get_config("qwen3-4b", smoke=True)
    src = SyntheticLM(cfg.vocab_size, 32, 8, seed=1)
    batch = src.batch_at(0)
    t1 = Trainer(cfg, AdamWConfig(lr=1e-3), grad_accum=1, device=CPU)
    t2 = Trainer(cfg, AdamWConfig(lr=1e-3), grad_accum=4, device=CPU)
    s1, m1 = t1.train_step(t1.init_state(0), batch)
    s2, m2 = t2.train_step(t2.init_state(0), batch)
    assert set(m1) == {"ce", "aux", "grad_norm", "lr", "loss"}
    assert set(m2) == {"grad_norm", "lr", "loss"}                 # JAX's accum metrics
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-3,
                                   atol=2e-5)


def test_trainer_loss_decreases_and_resumes(tmp_path):
    cfg = get_config("llama3-8b", smoke=True)
    src = SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    tr = Trainer(cfg, opt, ckpt_dir=str(tmp_path), device=CPU)
    out = tr.fit(src, 20, log_every=0, ckpt_every=10)
    assert out["losses"][-1] < out["losses"][0]
    assert CheckpointManager(str(tmp_path)).all_steps() == [10, 20]
    logs = []
    tr2 = Trainer(cfg, opt, ckpt_dir=str(tmp_path), device=CPU)
    out2 = tr2.fit(src, 22, log_every=0, log=logs.append)
    assert len(out2["losses"]) == 2 and logs == ["[trainer] resumed from step 20"]
    assert int(out2["state"]["opt"]["step"]) == 22
    assert tr2.monitor.count[0] == 2                       # the steps were timed


def test_checkpoint_atomic_corruption_and_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_last=2, async_save=False)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)},
            "d": (torch.zeros(2, dtype=torch.bfloat16), torch.tensor(3))}
    for step in (1, 2, 3):
        cm.save(step, tree, blocking=True)
    assert cm.all_steps() == [2, 3] and cm.latest_step() == 3
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    rest = cm.restore(3, tree)
    def leaves(t):
        return [t["a"], t["b"]["c"], *t["d"]]
    for a, b in zip(leaves(rest), leaves(tree)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    ck = os.path.join(tmp_path, "ckpt_3")
    with open(os.path.join(ck, "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    assert sorted(arrays) == ["a", "b::c", "d::#0", "d::#1"]          # JAX's flat keys
    assert arrays["d::#0"]["dtype"] == "bfloat16"
    victim = arrays["a"]["file"]
    arr = np.load(os.path.join(ck, victim)).copy()
    arr.view(np.uint8)[0] ^= 0xFF
    np.save(os.path.join(ck, victim), arr)
    with pytest.raises(IOError, match="corruption"):
        cm.restore(3, tree)
    one = sharding.Grid((1,), ("data",))          # a grid of one rank holds every block whole
    places = {"a": sharding.Placement(one, ("data", None), (2, 3)),
              "b": {"c": sharding.replicated(one, (4,))},
              "d": (sharding.replicated(one, (2,)), sharding.replicated(one, ()))}
    for a, b in zip(leaves(cm.restore(2, tree, shardings=places)), leaves(tree)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    with pytest.raises(ValueError, match="placement"):
        cm.restore(2, tree, shardings=dict(places, a=sharding.Placement(one, (), (3, 2))))


def test_async_save_snapshots_before_the_write(tmp_path):
    """The host copy is taken at ``save``: an in-place update afterwards (the
    trainer's donated state) does not reach the files."""
    cm = CheckpointManager(str(tmp_path))
    t = {"w": torch.ones(1000)}
    cm.save(5, t)
    t["w"].add_(1.0)
    cm.wait()
    assert torch.equal(cm.restore(5, t)["w"], torch.ones(1000))


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    """A JAX train state (llama3-8b SMOKE after one step) saved by JAX's
    ``CheckpointManager`` restores into the port's trainer state, every leaf
    equal to ``convert.train_state_from_jax`` of it."""
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jt = JaxTrainer(jcfg, jax_opt.AdamWConfig(lr=1e-3, warmup_steps=2))
    js = jt.init_state(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(SyntheticLM(jcfg.vocab_size, 16, 2).batch_at(0)["tokens"])}
    js, _ = jt.train_step(js, batch)
    JaxCheckpointManager(str(tmp_path), async_save=False).save(1, js, blocking=True)
    tr = Trainer(get_config("llama3-8b", smoke=True), AdamWConfig(), device=CPU)
    cm = CheckpointManager(str(tmp_path))
    assert cm.latest_step() == 1
    got = cm.restore(1, tr.init_state(3))
    want = train_state_from_jax(jax.tree.map(np.asarray, js), device=CPU)
    assert int(got["opt"]["step"]) == 1 and got["opt"]["step"].dtype == torch.int32
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_jax_written_bf16_leaf_restores_in_the_port(tmp_path):
    """JAX writes bf16 through ``ml_dtypes``; the port reads its 2-byte words."""
    tree = {"w": (jnp.arange(6, dtype=jnp.float32).reshape(2, 3) - 2.5).astype(jnp.bfloat16),
            "s": jnp.asarray(3, jnp.int32)}
    JaxCheckpointManager(str(tmp_path), async_save=False).save(1, tree, blocking=True)
    tpl = {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
           "s": torch.zeros((), dtype=torch.int32)}
    got = CheckpointManager(str(tmp_path)).restore(1, tpl)
    assert got["w"].dtype == torch.bfloat16 and int(got["s"]) == 3
    assert torch.equal(got["w"].float(), torch.arange(6.0).reshape(2, 3) - 2.5)


def test_straggler_monitor_flags_slow_worker_as_jax():
    """``tests/test_training.py``'s degrading worker, and the port's monitor state
    equal to JAX's after every record."""
    cfg = StragglerConfig(min_samples=8, consecutive=3, z_threshold=3.0)
    mon = StragglerMonitor(cfg)
    ref = jax_straggler.StragglerMonitor(jax_straggler.StragglerConfig(
        min_samples=8, consecutive=3, z_threshold=3.0))
    rng = np.random.default_rng(0)
    flagged = []
    for step in range(40):
        for w in range(4):
            t = 0.1 + rng.normal(0, 0.002)
            if w == 2 and step >= 25:
                t *= 3.0                                   # worker 2 degrades
            got = mon.record(w, t)
            assert got == ref.record(w, t)
            if got:
                flagged.append((w, step))
    assert [w for w, _ in flagged] == [2]
    assert mon.healthy_workers([0, 1, 2, 3]) == [0, 1, 3]
    assert (mon.mean, mon.var, mon.streak) == (ref.mean, ref.var, ref.streak)


@pytest.mark.parametrize("step,shard,num_shards", [(0, 0, 1), (7, 0, 1), (7, 1, 2)])
def test_synthetic_sources_bit_equal_to_jax(step, shard, num_shards):
    for kw in (dict(seed=0), dict(seed=42, a=3, c=11)):
        got = SyntheticLM(1000, 32, 8, **kw).batch_at(step, shard, num_shards)
        want = jax_pipeline.SyntheticLM(1000, 32, 8, **kw).batch_at(step, shard, num_shards)
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        got = PackedSyntheticLM(500, 256, 7, **kw).batch_at(step, shard, num_shards)
        want = jax_pipeline.PackedSyntheticLM(500, 256, 7, **kw).batch_at(step, shard,
                                                                          num_shards)
        assert set(got) == set(want) == {"tokens", "offsets", "segment_ids"}
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    a, b = SyntheticLM(1000, 32, 8, seed=42).batch_at(7), SyntheticLM(1000, 32, 8,
                                                                        seed=42).batch_at(8)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_pack_ragged_bit_equal_to_jax():
    seqs = [np.arange(3), np.zeros(0, np.int64), np.asarray([7, 8]), np.arange(5) * 2]
    for case in (seqs, [], [np.zeros(0)]):
        got, want = pack_ragged(case), jax_pipeline.pack_ragged(case)
        for k in ("tokens", "offsets", "segment_ids"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_byte_corpus_bit_equal_to_jax(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(b"hello world, this is a tiny corpus for byte-level lm " * 20)
    src = ByteCorpus(str(p), seq_len=16, batch_size=4, seed=3)
    ref = jax_pipeline.ByteCorpus(str(p), seq_len=16, batch_size=4, seed=3)
    for step in (0, 5):
        got = src.batch_at(step)["tokens"]
        assert got.shape == (4, 16) and got.max() < 256
        np.testing.assert_array_equal(got, ref.batch_at(step)["tokens"])


def test_prefetcher():
    src = SyntheticLM(100, 16, 2, seed=0)
    pf = Prefetcher(src, start_step=5)
    for want in (5, 6):
        step, batch = pf.next()
        assert step == want
        np.testing.assert_array_equal(batch["tokens"], src.batch_at(want)["tokens"])
    pf.stop()


def test_entry_points_default_to_the_card_and_refuse_a_mesh(tmp_path):
    cfg = get_config("llama3-8b", smoke=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, AdamWConfig())
    with pytest.raises(TypeError, match="utils.sharding.Grid"):
        Trainer(cfg, AdamWConfig(), mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="abstract grid"):
        Trainer(cfg, AdamWConfig(), mesh=sharding.Grid.abstract((4, 2), ("data", "model")),
                device=CPU)
    with pytest.raises(SystemExit):
        train_cli.main(["--mesh", "bogus"])


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    """The CLI trains zamba2 SMOKE, checkpoints, and a second run resumes."""
    argv = ["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    out = train_cli.main(argv)
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
    out2 = train_cli.main(argv[:6] + ["6"] + argv[7:])
    assert len(out2["losses"]) == 2
    assert "resumed from step 4" in capsys.readouterr().out

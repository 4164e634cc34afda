"""The port's int8 error-feedback gradient sync (``training/grad_compression.py``)
in a gloo world of 8 ranks, against the JAX package's on the CPU.

JAX's ``compressed_psum`` runs in-process under ``jax.vmap(..., axis_name=
"data")`` over the same 8 rows that the ranks hold one each (jitted once).
Held: ``quantize_int8``'s payload and scale bit-equal; over two steps (the
second adding the first's error; JAX's second step is fed the port's first
error, so that each step is held on the same inputs) the mean within 1 ulp
of JAX's and the same on every rank, the new error within 1 ulp of the
gradient it was taken from (XLA fuses ``g − q·scale`` into one fused
multiply-add, the port rounds the product first, so the two differ by up to
half an ulp of ``q·scale``); the error feedback telescoping over the two steps (the means plus the last errors' mean give the gradients'
mean); JAX's own limit, 0.05 of the fp32 mean's largest magnitude; the tree
form leaf by leaf.  The collectives are counted: one ``all_reduce`` max of
one fp32 scalar and one ``all_reduce`` sum of the int32 cast a tensor, so a
call moves ``4 + 4·numel`` bytes a rank, as many as an fp32 all-reduce would
(the JAX docstring's "4× less collective traffic" is not what its int32
``psum`` moves).
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.training import grad_compression as jax_gc
from repro_torch.launch.world import run_world
from repro_torch.training import grad_compression as gc

HERE = os.path.dirname(__file__)
D = 8
_rng = np.random.default_rng(0)
G = _rng.standard_normal((D, 64)).astype(np.float32)
G2 = _rng.standard_normal((D, 64)).astype(np.float32)
TREE = {"a": _rng.standard_normal((D, 3, 5)).astype(np.float32) * 1e-3,
        "b": _rng.standard_normal((D, 7)).astype(np.float32)}


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compressed")
    return run_world("torch_mesh_worlds:small_world", D,
                     dict(compressed=dict(g=G, g2=G2, tree=TREE)),
                     workdir=tmp / "world8", timeout=240, pythonpath=[HERE])


@functools.lru_cache(maxsize=None)
def _jax_psum():
    return jax.jit(jax.vmap(lambda g, e: jax_gc.compressed_psum(g, "data", e),
                            axis_name="data"))


def _jax_step(world, step):
    """JAX's ``(mean, error)`` a rank, and what each rank quantised."""
    if step == 1:
        g, e = G, np.zeros_like(G)
    else:
        g, e = G2, np.stack([r["compressed"]["err1"] for r in world])
    m, err = _jax_psum()(jnp.asarray(g), jnp.asarray(e))
    return np.asarray(m), np.asarray(err), g + e


@functools.lru_cache(maxsize=None)
def _jax_tree():
    fn = jax.jit(jax.vmap(lambda g, e: jax_gc.compressed_grad_sync(g, "data", e),
                          axis_name="data"))
    tree = {k: jnp.asarray(v) for k, v in TREE.items()}
    synced, errs = fn(tree, jax.tree.map(jnp.zeros_like, tree))
    return jax.tree.map(np.asarray, synced), jax.tree.map(np.asarray, errs)


def test_quantize_int8_is_jax_bit_for_bit():
    for row in (G[0], TREE["a"][3].reshape(-1), np.zeros(5, np.float32)):
        q, s = gc.quantize_int8(torch.from_numpy(row))
        jq, js = jax_gc.quantize_int8(jnp.asarray(row))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s).tobytes() == np.asarray(js, np.float32).tobytes()
        np.testing.assert_array_equal(gc.dequantize_int8(q, s).numpy(),
                                      np.asarray(jax_gc.dequantize_int8(jq, js)))


@pytest.mark.parametrize("step", [1, 2])
def test_compressed_psum_matches_jax(world, step):
    jm, je, g = _jax_step(world, step)
    for r, ranked in enumerate(world):
        c = ranked["compressed"]
        m, e = c[f"mean{step}"], c[f"err{step}"]
        np.testing.assert_array_equal(m, world[0]["compressed"][f"mean{step}"])
        assert (np.abs(m - jm[r]) <= _ulp(jm[r])).all()
        assert (np.abs(e - je[r]) <= _ulp(g[r])).all()
    ref = (G if step == 1 else G2).mean(0)
    err = np.abs(world[0]["compressed"][f"mean{step}"] - ref).max() / np.abs(ref).max()
    assert err < 0.05, err                             # tests/test_distributed.py's limit


def test_error_feedback_telescopes(world):
    """Nothing is lost over two steps: the two means plus the last errors' mean
    are the two gradients' mean, up to fp32 rounding."""
    c = [r["compressed"] for r in world]
    got = c[0]["mean1"] + c[0]["mean2"] + np.mean([x["err2"] for x in c], axis=0)
    want = G.mean(0) + G2.mean(0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for x in c:                       # at most half a step of the shared scale
        assert np.abs(x["err1"]).max() <= 0.5 * np.abs(G).max() / 127 * (1 + 1e-6)


def test_compressed_psum_moves_int32_bytes(world):
    counts = world[0]["compressed"]["psum_counts"]
    n = G.shape[1]
    assert counts["calls"] == {"all_gather": 0, "all_to_all": 0, "all_reduce": 2}
    assert counts["bytes"]["all_reduce"] == 4 + 4 * n          # fp32 would move 4·n too


def test_compressed_grad_sync_matches_jax(world):
    synced, errs = _jax_tree()
    for r, ranked in enumerate(world):
        c = ranked["compressed"]
        for k in TREE:
            assert (np.abs(c["synced"][k] - synced[k][r]) <= _ulp(synced[k][r])).all(), k
            assert (np.abs(c["errs"][k] - errs[k][r]) <= _ulp(TREE[k][r])).all(), k
    counts = world[0]["compressed"]["sync_counts"]
    assert counts["calls"]["all_reduce"] == 2 * len(TREE)
    assert counts["bytes"]["all_reduce"] == sum(4 + 4 * v[0].size for v in TREE.values())
    zeros = gc.init_errors({k: torch.from_numpy(v[0]) for k, v in TREE.items()})
    assert all(z.dtype == torch.float32 and not z.any() for z in zeros.values())

"""The port's §4 blocked scan pipeline (B2–B4) against the JAX package.

Inputs are drawn with numpy from a seed and go through both packages.  The
JAX phase functions run in Pallas interpret mode (their own default on the
CPU); the port's run their plain versions, as every kernel wrapper does on a
CPU tensor.  Integer payloads, and fp32 payloads holding small integers, must
be bit-identical to the JAX result; random fp32 must stay within the JAX
package's ``8·√n``-ulp bound against the fp64 reference, as the JAX scans are
held.  Sorts, splits and samples under the same uniforms must be identical.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.analysis import ulp
from repro.core.primitives import radix_sort as jax_radix_sort
from repro.core.primitives import split as jax_split
from repro.core.primitives import top_p_sample as jax_top_p_sample
from repro.core.scan import scan as jax_scan
from repro.kernels import scan_pipeline as jax_sp
from repro_torch.core import primitives as P
from repro_torch.core import scan as port_scan
from repro_torch.kernels import scan_pipeline as port_sp

N = 777                                       # ragged: not a multiple of any block
_NP = {"int8": np.int8, "int32": np.int32, "float32": np.float32}


@functools.lru_cache(maxsize=None)
def _input(kind: str, shape=(3, N), seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "f32rand":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "f32int":
        return rng.integers(-8, 9, shape).astype(np.float32)
    return rng.integers(-100, 101, shape).astype(_NP[kind])


def _check(kind, got, want, x):
    """Bit-equal, or for random fp32 both within the ulp bound of the fp64 scan."""
    assert got.dtype == want.dtype
    if kind == "f32rand":
        n = x.shape[-1]
        bound = ulp.ulp_bound("highest", n)
        ref, sc = ulp.scan_ref(x), ulp.scan_scale(x)
        assert ulp.max_ulp(got, ref, sc) <= bound
        assert ulp.max_ulp(want, ref, sc) <= bound
    else:
        np.testing.assert_array_equal(got, want)


# ---- the three phase functions, module against module ----


def _b2_rows(kind: str, shape, seed: int):
    """Rows of every dtype B2 reads, as numpy (bf16 as fp32 holding bf16 values)."""
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random(shape) < 0.5
    if kind == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "int16":
        return rng.integers(-32768, 32768, shape).astype(np.int16)
    if kind == "bf16":
        return rng.integers(-8, 9, shape).astype(np.float32)
    return _input(kind, shape, seed)


def _both(kind, xn):
    """The same rows as a JAX array and a torch tensor."""
    if kind == "bf16":
        return jnp.asarray(xn, jnp.bfloat16), torch.from_numpy(xn).to(torch.bfloat16)
    return jnp.asarray(xn), torch.from_numpy(xn)


@pytest.mark.parametrize("ragged", [False, True], ids=["whole", "ragged"])
@pytest.mark.parametrize("kind", ["int8", "uint8", "bool", "int16", "int32", "bf16",
                                  "f32int", "f32rand"])
def test_block_partial_sums_matches_jax(kind, ragged):
    """B2 alone and the fused sums and carries, against JAX's ``block_partial_sums``
    and ``carry_scan``; a ragged row is zero-padded to whole blocks, as
    ``blocked_scan`` pads it."""
    n = 3 * 16 * 8 - (37 if ragged else 0)
    xn = _b2_rows(kind, (2, n), seed=1)
    xn = np.pad(xn, ((0, 0), (0, 3 * 16 * 8 - n))).reshape(2, 3, 16, 8)
    jx, tx = _both(kind, xn)
    j = np.asarray(jax_sp.block_partial_sums(jx))
    jc = np.asarray(jax_sp.carry_scan(jnp.asarray(j)))
    t = port_sp.block_partial_sums(tx).numpy()
    ts, tc = (v.numpy() for v in port_sp.block_sums_carries(tx))
    assert t.shape == (2, 3) and t.dtype == j.dtype == ts.dtype == tc.dtype
    np.testing.assert_array_equal(ts, t)
    if kind == "f32rand":
        flat = xn.reshape(2, 3, -1).astype(np.float64)
        ref, sc = flat.sum(-1), np.abs(flat).sum(-1)
        bound = ulp.ulp_bound("highest", flat.shape[-1])
        assert ulp.max_ulp(t, ref, sc) <= bound and ulp.max_ulp(j, ref, sc) <= bound
        np.testing.assert_array_equal(tc, port_sp.carry_scan(torch.from_numpy(t)).numpy())
        cref = np.concatenate([np.zeros((2, 1)), np.cumsum(ref, -1)[:, :-1]], -1)
        csc = np.concatenate([np.zeros((2, 1)), np.cumsum(sc, -1)[:, :-1]], -1)
        bound = ulp.ulp_bound("highest", flat.shape[-1] * 3)
        assert ulp.max_ulp(tc, cref, csc) <= bound and ulp.max_ulp(jc, cref, csc) <= bound
    else:
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("kind", ["int32", "f32int", "f32rand"])
def test_carry_scan_matches_jax(kind):
    sums = _input(kind, (3, 50), seed=2)
    j = np.asarray(jax_sp.carry_scan(jnp.asarray(sums)))
    t = port_sp.carry_scan(torch.from_numpy(sums)).numpy()
    assert (t[:, 0] == 0).all()
    if kind == "f32rand":
        ref = np.concatenate([np.zeros((3, 1)), ulp.scan_ref(sums)[:, :-1]], -1)
        sc = np.concatenate([np.zeros((3, 1)), ulp.scan_scale(sums)[:, :-1]], -1)
        bound = ulp.ulp_bound("highest", 50)
        assert ulp.max_ulp(t, ref, sc) <= bound and ulp.max_ulp(j, ref, sc) <= bound
    else:
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("variant", ["scanu", "scanul1"])
@pytest.mark.parametrize("kind", ["int8", "int32", "f32int", "f32rand"])
def test_block_scan_carry_matches_jax(kind, variant):
    blocks = _input(kind, (2, 3, 16, 8), seed=3)
    acc = np.int32 if kind in ("int8", "int32") else np.float32
    carries = _input("int32" if acc is np.int32 else "f32int", (2, 3), seed=4).astype(acc)
    j = np.asarray(jax_sp.block_scan_carry(jnp.asarray(blocks), jnp.asarray(carries),
                                           variant=variant))
    t = port_sp.block_scan_carry(torch.from_numpy(blocks), torch.from_numpy(carries),
                                 variant=variant).numpy()
    assert t.shape == blocks.shape
    if kind == "f32rand":
        flat = blocks.reshape(2, 3, -1)
        ref = ulp.scan_ref(flat) + carries[..., None]
        sc = ulp.scan_scale(flat) + np.abs(carries[..., None])
        bound = ulp.ulp_bound("highest", flat.shape[-1])
        for got in (t, j):
            assert ulp.max_ulp(got.reshape(flat.shape), ref, sc) <= bound
    else:
        np.testing.assert_array_equal(t, j)


# ---- scan(method="blocked") ----


@pytest.mark.parametrize("variant", ["scanu", "scanul1"])
@pytest.mark.parametrize("s,block_tiles", [(8, 1), (8, 2), (8, 4), (16, 1), (16, 2),
                                           (16, 4)])
@pytest.mark.parametrize("kind", ["int8", "int32", "f32int", "f32rand"])
def test_blocked_scan_matches_jax(kind, s, block_tiles, variant):
    x = _input(kind)
    kw = dict(method="blocked", tile_s=s, block_tiles=block_tiles, variant=variant)
    j = np.asarray(jax_scan(jnp.asarray(x), **kw))
    t = port_scan(torch.from_numpy(x), **kw).numpy()
    _check(kind, t, j, x)


@pytest.mark.parametrize("opts", [dict(exclusive=True), dict(reverse=True),
                                  dict(exclusive=True, reverse=True), dict(axis=0)],
                         ids=["exclusive", "reverse", "exclusive-reverse", "axis0"])
def test_blocked_scan_options_match_jax(opts):
    x = _input("int32", (N, 3)) if "axis" in opts else _input("int32")
    kw = dict(method="blocked", tile_s=8, block_tiles=2, **opts)
    j = np.asarray(jax_scan(jnp.asarray(x), **kw))
    t = port_scan(torch.from_numpy(x), **kw).numpy()
    assert t.shape == x.shape
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("n", [1, 5, 64, 200, 256])
def test_single_block_skips_the_sums_and_the_carry_scan(n, monkeypatch):
    """``nb == 1``: the carries are zero and phases 1-2 do not run."""
    assert port_sp.block_geometry(n, 8, 4)[2] == 1

    def refuse(*a, **k):
        raise AssertionError("phase 1 or 2 ran for a single block")

    monkeypatch.setattr(port_sp, "block_partial_sums_plain", refuse)
    monkeypatch.setattr(port_sp, "carry_scan_plain", refuse)
    x = _input("int8", (2, n), seed=n)
    j = np.asarray(jax_scan(jnp.asarray(x), method="blocked", tile_s=8, block_tiles=4))
    t = port_scan(torch.from_numpy(x), method="blocked", tile_s=8, block_tiles=4).numpy()
    np.testing.assert_array_equal(t, j)


def test_two_blocks_run_the_sums_and_the_carry_scan(monkeypatch):
    calls = []
    for name in ("block_partial_sums_plain", "carry_scan_plain"):
        fn = getattr(port_sp, name)
        monkeypatch.setattr(port_sp, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    x = _input("int32", (2, 257), seed=5)
    t = port_scan(torch.from_numpy(x), method="blocked", tile_s=8, block_tiles=4)
    assert calls == ["block_partial_sums_plain", "carry_scan_plain"]
    np.testing.assert_array_equal(t.numpy(), np.cumsum(x, -1, dtype=np.int32))


@pytest.mark.parametrize("dtype", ["bool", "bfloat16"])
def test_blocked_scan_bool_and_bf16_match_jax(dtype):
    raw = _input("int32", (2, 300), seed=6)
    xn = (raw > 0) if dtype == "bool" else (raw % 5 - 2).astype(np.float32)
    jx = jnp.asarray(xn, jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(xn)
    tx = torch.from_numpy(xn)
    tx = tx.to(torch.bfloat16) if dtype == "bfloat16" else tx
    j = np.asarray(jax_scan(jx, method="blocked", tile_s=8, block_tiles=1))
    t = port_scan(tx, method="blocked", tile_s=8, block_tiles=1).numpy()
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


# ---- the operators over the blocked scan ----


def test_split_blocked_matches_jax():
    x = _input("f32rand", (2, 203), seed=7)
    f = _input("int32", (2, 203), seed=8) > 0
    jz, ji, jc = jax_split(jnp.asarray(x), jnp.asarray(f), method="blocked", tile_s=8)
    z, i, c = P.split(torch.from_numpy(x), torch.from_numpy(f), method="blocked", tile_s=8)
    for got, want in ((z, jz), (i, ji), (c, jc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_radix_sort_blocked_matches_jax(dtype):
    x = _input("f32rand" if dtype == "float32" else "int8", (2, 203), seed=9)
    x[:, 10:30] = x[:, :20]                   # ties: stability decides their order
    jv, ji = jax_radix_sort(jnp.asarray(x), descending=True, method="blocked", tile_s=8)
    v, i = P.radix_sort(torch.from_numpy(x), descending=True, method="blocked", tile_s=8)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_top_p_sample_blocked_matches_jax():
    rng = np.random.default_rng(10)
    logits = (rng.standard_normal((4, 300)) * 3).astype(np.float32)
    u = rng.random((4, 1)).astype(np.float32)
    j = np.asarray(jax_top_p_sample(jnp.asarray(logits), None, p=0.9, method="blocked",
                                    tile_s=8, u=jnp.asarray(u)))
    t = P.top_p_sample(torch.from_numpy(logits), p=0.9, method="blocked", tile_s=8,
                       u=torch.from_numpy(u))
    np.testing.assert_array_equal(t.numpy(), j)


# ---- errors ----


def test_blocked_errors():
    x = torch.ones((2, 10))
    with pytest.raises(ValueError, match="variant"):
        port_scan(x, method="blocked", variant="scanx")
    with pytest.raises(ValueError, match="variant"):
        port_sp.blocked_scan(x, variant="scanx")
    with pytest.raises(ValueError, match="variant"):
        port_sp.block_scan_carry(x.reshape(2, 1, 5, 2), torch.zeros((2, 1)),
                                 variant="scanx")
    for bt in (0, -1):
        with pytest.raises(ValueError, match="block_tiles"):
            port_scan(x, method="blocked", block_tiles=bt)
        with pytest.raises(ValueError, match="block_tiles"):
            port_sp.blocked_scan(x, block_tiles=bt)
    with pytest.raises(ValueError, match="s must be <= 128"):
        port_sp.blocked_scan(x, s=129)
    with pytest.raises(ValueError, match="carries"):
        port_sp.block_scan_carry(x.reshape(2, 1, 5, 2), torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="precision"):
        port_sp.blocked_scan(x, precision="exact")
    assert port_sp.blocked_scan(x, s=2, precision="fast")[:, -1].tolist() == [10.0, 10.0]

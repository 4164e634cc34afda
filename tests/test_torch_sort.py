"""The port's sort and sampling operators, and the B7/B8 modules, against the JAX package.

Keys, logits and uniforms are drawn with numpy from a seed and go through both
packages.  Sorts must give the JAX package's values *and* permutation bit for
bit, for every port method and every ``bits_per_pass``; the JAX package
guarantees that all its methods and pass widths agree, so one JAX sort per
input is the reference.  Samplers fed the same uniforms (``u=``) must pick the
same index: both sides take fp32 prefix sums of the same probabilities, so
they could differ only where ``u · cdf[-1]`` falls within a few fp32 roundings
of a CDF step, which these seeded inputs do not hit.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.primitives import multi_split as jax_multi_split
from repro.core.primitives import radix_sort as jax_radix_sort
from repro.core.primitives import top_p_sample as jax_top_p_sample
from repro.core.primitives import weighted_sample as jax_weighted_sample
from repro.kernels import split_mm as jax_split_mm
from repro_torch.core import primitives as P
from repro_torch.kernels import ops
from repro_torch.kernels import split_mm as port_split_mm

METHODS = ("vector", "matmul", "kernel")
N = 203                                       # ragged: no multiple of 8, 16 or 128


@functools.lru_cache(maxsize=None)
def _keys(dtype: str, seed: int = 0) -> np.ndarray:
    """(2, N) keys with duplicates (stability) and signed zeros / extremes."""
    rng = np.random.default_rng(seed)
    if dtype in ("float32", "bfloat16"):
        x = rng.standard_normal((2, N)).astype(np.float32)
        x[:, 5:40:5] = x[:, :1]               # ties: stability decides their order
        x[0, 50], x[0, 51], x[1, 60] = 0.0, -0.0, -np.inf
        x[1, 61] = np.inf
        return x
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, (2, N), endpoint=True).astype(dtype)
    x[:, 10:60:7] = x[:, :1]
    x[0, 70], x[1, 71] = info.min, info.max
    return x


def _to_jax(x: np.ndarray, dtype: str):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else x.dtype)


def _to_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(x.copy())
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@functools.lru_cache(maxsize=None)
def _jax_sorted(dtype: str, descending: bool):
    v, i = jax_radix_sort(_to_jax(_keys(dtype), dtype), descending=descending,
                          method="vector")
    return np.asarray(v.astype(jnp.float32) if dtype == "bfloat16" else v), np.asarray(i)


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("bits_per_pass", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int32"])
@pytest.mark.parametrize("method", METHODS)
def test_radix_sort_matches_jax(method, dtype, bits_per_pass, descending):
    jv, ji = _jax_sorted(dtype, descending)
    v, i = P.radix_sort(_to_torch(_keys(dtype), dtype), descending=descending,
                        method=method, bits_per_pass=bits_per_pass, tile_s=16)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), ji)
    got = v.float().numpy() if dtype == "bfloat16" else v.numpy()
    np.testing.assert_array_equal(got, jv)
    # -0.0 and 0.0 keep their own bits (their order is the encoding's)
    assert np.array_equal(np.signbit(got), np.signbit(jv))


def test_sort_and_topk_match_jax():
    from repro.core.primitives import sort as jax_sort
    from repro.core.primitives import topk as jax_topk
    x = _keys("int8")
    jv, ji = jax_sort(jnp.asarray(x), descending=True)
    for method in METHODS:
        v, i = P.sort(torch.from_numpy(x), descending=True, method=method)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    jv, ji = jax_topk(jnp.asarray(x), 7)
    for method in METHODS:
        v, i = P.topk(torch.from_numpy(x), 7, method=method)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_sortable_encoding_round_trips_and_orders():
    x = torch.tensor([-np.inf, -2.5, -0.0, 0.0, 1e-30, 3.0, np.inf])
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        enc = P.float_to_sortable_int(x.to(dt))
        assert torch.equal(P.sortable_int_to_float(enc, dt).view(enc.dtype),
                           x.to(dt).view(enc.dtype))
        mask = 0xFFFF if enc.dtype == torch.int16 else 0xFFFFFFFF
        u = [v & mask for v in enc.tolist()]
        assert u == sorted(u)


@pytest.mark.parametrize("method", ["vector", "matmul"])
def test_multi_split_matches_jax(method):
    rng = np.random.default_rng(3)
    x = rng.integers(-1000, 1000, (2, N)).astype(np.int32)
    d = rng.integers(0, 6, (2, N)).astype(np.int32)
    jz, ji, jc = jax_multi_split(jnp.asarray(x), jnp.asarray(d), 6, method="vector")
    z, i, c = P.multi_split(torch.from_numpy(x), torch.from_numpy(d), 6,
                            method=method, tile_s=8)
    for got, want in ((z, jz), (i, ji), (c, jc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the kernel method (B6; its plain version on the CPU) gives the same split
    kz, ki, kc = P.multi_split(torch.from_numpy(x), torch.from_numpy(d), 6, method="kernel")
    for got, want in ((kz, jz), (ki, ji), (kc, jc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pass_bits,shift", [(1, 0), (4, 4), (4, 12), (8, 8)])
def test_radix_pass_module_matches_jax_kernel(pass_bits, shift):
    """B7's plain version against the Pallas kernel itself (interpret mode)."""
    rng = np.random.default_rng(pass_bits * 16 + shift)
    w = rng.integers(0, 1 << 16, (2, 256)).astype(np.uint16)
    w[:, 100:140] = w[:, :40]
    perm = rng.permutation(256).astype(np.int32)[None].repeat(2, 0)
    jw, jp = jax_split_mm.radix_pass_multibit(jnp.asarray(w), jnp.asarray(perm),
                                              shift=shift, pass_bits=pass_bits, s=16)
    tw, tp = port_split_mm.radix_pass_multibit(
        torch.from_numpy(w.view(np.int16)), torch.from_numpy(perm), shift=shift,
        pass_bits=pass_bits)
    np.testing.assert_array_equal(tw.numpy().view(np.uint16), np.asarray(jw))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_radix_pass_module_validates():
    w = torch.zeros((2, 8), dtype=torch.int16)
    p = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        port_split_mm.radix_pass_multibit(w.float(), p, shift=0, pass_bits=4)
    with pytest.raises(TypeError):
        port_split_mm.radix_pass_multibit(w, p.long(), shift=0, pass_bits=4)
    with pytest.raises(ValueError):
        port_split_mm.radix_pass_multibit(w, p[:, :4], shift=0, pass_bits=4)
    with pytest.raises(ValueError):
        port_split_mm.radix_pass_multibit(w, p, shift=14, pass_bits=4)
    with pytest.raises(ValueError):
        port_split_mm.radix_pass_multibit(w, p, shift=0, pass_bits=9)


def _sorted_probs(seed: int, rows: int = 3, n: int = N, scale: float = 3.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, n)) * scale).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    p = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return -np.sort(-p, axis=-1), rng.random((rows, 1), dtype=np.float32)


@pytest.mark.parametrize("p", [0.0, 0.5, 0.9, 1.0])
def test_topp_tail_module_matches_jax_kernel(p):
    """B8's plain version against the Pallas kernel itself (interpret mode)."""
    sp, u = _sorted_probs(7)
    j = np.asarray(jax_split_mm.topp_mask_sample_tiles(jnp.asarray(sp), jnp.asarray(u), p=p))
    t = port_split_mm.topp_mask_sample_tiles(torch.from_numpy(sp), torch.from_numpy(u), p=p)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)
    with pytest.raises(ValueError):
        port_split_mm.topp_mask_sample_tiles(torch.from_numpy(sp), torch.from_numpy(u[:2]), p=p)


@pytest.mark.parametrize("method", METHODS)
def test_weighted_sample_matches_jax(method):
    sp, u = _sorted_probs(11)
    w = sp * 5.0
    j = np.asarray(jax_weighted_sample(jnp.asarray(w), None, u=jnp.asarray(u),
                                       method="vector"))
    t = P.weighted_sample(torch.from_numpy(w), u=torch.from_numpy(u), method=method,
                          tile_s=16)
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("sort_method", ["radix", "xla"])
@pytest.mark.parametrize("method", METHODS)
def test_top_p_sample_matches_jax(method, sort_method):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, N)) * 2.0).astype(np.float32)
    u = rng.random((3, 1), dtype=np.float32)
    for p, temp in ((0.9, 1.0), (0.5, 0.7)):
        j = np.asarray(jax_top_p_sample(jnp.asarray(logits), None, p=p, temperature=temp,
                                        method="vector", sort_method=sort_method,
                                        u=jnp.asarray(u)))
        t = P.top_p_sample(torch.from_numpy(logits), p=p, temperature=temp,
                           method=method, sort_method=sort_method, tile_s=16,
                           u=torch.from_numpy(u))
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), j)


def test_top_p_kernel_method_matches_jax_kernel_method():
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((2, 128)) * 2.0).astype(np.float32)
    u = rng.random((2, 1), dtype=np.float32)
    j = np.asarray(jax_top_p_sample(jnp.asarray(logits), None, method="kernel",
                                    u=jnp.asarray(u)))
    t = P.top_p_sample(torch.from_numpy(logits), method="kernel", u=torch.from_numpy(u))
    np.testing.assert_array_equal(t.numpy(), j)


def test_top_p_temperature_zero_is_greedy_like_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    logits[1, 3] = np.nan
    j = np.asarray(jax_top_p_sample(jnp.asarray(logits), None, temperature=0.0))
    t = P.top_p_sample(torch.from_numpy(logits), temperature=0.0)
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t.numpy(), np.nanargmax(logits, -1))


def test_top_p_sample_validates():
    x = torch.zeros((1, 4))
    for kw in (dict(p=1.5), dict(temperature=-1.0), dict(sort_method="bitonic"),
               dict(nonfinite="bogus")):
        with pytest.raises(ValueError):
            P.top_p_sample(x, **kw)
    with pytest.raises(NotImplementedError):
        P.top_p_sample(x, nonfinite="sanitize")
    with pytest.raises(ValueError):
        P.radix_sort(torch.zeros(4, dtype=torch.int32), bits_per_pass=0)


def test_cpu_sampler_counts_no_launch():
    ops.reset_launch_counts()
    sp, u = _sorted_probs(1)
    P.top_p_sample(torch.from_numpy(np.log(sp)), method="kernel", u=torch.from_numpy(u))
    assert set(ops.launch_counts().values()) == {0}

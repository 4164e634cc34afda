"""The port's packed-batch operators (``core/segmented.py``) against the JAX package.

Values and offsets are drawn with numpy from a seed and go through both
packages on the CPU, on every method.  The JAX ``kernel`` and ``blocked``
methods run their Pallas kernels in interpret mode, with ``tile_s=8``; the
port's run the kernels' plain versions.  Tolerances:

* counts, permutations, indices, sorted values, compressed payloads and
  sampled ids are exact;
* scans of integer and integer-valued payloads are bit-identical;
* random fp32 scans are held, in both packages, to the JAX package's
  segmented contract: ``8·√n`` ulp against the fp64 per-segment scan, at the
  scale of the running ``Σ|x|`` from the row start (``analysis/ulp.py``
  ``segment_scan_scale``);
* softmax probabilities agree within 1e-6 relative (``exp`` rounds apart in
  XLA and torch).

Offsets include empty segments at the start, the middle and the end, a
segment longer than a block, and a ragged packed length.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import ulp
from repro.core import segmented as J
from repro_torch.core import guards
from repro_torch.core import segmented as T
from repro_torch.core.primitives import radix_sort, top_p_sample

METHODS = ["matmul", "vector", "kernel", "blocked"]
KW = dict(tile_s=8, block_tiles=2)                 # blocks of 128: several per packed row
LENS = (0, 5, 1, 0, 130, 17, 0, 300, 40, 0)       # n = 493


@functools.lru_cache(maxsize=None)
def _offsets(lens=LENS) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _values(kind: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "f32rand":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "f32int":
        return rng.integers(-8, 9, shape).astype(np.float32)
    if kind == "bool":
        return rng.random(shape) < 0.4
    if kind == "bf16":
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(-100, 101, shape).astype({"int8": np.int8, "int32": np.int32}[kind])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


# ---- boundary structure and the container ----


@pytest.mark.parametrize("lens", [LENS, (3,), (0, 0, 4), (2, 0, 0)])
def test_flags_ids_and_ends_match_jax(lens):
    off = _offsets(lens)
    n = int(off[-1])
    np.testing.assert_array_equal(T.boundary_flags(_t(off), n).numpy(),
                                  np.asarray(J.boundary_flags(_j(off), n)))
    np.testing.assert_array_equal(T.segment_ids(_t(off), n).numpy(),
                                  np.asarray(J.segment_ids(_j(off), n)))
    x = _values("int32", (2, n))
    np.testing.assert_array_equal(T._segment_ends(_t(x), _t(off)).numpy(),
                                  np.asarray(J._segment_ends(_j(x), _j(off))))


def test_segmented_batch_round_trips_like_jax():
    segs = [np.arange(3, dtype=np.float32), np.zeros(0, np.float32),
            np.asarray([7.0, 8.0], np.float32)]
    tb, jb = T.SegmentedBatch.from_ragged(segs), J.SegmentedBatch.from_ragged(segs)
    assert tb.num_segments == jb.num_segments == 3
    np.testing.assert_array_equal(tb.offsets.numpy(), np.asarray(jb.offsets))
    np.testing.assert_array_equal(tb.lengths.numpy(), np.asarray(jb.lengths))
    for a, b in zip(tb.to_ragged(), jb.to_ragged()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tb.to_dense(fill_value=-1), jb.to_dense(fill_value=-1)):
        np.testing.assert_array_equal(a, b)
    empty = T.SegmentedBatch.from_ragged([[], []])
    assert empty.values.shape == (0,) and empty.offsets.tolist() == [0, 0, 0]
    assert T.segment_scan(empty, method="kernel").shape == (0,)


@pytest.mark.parametrize("bad,exc,match", [
    ([[0, 1], [1, 2]], ValueError, "1-D"),
    ([], ValueError, "empty"),
    ([1, 5], ValueError, r"offsets\[0\]"),
    ([0, 4], ValueError, r"offsets\[-1\]"),
    ([0, 3, 2, 5], ValueError, "non-decreasing"),
])
def test_validate_offsets_errors(bad, exc, match):
    off = torch.tensor(bad, dtype=torch.int32)
    with pytest.raises(exc, match=match):
        guards.validate_offsets(off, 5, op="t")
    with pytest.raises(exc, match=match):
        T.segment_scan(torch.ones(5), off, method="vector")


def test_validate_offsets_refuses_floats_and_keeps_good_offsets():
    with pytest.raises(TypeError, match="integer"):
        guards.validate_offsets(torch.tensor([0.0, 5.0]), 5, op="t")
    good = torch.tensor([0, 0, 5])
    assert guards.validate_offsets(good, 5, op="t") is good
    with pytest.raises(ValueError, match="offsets required"):
        T.segment_scan(torch.ones(5))


def test_unported_options_raise():
    x, off = torch.ones(5), [0, 2, 5]
    np.testing.assert_array_equal(
        T.segment_linear_scan(x, x, off, method="matmul", precision="compensated").numpy(),
        np.asarray(J.segment_linear_scan(jnp.ones(5), jnp.ones(5), jnp.asarray(off),
                                         method="matmul", precision="compensated")))
    xn = torch.tensor([1.0, float("nan"), 1.0, float("inf"), 1.0])
    jn = jnp.asarray(xn.numpy())
    np.testing.assert_array_equal(
        T.segment_linear_scan(xn, xn, off, nonfinite="sanitize").numpy(),
        np.asarray(J.segment_linear_scan(jn, jn, jnp.asarray(off), nonfinite="sanitize")))
    with pytest.raises(ValueError, match="precision"):
        T.segment_scan(x, off, method="vector", precision="compensated")
    np.testing.assert_array_equal(
        T.segment_scan(xn, off, nonfinite="sanitize").numpy(),
        np.asarray(J.segment_scan(jn, jnp.asarray(off), nonfinite="sanitize")))
    with pytest.raises(guards.NonFiniteError):
        T.segment_top_p_sample(xn, off, nonfinite="raise")
    with pytest.raises(J.guards.NonFiniteError):
        J.segment_top_p_sample(jn, jnp.asarray(off), None, nonfinite="raise")
    with pytest.raises(ValueError, match="nonfinite"):
        T.segment_scan(x, off, nonfinite="ignore")


# ---- segment_scan and the ops read off it ----


def _check_scan(kind, got, want, x, off):
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind != "f32rand":
        np.testing.assert_array_equal(got, want)
        return
    ref = np.stack([ulp.segment_scan_ref(r, off) for r in x.reshape(-1, x.shape[-1])])
    sc = ulp.scan_scale(x.reshape(ref.shape))
    bound = ulp.ulp_bound("highest", x.shape[-1])
    assert ulp.max_ulp(got.reshape(ref.shape), ref, sc) <= bound
    assert ulp.max_ulp(want.reshape(ref.shape), ref, sc) <= bound


@pytest.mark.parametrize("kind", ["int8", "int32", "bool", "f32int", "f32rand"])
@pytest.mark.parametrize("method", METHODS)
def test_segment_scan_matches_jax(method, kind):
    off = _offsets()
    x = _values(kind, (int(off[-1]),))
    j = J.segment_scan(_j(x), _j(off), method=method, **KW)
    t = T.segment_scan(_t(x), _t(off), method=method, **KW)
    _check_scan(kind, t.numpy(), np.asarray(j), x, off)


@pytest.mark.parametrize("exclusive,reverse", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("method", METHODS)
def test_segment_scan_exclusive_reverse_match_jax(method, exclusive, reverse):
    off = _offsets()
    x = _values("int32", (3, int(off[-1])), seed=1)        # leading rows share the offsets
    j = J.segment_scan(_j(x), _j(off), method=method, exclusive=exclusive,
                       reverse=reverse, **KW)
    t = T.segment_scan(_t(x), off.tolist(), method=method, exclusive=exclusive,
                       reverse=reverse, **KW)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("method", METHODS)
def test_segment_sums_and_cumsum_match_jax(method):
    off = _offsets()
    x = _values("int8", (int(off[-1]),), seed=2)
    np.testing.assert_array_equal(
        T.segment_sums(_t(x), _t(off), method=method, **KW).numpy(),
        np.asarray(J.segment_sums(_j(x), _j(off), method=method, **KW)))
    sb = T.SegmentedBatch(_t(x), _t(off))
    np.testing.assert_array_equal(T.segment_cumsum(sb, method=method, **KW).numpy(),
                                  np.asarray(J.segment_cumsum(_j(x), _j(off),
                                                              method=method, **KW)))


@pytest.mark.parametrize("method", METHODS)
def test_segment_softmax_matches_jax(method):
    off = _offsets()
    x = _values("f32rand", (int(off[-1]),), seed=3) * 4
    t = T.segment_softmax(_t(x), _t(off), method=method, **KW).numpy()
    j = np.asarray(J.segment_softmax(_j(x), _j(off), method=method, **KW))
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    sums = np.add.reduceat(t.astype(np.float64), off[:-1][np.diff(off) > 0])
    np.testing.assert_allclose(sums, 1.0, rtol=1e-5)


# ---- compress / sort / topk ----


@pytest.mark.parametrize("payload", ["int32", "f32rand"])
@pytest.mark.parametrize("method", METHODS)
def test_segment_compress_matches_jax(method, payload):
    off = _offsets()
    n = int(off[-1])
    x, m = _values(payload, (n,), seed=4), _values("bool", (n,), seed=5)
    jz, jc = J.segment_compress(_j(x), _j(m), _j(off), method=method, fill_value=-1, **KW)
    tz, tc = T.segment_compress(_t(x), _t(m), _t(off), method=method, fill_value=-1, **KW)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("keys", ["int8", "bf16", "f32rand", "int32"])
@pytest.mark.parametrize("method", METHODS)
def test_segment_sort_matches_jax_and_the_1d_sort(method, keys, descending):
    off = _offsets()
    n = int(off[-1])
    x = _values(keys, (n,), seed=6).copy()
    x[100:140] = x[:40]                                    # duplicates: stability
    jx, tx = _j(x), _t(x)
    if keys == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    bpp = 8 if keys in ("int32", "f32rand") else 4
    jv, ji = J.segment_sort(jx, _j(off), descending=descending, method=method,
                            bits_per_pass=bpp, **KW)
    tv, ti = T.segment_sort(tx, _t(off), descending=descending, method=method,
                            bits_per_pass=bpp, **KW)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)))
    for a, b in zip(off[:-1], off[1:]):                    # one 1-D sort per segment
        if b > a:
            sv, si = radix_sort(tx[a:b], descending=descending, method="vector")
            assert torch.equal(tv[a:b], sv) and torch.equal(ti[a:b] - int(a), si)


@pytest.mark.parametrize("k", [1, 3, 64])
@pytest.mark.parametrize("method", METHODS)
def test_segment_topk_matches_jax(method, k):
    off = _offsets()
    x = _values("int32", (int(off[-1]),), seed=7)
    jr = J.segment_topk(_j(x), _j(off), k=k, method=method, fill_value=-7, **KW)
    tr = T.segment_topk(_t(x), _t(off), k=k, method=method, fill_value=-7, **KW)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_segment_topk_and_sort_of_an_all_empty_batch():
    v, i, c = T.segment_topk(torch.zeros(0), [0, 0], k=2, method="kernel")
    assert v.shape == (1, 2) and i.tolist() == [[-1, -1]] and c.tolist() == [0]
    assert T.segment_sort(torch.zeros(0, dtype=torch.int32), [0, 0],
                          method="blocked")[0].shape == (0,)


# ---- the sampler ----


@functools.lru_cache(maxsize=None)
def _sampler_case(seed: int):
    rng = np.random.default_rng(seed)
    off = _offsets()
    x = (rng.standard_normal(int(off[-1])) * 3).astype(np.float32)
    u = rng.random((len(LENS), 1)).astype(np.float32)
    return off, x, u


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("method", METHODS)
def test_segment_top_p_sample_matches_jax_under_its_uniforms(method, temperature):
    off, x, u = _sampler_case(8)
    for p in (0.5, 0.9):
        j = J.segment_top_p_sample(_j(x), _j(off), None, p=p, temperature=temperature,
                                   method=method, u=_j(u), **KW)
        t = T.segment_top_p_sample(_t(x), _t(off), p=p, temperature=temperature,
                                   method=method, u=_t(u), **KW)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert (t.numpy()[np.diff(off) == 0] == 0).all()


@pytest.mark.parametrize("method", METHODS)
def test_segment_top_p_sample_greedy_probs_and_1d_agreement(method):
    off, x, u = _sampler_case(9)
    x = x.copy()
    x[10:15] = x[6:11].max() + 1                           # ties go to the lowest id
    j = J.segment_top_p_sample(_j(x), _j(off), None, temperature=0.0, method=method)
    t = T.segment_top_p_sample(_t(x), _t(off), temperature=0.0, method=method)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    probs = T.segment_softmax(_t(x), _t(off), method="vector")
    jp = J.segment_top_p_sample(_j(probs.numpy()), _j(off), None, is_probs=True,
                                method=method, u=_j(u), **KW)
    tp = T.segment_top_p_sample(probs, _t(off), is_probs=True, method=method, u=_t(u), **KW)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # each segment against the 1-D sampler on its own row, under the same uniform
    t = T.segment_top_p_sample(_t(x), _t(off), method=method, u=_t(u), **KW)
    for i, (a, b) in enumerate(zip(off[:-1], off[1:])):
        if b > a:
            one = top_p_sample(_t(x[a:b])[None], method="vector", u=_t(u[i:i + 1]))
            assert int(one[0]) == int(t[i])


def test_generator_draws_one_uniform_per_segment():
    off, x, _ = _sampler_case(10)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    t = T.segment_top_p_sample(_t(x), _t(off), g1, method="vector")
    u = torch.rand((len(LENS), 1), generator=g2)
    assert torch.equal(t, T.segment_top_p_sample(_t(x), _t(off), method="vector", u=u))
    assert torch.equal(T.segment_top_p_sample(torch.zeros(0), [0, 0, 0], method="kernel"),
                       torch.zeros(2, dtype=torch.int32))

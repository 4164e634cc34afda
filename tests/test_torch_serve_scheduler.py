"""The port's continuous batching against the JAX package: the page allocator, the
paged KV layout, paged decode attention and the FCFS ``ContinuousEngine``.

The JAX ``llama3-8b`` SMOKE model is initialised from a fixed key and carried
across with :func:`repro_torch.convert.params_from_jax`; both packages run the
same numpy-seeded traces on the CPU in fp32.  Streams must be identical:
greedy as it is, the top-p samplers under the JAX engine's own uniforms,
rebuilt from each request's key chain (one ``split`` for the prefill's
sample, then one a decoded token, each drawing ``uniform(k, (1, 1))``).  The
``requests`` and ``stats`` of a run must equal JAX's exactly.  Tensors within
``ATOL`` are those of ``tests/test_torch_serve.py``.
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

from repro.models import attention as jax_att
from repro.models.layers import use_compute_dtype
from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro.serving import paged_kv as jax_paged_kv
from repro.serving.scheduler import ContinuousEngine as JaxContinuousEngine
from repro.serving.scheduler import Request as JaxRequest
from repro.serving.scheduler import poisson_trace as jax_poisson_trace
from repro_torch.analysis.streams import DenseReplay, first_divergence, step_margin
from repro_torch.configs import base as port_base
from repro_torch.convert import params_from_jax
from repro_torch.launch.world import run_world
from repro_torch.models import attention as att
from repro_torch.models.model import build_model, get_config
from repro_torch.serving import paged_kv
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import ContinuousEngine, Request, poisson_trace

ATOL = 2e-5
PS = 8                      # page size used throughout, as in the JAX tests
GEOM = dict(max_batch=2, page_size=PS, n_pages=9, max_len=24, tick_tokens=4)
TRACE = dict(rate=0.4, seed=11, prompt_len=(3, 8), max_new=(2, 5))
HERE = os.path.dirname(__file__)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax_build_model(jax_get_config("llama3-8b", smoke=True)).init(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _np_params():
    return jax.tree.map(np.asarray, _jax_params())


def _port_params():
    return params_from_jax(_np_params(), device="cpu")


def _cfg():
    return get_config("llama3-8b", smoke=True)


def _engine(sampler="greedy", **kw):
    return ContinuousEngine(_cfg(), _port_params(), sampler=sampler, top_p=0.9,
                            device="cpu", **{**GEOM, **kw})


def _jax_engine(sampler="greedy", **kw):
    return JaxContinuousEngine(jax_get_config("llama3-8b", smoke=True), _jax_params(),
                               sampler=sampler, top_p=0.9, **{**GEOM, **kw})


def _jax_uniforms(seed: int, n: int) -> np.ndarray:
    """The uniforms the JAX engine draws for a request keyed ``PRNGKey(seed)``."""
    key = jax.random.PRNGKey(seed)
    us = []
    for _ in range(n):
        key, k = jax.random.split(key)
        us.append(float(jax.random.uniform(k, (1, 1), dtype=jnp.float32)[0, 0]))
    return np.asarray(us, np.float32)


def _pair(rid, tokens, n, seed, eos_id=None, arrival=0):
    """The same request for both packages, the port's fed JAX's uniforms."""
    toks = np.asarray(tokens, np.int32)
    j = JaxRequest(rid=rid, tokens=toks, max_new_tokens=n,
                   key=np.asarray(jax.random.PRNGKey(seed)), eos_id=eos_id,
                   arrival_step=arrival)
    t = Request(rid=rid, tokens=toks, max_new_tokens=n, seed=seed, eos_id=eos_id,
                arrival_step=arrival, uniforms=_jax_uniforms(seed, n))
    return j, t


def _trace_pair(n=5, **kw):
    kw = {**TRACE, **kw}
    jt = jax_poisson_trace(n, vocab_size=256, **kw)
    tt = poisson_trace(n, vocab_size=256, **kw)
    for r in tt:
        r.uniforms = _jax_uniforms(r.seed, r.max_new_tokens)
    return jt, tt


def _assert_same_result(got, want):
    assert got["stats"] == want["stats"]
    assert got["requests"] == want["requests"]
    assert sorted(got["streams"]) == sorted(want["streams"])
    for rid, s in want["streams"].items():
        np.testing.assert_array_equal(got["streams"][rid], np.asarray(s), err_msg=rid)


@functools.lru_cache(maxsize=None)
def _jax_run(sampler: str):
    jt, _ = _trace_pair()
    return _jax_engine(sampler).run(jt)


# ---------------------------------------------------------------------------
# the page allocator (a free list picked with the paper's compress)
# ---------------------------------------------------------------------------


def test_allocator_lowest_free_first_and_reuse():
    al = paged_kv.PageAllocator(8, device="cpu")    # capacity 7, page 0 reserved
    np.testing.assert_array_equal(al.alloc(3), [1, 2, 3])   # never page 0
    np.testing.assert_array_equal(al.alloc(4), [4, 5, 6, 7])
    assert al.alloc(1) is None and al.in_use == 7 == al.peak_in_use
    al.release([1, 2, 3])
    np.testing.assert_array_equal(al.alloc(2), [1, 2])      # lowest freed id first


def test_allocator_rejects_double_free_bad_ids_and_a_pool_of_one():
    al = paged_kv.PageAllocator(4, device="cpu")
    ids = al.alloc(2)
    al.release(ids)
    with pytest.raises(ValueError, match="double free"):
        al.release(ids)
    with pytest.raises(ValueError, match="outside"):
        al.release([0])                     # the scratch page is not releasable
    with pytest.raises(ValueError, match="outside"):
        al.release([4])
    with pytest.raises(ValueError, match=">= 2"):
        paged_kv.PageAllocator(1, device="cpu")
    with pytest.raises(ValueError):
        al.alloc(0)


@pytest.mark.parametrize("method", ["vector", "matmul"])
def test_allocator_picks_equal_jax_over_a_seeded_sequence(method):
    rng = np.random.default_rng(5)
    ja = jax_paged_kv.PageAllocator(33)
    ta = paged_kv.PageAllocator(33, method=method, device="cpu")
    held = []
    for _ in range(60):
        if held and rng.random() < 0.45:
            ids = held.pop(int(rng.integers(len(held))))
            ja.release(ids)
            ta.release(ids)
            continue
        n = int(rng.integers(1, 9))
        j, t = ja.alloc(n), ta.alloc(n)
        assert (j is None) == (t is None)
        if j is not None:
            np.testing.assert_array_equal(t, j)
            held.append(t)
        assert ta.in_use == ja.in_use and ta.peak_in_use == ja.peak_in_use
    np.testing.assert_array_equal(ta.free, ja.free)


# ---------------------------------------------------------------------------
# the paged layout: the gathered view is the dense cache
# ---------------------------------------------------------------------------


def test_insert_then_gather_matches_dense_prefill_cache():
    cfg, tp = _cfg(), _port_params()
    model = build_model(cfg)
    caches = paged_kv.build_paged_caches(model, 2, 9, PS, 3, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 10))
    _, dense = model.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=2 * PS)
    paged_kv.insert_request(caches, dense, 1, np.asarray([4, 2]))
    view = paged_kv.gather_dense(caches)["stack"]["sub0"]
    for name in ("k", "v"):
        assert torch.equal(view[name][:, 1, :2 * PS], dense["stack"]["sub0"][name][:, 0])
        assert not view[name][:, 1, 2 * PS:].any()      # the scratch page, never written
    assert caches["stack"]["sub0"]["pages"][:, 1].tolist() == [[4, 2, 0]] * cfg.n_layers
    # the same view as the JAX package's
    jm = jax_build_model(jax_get_config("llama3-8b", smoke=True))
    _, jd = jm.prefill(_jax_params(), {"tokens": jnp.asarray(toks)}, cache_len=2 * PS)
    jc = jax_paged_kv.insert_request(jax_paged_kv.build_paged_caches(jm, 2, 9, PS, 3),
                                     jd, 1, np.asarray([4, 2]))
    jv = jax_paged_kv.gather_dense(jc)["stack"]["sub0"]
    for name in ("k", "v"):
        np.testing.assert_allclose(view[name].numpy(), np.asarray(jv[name]), rtol=0,
                                   atol=ATOL)


def test_build_paged_caches_rejects_non_attention_models():
    cfg = get_config("zamba2-1.2b", smoke=True)
    with pytest.raises(ValueError, match="attention"):
        paged_kv.build_paged_caches(build_model(cfg), 2, 8, PS, 2, device="cpu")


def _port_config(name):
    """The JAX package's SMOKE config of ``name`` as the port's ``ModelConfig``."""
    jc = jax_get_config(name, smoke=True)
    sub = {"moe": port_base.MoEConfig, "mla": port_base.MLAConfig,
           "ssm": port_base.SSMConfig, "xlstm": port_base.XLSTMConfig}
    kw = {}
    for f in dataclasses.fields(port_base.ModelConfig):
        v = getattr(jc, f.name)
        kw[f.name] = sub[f.name](**dataclasses.asdict(v)) if f.name in sub and v else v
    return port_base.ModelConfig(**kw)


@pytest.mark.parametrize("name", ["minicpm3-4b", "zamba2-1.2b", "xlstm-350m",
                                  "whisper-small"])
def test_continuous_engine_rejects_non_attention_stacks(name):
    cfg = _port_config(name)
    with pytest.raises(ValueError, match="attention-only"):
        ContinuousEngine(cfg, None, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        JaxContinuousEngine(jax_get_config(name, smoke=True), None)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def test_attn_decode_paged_matches_jax_with_a_row_on_the_scratch_page():
    cfg = _cfg()
    rng = np.random.default_rng(1)
    b, n_pages, nblk, kh, hd = 3, 7, 3, cfg.n_kv_heads, cfg.head_dim_
    p = {k: v[0] for k, v in _np_params()["stack"]["sub0"]["attn"].items()}
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    kp = rng.normal(size=(n_pages, PS, kh, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, PS, kh, hd)).astype(np.float32)
    # row 2's table is cleared: it writes to and reads the scratch page 0
    pages = np.asarray([[3, 1, 5], [2, 6, 0], [0, 0, 0]], np.int32)
    pos = np.asarray([17, 9, 4], np.int32)
    with use_compute_dtype(jnp.float32):       # as the JAX model runs its layers
        jy, jc = jax_att.attn_decode_paged(p, jnp.asarray(x), jax_get_config(
            "llama3-8b", smoke=True), {"k": jnp.asarray(kp), "v": jnp.asarray(vp),
                                       "pages": jnp.asarray(pages)}, jnp.asarray(pos))
    cache = {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy()),
             "pages": torch.from_numpy(pages)}
    ty, tc = att.attn_decode_paged({k: torch.tensor(v) for k, v in p.items()},
                                   torch.from_numpy(x), cfg, cache, torch.from_numpy(pos),
                                   cdt=torch.float32)
    assert tc is cache and tc["pages"] is cache["pages"]
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=0,
                                   atol=ATOL)
    assert not np.array_equal(tc["k"][0].numpy(), kp[0])    # row 2 wrote page 0


def _paged_copy_of(dense, perm, n_pages):
    """Paged caches holding the dense caches' rows, row r's blocks on pages ``perm[r]``."""
    k = dense["stack"]["sub0"]["k"]
    n_layers, b, t, kh, hd = k.shape
    nblk = t // PS
    out = {"k": torch.zeros((n_layers, n_pages, PS, kh, hd)),
           "v": torch.zeros((n_layers, n_pages, PS, kh, hd)),
           "pages": torch.zeros((n_layers, b, nblk), dtype=torch.int32)}
    for name in ("k", "v"):
        blocks = dense["stack"]["sub0"][name].reshape(n_layers, b, nblk, PS, kh, hd)
        for r in range(b):
            out[name][:, perm[r]] = blocks[:, r]
    for r in range(b):
        out["pages"][:, r] = torch.as_tensor(perm[r], dtype=torch.int32)
    return {"stack": {"sub0": out}}


@pytest.mark.parametrize("per_row", [True, False])
def test_paged_decode_is_bit_equal_to_dense_decode(per_row):
    """At equal attention length the paged layout is a layout: the same logits and
    the same cache bits as the port's dense decode, per-row or scalar positions."""
    cfg, tp = _cfg(), _port_params()
    model = build_model(cfg)
    rng = np.random.default_rng(2)
    b, nblk = 3, 3
    toks = rng.integers(0, cfg.vocab_size, (b, 6))
    _, dense = model.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=nblk * PS)
    perm = [[7, 2, 9], [1, 8, 4], [3, 6, 5]]
    paged = _paged_copy_of(dense, perm, 10)
    pos = torch.tensor([6, 9, 13]) if per_row else 6
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
    for _ in range(3):
        ld, dense = model.decode_step(tp, nxt, dense, pos)
        lp, paged = model.decode_step(tp, nxt, paged, pos)
        assert torch.equal(lp, ld)
        view = paged_kv.gather_dense(paged)["stack"]["sub0"]
        for name in ("k", "v"):
            assert torch.equal(view[name], dense["stack"]["sub0"][name])
        nxt = torch.argmax(ld, -1, keepdim=True)
        pos = pos + 1


def test_dense_per_row_decode_matches_jax():
    jcfg = jax_get_config("llama3-8b", smoke=True)
    jm, tm = jax_build_model(jcfg), build_model(_cfg())
    toks = np.random.default_rng(3).integers(0, 256, (2, 5)).astype(np.int32)
    _, jc = jm.prefill(_jax_params(), {"tokens": jnp.asarray(toks)}, cache_len=16)
    _, tc = tm.prefill(_port_params(), {"tokens": torch.from_numpy(toks)}, cache_len=16)
    pos = np.asarray([5, 11], np.int32)
    nxt = toks[:, -1:]
    jl, _ = jm.decode_step(_jax_params(), jnp.asarray(nxt), jc, jnp.asarray(pos))
    tl, _ = tm.decode_step(_port_params(), torch.from_numpy(nxt), tc, torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


def test_hybrid_decode_refuses_per_row_positions():
    cfg = get_config("zamba2-1.2b", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.int64)
    _, caches = model.prefill(params, {"tokens": toks}, cache_len=8)
    with pytest.raises(ValueError, match="per-row"):
        model.decode_step(params, toks[:, :1], caches, torch.tensor([4, 4]))
    with pytest.raises(NotImplementedError):
        model.empty_caches(2, 8, device="cpu")


def test_empty_caches_have_the_prefill_caches_layout():
    cfg, tp = _cfg(), _port_params()
    model = build_model(cfg)
    _, dense = model.prefill(tp, {"tokens": torch.zeros((2, 3), dtype=torch.int64)},
                             cache_len=8)
    empty = model.empty_caches(2, 8, device="cpu")
    for name in ("k", "v"):
        got, want = empty["stack"]["sub0"][name], dense["stack"]["sub0"][name]
        assert got.shape == want.shape and got.dtype == want.dtype and not got.any()
    jshape = jax_build_model(jax_get_config("llama3-8b", smoke=True)).empty_caches(2, 8)
    assert tuple(empty["stack"]["sub0"]["k"].shape) == jshape["stack"]["sub0"]["k"].shape


@functools.lru_cache(maxsize=None)
def _batch_gap(b: int) -> float:
    """The largest logit difference between rows decoded one step alone and inside
    a batch of ``b``, on random prompts of the SMOKE model."""
    cfg, tp = _cfg(), _port_params()
    model = build_model(cfg)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 7)))
    _, caches = model.prefill(tp, {"tokens": toks}, cache_len=16)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
    solo = [model.decode_step(tp, nxt[r:r + 1], {"stack": {"sub0": {
        k: v[:, r:r + 1].clone() for k, v in caches["stack"]["sub0"].items()}}}, 7)[0]
        for r in range(b)]
    batched, _ = model.decode_step(tp, nxt, caches, 7)
    return float((batched - torch.cat(solo)).abs().max())


def test_a_decode_step_at_batch_1_and_batch_b_differs_only_in_rounding():
    """The CPU's GEMMs sum a row of one in another order than a row of several
    (seen here: ~2.6e-6 on logits of O(1) at every b > 1), so a continuous stream
    is held to its solo stream by the divergence rule
    (``analysis/streams.py``), not bit for bit."""
    assert _batch_gap(1) == 0.0
    for b in (GEOM["max_batch"], 8):
        assert _batch_gap(b) <= ATOL


def test_step_margin_reads_the_decision_distance():
    logits = torch.tensor([0.0, 3.0, 2.5, -1.0])
    assert step_margin(logits, 0.5, sampler="greedy") == pytest.approx(0.25)
    probs = torch.softmax(logits.double(), -1)
    # the nucleus is tokens 1 and 2; theta exactly on the first CDF step: no margin
    u = float(probs[1] / (probs[1] + probs[2]))
    assert step_margin(logits, u, sampler="topp_xla", top_p=0.9) < 1e-7
    assert step_margin(logits, 0.3, sampler="topp_scan", top_p=0.9) > 0.01
    assert first_divergence([1, 2, 3], [1, 2, 3]) is None
    assert first_divergence([1, 2, 3], [1, 5, 3]) == 1
    assert first_divergence([1, 2], [1, 2, 3]) == 2


# ---------------------------------------------------------------------------
# the engine against JAX's, and against the port's solo ServeEngine
# ---------------------------------------------------------------------------


def test_poisson_trace_equals_jax():
    jt, tt = _trace_pair(n=12, seed=5, rate=0.3, prompt_len=(2, 30), max_new=(1, 9))
    for j, t in zip(jt, tt):
        assert (t.rid, t.arrival_step, t.max_new_tokens, t.eos_id) == \
            (j.rid, j.arrival_step, j.max_new_tokens, j.eos_id)
        np.testing.assert_array_equal(t.tokens, j.tokens)
        np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(t.seed)), j.key)


@pytest.mark.parametrize("sampler", ["greedy", "topp_scan", "topp_xla"])
def test_continuous_engine_equals_jax(sampler):
    _, tt = _trace_pair()
    got = _engine(sampler).run(tt)
    want = _jax_run(sampler)
    _assert_same_result(got, want)
    if sampler != "greedy":
        assert len(np.unique(np.concatenate(list(got["streams"].values())))) > 4


def _solo_stream(req, n_blocks, sampler, eos_id=None, logits=None):
    """The port's solo ServeEngine stream of ``req`` at equal attention length,
    appending each step's logits row to ``logits`` when it is a list."""
    solo = ServeEngine(_cfg(), _port_params(), max_len=n_blocks * PS, sampler=sampler,
                       top_p=0.9, device="cpu")
    if logits is not None:
        orig = solo._sample
        solo._sample = lambda lg, gen, u: (logits.append(lg[0].clone()), orig(lg, gen, u))[1]
    return solo.generate({"tokens": torch.from_numpy(req.tokens)[None]},
                         req.max_new_tokens, uniforms=_stream_uniforms(req)[:, None],
                         eos_id=eos_id)[0].numpy()


def _stream_uniforms(req):
    if req.uniforms is not None:
        return torch.from_numpy(req.uniforms)
    return torch.rand((req.max_new_tokens,), generator=torch.Generator().manual_seed(req.seed))


def _hold_to_solo(res, reqs, eng, sampler):
    """Each stream equals its solo stream, or parts from it first at a step whose
    margin lies within the measured batch-1 against batch-b logit difference."""
    gap = _batch_gap(eng.max_batch)
    equal = 0
    for r in reqs:
        logits = []
        ref = _solo_stream(r, eng.n_blocks, sampler, eos_id=r.eos_id, logits=logits)
        got = res["streams"][r.rid]
        k = first_divergence(got, ref)
        if k is None:
            equal += 1
            continue
        assert k < min(len(got), len(ref)), (r.rid, got, ref)
        margin = step_margin(logits[k], float(_stream_uniforms(r)[k]), sampler=sampler,
                             top_p=eng.top_p, other=int(got[k]))
        assert margin <= gap, (r.rid, k, margin, gap)
    return equal


@pytest.mark.parametrize("sampler", ["greedy", "topp_scan", "topp_sharded", "topp_xla"])
def test_continuous_matches_solo_streams_across_samplers(sampler):
    eng = _engine(sampler)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=f"r{i}", tokens=rng.integers(0, 256, s).astype(np.int32),
                    max_new_tokens=n, seed=60 + i, arrival_step=i)
            for i, (s, n) in enumerate([(4, 6), (7, 4), (4, 5)])]
    res = eng.run(reqs)
    _hold_to_solo(res, reqs, eng, sampler)


def test_continuous_eos_stream_matches_solo_and_jax():
    eng = _engine()
    toks = np.random.default_rng(2).integers(0, 256, 5).astype(np.int32)
    full = _solo_stream(Request("e0", toks, 8, seed=7), eng.n_blocks, "greedy")
    eos = int(full[2])
    ref = _solo_stream(Request("e0", toks, 8, seed=7), eng.n_blocks, "greedy", eos_id=eos)
    j, t = _pair("e0", toks, 8, 7, eos_id=eos)
    res = eng.run([t])
    assert _hold_to_solo(res, [t], eng, "greedy") == 1       # alone in the batch
    np.testing.assert_array_equal(res["streams"]["e0"], ref)
    assert res["streams"]["e0"][-1] == eos and len(ref) < 8
    _assert_same_result(res, _jax_engine().run([j]))


def test_fcfs_admission_blocks_under_page_pressure():
    """A later small request must not bypass a blocked earlier big one."""
    geom = dict(page_size=4, n_pages=5, max_len=12, tick_tokens=2)
    # capacity 4 pages of 4: A and B need 3 pages each, C needs 1
    pairs = [_pair("A", [1, 2, 3, 4], 8, 0, arrival=0),
             _pair("B", [1, 2, 3, 4], 8, 1, arrival=1),
             _pair("C", [1, 2], 2, 2, arrival=1)]
    res = _engine(**geom).run([t for _, t in pairs])
    info = res["requests"]
    assert info["A"]["admit_step"] == 0
    assert info["B"]["admit_step"] >= info["A"]["finish_step"]
    assert info["C"]["admit_step"] >= info["B"]["admit_step"]
    assert res["stats"]["peak_pages"] <= 4
    _assert_same_result(res, _jax_engine(**geom).run([j for j, _ in pairs]))


def test_eviction_reclaims_pages_for_later_requests():
    """More pages in all than the pool holds: only works with eviction and reuse."""
    geom = dict(page_size=4, n_pages=4, max_len=12, max_batch=1, tick_tokens=4)
    rng = np.random.default_rng(0)
    pairs = [_pair(f"r{i}", rng.integers(0, 256, 5), 6, i) for i in range(4)]
    eng = _engine(**geom)
    res = eng.run([t for _, t in pairs])
    assert len(res["streams"]) == 4
    assert res["stats"]["peak_pages"] <= eng.alloc.capacity == 3
    assert all(len(s) == 6 for s in res["streams"].values())
    assert not eng.caches["stack"]["sub0"]["pages"].any()    # every table cleared
    _assert_same_result(res, _jax_engine(**geom).run([j for j, _ in pairs]))
    assert _hold_to_solo(res, [t for _, t in pairs], eng, "greedy") == 4   # batch of 1


def test_zero_length_over_budget_and_bad_uniforms_rejected_eagerly():
    eng = _engine()
    with pytest.raises(ValueError, match="zero-length"):
        eng.run([Request("z", np.zeros(0, np.int32), 2)])
    with pytest.raises(ValueError, match="max_len"):
        eng.run([Request("b", np.ones(30, np.int32), 10)])
    with pytest.raises(ValueError, match="max_new_tokens >= 1"):
        eng.run([Request("n", np.asarray([1, 2], np.int32), 0)])
    with pytest.raises(ValueError, match="uniforms"):
        eng.run([Request("u", np.asarray([1, 2], np.int32), 3,
                         uniforms=np.zeros(2, np.float32))])
    with pytest.raises(ValueError, match="sampler"):
        _engine("topp_kernel")


def test_arrival_trace_replays_deterministically():
    eng = _engine("topp_scan")
    reqs = poisson_trace(5, rate=0.4, vocab_size=256, seed=11, prompt_len=(3, 8),
                         max_new=(2, 5))
    r1, r2 = eng.run(reqs), eng.run(reqs)
    _assert_same_result(r2, r1)
    # the trace's seeds give the stream; the schedule is JAX's whatever the uniforms
    assert r1["requests"] == _jax_run("topp_scan")["requests"]


PRESSURE = dict(rate=0.5, seed=11, prompt_len=(2, 12), max_new=(1, 10))


@pytest.mark.parametrize("sampler", ["greedy", "topp_scan"])
def test_paged_decode_of_a_run_equals_its_dense_replay(sampler):
    """Every decode step of a run under page pressure, repeated on a dense cache
    fed only from the prefills: each row that holds a request gets the same bits."""
    eng = _engine(sampler)
    reqs = poisson_trace(9, vocab_size=256, **PRESSURE)
    with DenseReplay(eng) as rep:
        res = eng.run(reqs)
    out = rep.result()
    assert out["bit_equal"] and out["max_abs_diff"] == 0.0, out
    assert out["steps"] % eng.tick_tokens == 0 and out["steps"] >= res["stats"]["steps"]
    assert out["row_steps"] >= res["stats"]["total_tokens"] - res["stats"]["reqs"]
    assert eng.model.decode_step.__func__ is type(eng.model).decode_step   # restored


def test_dense_replay_sees_a_stale_page_table(monkeypatch):
    """Eviction that leaves a row's table in place: the idle row goes on writing
    into pages handed to another request, and the replay sees the damage."""
    monkeypatch.setattr(paged_kv, "clear_page_table", lambda caches, row: caches)
    eng = _engine()
    with DenseReplay(eng) as rep:
        eng.run(poisson_trace(9, vocab_size=256, **PRESSURE))
    out = rep.result()
    assert not out["bit_equal"] and out["max_abs_diff"] > 0.1, out


def test_continuous_topp_sharded_on_two_ranks_equals_the_local_engine(tmp_path):
    _, tt = _trace_pair()
    trace = [dataclasses.asdict(r) for r in tt]
    out = run_world("torch_dist_worlds:run_continuous", 2,
                    dict(params=_np_params(), trace=trace, geom=GEOM),
                    workdir=tmp_path, timeout=240, pythonpath=[HERE])
    local = _engine("topp_sharded").run(tt)
    for rank in out:
        assert rank["requests"] == local["requests"] and rank["stats"] == local["stats"]
        for rid, s in local["streams"].items():
            np.testing.assert_array_equal(rank["streams"][rid], s, err_msg=rid)
        assert rank["collectives"] > 0

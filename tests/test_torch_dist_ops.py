"""The port's distributed operators in gloo worlds of 2, 4 and 8 ranks, against JAX.

One world per size runs every case (``torch_dist_worlds.run_world_cases``:
one process a rank, a ``file://`` rendezvous in a temporary directory, a
deadline on the whole world), once per module; the parametrised tests then
hold each case's gathered result against the JAX package on the same numpy
inputs:

* sorts and top-k bit-equal (values and permutation) to JAX's local
  ``radix_sort``/``topk`` on every method: descending, bf16, int8 at a ragged
  length, and duplicate uint8 keys down to one key or none a shard (D = 8);
* integer recurrences and segmented scans bit-equal to JAX's local
  ``linear_scan``/``segment_scan`` (the four offset layouts of the JAX
  package's own dist test); fp32 recurrences within ``rtol = atol = 2e-5``, as
  the JAX package holds its own;
* ``dist_top_p_sample`` tokens equal to JAX's ``dist_top_p_sample`` at the
  same D and uniforms (its contract is documented-ulp, not bitwise, so the
  JAX side is the distributed sampler itself, run in one subprocess with
  eight host devices);
* each call's collective counts and bytes equal to the port's closed forms
  (``repro_torch.analysis.collectives.modeled_dist_traffic``);
* ``ServeEngine(sampler="topp_sharded")`` on the SMOKE llama3-8b in the world
  of 2: the same stream on both ranks, equal to the port's solo ``topp_scan``
  stream and to JAX's ``topp_sharded`` engine on a mesh of 2.

``dist_top_p_sample``'s non-finite policies are in
``test_torch_dist_ops_policies.py``: JAX's eager reference for them takes most
of the time, and a file of their own lets ``--dist loadfile`` run the two
halves on two workers.

The kernel methods run their kernels' plain versions here (CPU tensors).
"""
from __future__ import annotations

import functools
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.core.linrec import linear_scan as jax_linear_scan
from repro.core.primitives import radix_sort as jax_radix_sort
from repro.core.primitives import topk as jax_topk
from repro.core.segmented import segment_scan as jax_segment_scan
from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro_torch.analysis.collectives import modeled_dist_traffic
from repro_torch.core import comm, dist_ops
from repro_torch.core.primitives import radix_sort, top_p_sample
from repro_torch.launch.world import run_world

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLDS = (2, 4, 8)
METHODS = ("matmul", "vector", "kernel", "blocked")
WORLD_TIMEOUT = 240
TOL = dict(rtol=2e-5, atol=2e-5)


def _ints(seed, shape, lo, hi):
    return np.random.default_rng(seed).integers(lo, hi, size=shape)


def _uniform(seed, shape, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ---- the cases (global numpy inputs, built at import: same on every rank) ----

_SORTS = {
    "u8_dup": dict(x=_ints(1, (2, 14), 0, 4), dtype="uint8", kw=dict(bits_per_pass=8)),
    "u8_ragged": dict(x=_ints(2, (19,), 0, 200), dtype="uint8", kw=dict(bits_per_pass=8)),
    # one key or none a shard at D = 8: stability of the shard-major exchange
    "u8_sparse_dups": dict(x=_ints(3, (6,), 0, 2), dtype="uint8", kw=dict(bits_per_pass=8)),
    "bf16_desc": dict(x=_normal(4, (2, 16)), dtype="bfloat16",
                      kw=dict(descending=True, bits_per_pass=8)),
    "f32": dict(x=_normal(5, (2, 100), 5.0), dtype="float32", kw=dict(bits_per_pass=4)),
    "f32_desc_dups": dict(x=np.round(_normal(6, (3, 37), 2.0)), dtype="float32",
                          kw=dict(descending=True, bits_per_pass=4)),
    "i32_ragged_digit": dict(x=_ints(7, (2, 41), -1000, 1000), dtype="int32",
                             kw=dict(bits_per_pass=3)),
    "i16": dict(x=_ints(8, (2, 25), -300, 300), dtype="int16", kw=dict(bits_per_pass=5)),
}
_TOPKS = {
    "i8_k13": dict(x=_ints(9, (13,), -4, 4), dtype="int8", k=13, kw=dict(bits_per_pass=8)),
    "i8_k5": dict(x=_ints(10, (2, 13), -4, 4), dtype="int8", k=5, kw=dict(bits_per_pass=4)),
    "f32_k3": dict(x=_normal(11, (2, 30)), dtype="float32", k=3, kw=dict(bits_per_pass=4)),
}
_LINRECS = {
    "f32_excl": dict(a=_uniform(12, (2, 13), 0.8, 1.2),
                     b=_normal(13, (2, 13)), dtype="float32", exact=False,
                     kw=dict(exclusive=True)),
    "int_ones": dict(a=np.ones((2, 16), np.int32), b=_ints(14, (2, 16), 0, 5).astype(np.int32),
                     dtype="int32", exact=True, kw={}),
    "f32_initial": dict(a=_uniform(15, (13,), 0.8, 1.2),
                        b=_normal(16, (13,)), dtype="float32", exact=False,
                        kw=dict(initial=3.0)),
    "int_signs_excl": dict(a=_ints(17, (2, 29), -1, 2).astype(np.int32),
                           b=_ints(18, (2, 29), -3, 4).astype(np.int32), dtype="int32",
                           exact=True, kw=dict(exclusive=True, initial=2.0)),
    "f32_long": dict(a=_uniform(19, (2, 300), 0.9, 1.0),
                     b=_normal(20, (2, 300)), dtype="float32", exact=False, kw={}),
}
_LAYOUTS = {"mid": [0, 5, 11, 16], "one": [0, 16], "empties": [0, 0, 7, 7, 7, 16, 16],
            "aligned": [0, 4, 8, 12, 16]}
_SEGSCANS = {f"i8_{name}{'_excl' if ex else ''}": dict(
    x=_ints(21, (2, 16), -5, 5), dtype="int8", offsets=offs, kw=dict(exclusive=ex))
    for name, offs in _LAYOUTS.items() for ex in (False, True)}
_SEGSCANS["f32_int_ragged"] = dict(x=_ints(22, (15,), -4, 5).astype(np.float32),
                                   dtype="float32", offsets=[0, 6, 15],
                                   kw=dict(exclusive=True, block_tiles=2))
_SEGSCANS["i32_wide"] = dict(x=_ints(23, (3, 53), -50, 50), dtype="int32",
                             offsets=[0, 3, 3, 20, 21, 40, 53], kw={})
_TOPP_LOGITS = _normal(24, (4, 33), 3.0)
_TOPP_U = np.random.default_rng(25).random((4, 1)).astype(np.float32)
_TOPPS = {
    "matmul": dict(p=0.8, method="matmul"),
    "kernel": dict(p=0.8, method="kernel"),
    "temperature": dict(p=0.9, temperature=0.7, method="matmul"),
    "greedy": dict(temperature=0.0),
}



def _cases():
    cases = []
    for name, c in _SORTS.items():
        for m in METHODS:
            cases.append(dict(id=f"sort-{name}-{m}", op="sort", x=c["x"], dtype=c["dtype"],
                              kw=dict(c["kw"], method=m, tile_s=8)))
    for name, c in _TOPKS.items():
        for m in METHODS:
            cases.append(dict(id=f"topk-{name}-{m}", op="topk", x=c["x"], dtype=c["dtype"],
                              k=c["k"], kw=dict(c["kw"], method=m, tile_s=8)))
    for name, c in _LINRECS.items():
        for m in METHODS:
            cases.append(dict(id=f"linrec-{name}-{m}", op="linrec", a=c["a"], b=c["b"],
                              dtype=c["dtype"], kw=dict(c["kw"], method=m, tile_s=8)))
    for name, c in _SEGSCANS.items():
        for m in METHODS:
            tile = 4 if name == "f32_int_ragged" else 8
            cases.append(dict(id=f"segscan-{name}-{m}", op="segscan", x=c["x"],
                              dtype=c["dtype"], offsets=c["offsets"],
                              kw=dict(c["kw"], method=m, tile_s=tile)))
    for name, kw in _TOPPS.items():
        cases.append(dict(id=f"topp-{name}", op="topp", logits=_TOPP_LOGITS, u=_TOPP_U,
                          kw=dict(kw, tile_s=8)))
    return cases


CASES = _cases()
CASE_IDS = [c["id"] for c in CASES]
BY_ID = {c["id"]: c for c in CASES}

# ---- the engine (world of 2) ----

ENGINE_B, ENGINE_S, ENGINE_NEW, ENGINE_P = 2, 12, 6, 0.9


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = jax_get_config("llama3-8b", smoke=True)
    return jax.tree.map(np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(0)))


def _engine_prompts():
    return _ints(26, (ENGINE_B, ENGINE_S), 0, 256).astype(np.int32)


def _jax_uniforms(key, steps: int, b: int) -> np.ndarray:
    """The JAX engine's per-step sampler uniforms, as a (steps, b) array."""
    us = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(k, (b, 1), dtype=jnp.float32)))
    return np.concatenate(us, axis=1).T.copy()


ENGINE_KEY = 5

# ---- JAX's distributed sampler and engine, in one subprocess of 8 host devices ----

_JAX_SCRIPT = """
import numpy as np, jax, jax.numpy as jnp
from repro.core import dist_top_p_sample
from repro.models.model import get_config
from repro.serving.engine import ServeEngine
from repro.utils.compat import make_mesh
inp = np.load({inputs!r}, allow_pickle=True)
logits, u = jnp.asarray(inp["logits"]), jnp.asarray(inp["u"])
out = {{}}
cases = inp["topps"].item()
for d in {worlds!r}:
    mesh = make_mesh((d,), ("model",))
    for name, kw in cases.items():
        f = jax.jit(lambda lg, uu: dist_top_p_sample(lg, None, mesh, "model", u=uu,
                                                     tile_s=8, **kw))
        out[f"topp-{{name}}-{{d}}"] = np.asarray(f(logits, u))
params = jax.tree.map(jnp.asarray, inp["params"].item())
eng = ServeEngine(get_config("llama3-8b", smoke=True), params,
                  mesh=make_mesh((2,), ("model",)), max_len={max_len}, top_p={top_p},
                  sampler="topp_sharded")
out["engine"] = np.asarray(eng.generate({{"tokens": jnp.asarray(inp["prompts"])}}, {new},
                                        jax.random.PRNGKey({key})))
np.savez({outputs!r}, **out)
"""


def _start_jax(tmp):
    inputs, outputs = str(tmp / "jax_in.npz"), str(tmp / "jax_out.npz")
    np.savez(inputs, logits=_TOPP_LOGITS, u=_TOPP_U, topps=np.array(_TOPPS, dtype=object),
             params=np.array(_jax_params(), dtype=object), prompts=_engine_prompts())
    code = _JAX_SCRIPT.format(inputs=inputs, outputs=outputs, worlds=WORLDS,
                              max_len=ENGINE_S + ENGINE_NEW, top_p=ENGINE_P, new=ENGINE_NEW,
                              key=ENGINE_KEY)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, outputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results, and JAX's distributed sampler and engine."""
    tmp = tmp_path_factory.mktemp("dist_ops")
    proc, jax_out = _start_jax(tmp)
    try:
        engine = dict(params=_jax_params(), prompts=_engine_prompts(),
                      uniforms=_jax_uniforms(jax.random.PRNGKey(ENGINE_KEY), ENGINE_NEW,
                                             ENGINE_B),
                      new=ENGINE_NEW, top_p=ENGINE_P)
        worlds = {}
        for d in WORLDS:
            worlds[d] = run_world("torch_dist_worlds:run_world_cases", d,
                                  dict(cases=CASES, engine=engine if d == 2 else None),
                                  workdir=tmp / f"world{d}", timeout=WORLD_TIMEOUT,
                                  pythonpath=[os.path.dirname(__file__)])
        log, _ = proc.communicate(timeout=WORLD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
    return {"worlds": worlds, "jax": dict(np.load(jax_out)), "engine": engine}


def _case(runs, d, cid, rank=0):
    return runs["worlds"][d][rank]["cases"][cid]


# ---- the JAX package's local siblings on the same inputs ----


@functools.lru_cache(maxsize=None)
def _jax_reference(cid):
    c = BY_ID[cid]
    kw = {k: v for k, v in c["kw"].items() if k not in ("method", "block_tiles")}
    if c["op"] in ("sort", "topk"):
        jdt = jnp.bfloat16 if c["dtype"] == "bfloat16" else c["dtype"]
        x = jnp.asarray(c["x"].astype(np.float32) if c["dtype"] == "bfloat16" else c["x"], jdt)
        if c["op"] == "sort":
            v, i = jax_radix_sort(x, method="vector", **kw)
        else:
            v, i = jax_topk(x, c["k"], method="vector", **kw)
        return [np.asarray(v.astype(jnp.float32) if c["dtype"] == "bfloat16" else v),
                np.asarray(i)]
    if c["op"] == "linrec":
        return [np.asarray(jax_linear_scan(jnp.asarray(c["a"]), jnp.asarray(c["b"]),
                                           method="vector", **kw))]
    if c["op"] == "segscan":
        return [np.asarray(jax_segment_scan(jnp.asarray(c["x"], c["dtype"]),
                                            jnp.asarray(c["offsets"], jnp.int32),
                                            method="vector", **kw))]
    raise ValueError(cid)


_PARITY = [(d, cid) for d in WORLDS for cid in CASE_IDS if not cid.startswith("topp")]


@pytest.mark.parametrize("d,cid", _PARITY, ids=[f"D{d}-{c}" for d, c in _PARITY])
def test_matches_the_jax_local_sibling(runs, d, cid):
    got = _case(runs, d, cid)["out"]
    want = _jax_reference(cid)
    op = BY_ID[cid]["op"]
    exact = op != "linrec" or _LINRECS[cid.split("-")[1]]["exact"]
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if exact:
            assert g.dtype == w.dtype and np.array_equal(g, w), (g, w)
        else:
            np.testing.assert_allclose(g, w, **TOL)


_TOPP_IDS = [(d, name) for d in WORLDS for name in _TOPPS]


@pytest.mark.parametrize("d,name", _TOPP_IDS, ids=[f"D{d}-{n}" for d, n in _TOPP_IDS])
def test_top_p_tokens_match_jax_dist_top_p_sample(runs, d, name):
    got = _case(runs, d, f"topp-{name}")["out"][0]
    want = runs["jax"][f"topp-{name}-{d}"]
    assert got.dtype == np.int32 and np.array_equal(got, want), (got, want)
    if name == "greedy":
        assert np.array_equal(got, np.argmax(_TOPP_LOGITS, -1))


@pytest.mark.parametrize("d", WORLDS)
def test_every_rank_returns_the_same_global_result(runs, d):
    ranks = runs["worlds"][d]
    for cid in CASE_IDS:
        for r in range(1, d):
            for a, b in zip(ranks[0]["cases"][cid]["out"], ranks[r]["cases"][cid]["out"]):
                assert np.array_equal(a, b), (cid, r)


def _model(c, d):
    if c["op"] in ("sort", "topk"):
        x = c["x"]
        return modeled_dist_traffic("dist_sort", d=d, n=x.shape[-1],
                                    batch=math.prod(x.shape[:-1]), dtype=c["dtype"],
                                    bits_per_pass=c["kw"]["bits_per_pass"])
    if c["op"] == "topp":
        x = c["logits"]
        return modeled_dist_traffic("dist_top_p_sample", d=d, n=x.shape[-1],
                                    batch=x.shape[0], greedy=c["kw"].get("temperature") == 0.0,
                                    nonfinite=c["kw"].get("nonfinite", "propagate"))
    x = c["a"] if c["op"] == "linrec" else c["x"]
    op = "dist_linear_scan" if c["op"] == "linrec" else "dist_segment_scan"
    return modeled_dist_traffic(op, d=d, n=x.shape[-1], batch=math.prod(x.shape[:-1]),
                                itemsize=4)


_COUNT_IDS = [(d, cid) for d in WORLDS for cid in CASE_IDS
              if cid.endswith("-kernel") or cid.startswith("topp")]


@pytest.mark.parametrize("d,cid", _COUNT_IDS, ids=[f"D{d}-{c}" for d, c in _COUNT_IDS])
def test_collective_counts_and_bytes_match_the_model(runs, d, cid):
    model = _model(BY_ID[cid], d)
    for rank in range(d):
        counts = _case(runs, d, cid, rank)["counts"]
        assert {k: v for k, v in counts["calls"].items() if v} == model["counts_by_kind"]
        assert {k: v for k, v in counts["bytes"].items() if v} == model["bytes_by_kind"]
        assert sum(counts["bytes"].values()) == model["operand_bytes"]


def test_the_exchange_sends_each_element_once():
    """A radix pass moves 4·B·C·L bytes a rank; JAX's dense buffer moves D times that."""
    d, n, b = 4, 100, 2
    m = modeled_dist_traffic("dist_sort", d=d, n=n, batch=b, dtype="float32", bits_per_pass=4)
    assert m["counts_by_kind"] == {"all_gather": 8, "all_to_all": 8}
    assert m["bytes_by_kind"]["all_to_all"] == 8 * 4 * b * 2 * 25
    assert m["jax_operand_bytes"] - m["operand_bytes"] == (d - 1) * 8 * 4 * b * 2 * 25


# ---- the engine ----


def test_sharded_engine_stream_is_the_same_on_both_ranks(runs):
    e0, e1 = runs["worlds"][2][0]["engine"], runs["worlds"][2][1]["engine"]
    assert e0["sharded"].shape == (ENGINE_B, ENGINE_NEW)
    assert np.array_equal(e0["sharded"], e1["sharded"])


def test_sharded_engine_stream_equals_the_solo_topp_scan_stream(runs):
    e = runs["worlds"][2][0]["engine"]
    assert np.array_equal(e["sharded"], e["solo"])


def test_sharded_engine_stream_equals_the_jax_engine(runs):
    assert np.array_equal(runs["worlds"][2][0]["engine"]["sharded"], runs["jax"]["engine"])


def test_sharded_engine_collectives_per_sampled_token(runs):
    e = runs["worlds"][2][0]["engine"]
    step = modeled_dist_traffic("dist_top_p_sample", d=2, n=jax_get_config(
        "llama3-8b", smoke=True).vocab_size, batch=ENGINE_B)
    assert e["counts"]["calls"] == {k: ENGINE_NEW * step["counts_by_kind"].get(k, 0)
                                    for k in comm.KINDS}


# ---- one rank: no process group, no collective ----


def test_one_rank_needs_no_process_group_and_is_the_local_op():
    assert not torch.distributed.is_initialized()
    comm.reset_comm_counts()
    x = torch.from_numpy(_SORTS["f32"]["x"])
    v, i = dist_ops.dist_sort(x, x.shape[-1], method="matmul", tile_s=8)
    v0, i0 = radix_sort(x, method="matmul", tile_s=8)
    assert torch.equal(v, v0) and torch.equal(i, i0)
    lg, u = torch.from_numpy(_TOPP_LOGITS), torch.from_numpy(_TOPP_U)
    t = dist_ops.dist_top_p_sample(lg, 33, p=0.8, method="matmul", tile_s=8, u=u)
    assert torch.equal(t, top_p_sample(lg, p=0.8, method="matmul", tile_s=8, u=u))
    assert comm.comm_counts()["calls"] == {k: 0 for k in comm.KINDS}
    assert modeled_dist_traffic("dist_sort", d=1, n=100)["collective_count"] == 0


@pytest.mark.parametrize("fn", [
    lambda: dist_ops.dist_sort(torch.zeros(3), 4),
    lambda: dist_ops.dist_linear_scan(torch.ones(5), torch.ones(5), 4),
    lambda: dist_ops.dist_segment_scan(torch.ones(4), torch.tensor([0, 4]), 5),
    lambda: dist_ops.dist_top_p_sample(torch.zeros((1, 4)), 0),
], ids=["sort", "linrec", "segscan", "topp"])
def test_a_shard_of_the_wrong_length_is_refused(fn):
    with pytest.raises(ValueError):
        fn()


def test_shard_layout_round_trips_at_one_rank():
    x = torch.arange(13)
    assert torch.equal(comm.shard_last(x, 1, 0), x)
    assert torch.equal(comm.gather_last(x, 13), x)
    assert [comm.shard_last(x, 8, r).numel() for r in range(8)] == [2, 2, 2, 2, 2, 2, 1, 0]

"""The port's MCScan (``repro_torch.core.distributed``) in gloo worlds, against JAX.

As ``test_torch_dist_ops.py``: one world per size (2, 4 and 8 ranks, one
process each) runs every case once per module, and the parametrised tests
hold each case's gathered result against the JAX package's local ``scan`` on
the same numpy inputs — integer and integer-valued inputs bit-equal on every
method, random fp32 within ``rtol = 1e-5, atol = 1e-4`` (the block offsets
are sums in another order).  The world of 8 also runs ``mcscan`` on a
``(4, 2)`` grid of ranks, the counterpart of JAX's 2-D mesh with
``batch_axis_name``.  Each call's collectives are held to the closed form
(one ``all_gather`` of the block sums), and :func:`run_world`'s deadline and
failure reports are tested with worlds that fail or hang on purpose.
"""
from __future__ import annotations

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scan import scan as jax_scan
from repro_torch.analysis.collectives import modeled_dist_traffic
from repro_torch.core import comm
from repro_torch.core.distributed import mcscan
from repro_torch.core.scan import scan
from repro_torch.launch.world import run_world

WORLDS = (2, 4, 8)
METHODS = ("matmul", "vector", "kernel", "blocked")
HERE = os.path.dirname(__file__)
F32_TOL = dict(rtol=1e-5, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


_INPUTS = {
    "i8_mask": dict(x=(_rng(1).random((1, 4096)) < 0.5).astype(np.int8), dtype="int8",
                    exact=True, kw={}),
    "i8_ragged_excl": dict(x=_rng(2).integers(-3, 4, (2, 1001)).astype(np.int8),
                           dtype="int8", exact=True, kw=dict(exclusive=True)),
    "i8_acc_f32": dict(x=_rng(3).integers(-3, 4, (2, 300)).astype(np.int8), dtype="int8",
                       exact=True, kw=dict(accum_dtype="float32")),
    "i32": dict(x=_rng(4).integers(-100, 100, (3, 777)).astype(np.int32), dtype="int32",
                exact=True, kw={}),
    "f32": dict(x=_rng(5).normal(size=(2, 4096)).astype(np.float32), dtype="float32",
                exact=False, kw={}),
    "f32_scanu": dict(x=_rng(6).normal(size=(2, 1000)).astype(np.float32), dtype="float32",
                      exact=False, kw=dict(variant="scanu")),
}
CASES = [dict(id=f"{name}-{m}", op="mcscan", x=c["x"], dtype=c["dtype"],
              kw=dict(c["kw"], method=m, tile_s=8, block_tiles=2))
         for name, c in _INPUTS.items() for m in METHODS]
CASE_IDS = [c["id"] for c in CASES]
BY_ID = {c["id"]: c for c in CASES}
GRID = dict(x=_rng(7).normal(size=(2, 4096)).astype(np.float32), shape=(4, 2),
            method="blocked", tile_s=8, block_tiles=2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mcscan")
    return {d: run_world("torch_dist_worlds:run_world_cases", d,
                         dict(cases=CASES, grid=GRID if d == 8 else None),
                         workdir=tmp / f"world{d}", timeout=240, pythonpath=[HERE])
            for d in WORLDS}


def _jax_scan(c):
    kw = dict(c["kw"], method="vector")
    if "accum_dtype" in kw:
        kw["accum_dtype"] = jnp.dtype(kw["accum_dtype"])
    return np.asarray(jax_scan(jnp.asarray(c["x"]), axis=-1, **kw))


_PAIRS = [(d, cid) for d in WORLDS for cid in CASE_IDS]


@pytest.mark.parametrize("d,cid", _PAIRS, ids=[f"D{d}-{c}" for d, c in _PAIRS])
def test_mcscan_matches_the_jax_local_scan(worlds, d, cid):
    c = BY_ID[cid]
    got = worlds[d][0]["cases"][cid]["out"][0]
    want = _jax_scan(c)
    assert got.shape == want.shape and got.dtype == want.dtype
    if _INPUTS[cid.split("-")[0]]["exact"]:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
def test_mcscan_moves_one_all_gather_of_block_sums(worlds, d):
    for cid in CASE_IDS:
        c = BY_ID[cid]
        acc = 4                                     # every case accumulates in 4 bytes
        model = modeled_dist_traffic("mcscan", d=d, n=c["x"].shape[-1],
                                     batch=math.prod(c["x"].shape[:-1]), itemsize=acc)
        for rank in range(d):
            counts = worlds[d][rank]["cases"][cid]["counts"]
            assert {k: v for k, v in counts["calls"].items() if v} == model["counts_by_kind"]
            assert {k: v for k, v in counts["bytes"].items() if v} == model["bytes_by_kind"]


def test_mcscan_on_a_2d_grid_of_ranks(worlds):
    """The batch rows on one grid axis, the scanned axis on the other."""
    x = GRID["x"]
    for rank in range(8):
        got = worlds[8][rank]["grid"]["out"][0]
        np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64), -1), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(got, np.asarray(jax_scan(jnp.asarray(x), method="vector")),
                                   **F32_TOL)
        # each rank gathered only over its data group of 4
        model = modeled_dist_traffic("mcscan", d=4, n=x.shape[-1], batch=1)
        assert worlds[8][rank]["grid"]["counts"]["bytes"]["all_gather"] == \
            model["operand_bytes"]


def test_mcscan_of_one_rank_is_the_local_scan():
    assert not torch.distributed.is_initialized()
    comm.reset_comm_counts()
    x = torch.from_numpy(_INPUTS["i32"]["x"])
    for m in METHODS:
        assert torch.equal(mcscan(x, method=m, tile_s=8),
                           scan(x, method=m, tile_s=8))
    assert comm.comm_counts()["calls"] == {k: 0 for k in comm.KINDS}
    assert modeled_dist_traffic("mcscan", d=1, n=777, batch=3)["collective_count"] == 0


def test_a_failing_rank_fails_the_world(tmp_path):
    # the waiting rank may notice its lost peer first: any rank may be named,
    # and every rank's log is in the message
    with pytest.raises(RuntimeError, match="exited with") as err:
        run_world("torch_dist_worlds:fail_on_rank", 2, dict(rank=1), workdir=tmp_path,
                  timeout=120, pythonpath=[HERE])
    assert "rank 1 fails on purpose" in str(err.value)


def test_a_hung_rank_fails_the_world_at_its_deadline(tmp_path):
    with pytest.raises(RuntimeError, match="did not finish within"):
        run_world("torch_dist_worlds:hang_on_rank", 2, dict(rank=0), workdir=tmp_path,
                  timeout=15, pythonpath=[HERE])

"""``dist_top_p_sample``'s non-finite policies in a gloo world of 2, against JAX.

The other half of ``test_torch_dist_ops.py``, in a file of its own so that
``--dist loadfile`` can run the two on two workers.  The world of 2
(``torch_dist_worlds.run_world_cases``) runs every policy case; JAX's
``dist_top_p_sample`` on a mesh of 2 host devices runs them in two
subprocesses at once, half the policies each.  JAX's raise gate reads
concrete logits, so each ``raise`` case first runs that gate
(``primitives._reject_poisoned_logits``, the one ``dist_top_p_sample`` calls)
on them; then every case that passes runs jitted, the gate staged as a
``debug_check`` that a plain ``jit`` drops, as the sampler's own jitted calls
do.  (Eagerly, JAX's sampler took 2–3 minutes a case here.)  The
tests hold each case's tokens (or its ``NonFiniteError``) and collectives
against JAX and the port's closed forms, on the same numpy inputs as
``test_torch_dist_ops.py``'s top-p cases:

* a clean row, a row masked with -inf over its second half (rank 1's whole
  shard), a fully masked row and a NaN-poisoned row;
* ``sanitize`` on ``"matmul"`` and ``"kernel"``, ``raise`` on all four rows
  and on the two clean ones.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro_torch.core import dist_ops, guards
from repro_torch.core.primitives import top_p_sample
from repro_torch.launch.world import run_world
from test_torch_dist_ops import ROOT, WORLD_TIMEOUT, _TOPP_LOGITS, _TOPP_U, _model

_POISONED = _TOPP_LOGITS.copy()
_POISONED[1, 17:] = -np.inf
_POISONED[2] = -np.inf
_POISONED[3, [5, 20]] = np.nan
_POLICIES = {
    "sanitize-matmul": dict(p=0.8, method="matmul", nonfinite="sanitize"),
    "sanitize-kernel": dict(p=0.8, method="kernel", nonfinite="sanitize"),
    "raise": dict(p=0.8, method="matmul", nonfinite="raise"),
    "raise-clean-rows": dict(p=0.8, method="matmul", nonfinite="raise", rows=2),
}
# JAX's reference in two subprocesses at once, about half the time each
_JAX_GROUPS = (("sanitize-matmul", "raise"), ("sanitize-kernel", "raise-clean-rows"))


def _policy_cases():
    return [dict(id=f"policy-{name}", op="topp", logits=_POISONED[:kw.get("rows", 4)],
                 u=_TOPP_U[:kw.get("rows", 4)],
                 kw=dict({k: v for k, v in kw.items() if k != "rows"}, tile_s=8))
            for name, kw in _POLICIES.items()]


POLICY_CASES = _policy_cases()
BY_ID = {c["id"]: c for c in POLICY_CASES}

_JAX_SCRIPT = """
import numpy as np, jax, jax.numpy as jnp
from repro.core import dist_top_p_sample
from repro.core.primitives import _reject_poisoned_logits
from repro.utils.compat import make_mesh
from repro.core.guards import NonFiniteError
inp = np.load({inputs!r}, allow_pickle=True)
u = jnp.asarray(inp["u"])
mesh2 = make_mesh((2,), ("model",))
out = {{}}
for name, kw in inp["policies"].item().items():
    kw = dict(kw)
    rows = kw.pop("rows", 4)
    lg = jnp.asarray(inp["poisoned"][:rows])
    try:
        if kw["nonfinite"] == "raise":      # the gate on concrete logits
            _reject_poisoned_logits(lg)
        f = jax.jit(lambda ll, uu: dist_top_p_sample(ll, None, mesh2, "model", u=uu,
                                                     tile_s=8, **kw))
        out[f"policy-{{name}}"] = np.asarray(f(lg, u[:rows]))
    except NonFiniteError:
        out[f"policy-{{name}}"] = np.asarray("NonFiniteError")
np.savez({outputs!r}, **out)
"""


def _start_jax(tmp, names, tag):
    inputs, outputs = str(tmp / f"jax_in{tag}.npz"), str(tmp / f"jax_out{tag}.npz")
    np.savez(inputs, u=_TOPP_U, poisoned=_POISONED,
             policies=np.array({k: _POLICIES[k] for k in names}, dtype=object))
    code = _JAX_SCRIPT.format(inputs=inputs, outputs=outputs)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, outputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 2's results on every policy case, and JAX's tokens."""
    tmp = tmp_path_factory.mktemp("dist_ops_policies")
    procs = [_start_jax(tmp, names, i) for i, names in enumerate(_JAX_GROUPS)]
    try:
        world = run_world("torch_dist_worlds:run_world_cases", 2,
                          dict(cases=POLICY_CASES, engine=None), workdir=tmp / "world2",
                          timeout=WORLD_TIMEOUT, pythonpath=[os.path.dirname(__file__)])
        logs = [proc.communicate(timeout=WORLD_TIMEOUT)[0] for proc, _ in procs]
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    jax_out = {}
    for (proc, out), log in zip(procs, logs):
        assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
        jax_out.update(np.load(out))
    return {"world": world, "jax": jax_out}


def _case(runs, cid, rank=0):
    return runs["world"][rank]["cases"][cid]


@pytest.mark.parametrize("name", list(_POLICIES))
def test_top_p_nonfinite_policies_match_jax(runs, name):
    """Both ranks give JAX's tokens on the poisoned rows at D = 2, or both raise
    ``NonFiniteError`` where JAX does; sanitize gives the poisoned rows their
    greedy token."""
    want = runs["jax"][f"policy-{name}"]
    for rank in range(2):
        case = _case(runs, f"policy-{name}", rank)
        if want.dtype.kind == "U":
            assert case.get("raised") == str(want) == "NonFiniteError"
            continue
        got = case["out"][0]
        assert got.dtype == np.int32 and np.array_equal(got, want), (got, want)
        if name.startswith("sanitize"):
            greedy = np.argmax(np.where(np.isnan(_POISONED), -np.inf, _POISONED), -1)
            assert got[2] == 0 and got[3] == greedy[3]


@pytest.mark.parametrize("name", list(_POLICIES))
def test_top_p_nonfinite_policy_collectives_match_the_model(runs, name):
    """Raise adds one all-reduce of the rows' flags (and a rejected call stops
    there); sanitize adds it and the greedy token's two all-reduces."""
    c = BY_ID[f"policy-{name}"]
    model = _model(c, 2)
    if name == "raise":
        model = {"counts_by_kind": {"all_reduce": 1},
                 "bytes_by_kind": {"all_reduce": 12 * c["logits"].shape[0]}}
    for rank in range(2):
        counts = _case(runs, c["id"], rank)["counts"]
        assert {k: v for k, v in counts["calls"].items() if v} == model["counts_by_kind"]
        assert {k: v for k, v in counts["bytes"].items() if v} == model["bytes_by_kind"]


def test_top_p_nonfinite_policies_at_one_rank_are_the_local_sampler():
    lg = torch.from_numpy(_POISONED)
    u = torch.from_numpy(_TOPP_U)
    t = dist_ops.dist_top_p_sample(lg, 33, p=0.8, method="matmul", tile_s=8, u=u,
                                   nonfinite="sanitize")
    assert torch.equal(t, top_p_sample(lg, p=0.8, method="matmul", tile_s=8, u=u,
                                       nonfinite="sanitize"))
    with pytest.raises(guards.NonFiniteError):
        dist_ops.dist_top_p_sample(lg, 33, u=u, nonfinite="raise")

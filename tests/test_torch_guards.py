"""The port's guard layer against the JAX package's (``tests/test_guards.py``).

The contracts, in the order ``docs/architecture.md`` rule 10 gives them:

1. the ``nonfinite`` policy resolves context > ``REPRO_NONFINITE`` > argument,
   and ``"propagate"`` inside ``guards_disabled``;
2. ``guard_check`` does nothing with checks off; a guarded operator's default
   call issues exactly the ATen operations it issues under
   ``guards_disabled()`` (the counterpart of JAX's jaxpr-identity gate,
   recorded with a ``TorchDispatchMode``);
3. the validators raise at the call site.

Left out of ``tests/test_guards.py``: its five backend-probe tests
(``test_probe_lowering_succeeds_and_caches``,
``test_forced_probe_failure_degrades_with_single_warning``,
``test_forced_probe_failure_through_public_entry``,
``test_probe_bypassed_under_guards_disabled``, ``test_probe_family_collapse``):
the port has no probe and no fallback, and a kernel that fails to build
raises.  JAX's traced-offsets tests become eager ones: PyTorch offsets are
always concrete, so the CSR contract raises at the call site with checks on or
off.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import guards as jax_guards
from repro.core.scan import scan as jax_scan
from repro.core.segmented import segment_scan as jax_segment_scan
from repro_torch.core import guards
from repro_torch.core.linrec import linear_scan
from repro_torch.core.primitives import radix_sort, split, top_p_sample, weighted_sample
from repro_torch.core.scan import scan
from repro_torch.core.segmented import segment_scan, segment_top_p_sample

OFF = torch.tensor([0, 3, 5], dtype=torch.int32)
X5 = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])


# ---- non-finite policy resolution ----


def test_resolution_order_ctx_beats_env_beats_arg(monkeypatch):
    assert guards.ENV_VAR == jax_guards.ENV_VAR == "REPRO_NONFINITE"
    assert guards.NONFINITE == jax_guards.NONFINITE
    monkeypatch.setenv(guards.ENV_VAR, "raise")
    assert guards.resolve_nonfinite("propagate") == "raise"        # env > arg
    with guards.nonfinite_override("sanitize"):                     # ctx > env
        assert guards.resolve_nonfinite("propagate") == "sanitize"
    monkeypatch.delenv(guards.ENV_VAR)
    assert guards.resolve_nonfinite("sanitize") == "sanitize"      # arg
    assert guards.resolve_nonfinite() == "propagate"


def test_unknown_policy_rejected_everywhere(monkeypatch):
    with pytest.raises(ValueError, match="nonfinite"):
        guards.resolve_nonfinite("explode", op="t")
    with pytest.raises(ValueError, match="nonfinite"):
        with guards.nonfinite_override("explode"):
            pass
    monkeypatch.setenv(guards.ENV_VAR, "explode")
    with pytest.raises(ValueError, match=guards.ENV_VAR):
        guards.resolve_nonfinite()


def test_guards_disabled_forces_propagate_and_no_checks(monkeypatch):
    assert guards.CHECKS_ENV_VAR == jax_guards.CHECKS_ENV_VAR == "REPRO_CHECKS"
    monkeypatch.setenv(guards.CHECKS_ENV_VAR, "1")
    with guards.nonfinite_override("raise"):
        with guards.guards_disabled():
            assert guards.resolve_nonfinite() == "propagate"
            assert not guards.checks_enabled()
            assert not guards.guards_active()
        assert guards.resolve_nonfinite() == "raise"
    assert guards.checks_enabled()


def test_env_var_drives_operator_behaviour(monkeypatch):
    bad = np.asarray([1.0, np.nan, 3.0], np.float32)
    monkeypatch.setenv(guards.ENV_VAR, "sanitize")
    got = scan(torch.from_numpy(bad))
    assert got.tolist() == [1.0, 1.0, 4.0] == np.asarray(jax_scan(jnp.asarray(bad))).tolist()
    monkeypatch.setenv(guards.ENV_VAR, "raise")
    with pytest.raises(guards.NonFiniteError):
        scan(torch.from_numpy(bad))
    with pytest.raises(jax_guards.NonFiniteError):
        jax_scan(jnp.asarray(bad))


# ---- checks ----


def test_guard_check_noop_when_off():
    ran = []
    with guards.checks(False):          # pinned off, whatever REPRO_CHECKS says
        guards.guard_check(lambda: ran.append(1), "never evaluated")
    assert not ran


def test_guard_check_eager_raises():
    with guards.checks():
        with pytest.raises(guards.GuardCheckError, match="bad scalar"):
            guards.guard_check(False, "bad scalar")
        with pytest.raises(guards.GuardCheckError, match="bad tensor"):
            guards.guard_check(lambda: torch.tensor(False), "bad tensor")
        guards.guard_check(True, "fine")


def test_guard_check_fires_through_checked():
    def f(x):
        guards.guard_check(lambda: bool((x > 0).all()), "x must be positive")
        return x * 2

    with guards.checks():
        assert guards.checked(f)(torch.tensor([1.0, 2.0])).tolist() == [2.0, 4.0]
        with pytest.raises(guards.GuardCheckError, match="positive"):
            guards.checked(f)(torch.tensor([1.0, -2.0]))


@pytest.mark.parametrize("enabled", [False, True])
def test_offsets_csr_contract_raises_at_the_call_site(enabled):
    """JAX stages the CSR check for traced offsets; the port's are concrete, so
    the same contract raises eagerly with checks on or off."""
    with guards.checks(enabled):
        assert segment_scan(X5, OFF).shape == X5.shape
        with pytest.raises(ValueError, match="non-decreasing"):
            segment_scan(X5, torch.tensor([0, 4, 2, 5]))


def test_checks_env_var(monkeypatch):
    monkeypatch.setenv(guards.CHECKS_ENV_VAR, "1")
    assert guards.checks_enabled()
    with guards.checks(False):          # the context wins over the environment
        assert not guards.checks_enabled()
    monkeypatch.delenv(guards.CHECKS_ENV_VAR)
    assert not guards.checks_enabled()


# ---- ATen-op identity: guarded defaults == guards_disabled ----


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(fn, arg):
    with _OpLog() as log:
        fn(arg)
    return log.ops


IDENTITY_CASES = [
    ("scan", lambda x: scan(x)),
    ("linrec", lambda x: linear_scan(x, x)),
    ("segment_scan", lambda x: segment_scan(x, OFF)),
    ("weighted_sample", lambda x: weighted_sample(x, u=torch.tensor(0.5))),
    ("top_p", lambda x: top_p_sample(x[None], p=0.9, u=torch.tensor([[0.5]]))),
    ("segment_top_p", lambda x: segment_top_p_sample(x, OFF, p=0.9,
                                                     u=torch.tensor([[0.5], [0.5]]))),
]


@pytest.mark.parametrize("name,fn", IDENTITY_CASES, ids=[c[0] for c in IDENTITY_CASES])
def test_aten_ops_identity_guarded_vs_disabled(name, fn):
    with guards.checks(False):          # the documented checks-off contract
        guarded = _ops(fn, X5)
    with guards.guards_disabled():
        bare = _ops(fn, X5)
    assert guarded and guarded == bare, f"{name}: guards added operations to the call"


# ---- validators ----


def test_validate_axis_rejects_out_of_bounds():
    assert guards.validate_axis(-1, 2, op="scan") == 1
    with pytest.raises(ValueError, match="axis"):
        guards.validate_axis(5, 2, op="scan")
    with pytest.raises(ValueError, match="axis"):
        scan(torch.ones((2, 3)), axis=7)
    with pytest.raises(ValueError, match="axis"):
        linear_scan(torch.ones(4), torch.ones(4), axis=-2)


def test_validate_bits_per_pass():
    with pytest.raises(ValueError, match="bits_per_pass"):
        radix_sort(torch.tensor([3, 1, 2], dtype=torch.int32), bits_per_pass=0)
    with pytest.raises(ValueError, match="bits_per_pass"):
        radix_sort(torch.tensor([3, 1, 2], dtype=torch.int32), bits_per_pass=9)


@pytest.mark.parametrize("bad", [
    [1, 3, 5],          # offsets[0] != 0
    [0, 3, 9],          # offsets[-1] != n
    [0, 4, 2, 5],       # decreasing
    [[0, 3, 5]],        # 2-D
])
def test_validate_offsets_concrete(bad):
    with pytest.raises(ValueError):
        segment_scan(X5, torch.tensor(bad))
    with pytest.raises(ValueError):
        jax_segment_scan(jnp.asarray(X5.numpy()), jnp.asarray(bad))


def test_validate_offsets_good_offsets_agree_with_jax():
    got = segment_scan(X5, OFF, method="vector")
    want = jax_segment_scan(jnp.asarray(X5.numpy()), jnp.asarray(OFF.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want))


def test_sampler_param_validation():
    logits = torch.tensor([[0.0, 1.0, 2.0]])
    u = torch.tensor([[0.5]])
    with pytest.raises(ValueError, match="p must"):
        top_p_sample(logits, p=1.5, u=u)
    with pytest.raises(ValueError, match="p must"):
        top_p_sample(logits, p=float("nan"), u=u)
    with pytest.raises(ValueError, match="temperature"):
        top_p_sample(logits, temperature=-1.0, u=u)
    with pytest.raises(ValueError, match="temperature"):
        top_p_sample(logits, temperature=float("inf"), u=u)


def test_kernel_entry_validators():
    from repro_torch.kernels.scan_mm import scan_tiles
    from repro_torch.kernels.split_mm import multi_split_tiles, split_tiles

    with pytest.raises(ValueError, match="variant"):
        scan_tiles(torch.ones(8), variant="scanul3", s=2)
    with pytest.raises(ValueError, match="must match"):
        split_tiles(torch.ones(8), torch.ones(7))
    with pytest.raises(ValueError, match="num_buckets"):
        multi_split_tiles(torch.ones(8), torch.zeros(8, dtype=torch.int32),
                          num_buckets=0)
    with pytest.raises(ValueError):
        split(torch.ones(8), torch.ones(7, dtype=torch.int8))


def test_apply_nonfinite_policies():
    x = torch.tensor([1.0, float("inf"), float("nan")])
    assert guards.apply_nonfinite(x, "propagate", op="t") is x
    got = guards.apply_nonfinite(x, "sanitize", op="t", identity=7.0)
    want = jax_guards.apply_nonfinite(jnp.asarray(x.numpy()), "sanitize", op="t",
                                      identity=7.0)
    assert got.tolist() == np.asarray(want).tolist() == [1.0, 7.0, 7.0]
    with pytest.raises(guards.NonFiniteError, match="nonfinite='raise'"):
        guards.apply_nonfinite(x, "raise", op="t")
    ints = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert guards.apply_nonfinite(ints, "raise", op="t") is ints
    assert guards.apply_nonfinite(ints, "sanitize", op="t") is ints
    with guards.guards_disabled():
        assert guards.apply_nonfinite(x, "raise", op="t") is x

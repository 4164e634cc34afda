"""Fault injection: every fault lands on a documented outcome, as in the JAX package.

Counterpart of ``tests/test_faults.py``.  Each test injects one class of fault
through a public operator of both packages on the same numpy inputs and asks
:func:`repro_torch.analysis.faults.classify` for JAX's outcome: ``value`` /
``type`` (validation), ``nonfinite`` (the ``"raise"`` policy), ``checkified``
(a ``guard_check`` with checks on; JAX's ``checkify.JaxRuntimeError``), or
``ok`` (propagate and sanitize), with ``sanitize``'s values equal to JAX's.

Left out: the two lowering tests (``test_lowering_failure_degrades_scan``,
``test_lowering_failure_result_matches_fallback``): the port has no probe and
no fallback, so it has no ``"degraded"`` outcome (``OUTCOMES`` drops it).
JAX's traced-offsets test (its offsets are tracers, caught by a staged check)
becomes an eager one here: the port's offsets are concrete and raise
``ValueError`` at the call site, checks on or off.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.analysis import faults as jax_faults
from repro.core import guards as jax_guards
from repro.core.linrec import linear_scan as jax_linear_scan
from repro.core.primitives import top_p_sample as jax_top_p_sample
from repro.core.primitives import weighted_sample as jax_weighted_sample
from repro.core.scan import scan as jax_scan
from repro.core.segmented import segment_scan as jax_segment_scan
from repro.core.segmented import segment_top_p_sample as jax_segment_top_p_sample
from repro_torch.analysis.faults import (
    OUTCOMES, adversarial_params, checks, classify, corrupt_offsets, inject_nonfinite,
)
from repro_torch.core import guards
from repro_torch.core.linrec import linear_scan
from repro_torch.core.primitives import radix_sort, top_p_sample, weighted_sample
from repro_torch.core.scan import scan
from repro_torch.core.segmented import segment_scan, segment_top_p_sample

OFF = np.asarray([0, 3, 5], np.int32)
X5 = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
METHODS = ("vector", "matmul", "kernel", "blocked")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("kind", ["nan", "inf", "-inf", "extreme"])
def test_injection_poisons_the_same_elements_as_jax(kind):
    x = np.arange(64, dtype=np.float32).reshape(4, 16)
    got = inject_nonfinite(_t(x), kind, frac=0.1, seed=7).numpy()
    want = np.asarray(jax_faults.inject_nonfinite(_j(x), kind, frac=0.1, seed=7))
    np.testing.assert_array_equal(got, want)


# ---- non-finite payloads ----


@pytest.mark.parametrize("kind", ["nan", "inf", "-inf", "extreme"])
def test_nonfinite_payload_propagates_by_default(kind):
    x = inject_nonfinite(_t(X5), kind, frac=0.2, seed=3)
    with checks(False):                 # propagate is the unchecked IEEE contract
        outcome, out = classify(scan, x)
    with jax_guards.checks(False):
        jout, jres = jax_faults.classify(jax_scan, _j(x.numpy()))
    assert outcome == jout == "ok"
    np.testing.assert_array_equal(out.numpy(), np.asarray(jres))
    if kind != "extreme":               # extreme payloads are finite until summed
        assert not bool(torch.isfinite(out).all())


@pytest.mark.parametrize("kind", ["nan", "inf", "-inf"])
@pytest.mark.parametrize("op", ["scan", "linrec", "segment_scan"])
def test_nonfinite_payload_raises_under_policy(kind, op):
    x = inject_nonfinite(_t(X5), kind, frac=0.2, seed=4)
    fns = {
        "scan": (lambda v: scan(v, nonfinite="raise"),
                 lambda v: jax_scan(v, nonfinite="raise")),
        "linrec": (lambda v: linear_scan(v, v, nonfinite="raise"),
                   lambda v: jax_linear_scan(v, v, nonfinite="raise")),
        "segment_scan": (lambda v: segment_scan(v, _t(OFF), nonfinite="raise"),
                         lambda v: jax_segment_scan(v, _j(OFF), nonfinite="raise")),
    }
    outcome, detail = classify(fns[op][0], x)
    jout, _ = jax_faults.classify(fns[op][1], _j(x.numpy()))
    assert outcome == jout == "nonfinite", (op, kind, detail)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_nonfinite_payload_sanitizes_to_identity(kind, method):
    x = inject_nonfinite(_t(X5), kind, frac=0.2, seed=5)
    outcome, out = classify(scan, x, nonfinite="sanitize", method=method, tile_s=8)
    jout, jres = jax_faults.classify(jax_scan, _j(x.numpy()), nonfinite="sanitize",
                                     method=method, tile_s=8)
    assert outcome == jout == "ok"
    assert bool(torch.isfinite(out).all())
    ref = scan(torch.where(torch.isfinite(x), x, 0.0), method=method, tile_s=8)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jres))   # integer-valued


@pytest.mark.parametrize("op", ["linrec", "segment_scan"])
def test_nonfinite_payload_sanitizes_like_jax(op):
    a = inject_nonfinite(_t(X5), "inf", frac=0.2, seed=8) / 4
    b = inject_nonfinite(_t(X5), "nan", frac=0.2, seed=9)
    if op == "linrec":
        got = linear_scan(a, b, nonfinite="sanitize", method="vector")
        want = jax_linear_scan(_j(a.numpy()), _j(b.numpy()), nonfinite="sanitize",
                               method="vector")
    else:
        got = segment_scan(b, _t(OFF), nonfinite="sanitize", method="vector")
        want = jax_segment_scan(_j(b.numpy()), _j(OFF), nonfinite="sanitize")
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nan_logits_sampler_contracts():
    logits = inject_nonfinite(torch.zeros((2, 8)), "nan", frac=0.2, seed=6)
    jl = _j(logits.numpy())
    u = np.asarray([[0.5], [0.5]], np.float32)
    with checks(False), jax_guards.checks(False):
        assert classify(top_p_sample, logits, u=_t(u))[0] == \
            jax_faults.classify(jax_top_p_sample, jl, None, u=_j(u))[0] == "ok"
    assert classify(top_p_sample, logits, u=_t(u), nonfinite="raise")[0] == \
        jax_faults.classify(jax_top_p_sample, jl, None, u=_j(u),
                            nonfinite="raise")[0] == "nonfinite"
    outcome, tok = classify(top_p_sample, logits, u=_t(u), nonfinite="sanitize")
    jout, jtok = jax_faults.classify(jax_top_p_sample, jl, None, u=_j(u),
                                     nonfinite="sanitize")
    assert outcome == jout == "ok"
    assert tok.tolist() == np.asarray(jtok).tolist()
    assert tok.shape == (2,) and bool((tok >= 0).all())


def test_checkified_cdf_assertion_fires():
    """The finite-CDF check catches NaN weights with checks on."""
    w = np.asarray([0.2, np.nan, 0.1], np.float32)

    with checks():
        outcome, detail = classify(guards.checked(
            lambda v: weighted_sample(v, u=torch.tensor(0.5))), _t(w))
    with jax_guards.checks():
        jout, _ = jax_faults.classify(jax_guards.checked(
            lambda v: jax_weighted_sample(v, None, u=jnp.asarray(0.5))), _j(w))
    assert outcome == jout == "checkified", detail
    with checks(False):                 # off: the NaN propagates into a sample
        assert classify(weighted_sample, _t(w), u=torch.tensor(0.5))[0] == "ok"


# ---- corrupted offsets ----


@pytest.mark.parametrize("mode,expected", [
    ("unsorted", "value"), ("negative", "value"), ("overrun", "value"),
    ("head", "value"), ("float", "type"),
])
def test_corrupted_offsets_rejected_eagerly(mode, expected):
    bad = corrupt_offsets(_t(OFF), mode)
    np.testing.assert_array_equal(bad.numpy(),
                                  np.asarray(jax_faults.corrupt_offsets(_j(OFF), mode)))
    if mode == "float":
        # the public entries cast loose offsets to int32; the validator owns the
        # TypeError contract
        with pytest.raises(TypeError):
            guards.validate_offsets(bad, 5, op="segment_scan")
        return
    outcome, detail = classify(segment_scan, _t(X5), bad)
    jout, _ = jax_faults.classify(jax_segment_scan, _j(X5), _j(bad.numpy()))
    assert outcome == jout == expected, (mode, detail)


@pytest.mark.parametrize("mode", ["unsorted", "negative", "overrun", "head"])
def test_corrupted_offsets_under_checks_rejected_at_the_call_site(mode):
    """JAX's traced offsets hit a staged check ("checkified"); the port's offsets are
    concrete, so the same fault is a "value" outcome before any kernel runs."""
    bad = corrupt_offsets(_t(OFF), mode)
    with checks():
        outcome, detail = classify(guards.checked(segment_scan), _t(X5), bad)
    assert outcome == "value", (mode, detail)


# ---- adversarial sampler parameters ----


@pytest.mark.parametrize("which,expected", [
    ("p_over", "value"), ("p_under", "value"), ("p_nan", "value"),
    ("temp_negative", "value"), ("temp_nan", "value"), ("temp_inf", "value"),
    ("temp_zero", "ok"),
])
def test_adversarial_sampler_params(which, expected):
    logits = np.asarray([[0.0, 1.0, 5.0]], np.float32)
    kw = adversarial_params(which)
    assert repr(kw) == repr(jax_faults.adversarial_params(which))     # NaN != NaN
    u = np.asarray([[0.5]], np.float32)
    outcome, detail = classify(top_p_sample, _t(logits), u=_t(u), **kw)
    assert outcome == expected, (which, detail)
    out2, detail2 = classify(segment_top_p_sample, _t(logits[0]), _t([0, 3]),
                             u=_t(u), **kw)
    assert out2 == expected, (which, detail2)
    jout, _ = jax_faults.classify(jax_top_p_sample, _j(logits), None, u=_j(u), **kw)
    jout2, _ = jax_faults.classify(jax_segment_top_p_sample, _j(logits[0]),
                                   _j(np.asarray([0, 3])), None, u=_j(u), **kw)
    assert jout == jout2 == expected


def test_unsupported_sort_dtype_hits_type_contract():
    """float64 keys have no sortable-int encoding in either package: a TypeError."""
    assert classify(radix_sort, torch.tensor([3.0, 1.0, 2.0]))[0] == "ok"
    outcome, detail = classify(radix_sort, torch.tensor([3.0, 1.0], dtype=torch.float64))
    assert outcome == "type", detail


def test_temperature_zero_is_argmax():
    logits = np.asarray([[0.0, 9.0, 1.0], [3.0, 0.0, 0.0]], np.float32)
    tok = top_p_sample(_t(logits), temperature=0.0)
    assert tok.tolist() == [1, 0] == np.asarray(
        jax_top_p_sample(_j(logits), None, temperature=0.0)).tolist()


def test_outcomes_closed_set():
    assert set(OUTCOMES) == {"ok", "value", "type", "nonfinite", "checkified"}
    assert set(OUTCOMES) == set(jax_faults.OUTCOMES) - {"degraded"}

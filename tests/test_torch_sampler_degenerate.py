"""Degenerate sampler inputs on every method, the port against the JAX package.

Counterpart of ``tests/test_sampler_degenerate.py``: ``temperature -> 0`` (the
greedy limit), ``p in {0, 1}``, a one-token vocabulary, fully ``-inf`` rows
and NaN logits, through ``top_p_sample`` on all four ``method=`` values and
``segment_top_p_sample``, each under the ``nonfinite`` policies.  The same
numpy logits and uniforms go through both packages; every case asks for the
same tokens as JAX, or the same ``NonFiniteError``.  JAX's ``"kernel"`` and
``"blocked"`` methods run their Pallas kernels in interpret mode.

Left out: the two hypothesis properties (``test_sampled_token_always_in_range``,
``test_greedy_limit_matches_argmax_property``) and the one-token vocabulary
(``test_single_token_vocab``, ``test_single_token_segments``).  They hold the
plain sampler's range, greedy limit and edge shapes, not a guard, and would
compile every method's JAX operations once more for shapes of their own.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

from repro.core import guards as jax_guards
from repro.core.primitives import top_p_sample as jax_top_p_sample
from repro.core.segmented import segment_top_p_sample as jax_segment_top_p_sample
from repro_torch.core import guards
from repro_torch.core.primitives import top_p_sample
from repro_torch.core.segmented import segment_top_p_sample

S = 8
METHODS_ALL = ["vector", "matmul", "kernel", "blocked"]
LOGITS = np.asarray([[0.0, 3.0, 1.0, -2.0], [5.0, 0.0, 0.0, 0.0]], np.float32)
U = np.asarray([[0.4], [0.7]], np.float32)
# every case is (2, 4), so that each method's JAX operations compile once
MASKED = np.asarray([[-np.inf] * 4, [0.0, 2.0, 1.0, -np.inf]], np.float32)
POISONED = np.asarray([[0.0, np.nan, 4.0, -1.0], [0.0, 2.0, 1.0, -np.inf]], np.float32)
U3 = np.asarray([[0.5], [0.5]], np.float32)


def _seg(logits):
    """A rectangular (B, V) batch packed as segments of one array."""
    b, v = logits.shape
    return logits.reshape(b * v), np.arange(b + 1, dtype=np.int32) * v


def _port(logits, u, **kw):
    return top_p_sample(torch.from_numpy(logits), u=torch.from_numpy(u), tile_s=S, **kw)


def _jax(logits, u, **kw):
    return jax_top_p_sample(jnp.asarray(logits), None, u=jnp.asarray(u), tile_s=S, **kw)


def _port_seg(logits, u, **kw):
    vals, off = _seg(logits)
    return segment_top_p_sample(torch.from_numpy(vals), torch.from_numpy(off),
                                u=torch.from_numpy(u), tile_s=S, **kw)


def _jax_seg(logits, u, **kw):
    vals, off = _seg(logits)
    return jax_segment_top_p_sample(jnp.asarray(vals), jnp.asarray(off), None,
                                    u=jnp.asarray(u), tile_s=S, **kw)


def _both(logits, u, **kw):
    """``top_p_sample``'s tokens in the port and in JAX, as lists."""
    return _port(logits, u, **kw).tolist(), np.asarray(_jax(logits, u, **kw)).tolist()


def _both_seg(logits, u, **kw):
    """``segment_top_p_sample``'s tokens on the packed rows, port and JAX."""
    return (_port_seg(logits, u, **kw).tolist(),
            np.asarray(_jax_seg(logits, u, **kw)).tolist())


def _both_raise(fns, logits, u, **kw):
    """Both packages reject ``logits`` under ``nonfinite="raise"``."""
    with pytest.raises(guards.NonFiniteError):
        fns[0](logits, u, **kw)
    with pytest.raises(jax_guards.NonFiniteError):
        fns[1](logits, u, **kw)


# ---- temperature -> 0: the greedy limit ----


@pytest.mark.parametrize("method", METHODS_ALL)
def test_temperature_zero_is_argmax(method):
    got, want = _both(LOGITS, U, temperature=0.0, method=method)
    assert got == want == [1, 0]


def test_temperature_zero_segmented_matches_batched():
    got, want = _both_seg(LOGITS, U, temperature=0.0)
    assert got == want == [1, 0]


@pytest.mark.parametrize("method", ["vector", "matmul"])
def test_small_temperature_converges_to_greedy(method):
    got, want = _both(LOGITS, U, temperature=1e-4, method=method)
    assert got == want == [1, 0]


def test_temperature_zero_breaks_ties_to_lowest_id():
    tied = np.asarray([[2.0, 7.0, 7.0, 1.0], [7.0, 1.0, 7.0, 7.0]], np.float32)
    assert _both(tied, U3, temperature=0.0) == ([1, 0], [1, 0])
    assert _both_seg(tied, U3, temperature=0.0) == ([1, 0], [1, 0])


# ---- p in {0, 1} ----


@pytest.mark.parametrize("method", METHODS_ALL)
def test_p_zero_keeps_only_top_token(method):
    got, want = _both(LOGITS, U, p=0.0, method=method)
    assert got == want == [1, 0]


@pytest.mark.parametrize("method", METHODS_ALL)
def test_p_one_samples_full_distribution(method):
    got, want = _both(LOGITS, U, p=1.0, method=method)
    assert got == want and all(0 <= t < LOGITS.shape[-1] for t in got)


def test_p_extremes_segmented():
    assert _both_seg(LOGITS, U, p=0.0) == ([1, 0], [1, 0])
    got, want = _both_seg(LOGITS, U, p=1.0)
    assert got == want and all(0 <= t < LOGITS.shape[-1] for t in got)


# ---- fully -inf rows and NaN logits, under each policy ----


@pytest.mark.parametrize("method", METHODS_ALL)
def test_all_inf_row_sanitize_greedy_fallback(method):
    got, want = _both(MASKED, U3, method=method, nonfinite="sanitize")
    assert got == want
    assert got[0] == 0            # a fully masked row -> the deterministic index 0
    assert got[1] == 1            # a healthy row samples normally


@pytest.mark.parametrize("method", METHODS_ALL)
def test_all_inf_row_raise_rejected_but_partial_mask_legal(method):
    _both_raise((_port, _jax), MASKED, U3, method=method, nonfinite="raise")
    part = np.asarray([[-np.inf, 2.0, 1.0, 0.0], [0.0, 2.0, 1.0, -np.inf]], np.float32)
    got, want = _both(part, U3, method=method, nonfinite="raise")
    assert got == want and got[0] != 0 and got[1] != 3   # masked tokens never drawn


@pytest.mark.parametrize("method", METHODS_ALL)
def test_nan_logits_policies(method):
    with guards.checks(False), jax_guards.checks(False):
        got, want = _both(POISONED, U3, method=method)         # propagate: no crash
    assert len(got) == len(want) == 2 and got[1] == want[1]
    _both_raise((_port, _jax), POISONED, U3, method=method, nonfinite="raise")
    got, want = _both(POISONED, U3, method=method, nonfinite="sanitize")
    assert got == want
    assert got[0] == 2            # greedy over the finite entries of the bad row
    assert got[1] == 1


@pytest.mark.parametrize("method", METHODS_ALL)
def test_segmented_masked_and_nan_policies(method):
    got, want = _both_seg(MASKED, U3, method=method, nonfinite="sanitize")
    assert got == want and got[0] == 0
    _both_raise((_port_seg, _jax_seg), MASKED, U3, method=method, nonfinite="raise")
    _both_raise((_port_seg, _jax_seg), POISONED, U3, method=method, nonfinite="raise")
    got, want = _both_seg(POISONED, U3, method=method, nonfinite="sanitize")
    assert got == want and got[0] == 2


def test_override_and_env_reach_the_samplers(monkeypatch):
    """The policy resolves context > ``REPRO_NONFINITE`` > argument in both."""
    with guards.nonfinite_override("sanitize"), jax_guards.nonfinite_override("sanitize"):
        got, want = _both(MASKED, U3, method="vector")
    assert got == want and got[0] == 0
    monkeypatch.setenv(guards.ENV_VAR, "raise")
    _both_raise((_port, _jax), MASKED, U3, method="vector")

"""The port's precision axis (``precision=``) against the JAX package.

Inputs are drawn with numpy from a seed and go through both packages:

* resolution: ``precision_override`` > ``REPRO_SCAN_PRECISION`` > the
  argument, the explicit-vector raise and the auto-to-vector degrade, case by
  case against JAX's ``resolve_precision``;
* ``split_f16``'s ``(hi, lo, e)`` bit-equal to JAX's on normal-range rows (the
  extreme exponents, near the fp16 overflow, zero and non-finite rows), and
  ``pdot`` for each ``exact=`` and precision: bit-equal on integer-valued
  fp32, within the precision's bound at the product's scale on random fp32;
* ``scan``, ``segment_scan``, ``linear_scan``, ``cumprod``,
  ``segment_linear_scan`` and ``ssd_scan`` on ``"matmul"``, ``"kernel"`` and
  ``"blocked"`` under ``"compensated"`` and ``"fast"``: within
  ``ulp_bound(precision, n)`` of fp64 at n of 5, 97 and 600 (``ulp_oracle``'s
  assertion), ``"fast"`` further than ``"highest"``'s bound from ``"highest"``,
  and at n = 600 within twice ``ulp_bound("highest", n)`` of JAX's result on the
  same method (its Pallas kernels in interpret mode, one jitted call a method
  and precision, so each compiles once): both packages round the same operands
  to bf16 or split them the same way and sum exact products, so only the order
  of the sums differs;
* integer and integer-valued scans exact under every precision, non-finite
  placement as under ``"highest"`` on the same method, and the port's
  subnormals held to fp64 (not to JAX: XLA on the CPU flushes them).

The kernel methods run their plain versions here (CPU tensors); the card
tests (``test_torch_cuda.py``) hold the CUDA kernels to ``"highest"``'s bits.
"""
from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

import repro.core as J
from repro.analysis import ulp
from repro.core import precision as JP
from repro.core.ssd import ssd_scan as jax_ssd_scan
from repro_torch.analysis import ulp as port_ulp
from repro_torch.core import autotune
from repro_torch.core import precision as TP
from repro_torch.core.linrec import cumprod, linear_scan
from repro_torch.core.scan import scan
from repro_torch.core.segmented import segment_linear_scan, segment_scan
from repro_torch.core.ssd import ssd_scan, ssd_scan_ref
from ulp_oracle import UlpReport, assert_within_bound

ENGINE = ("matmul", "kernel", "blocked")
LOOSE = ("compensated", "fast")
NS = (5, 97, 600)
TILE = 8
# ssd_scan is not a scan: its limit is on |y - fp64| / max|y|.  "highest" and
# "compensated": chip_smoke's SSD_REL; "fast": bf16's relative spacing, since the
# log-decay cumsum keeps ~8 significand bits and exp carries that error into y
SSD_REL = {"highest": 2e-6, "compensated": 2e-6, "fast": 2.0 ** -8}


def _tight(n):
    """How far apart two results that differ only in the order of their fp32 sums
    may lie: twice ``"highest"``'s bound, far inside the ~2^15 ulp by which bf16
    operands move a result."""
    return 2 * ulp.ulp_bound("highest", n)


@pytest.fixture(autouse=True)
def _no_env_precision(monkeypatch):
    monkeypatch.delenv(TP.ENV_VAR, raising=False)


# ---------------------------------------------------------------------------
# resolution: override > env > argument, JAX's rules case by case
# ---------------------------------------------------------------------------

_SOURCES = ("argument", "env", "override", "override+env")
_RESOLVE = list(itertools.product(TP.PRECISIONS, (None, "matmul", "vector", "kernel"),
                                  (True, False), _SOURCES))


def _resolve(mod, monkeypatch, precision, method, explicit, source):
    """``mod.resolve_precision`` with ``precision`` put where ``source`` says (the
    argument then "highest"), or the ``ValueError`` it raises."""
    arg = precision if source == "argument" else "highest"
    if "env" in source:
        monkeypatch.setenv(TP.ENV_VAR, "fast" if source == "override+env" else precision)
    try:
        if "override" in source:
            with mod.precision_override(precision):
                return mod.resolve_precision(arg, method=method, explicit_method=explicit)
        return mod.resolve_precision(arg, method=method, explicit_method=explicit)
    except ValueError:
        return ValueError
    finally:
        monkeypatch.delenv(TP.ENV_VAR, raising=False)


@pytest.mark.parametrize("precision,method,explicit,source", _RESOLVE,
                         ids=[f"{p}-{m}-{'explicit' if e else 'auto'}-{s}"
                              for p, m, e, s in _RESOLVE])
def test_resolution_matches_jax(monkeypatch, precision, method, explicit, source):
    want = _resolve(JP, monkeypatch, precision, method, explicit, source)
    got = _resolve(TP, monkeypatch, precision, method, explicit, source)
    assert got == want
    if source != "argument" and method != "vector":
        assert got == precision             # the override, or the env, wins


def test_unknown_precisions_raise_as_in_jax(monkeypatch):
    for mod in (JP, TP):
        with pytest.raises(ValueError):
            mod.resolve_precision("exact")
        with pytest.raises(ValueError):
            with mod.precision_override("exact"):
                pass
        monkeypatch.setenv(TP.ENV_VAR, "exact")
        with pytest.raises(ValueError):
            mod.resolve_precision("highest")
        monkeypatch.delenv(TP.ENV_VAR)
    assert (TP.SPLIT_SHIFT, TP.ENV_VAR, TP.PRECISIONS) == (JP.SPLIT_SHIFT, JP.ENV_VAR,
                                                           JP.PRECISIONS)
    assert port_ulp.ULP_COEFF == ulp.ULP_COEFF


def test_override_and_env_reach_an_auto_call(monkeypatch):
    """On the CPU table a (1, 16384) fp32 scan resolves to "matmul": the override
    and the env var reach it, the override winning; at n = 600 it resolves to
    "vector", where any precision gives ``torch.cumsum``'s bits."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 16384)).astype(
        np.float32))
    assert autotune.resolve_method("scan", 16384, torch.float32, backend="cpu") == "matmul"
    want = {p: scan(x, method="matmul", precision=p) for p in TP.PRECISIONS}
    assert not torch.equal(want["compensated"], want["highest"])
    with TP.precision_override("compensated"):
        assert torch.equal(scan(x), want["compensated"])
    monkeypatch.setenv(TP.ENV_VAR, "fast")
    assert torch.equal(scan(x), want["fast"])
    with TP.precision_override("compensated"):
        assert torch.equal(scan(x, precision="highest"), want["compensated"])
    small = x[:, :600]
    assert autotune.resolve_method("scan", 600, torch.float32, backend="cpu") == "vector"
    assert torch.equal(scan(small, precision="compensated"), torch.cumsum(small, -1))
    with pytest.raises(ValueError):
        scan(small, method="vector", precision="fast")


# ---------------------------------------------------------------------------
# split_f16 and pdot against JAX
# ---------------------------------------------------------------------------

def _split_rows():
    rng = np.random.default_rng(2)
    mag = 0.5 + np.abs(rng.standard_normal((3, 32)))
    sgn = rng.choice([-1.0, 1.0], (3, 32))
    rows = [rng.standard_normal((4, 32)) * 2.0 ** rng.integers(-30, 30, (4, 1)),
            sgn * mag * 2.0 ** 125,                   # a max near 2^126
            sgn * mag * 2.0 ** -125,                  # near the normal floor
            sgn * mag * 65504.0 * rng.uniform(0.9, 3.0, (3, 32)),   # the fp16 overflow
            np.zeros((1, 32))]
    special = np.ones((3, 32))
    special[0, 3], special[1, 7], special[2, [1, 9]] = np.nan, np.inf, [-np.inf, np.nan]
    return np.concatenate(rows + [special]).astype(np.float32)


@pytest.mark.parametrize("axis", [-1, -2])
def test_split_f16_bit_equal_to_jax(axis):
    x = _split_rows()
    x = x if axis == -1 else np.ascontiguousarray(x.T)
    split = jax.jit(JP.split_f16, static_argnums=1)
    jh, jl, je = (np.asarray(t) for t in split(jnp.asarray(x), axis))
    th, tl, te = TP.split_f16(torch.from_numpy(x), axis=axis)
    assert th.dtype == tl.dtype == torch.float16 and te.dtype == torch.int32
    np.testing.assert_array_equal(th.numpy().view(np.uint16), jh.view(np.uint16))
    np.testing.assert_array_equal(tl.numpy().view(np.uint16), jl.view(np.uint16))
    np.testing.assert_array_equal(te.numpy(), je)


def _reconstruct(hi, lo, e):
    shift = torch.tensor(-TP.SPLIT_SHIFT)
    return TP.ldexp(hi.float() + TP.ldexp(lo.float(), shift), e)


def test_split_f16_exact_for_22_bit_mantissas_and_subnormals():
    """Every value of 22 significand bits comes back exactly, at any exponent the
    row's max allows, subnormal rows included (JAX flushes those to zero)."""
    rng = np.random.default_rng(1)
    ints = rng.integers(-(1 << 21), 1 << 21, (6, 64)).astype(np.float64)
    x = ints * 2.0 ** np.array([[-30], [0], [30], [-145], [-160], [104]])
    x32 = x.astype(np.float32)
    assert np.array_equal(x32.astype(np.float64)[:3], x[:3])      # 22 bits fit fp32
    hi, lo, e = TP.split_f16(torch.from_numpy(x32), axis=-1)
    np.testing.assert_array_equal(_reconstruct(hi, lo, e).numpy(), x32)
    tiny = np.finfo(np.float32).tiny
    assert np.abs(x32[3]).min() < tiny < np.abs(x32[3]).max()   # subnormals in a row
    assert int(e[4]) < -126 and bool((x32[4] != 0).any())       # a subnormal max
    assert float(TP.ldexp(torch.tensor([2.0 ** -140]), torch.tensor([200]))) == 2.0 ** 60


def _pdot_operands(exact, kind, rng):
    a = (rng.integers(-8, 9, (3, 16, 16)) if kind == "int"
         else rng.standard_normal((3, 16, 16))).astype(np.float32)
    b = (rng.integers(-8, 9, (3, 16, 16)) if kind == "int"
         else rng.standard_normal((3, 16, 16)) * 1e-3).astype(np.float32)
    if exact == "right":
        b = np.triu(np.ones((16, 16), np.float32))
    if exact == "left":
        a = np.tril(np.ones((16, 16), np.float32), -1)
    return a, b


@functools.lru_cache(maxsize=None)
def _jax_pdot(precision, exact):
    return jax.jit(lambda u, v: JP.pdot(u, v, acc=jnp.float32, precision=precision,
                                        exact=exact))


@pytest.mark.parametrize("kind", ["int", "random"])
@pytest.mark.parametrize("precision", TP.PRECISIONS)
@pytest.mark.parametrize("exact", ["right", "left", "none"])
def test_pdot_matches_jax(exact, precision, kind):
    a, b = _pdot_operands(exact, kind, np.random.default_rng(len(exact) + len(precision)))
    j = np.asarray(_jax_pdot(precision, exact)(a, b))
    t = TP.pdot(torch.from_numpy(a), torch.from_numpy(b), acc=torch.float32,
                precision=precision, exact=exact).numpy()
    assert t.dtype == np.float32 and t.shape == j.shape
    if kind == "int":
        np.testing.assert_array_equal(t, j)
        return
    scale = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
    exact64 = a.astype(np.float64) @ b.astype(np.float64)
    assert ulp.max_ulp(t, exact64, scale) <= ulp.ulp_bound(precision, 16)
    assert ulp.max_ulp(t, j.astype(np.float64), scale) <= _tight(16)
    if precision == "fast":                 # bf16 operands, not fp32 ones reordered
        h = TP.pdot(torch.from_numpy(a), torch.from_numpy(b), acc=torch.float32,
                    exact=exact).numpy()
        assert ulp.max_ulp(t, h.astype(np.float64), scale) > _tight(16)


def test_pdot_falls_through_for_data_that_is_not_fp32():
    a8 = torch.full((2, 8), 100, dtype=torch.int8)
    bf = torch.randn((2, 8), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    u = torch.ones((8, 8))
    for p in TP.PRECISIONS:
        assert TP.pdot(a8, a8.t(), acc=torch.int32, precision=p).tolist() == [[80000] * 2] * 2
        assert torch.equal(TP.pdot(bf, u.to(torch.bfloat16), acc=torch.float32, precision=p,
                                   exact="right"),
                           TP.pdot(bf, u.to(torch.bfloat16), acc=torch.float32))


# ---------------------------------------------------------------------------
# the scan family on the engine methods
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inputs(n):
    """JAX's precision sweep inputs (``tests/test_precision.py`` ``_cases``), and
    cumprod's multipliers near 1 (its ``test_cumprod_and_ssd_accept_precision``):
    a product that decays far below its tile's largest weight leaves the split's
    window, where the bound holds only at the end-of-scan scale."""
    rng = np.random.default_rng(n * 7 + 1)
    x = (rng.standard_normal(n) * np.exp(rng.standard_normal(n))).astype(np.float32)
    a = np.exp(-np.abs(rng.standard_normal(n))).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    starts = np.sort(rng.choice(n, size=max(1, n // 7), replace=False))
    starts[0] = 0
    ap = np.exp(rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, a, b, np.concatenate([starts, [n]]).astype(np.int32), ap


@functools.lru_cache(maxsize=None)
def _ssd_inputs():
    rng = np.random.default_rng(8)
    return (rng.standard_normal((2, 40, 3, 4)).astype(np.float32),
            (-np.abs(rng.standard_normal((2, 40, 3))) * 0.3).astype(np.float32),
            rng.standard_normal((2, 40, 3, 5)).astype(np.float32),
            rng.standard_normal((2, 40, 3, 5)).astype(np.float32))


def _linrec_forms(n):
    """cumprod's and segment_linear_scan's inputs as the one ``linear_scan`` each
    runs: ``b = [a_0, 0, …]`` from ``initial = 1``, and ``a`` zeroed at the
    segment starts (``initial = 0``)."""
    _, a, b, off, ap = _inputs(n)
    b1 = np.zeros(n, np.float32)
    b1[0] = ap[0]
    ac = a.copy()
    ac[off[:-1][off[:-1] < n]] = 0.0
    return {"linear_scan": (a, b), "cumprod": (ap, b1), "segment_linear_scan": (ac, b)}


@functools.lru_cache(maxsize=None)
def _refs(n):
    """Each op's fp64 reference and conditioning scale at length ``n``."""
    x, _, _, off, _ = _inputs(n)
    out = {"scan": (ulp.scan_ref(x), ulp.scan_scale(x)),
           "segment_scan": (ulp.segment_scan_ref(x, off), ulp.segment_scan_scale(x, off))}
    for op, (a, b) in _linrec_forms(n).items():
        out[op] = (ulp.linrec_ref(a, b), ulp.linrec_scale(a, b))
    return out


def _port(op, n, method, precision):
    x, a, b, off, ap = (torch.from_numpy(v) for v in _inputs(n))
    kw = dict(method=method, precision=precision, tile_s=TILE)
    return {"scan": lambda: scan(x, **kw),
            "segment_scan": lambda: segment_scan(x, off, **kw),
            "linear_scan": lambda: linear_scan(a, b, **kw),
            "cumprod": lambda: cumprod(ap, **kw),
            "segment_linear_scan": lambda: segment_linear_scan(a, b, off, **kw)}[op]().numpy()


def _jax_all(method, precision):
    """JAX's result of every op at n = 600, and of ``ssd_scan``.  One jitted
    ``linear_scan`` serves cumprod and segment_linear_scan too, on the inputs
    those reduce to (:func:`_linrec_forms`, the same arithmetic), so it
    compiles once."""
    x, _, _, off, _ = _inputs(600)
    kw = dict(method=method, precision=precision, tile_s=TILE)
    lin = jax.jit(lambda a, b: J.linear_scan(a, b, **kw))
    out = {"scan": jax.jit(lambda x: J.scan(x, **kw))(x),
           "segment_scan": jax.jit(lambda x, o: J.segment_scan(x, o, **kw))(x, off),
           "ssd_scan": jax.jit(lambda *t: jax_ssd_scan(*t, chunk=TILE, scan_method=method,
                                                       precision=precision))(*_ssd_inputs())}
    out.update({op: lin(a, b) for op, (a, b) in _linrec_forms(600).items()})
    return {k: np.asarray(v) for k, v in out.items()}


OPS = ("scan", "segment_scan", "linear_scan", "cumprod", "segment_linear_scan")
_BOUND_CASES = list(itertools.product(OPS, ENGINE, LOOSE, NS))


@pytest.mark.parametrize("op,method,precision,n", _BOUND_CASES,
                         ids=[f"{o}-{m}-{p}-n{n}" for o, m, p, n in _BOUND_CASES])
def test_within_the_precision_bound_of_fp64(op, method, precision, n):
    got = _port(op, n, method, precision)
    ref, scale = _refs(n)[op]
    err = ulp.ulp_error(got, ref, scale)
    assert_within_bound(UlpReport(op=op, method=method, precision=precision, n=n,
                                  max_ulp=float(err.max()), mean_ulp=float(err.mean())))
    if precision == "fast":
        hi = _port(op, n, method, "highest").astype(np.float64)
        assert ulp.max_ulp(got, hi, scale) > _tight(n)


def _ssd_port(method, precision):
    return ssd_scan(*(torch.from_numpy(v) for v in _ssd_inputs()), chunk=TILE,
                    scan_method=method, precision=precision).numpy()


@pytest.mark.parametrize("precision", LOOSE)
@pytest.mark.parametrize("method", ENGINE)
def test_ssd_scan_within_its_limit_of_fp64(method, precision):
    ref = ssd_scan_ref(*(torch.from_numpy(v).double() for v in _ssd_inputs())).numpy()
    got = _ssd_port(method, precision)
    assert np.abs(got - ref).max() <= SSD_REL[precision] * np.abs(ref).max()


@pytest.mark.parametrize("precision", LOOSE)
@pytest.mark.parametrize("method", ENGINE)
def test_within_twice_the_bound_of_jax_on_the_same_method(method, precision):
    """Within twice ``"highest"``'s bound of JAX, where ``"fast"`` lies further
    than that from ``"highest"``: the port rounds what JAX rounds (B1's row sums
    are a product too; the SSD's cross-chunk axis takes the rows' tile products
    on the CPU, not the column walk)."""
    want = _jax_all(method, precision)
    for op in OPS:
        got = _port(op, 600, method, precision)
        _, scale = _refs(600)[op]
        assert got.dtype == want[op].dtype and got.shape == want[op].shape
        e = ulp.max_ulp(got, want[op].astype(np.float64), scale)
        assert e <= _tight(600), (op, e)
        if precision == "fast":
            hi = _port(op, 600, method, "highest").astype(np.float64)
            assert ulp.max_ulp(got, hi, scale) > _tight(600), op
    y = _ssd_port(method, precision)
    top = np.abs(want["ssd_scan"]).max()
    assert np.abs(y - want["ssd_scan"]).max() <= 2 * SSD_REL["highest"] * top
    if precision == "fast":
        assert np.abs(y - _ssd_port(method, "highest")).max() > 2 * SSD_REL["highest"] * top


@pytest.mark.parametrize("precision", TP.PRECISIONS)
def test_integer_and_integer_valued_scans_exact(precision):
    rng = np.random.default_rng(7)
    xi = rng.integers(-100, 100, 300).astype(np.int32)
    xf = rng.integers(-3, 4, 300).astype(np.float32)
    ai = rng.integers(-1, 2, 300).astype(np.float32)
    off = np.asarray([0, 150, 150, 300], np.int32)
    kw = dict(precision=precision, tile_s=TILE)
    for method in ENGINE:
        for x in (xi, xf):
            t = torch.from_numpy(x)
            np.testing.assert_array_equal(scan(t, method=method, **kw).numpy(),
                                          np.cumsum(x, dtype=x.dtype))
            np.testing.assert_array_equal(segment_scan(t, off, method=method, **kw).numpy(),
                                          ulp.segment_scan_ref(x, off).astype(x.dtype))
        np.testing.assert_array_equal(
            linear_scan(torch.from_numpy(ai), torch.from_numpy(xf), method=method,
                        **kw).numpy(), ulp.linrec_ref(ai, xf))
        np.testing.assert_array_equal(
            cumprod(torch.from_numpy(ai[:40] + 1), method=method, **kw).numpy(),
            np.cumprod(ai[:40].astype(np.float64) + 1))


@pytest.mark.parametrize("precision", LOOSE)
@pytest.mark.parametrize("method", ENGINE)
def test_nonfinite_placement_as_under_highest(method, precision):
    """Non-finite values ride the split's high part, so NaN and ±inf land where
    ``"highest"`` puts them on the same method.  ``linear_scan``'s products are
    data×data: there a ``lo × inf`` cross term turns an inf of ``"highest"``
    into NaN (as in JAX); the non-finite elements are the same."""
    x = np.ones(48, np.float32)
    x[10], x[30] = np.inf, np.nan
    a = np.full(48, 0.5, np.float32)
    off = torch.tensor([0, 20, 48], dtype=torch.int32)
    t, ta = torch.from_numpy(x), torch.from_numpy(a)
    for name, call in (("scan", lambda p: scan(t, method=method, tile_s=4, precision=p)),
                       ("segment_scan", lambda p: segment_scan(t, off, method=method,
                                                               tile_s=4, precision=p)),
                       ("linear_scan", lambda p: linear_scan(ta, t, method=method, tile_s=4,
                                                             precision=p))):
        got, ref = call(precision).numpy(), call("highest").numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        assert not np.isfinite(got[30:]).any()
        if name == "linear_scan":
            assert np.isnan(got[np.isnan(ref)]).all()
        else:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
            np.testing.assert_array_equal(got[np.isinf(ref)], ref[np.isinf(ref)])


@pytest.mark.parametrize("precision", LOOSE)
@pytest.mark.parametrize("method", ENGINE)
def test_subnormal_inputs_held_to_fp64(method, precision):
    """The port keeps subnormals: a scan of them is within the bound of fp64 at
    the subnormal spacing, not the zeros of XLA's flush."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(256) * 1e-40).astype(np.float32)
    assert np.all(np.abs(x[x != 0]) < np.finfo(np.float32).tiny)
    got = scan(torch.from_numpy(x), method=method, tile_s=TILE, precision=precision).numpy()
    assert np.isfinite(got).all() and np.any(got != 0)
    err = ulp.ulp_error(got, ulp.scan_ref(x), ulp.scan_scale(x))
    assert_within_bound(UlpReport(op="scan", method=method, precision=precision, n=256,
                                  max_ulp=float(err.max()), mean_ulp=float(err.mean())))


def test_port_ulp_oracle_equals_jax():
    x, a, b, off, _ = _inputs(97)
    for name in ("scan_ref", "scan_scale"):
        np.testing.assert_array_equal(getattr(port_ulp, name)(x), getattr(ulp, name)(x))
    for name in ("linrec_ref", "linrec_scale"):
        np.testing.assert_array_equal(getattr(port_ulp, name)(a, b),
                                      getattr(ulp, name)(a, b))
    for name in ("segment_scan_ref", "segment_scan_scale"):
        np.testing.assert_array_equal(getattr(port_ulp, name)(x, off),
                                      getattr(ulp, name)(x, off))
    for p in TP.PRECISIONS:
        assert port_ulp.ulp_bound(p, 97) == ulp.ulp_bound(p, 97)


# ---------------------------------------------------------------------------
# the distributed entry points: a gloo world of 2 on the CPU
# ---------------------------------------------------------------------------

def _dist_cases():
    rng = np.random.default_rng(12)
    a = rng.uniform(0.8, 1.0, (2, 300)).astype(np.float32)
    b = rng.standard_normal((2, 300)).astype(np.float32)
    ai = rng.integers(-1, 2, (2, 300)).astype(np.float32)
    bi = rng.integers(-3, 4, (2, 300)).astype(np.float32)
    x = (rng.standard_normal((2, 97)) * np.exp(rng.standard_normal((2, 97)))).astype(
        np.float32)
    xi = rng.integers(-3, 4, (2, 97)).astype(np.float32)
    off = [0, 5, 5, 40, 41, 90, 97]
    cases = []
    for p, m in itertools.product(LOOSE, ENGINE):
        kw = dict(method=m, precision=p, tile_s=TILE)
        cases += [dict(id=f"linrec-{p}-{m}", op="linrec", a=a, b=b, dtype="float32", kw=kw),
                  dict(id=f"linrec_int-{p}-{m}", op="linrec", a=ai, b=bi, dtype="float32",
                       kw=kw),
                  dict(id=f"segscan-{p}-{m}", op="segscan", x=x, dtype="float32",
                       offsets=off, kw=kw),
                  dict(id=f"segscan_int-{p}-{m}", op="segscan", x=xi, dtype="float32",
                       offsets=off, kw=kw)]
    return cases


@pytest.fixture(scope="module")
def dist_world(tmp_path_factory):
    import os

    from repro_torch.launch.world import run_world
    cases = _dist_cases()
    ranks = run_world("torch_dist_worlds:run_world_cases", 2, dict(cases=cases),
                      workdir=tmp_path_factory.mktemp("dist_precision"), timeout=240,
                      pythonpath=[os.path.dirname(__file__)])
    return {c["id"]: c for c in cases}, ranks


def _dist_composed(c, precision, ref):
    """What ``dist_linear_scan`` / ``dist_segment_scan`` at D = 2 compute, from
    single-process calls on each rank's shard at ``precision``: rank 1's local
    recurrence plus the carry (the fp64 state entering it) times its ``cumprod``;
    rank 1's local segmented scan (its zero-padded shard, the clipped offsets)
    plus rank 0's last value before its first segment start."""
    kw = dict(c["kw"], precision=precision)
    if c["op"] == "linrec":
        a, b = torch.from_numpy(c["a"]), torch.from_numpy(c["b"])
        L = -(-a.shape[-1] // 2)
        y0 = linear_scan(a[:, :L], b[:, :L], **kw)
        carry = torch.from_numpy(ref[:, L - 1:L]).float()
        y1 = linear_scan(a[:, L:], b[:, L:], **kw) + carry * cumprod(a[:, L:], **kw)
        return torch.cat([y0, y1], -1).numpy()
    x = torch.from_numpy(c["x"])
    n = x.shape[-1]
    L = -(-n // 2)
    off = torch.tensor(c["offsets"], dtype=torch.int32)
    off[-1] = 2 * L
    y0 = segment_scan(x[:, :L], torch.clamp(off, 0, L), **kw)
    x1 = torch.nn.functional.pad(x[:, L:], (0, 2 * L - n))
    y1 = segment_scan(x1, torch.clamp(off - L, 0, L), **kw)
    first = int(min([o - L for o in c["offsets"][:-1] if L <= o < 2 * L] + [L]))
    y1[:, :first] += y0[:, -1:]
    return torch.cat([y0, y1[:, :n - L]], -1).numpy()


@pytest.mark.parametrize("precision", LOOSE)
@pytest.mark.parametrize("method", ENGINE)
def test_dist_linear_and_segment_scan_within_the_bound(dist_world, method, precision):
    """``dist_linear_scan`` and ``dist_segment_scan`` at D = 2: random fp32 within
    the precision's bound of fp64, within twice ``"highest"``'s of the same
    composition from single-process calls (:func:`_dist_composed`), and for
    ``"fast"`` further than that from its ``"highest"`` composition; integer-valued
    rows exact, both ranks the same, and the collectives those of the modeled
    call."""
    from repro_torch.analysis.collectives import modeled_dist_traffic
    cases, ranks = dist_world
    for op in ("linrec", "linrec_int", "segscan", "segscan_int"):
        c = cases[f"{op}-{precision}-{method}"]
        got = ranks[0]["cases"][c["id"]]["out"][0]
        assert np.array_equal(got, ranks[1]["cases"][c["id"]]["out"][0])
        if op.startswith("linrec"):
            ref, scale = ulp.linrec_ref(c["a"], c["b"]), ulp.linrec_scale(c["a"], c["b"])
            model = modeled_dist_traffic("dist_linear_scan", d=2, n=300, batch=2, itemsize=4)
        else:
            ref = np.stack([ulp.segment_scan_ref(r, c["offsets"]) for r in c["x"]])
            scale = ulp.segment_scan_scale(c["x"], c["offsets"])
            model = modeled_dist_traffic("dist_segment_scan", d=2, n=97, batch=2, itemsize=4)
        if op.endswith("_int"):
            np.testing.assert_array_equal(got, ref)
        else:
            n = got.shape[-1]
            assert ulp.max_ulp(got, ref, scale) <= ulp.ulp_bound(precision, n)
            local = _dist_composed(c, precision, ref).astype(np.float64)
            assert ulp.max_ulp(got, local, scale) <= _tight(n), op
            if precision == "fast":
                hi = _dist_composed(c, "highest", ref).astype(np.float64)
                assert ulp.max_ulp(got, hi, scale) > _tight(n), op
        for r in ranks:
            counts = r["cases"][c["id"]]["counts"]
            assert {k: v for k, v in counts["calls"].items() if v} == model["counts_by_kind"]

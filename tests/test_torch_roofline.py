"""The port's roofline (``repro_torch.analysis.roofline``) against the JAX package.

JAX's dry run reads XLA's cost analysis; the port counts a step's ATen ops
under a ``TorchDispatchMode`` on ``"meta"``.  Here the port's product flops
of each of the ten SMOKE archs' train step (``loss`` and its backward, with
remat and the layers unrolled, as JAX's dry run lowers them), prefill and
decode step are held to the ``dot_general`` flops of ``jax.make_jaxpr`` of
JAX's same step (2 · every lhs element · the rhs's free dims, summed through
sub-jaxprs, a ``scan`` body times its length), on the same parameter shapes.
Where the two packages form different products, each is named in
:func:`_named` with its closed form, and the difference must be their sum,
exactly.

Also: the counter on ``"cpu"`` and on ``"meta"`` counts a step alike; a GEMM
plus an add counts its closed form; each of the kernels' 20 wrapper functions
records its operands' and results' bytes on ``"meta"``, returns the card's
shapes and launches nothing; the loop rule equals stepping through the loop;
each collective's wire bytes are JAX's ``parse_collectives`` factors; and the
dry run's records on the DEBUG grids carry JAX's roofline keys, with
``hbm_bytes`` at least the arguments and outputs where a step reads every
argument and writes every output.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)
from jax.extend import core as jcore

from repro.analysis import roofline as jax_roofline
from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro_torch.analysis import roofline as rl
from repro_torch.configs.base import SHAPES
from repro_torch.kernels import (_build, linrec_mm, ops, scan_mm, scan_pipeline, segscan_mm,
                                 split_mm, ssd_chunk)
from repro_torch.launch import dryrun
from repro_torch.models.model import ARCHS, build_model, get_config
from repro_torch.models.transformer import layer_pattern
from repro_torch.training import optimizer as opt_lib

B, S, CACHE = 2, 24, 32          # the SMOKE steps: prompt of S, caches of CACHE positions
META = torch.device("meta")


# ---------------------------------------------------------------------------
# JAX's product flops
# ---------------------------------------------------------------------------


def _dot_flops(jaxpr) -> int:
    """``dot_general`` flops of a jaxpr: 2 · lhs elements · rhs free dims, summed
    through every sub-jaxpr (``pjit``, ``remat``, ``custom_vjp``), a ``scan``
    body times its length."""
    total = 0
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            (_, rc), (_, rb) = e.params["dimension_numbers"]
            lhs, rhs = e.invars[0].aval.shape, e.invars[1].aval.shape
            free = [d for i, d in enumerate(rhs) if i not in rc and i not in rb]
            total += 2 * math.prod(lhs) * math.prod(free)
        times = e.params.get("length", 1) if e.primitive.name == "scan" else 1
        for v in e.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else [v]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    total += times * _dot_flops(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    total += times * _dot_flops(sub)
    return total


def _cfgs(arch, kind):
    """Both packages' SMOKE config: ``"matmul"`` scans, layers unrolled, remat
    on for the train step (JAX's dry run's step)."""
    over = dict(scan_method="matmul", scan_layers=False, remat=kind == "train")
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _meta(sds):
    return torch.empty(sds.shape, dtype=getattr(torch, str(sds.dtype)), device=META)


def _batch(jcfg):
    """The step's inputs as JAX shapes: tokens and the family's stub embeddings."""
    out = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if jcfg.family == "encdec":
        out["enc_embed"] = jax.ShapeDtypeStruct((B, jcfg.enc_len, jcfg.d_model), jnp.float32)
    if jcfg.family == "vlm":
        out["img_embed"] = jax.ShapeDtypeStruct((B, jcfg.n_img_tokens, jcfg.d_model),
                                                jnp.float32)
    return out


@functools.lru_cache(maxsize=None)
def _both_flops(arch, kind):
    """``(JAX's dot_general flops, the port's product flops)`` of one step, both
    on JAX's ``eval_shape`` parameter shapes (the port's as ``"meta"`` tensors)."""
    jcfg, pcfg = _cfgs(arch, kind)
    jm, pm = jax_build_model(jcfg), build_model(pcfg)
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    pp = jax.tree.map(_meta, jp)
    jb = _batch(jcfg)
    pb = {k: _meta(v) for k, v in jb.items()}
    if kind == "train":
        jx = jax.make_jaxpr(lambda p, b: jax.value_and_grad(jm.loss, has_aux=True)(p, b))(
            jp, jb)
        with rl.counting() as c:
            for t in opt_lib.tree_leaves(pp):
                t.requires_grad_(True)
            pm.loss(pp, pb)[0].backward()
    elif kind == "prefill":
        jx = jax.make_jaxpr(lambda p, b: jm.prefill(p, b, cache_len=CACHE))(jp, jb)
        with rl.counting() as c:
            pm.prefill(pp, pb, cache_len=CACHE)
    else:
        jc = jax.eval_shape(lambda: jm.empty_caches(B, CACHE))
        tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
        jx = jax.make_jaxpr(lambda p, t, c: jnp.argmax(
            jm.decode_step(p, t, c, jnp.asarray(S, jnp.int32))[0], -1))(jp, tok, jc)
        with rl.counting() as c:
            logits, _ = pm.decode_step(pp, torch.empty((B, 1), dtype=torch.int32,
                                                       device=META),
                                       pm.empty_caches(B, CACHE, device=META), S)
            torch.argmax(logits, -1)
    return _dot_flops(jx.jaxpr), c.flops


def _named(arch, kind) -> dict:
    """The products one package forms and the other does not, by name: JAX's
    flops minus the port's, each in closed form from the SMOKE config."""
    cfg = get_config(arch, smoke=True)
    d, out = cfg.d_model, {}
    if kind == "prefill":
        s_all = S + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
        # JAX's prefill forms every position's logits and keeps the last; the
        # port forms the last position's alone
        out["prefill logits before the last position"] = 2 * B * (s_all - 1) * d * \
            cfg.padded_vocab
    # JAX's remat recomputes every product of a group, the backward's reads and
    # no more (partial evaluation drops the dead ones); forward, recompute and
    # two cotangents make four passes over an SSD factor in a train step
    passes = 4 if kind == "train" else 1

    def ssd_factors(q, h, n, p):
        # ssd_scan's three-operand einsums: JAX multiplies the pair of operands
        # that share every index (scores·L, and the decay with the smaller of
        # the B/C and x/h factors) as a dot_general with no contraction; the
        # port multiplies them elementwise
        nc = -(-S // q)
        return passes * (2 * B * nc * h * q * q + 4 * B * nc * q * h * min(n, p))

    if cfg.ssm is not None:
        m = cfg.ssm
        if kind == "decode":
            # mamba_step's state update B_t ⊗ x_t: a dot_general in JAX, an
            # elementwise product in the port
            out["Mamba2 decode outer product"] = cfg.n_layers * 2 * B * m.n_heads * \
                m.d_state * m.head_dim
        else:
            out["SSD einsum factors (Mamba2)"] = cfg.n_layers * ssd_factors(
                min(m.chunk, S), m.n_heads, m.d_state, m.head_dim)
    if cfg.xlstm is not None:
        x = cfg.xlstm
        every = len(layer_pattern(cfg))
        n_m, n_s = cfg.n_layers * (every - 1) // every, cfg.n_layers // every
        hd_m = int(x.proj_factor * d) // x.n_heads
        hd_s = d // x.n_heads
        kv = 2 * B * x.n_heads * hd_m * hd_m       # one token's k ⊗ v (einsum in JAX)
        if kind == "decode":
            out["mLSTM decode k⊗v"] = n_m * kv
        else:
            q = min(128, S)
            out["SSD einsum factors (mLSTM, numerator and normaliser)"] = n_m * (
                ssd_factors(q, x.n_heads, hd_m, hd_m) + ssd_factors(q, x.n_heads, hd_m, 1))
        if kind == "prefill":
            out["mLSTM prefill replay k⊗v"] = n_m * S * kv
        if kind == "train":
            # JAX's lax.scan forms the cotangent of the initial h at step 0 too;
            # the port's h_0 is a constant, so its first step forms none
            out["sLSTM step-0 recurrent cotangent"] = n_s * 2 * B * x.n_heads * 4 * \
                hd_s * hd_s
    if cfg.moe is not None and cfg.moe.n_shared and kind == "train":
        m = cfg.moe
        # torch.utils.checkpoint recomputes a group up to its last saved tensor
        # (the load-balancing loss, after the shared expert), so the port's
        # recompute forms the shared expert's down projection, which JAX's
        # partial evaluation drops as dead
        out["remat recompute of the shared expert's down projection"] = -(
            (cfg.n_layers - m.first_k_dense) * 2 * B * S * m.n_shared * m.d_ff_expert * d)
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_product_flops_match_jax(arch, kind):
    jax_flops, port_flops = _both_flops(arch, kind)
    named = _named(arch, kind)
    assert jax_flops - port_flops == sum(named.values()), (jax_flops, port_flops, named)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def _smoke_step(arch, method, device):
    """A SMOKE train step (loss and backward) on ``device``: its Count."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), scan_method=method,
                              scan_layers=False)
    model = build_model(cfg)
    params = model.init(0, device=device)
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32, device=device)}
    with rl.counting() as c:
        for t in opt_lib.tree_leaves(params):
            t.requires_grad_(True)
        model.loss(params, batch)[0].backward()
    return c


@pytest.mark.parametrize("method", ["matmul", "vector"])
@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b"])
def test_cpu_and_meta_count_alike(arch, method):
    cpu, meta = _smoke_step(arch, method, "cpu"), _smoke_step(arch, method, "meta")
    assert cpu.flops > 0
    assert cpu.flops_by_dtype == meta.flops_by_dtype
    assert cpu.aten_bytes == meta.aten_bytes
    assert cpu.ops == meta.ops


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_gemm_plus_add_counts_its_closed_form(device):
    m, k, n = 48, 32, 24
    a = torch.ones((m, k), device=device)
    w = torch.ones((n, k), device=device)
    bias = torch.ones((n,), device=device)
    with rl.counting() as c:
        y = a @ w.t() + bias                      # w.t() is a view: free
        y.view(n, m).t()                          # views: free
    assert c.flops_by_dtype == {"float32": 2 * m * k * n}
    # mm reads a and w and writes y; the add reads y and bias (once: broadcast)
    # and writes its output
    assert c.aten_bytes == 4 * (m * k + n * k + m * n) + 4 * (m * n + n + m * n)
    assert c.kernels == {}


def test_indexed_reads_and_writes_count_what_they_touch():
    table = torch.empty((1000, 64), device=META)
    idx = torch.empty((7,), dtype=torch.int64, device=META)
    cache = torch.empty((4, 512, 8), device=META)
    row = torch.empty((4, 1, 8), device=META)
    with rl.counting() as c:
        table[idx]                                # 7 rows read, 7 rows written
    assert c.aten_bytes == 2 * 7 * 64 * 4 + 7 * 8
    with rl.counting() as c:
        cache[:, 100:101] = row                   # one position a row written
    assert c.aten_bytes == 2 * 4 * 8 * 4


# ---------------------------------------------------------------------------
# the kernels' wrappers on "meta"
# ---------------------------------------------------------------------------


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


# name -> (kernel, wrapper, CPU args): each wrapper's tensors are read as given
WRAPPERS = {
    "scan_tiles": ("scan_mm", scan_mm.scan_tiles, lambda: (_t(4, 5000),)),
    "block_partial_sums": ("block_sums", scan_pipeline.block_partial_sums,
                           lambda: (_t(4, 3, 8, 8),)),
    "carry_scan": ("carry_scan", scan_pipeline.carry_scan, lambda: (_t(4, 3),)),
    "block_sums_carries": ("block_sums", scan_pipeline.block_sums_carries,
                           lambda: (_t(4, 3, 8, 8),)),
    "block_scan_carry": ("block_scan", scan_pipeline.block_scan_carry,
                         lambda: (_t(4, 3, 8, 8), _t(4, 3))),
    "blocked_scan": ("block_sums", scan_pipeline.blocked_scan, lambda: (_t(4, 5000),)),
    "split_tiles": ("split", split_mm.split_tiles,
                    lambda: (_t(4, 5000), _t(4, 5000, dtype=torch.bool))),
    "multi_split_tiles": ("multi_split",
                          lambda x, d: split_mm.multi_split_tiles(x, d, num_buckets=16),
                          lambda: (_t(4, 5000), _t(4, 5000, dtype=torch.int32))),
    "radix_pass_multibit": ("radix_pass",
                            lambda w, p: split_mm.radix_pass_multibit(w, p, shift=0,
                                                                      pass_bits=4),
                            lambda: (_t(4, 5000, dtype=torch.int32),
                                     _t(4, 5000, dtype=torch.int32))),
    "radix_pass_multibit(with_counts)": (
        "radix_pass_hist",
        lambda w, p: split_mm.radix_pass_multibit(w, p, shift=0, pass_bits=4,
                                                  with_counts=True),
        lambda: (_t(4, 5000, dtype=torch.int32), _t(4, 5000, dtype=torch.int32))),
    "topp_mask_sample_tiles": ("topp_tail",
                               lambda sp, u: split_mm.topp_mask_sample_tiles(sp, u, p=0.9),
                               lambda: (_t(4, 5000), _t(4, 1))),
    "seg_scan_tiles": ("seg_scan", segscan_mm.seg_scan_tiles,
                       lambda: (_t(4, 5000), _t(4, 5000, dtype=torch.uint8))),
    "seg_block_summaries": ("seg_summaries", segscan_mm.seg_block_summaries,
                            lambda: (_t(4, 3, 8, 8), _t(4, 3, 8, 8, dtype=torch.uint8))),
    "seg_carry_scan": ("seg_carry", segscan_mm.seg_carry_scan,
                       lambda: (_t(4, 3), _t(4, 3, dtype=torch.int32))),
    "seg_block_scan_carry": ("seg_block_scan", segscan_mm.seg_block_scan_carry,
                             lambda: (_t(4, 3, 8, 8), _t(4, 3, 8, 8, dtype=torch.uint8),
                                      _t(4, 3))),
    "linrec_columns": ("linrec_scan", lambda a, b: linrec_mm.linrec_columns(a, b, 1),
                       lambda: (_t(4, 16, 8), _t(4, 16, 8))),
    "linrec_scan_tiles": ("linrec_scan", linrec_mm.linrec_scan_tiles,
                          lambda: (_t(4, 5000), _t(4, 5000))),
    "linrec_block_summaries": ("linrec_summaries", linrec_mm.linrec_block_summaries,
                               lambda: (_t(4, 3, 8, 8), _t(4, 3, 8, 8))),
    "linrec_carry_scan": ("linrec_carry", linrec_mm.linrec_carry_scan,
                          lambda: (_t(4, 3), _t(4, 3))),
    "linrec_summaries_carries": ("linrec_summaries", linrec_mm.linrec_summaries_carries,
                                 lambda: (_t(4, 3, 8, 8), _t(4, 3, 8, 8))),
    "linrec_block_scan_carry": ("linrec_block_scan", linrec_mm.linrec_block_scan_carry,
                                lambda: (_t(4, 3, 8, 8), _t(4, 3, 8, 8), _t(4, 3))),
    "ssd_chunk_scan": ("ssd_chunk", lambda x, a, b, c: ssd_chunk.ssd_chunk_scan(x, a, b, c,
                                                                               chunk=8),
                       lambda: (_t(2, 20, 3, 4), _t(2, 20, 3), _t(2, 20, 3, 5),
                                _t(2, 20, 3, 5))),
}


def _nbytes(tree):
    ts = tree if isinstance(tree, (tuple, list)) else (tree,)
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("name", [n for n in WRAPPERS if n != "blocked_scan"])
def test_wrapper_on_meta_records_its_bytes_and_launches_nothing(name):
    kernel, fn, make = WRAPPERS[name]
    args = make()
    want = fn(*args)                              # the plain version: the card's shapes
    ops.reset_launch_counts()
    with rl.counting() as c:
        got = fn(*(a.to(META) for a in args))
    wants = want if isinstance(want, tuple) else (want,)
    gots = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in gots] == \
        [(tuple(t.shape), t.dtype) for t in wants]
    assert all(t.is_meta for t in gots)
    assert c.kernels == {kernel: {"calls": 1, "bytes": float(_nbytes(args) + _nbytes(want))}}
    assert not any(_build.LAUNCHES.values())


# PERF.md's kernel table: each kernel at the table's shape (fp32 rows of
# (4, 2^24) cut into 128 blocks of 8 tiles of 128², the sampler's (4, 128256),
# B7h's (4, 2^22), B3/B11/B15's (4, 128) summaries, zamba2's forward for B17)
# -> (its wrapper on meta tensors, the bytes the table's bound counts)
_R, _BL = (4, 1 << 24), (4, 128, 1024, 128)
_F32, _U8, _I32, _I16 = torch.float32, torch.uint8, torch.int32, torch.int16
TABLE = {
    "B1": (lambda: scan_mm.scan_tiles(_m(_R)), 2 * 4 * (1 << 26)),
    "B2": (lambda: scan_pipeline.block_partial_sums(_m(_BL)), 4 * (1 << 26) + 4 * 512),
    "B3": (lambda: scan_pipeline.carry_scan(_m((4, 128))), 2 * 4 * 512),
    "B4": (lambda: scan_pipeline.block_scan_carry(_m(_BL), _m((4, 128))),
           2 * 4 * (1 << 26) + 4 * 512),
    "B5": (lambda: split_mm.split_tiles(_m(_R), _m(_R, torch.bool)),
           (4 + 1 + 4 + 4) * (1 << 26) + 4 * 4),
    "B6": (lambda: split_mm.multi_split_tiles(_m(_R), _m(_R, _I32), num_buckets=16),
           16 * (1 << 26) + 4 * 64),
    "B7": (lambda: split_mm.radix_pass_multibit(_m((4, 128256), _I16), _m((4, 128256), _I32),
                                                shift=0, pass_bits=4),
           2 * (2 + 4) * 4 * 128256),
    "B7h": (lambda: split_mm.radix_pass_multibit(_m((4, 1 << 22), _I32),
                                                 _m((4, 1 << 22), _I32), shift=0,
                                                 pass_bits=4, with_counts=True),
            16 * (1 << 24) + 4 * 64),
    "B8": (lambda: split_mm.topp_mask_sample_tiles(_m((4, 128256)), _m((4, 1)), p=0.9),
           4 * 4 * 128256 + 4 * 4 + 4 * 4),
    "B9": (lambda: segscan_mm.seg_scan_tiles(_m(_R), _m(_R, _U8)), 9 * (1 << 26)),
    "B10": (lambda: segscan_mm.seg_block_summaries(_m(_BL), _m(_BL, _U8)),
            5 * (1 << 26) + 8 * 512),
    "B11": (lambda: segscan_mm.seg_carry_scan(_m((4, 128)), _m((4, 128), _I32)), 12 * 512),
    "B12": (lambda: segscan_mm.seg_block_scan_carry(_m(_BL), _m(_BL, _U8), _m((4, 128))),
            9 * (1 << 26) + 4 * 512),
    "B13": (lambda: linrec_mm.linrec_scan_tiles(_m(_R), _m(_R)), 12 * (1 << 26)),
    "B14": (lambda: linrec_mm.linrec_block_summaries(_m(_BL), _m(_BL)),
            8 * (1 << 26) + 8 * 512),
    "B15": (lambda: linrec_mm.linrec_carry_scan(_m((4, 128)), _m((4, 128))), 12 * 512),
    "B16": (lambda: linrec_mm.linrec_block_scan_carry(_m(_BL), _m(_BL), _m((4, 128))),
            12 * (1 << 26) + 4 * 512),
    "B17": (lambda: ssd_chunk.ssd_chunk_scan(_m((4, 2048, 64, 64)), _m((4, 2048, 64)),
                                             _m((4, 2048, 64, 64)), _m((4, 2048, 64, 64))),
            4 * 4 * 2048 * 64 * (64 + 1 + 64 + 64 + 64)),
}


def _m(shape, dtype=_F32):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.mark.parametrize("kernel", list(TABLE))
def test_recorded_bytes_at_the_table_shapes(kernel):
    """Each kernel's recorded bytes at PERF.md's table shape: each operand read
    once and each result written once, the bytes its bound column counts (B10's
    bound counts the trailing segments' values alone, a data-dependent part of
    what the record counts: every value and flag)."""
    call, want = TABLE[kernel]
    with rl.counting() as c:
        call()
    (rec,) = c.kernels.values()
    assert rec == {"calls": 1, "bytes": float(want)}


def test_blocked_scan_on_meta_records_its_two_launches():
    """``blocked_scan`` launches B2 + B3 fused, then B4, on the card: both
    recorded on ``"meta"``, each with its operands and results."""
    x = torch.empty((4, 5000), device=META)
    ops.reset_launch_counts()
    with rl.counting() as c:
        y = scan_pipeline.blocked_scan(x, s=8, block_tiles=2)
    nb = -(-5000 // 128)
    sums = carries = 4 * nb * 4
    assert tuple(y.shape) == (4, 5000) and y.is_meta
    assert c.kernels == {"block_sums": {"calls": 1, "bytes": float(4 * 5000 * 4 + sums
                                                                    + carries)},
                         "block_scan": {"calls": 1, "bytes": float(2 * 4 * 5000 * 4
                                                                   + carries)}}
    assert not any(_build.LAUNCHES.values())


def test_auto_on_meta_plans_the_card_s_kernels():
    """``scan_method="auto"`` on ``"meta"`` resolves through the ``"cuda"``
    table: zamba2's SMOKE train step walks B16 three times a Mamba2 layer
    (forward, remat recompute, adjoint), as on the card, and launches nothing."""
    cfg = dataclasses.replace(get_config("zamba2-1.2b", smoke=True), scan_method="auto",
                              remat=True, scan_layers=False)
    model = build_model(cfg)
    params = model.init(device=META)
    ops.reset_launch_counts()
    with rl.counting() as c:
        for t in opt_lib.tree_leaves(params):
            t.requires_grad_(True)
        model.loss(params, {"tokens": torch.empty((B, S), dtype=torch.int32,
                                                  device=META)})[0].backward()
    assert set(c.kernels) == {"linrec_block_scan"}
    assert c.kernels["linrec_block_scan"]["calls"] == 3 * cfg.n_layers
    assert not any(_build.LAUNCHES.values())


# ---------------------------------------------------------------------------
# loops over time
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_loop_rule_equals_stepping(kind):
    """xlstm's sLSTM scan and mLSTM prefill replay counted on ``"meta"`` under the
    loop rule (one step, or three under autograd, scaled) and stepped through on
    the CPU: equal."""
    cfg = dataclasses.replace(get_config("xlstm-350m", smoke=True), scan_method="matmul",
                              remat=True, scan_layers=False)
    model = build_model(cfg)

    def count(device):
        params = model.init(0, device=device)
        tokens = torch.zeros((B, S if kind != "decode" else 1), dtype=torch.int32,
                             device=device)
        with rl.counting() as c:
            if kind == "train":
                for t in opt_lib.tree_leaves(params):
                    t.requires_grad_(True)
                model.loss(params, {"tokens": tokens})[0].backward()
            elif kind == "prefill":
                model.prefill(params, {"tokens": tokens}, cache_len=CACHE)
            else:
                model.decode_step(params, tokens, model.empty_caches(B, CACHE, device=device),
                                  S)
        return c

    rule, stepped = count("meta"), count("cpu")
    assert rule.flops > 0
    assert rule.flops_by_dtype == stepped.flops_by_dtype
    assert rule.aten_bytes == stepped.aten_bytes
    assert rule.ops == stepped.ops
    assert rule.by_op["tanh.default"] == stepped.by_op["tanh.default"]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter",
                                  "all-to-all", "collective-permute"])
def test_wire_bytes_are_jax_s_factors(kind, group):
    ranks = ",".join(str(i) for i in range(group))
    hlo = (f"  %{kind}.3 = f32[64,32]{{1,0}} {kind}(f32[64,32]{{1,0}} %x), "
           f"replica_groups={{{{{ranks}}}}}")
    (parsed,) = jax_roofline.parse_collectives(hlo)
    assert parsed["group"] == group
    assert rl.wire_bytes(kind.replace("-", "_"), parsed["result_bytes"], group) == \
        parsed["wire_bytes"]


def test_analyze_sums_the_terms():
    count = rl.Count(flops_by_dtype={"bfloat16": 989e12, "float32": 67e12},
                     aten_bytes=3.35e12,
                     kernels={"linrec_block_scan": {"calls": 1, "bytes": 3.35e12}})
    roof = rl.analyze(count, [("all_reduce", "f32[8]", 450e9, 2)])
    assert roof.compute_s == pytest.approx(2.0)
    assert roof.memory_s == pytest.approx(2.0)
    assert roof.collective_s == pytest.approx(1.0)
    assert roof.kernel_bytes == 3.35e12 and roof.n_collectives == 1
    assert roof.bottleneck in ("compute", "memory")


# ---------------------------------------------------------------------------
# the dry run's records
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _debug_records():
    recs = []
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh_kind in ("single", "multi"):
                try:
                    recs.append(dryrun.run_cell(arch, shape, mesh_kind, debug=True))
                except dryrun.SkipCell:
                    pass
    return recs


def test_debug_grid_records_carry_jax_s_roofline_keys():
    keys = {f.name for f in dataclasses.fields(jax_roofline.Roofline)}
    recs = _debug_records()
    assert len(recs) > 40
    for r in recs:
        assert keys | {"flops_by_dtype", "kernel_bytes"} == set(r["roofline"]), r["arch"]
        assert r["useful_fraction"] is not None and r["useful_fraction"] > 0
        assert r["roofline"]["flops"] > 0 and r["roofline"]["bottleneck"] in (
            "compute", "memory", "collective")


def test_dense_and_hybrid_steps_move_their_arguments_and_outputs():
    """A dense or hybrid step reads every argument and writes every output (a
    MoE decode may read only its routed experts, so MoE archs are exempt)."""
    for r in _debug_records():
        if get_config(r["arch"]).moe is not None:
            continue
        by = r["bytes_per_device"]
        assert r["roofline"]["hbm_bytes"] >= by["arguments"] + by["output"], \
            (r["arch"], r["shape"], r["mesh"])

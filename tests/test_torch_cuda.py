"""The port's CUDA kernels against their plain versions, on the card.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

needs an NVIDIA GPU and ``nvcc``; the kernels are built at first use.  A CUDA
kernel has no CPU mode, so elsewhere every test here skips.  This file imports
neither JAX nor the JAX package: the machine with the card need not have them.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import pytest
import torch

from repro_torch.analysis.streams import DenseReplay, first_divergence, step_margin
from repro_torch.core import autotune, guards
from repro_torch.core.autotune import method_override
from repro_torch.core.linrec import cummax, cumprod, linear_scan
from repro_torch.core.primitives import (compress, multi_split, radix_sort, split,
                                         top_p_sample)
from repro_torch.core.scan import accum_dtype_for, scan
from repro_torch.core.segmented import (SegmentedBatch, segment_compress,
                                        segment_linear_scan, segment_scan)
from repro_torch.core.ssd import ssd_scan, ssd_scan_ref
from repro_torch.kernels import (_build, linrec_mm, lookback, ops, scan_mm, scan_pipeline,
                                 segscan_mm, split_mm, ssd_chunk)
from repro_torch.models import attention, mamba, moe
from repro_torch.models.model import build_model, get_config
from repro_torch.serving import paged_kv
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import ContinuousEngine, poisson_trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _counts(**want):
    """Every kernel's launch count: ``want``'s, 0 where it names none."""
    return {k: want.get(k, 0) for k in ops.KERNELS}


@pytest.mark.parametrize("n", [1, 100, 16387])
@pytest.mark.parametrize("s", [1, 8, 16, 100, 128])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.float32, torch.bfloat16])
def test_scan_tiles_kernel_matches_plain(dev, dtype, s, n):
    x = torch.randint(-100, 100, (3, n), generator=_gen(dev), device=dev)
    x = x.to(dtype) if not dtype.is_floating_point else (x % 7 - 3).to(dtype)
    for variant in ("scanu", "scanul1"):
        got = scan_mm.scan_tiles(x, s=s, variant=variant)
        want = scan_mm.scan_tiles_plain(x, s=s, variant=variant, acc=got.dtype)
        assert torch.equal(got, want)


# rows around the tile edge of the B7/B7h tile split, and several tiles
RADIX_ROWS = [1, 33, 5000, split_mm.RADIX_TILE - 1, split_mm.RADIX_TILE,
              split_mm.RADIX_TILE + 1, 3 * split_mm.RADIX_TILE + 17]


def _radix_keys(dev, word, b, n):
    """(b, n) random keys with runs of equal keys across every tile edge."""
    w = torch.randint(-(1 << 31), (1 << 31) - 1, (b, n), generator=_gen(dev), device=dev,
                      dtype=torch.int64).to(word)
    for edge in range(split_mm.RADIX_TILE, n, split_mm.RADIX_TILE):
        w[:, edge - 5:edge + 5] = w[:, edge - 5:edge - 4]
    return w


@pytest.mark.parametrize("b", [1, 2, 64])
@pytest.mark.parametrize("n", RADIX_ROWS)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("word", [torch.uint8, torch.int16, torch.int32])
def test_radix_pass_kernel_matches_plain(dev, word, k, n, b):
    bits = split_mm.KEY_DTYPES[word]
    w = _radix_keys(dev, word, b, n)
    perm = torch.randperm(n, generator=_gen(dev), device=dev).to(torch.int32)
    perm = perm.expand(b, n).contiguous()
    for shift in (0, bits - k):
        ops.reset_launch_counts()
        kw, kp = split_mm.radix_pass_multibit(w, perm, shift=shift, pass_bits=k)
        assert ops.launch_counts() == _counts(radix_pass=1)
        pw, pp = split_mm.radix_pass_plain(w, perm, shift=shift, pass_bits=k)
        assert torch.equal(kw, pw) and torch.equal(kp, pp)


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("n", RADIX_ROWS + [70001])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("word", [torch.uint8, torch.int16, torch.int32])
def test_radix_pass_hist_kernel_matches_plain(dev, word, k, n, b):
    """B7h: keys, permutation and histogram exact; the histogram counts the row's
    own keys (the ragged end is masked, nothing padded) and equals a bincount."""
    bits = split_mm.KEY_DTYPES[word]
    w = _radix_keys(dev, word, b, n)
    perm = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n).contiguous()
    for shift in sorted({0, (bits - k) // 2, bits - k}):
        ops.reset_launch_counts()
        kw, kp, kc = split_mm.radix_pass_multibit(w, perm, shift=shift, pass_bits=k,
                                                  with_counts=True)
        assert ops.launch_counts() == _counts(radix_pass_hist=1)
        pw, pp, pc = split_mm.radix_pass_plain(w, perm, shift=shift, pass_bits=k,
                                               with_counts=True)
        assert torch.equal(kw, pw) and torch.equal(kp, pp) and torch.equal(kc, pc)
        digits = ((w.to(torch.int64) >> shift) & ((1 << k) - 1))
        rows = torch.arange(b, device=dev)[:, None] << k
        hist = torch.bincount((digits + rows).reshape(-1), minlength=b << k)
        assert torch.equal(kc.long(), hist.reshape(b, 1 << k))


@pytest.mark.parametrize("n,k", [(300007, 8), (300007, 4), ((1 << 21) + 3, 4)])
@pytest.mark.parametrize("with_counts", [False, True])
def test_radix_pass_kernel_many_tiles(dev, n, k, with_counts):
    """Rows of many tiles: 74 a row, and 513 past 2^21 keys, more than the
    bucket-major scan's 256 threads take in one round."""
    w = _radix_keys(dev, torch.int32, 2, n)
    perm = torch.arange(n, dtype=torch.int32, device=dev).expand(2, n).contiguous()
    ops.reset_launch_counts()
    got = split_mm.radix_pass_multibit(w, perm, shift=8, pass_bits=k, with_counts=with_counts)
    assert ops.launch_counts() == _counts(**{"radix_pass_hist" if with_counts
                                             else "radix_pass": 1})
    want = split_mm.radix_pass_plain(w, perm, shift=8, pass_bits=k, with_counts=with_counts)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


@pytest.mark.parametrize("with_counts", [False, True])
def test_radix_pass_kernel_more_rows_than_a_grid(dev, with_counts):
    """More rows than a grid's y extent (65535): the entry point launches the rows
    in chunks; every row is a stable split of its own keys."""
    b, n, k = 70001, 7, 4
    w = torch.randint(0, 1 << 15, (b, n), generator=_gen(dev), device=dev).to(torch.int16)
    perm = torch.randperm(n, generator=_gen(dev), device=dev).to(torch.int32)
    perm = perm.expand(b, n).contiguous()
    ops.reset_launch_counts()
    got = split_mm.radix_pass_multibit(w, perm, shift=4, pass_bits=k, with_counts=with_counts)
    assert ops.launch_counts() == _counts(**{"radix_pass_hist" if with_counts
                                             else "radix_pass": 1})
    digits = (w.long() >> 4) & 15
    order = torch.sort(digits, dim=-1, stable=True).indices
    assert torch.equal(got[0], w.gather(1, order)) and torch.equal(got[1], perm.gather(1, order))
    if with_counts:
        rows = torch.arange(b, device=dev)[:, None] << k
        hist = torch.bincount((digits + rows).reshape(-1), minlength=b << k)
        assert torch.equal(got[2].long(), hist.reshape(b, 1 << k))


def test_radix_pass_kernel_unaligned_rows_and_repeats(dev):
    """Rows that start off a 16-byte boundary (an odd row length, a slice from the
    second row) take the element-wise loads; a second run gives the same bits."""
    base = _radix_keys(dev, torch.int16, 5, 3 * split_mm.RADIX_TILE + 17)
    for w in (base, base[1:]):
        n = w.shape[-1]
        perm = torch.arange(n, dtype=torch.int32, device=dev).expand(w.shape).contiguous()
        kw, kp, kc = split_mm.radix_pass_multibit(w, perm, shift=4, pass_bits=8,
                                                  with_counts=True)
        pw, pp, pc = split_mm.radix_pass_plain(w, perm, shift=4, pass_bits=8, with_counts=True)
        assert torch.equal(kw, pw) and torch.equal(kp, pp) and torch.equal(kc, pc)
        again = split_mm.radix_pass_multibit(w, perm, shift=4, pass_bits=8, with_counts=True)
        assert all(torch.equal(a, c) for a, c in zip(again, (kw, kp, kc)))


def test_radix_pass_hist_chain_sorts_int32_keys(dev):
    """The eight radix-16 passes of a 32-bit key sort, each on B7h."""
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (4, 100003), generator=_gen(dev),
                      device=dev, dtype=torch.int64).to(torch.int32)
    work = x ^ -(1 << 31)                                   # the sortable encoding
    perm = torch.arange(x.shape[-1], dtype=torch.int32, device=dev).expand(x.shape)
    perm = perm.contiguous()
    for shift in range(0, 32, 4):
        work, perm, counts = split_mm.radix_pass_multibit(work, perm, shift=shift,
                                                          pass_bits=4, with_counts=True)
        assert bool((counts.sum(-1) == x.shape[-1]).all())
    lv, li = torch.sort(x, dim=-1, stable=True)
    assert torch.equal(work ^ -(1 << 31), lv) and torch.equal(perm.long(), li)


def test_dist_sort_on_the_card_in_a_gloo_world(dev, tmp_path):
    """dist_sort(method="kernel") in a world of 2 ranks sharing the card: bit-equal
    to the local kernel sort, 8 B7h launches a rank and no B7."""
    import os

    from repro_torch.kernels import _build
    from repro_torch.launch.world import run_world

    _build.build_all()
    res = run_world("torch_dist_worlds:run_cuda_sort", 2, dict(n=100003, seed=3),
                    workdir=tmp_path, timeout=300, pythonpath=[os.path.dirname(__file__)])
    for r in res:
        assert r["equal"] and r["launches"] == _counts(radix_pass_hist=8)


def test_radix_sort_kernel_is_a_stable_sort(dev):
    x = torch.randn((3, 70001), generator=_gen(dev), device=dev).to(torch.bfloat16)
    v, i = radix_sort(x, descending=True, method="kernel")
    lv, li = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(v, lv) and torch.equal(i.long(), li)


def test_topp_tail_kernel_matches_plain_on_peaked_rows(dev):
    """Peaked rows keep every decision far outside the fp32 summation band."""
    logits = torch.zeros((6, 1000), device=dev)
    logits[:, :4] = torch.tensor([9.0, 8.0, 7.0, 6.0], device=dev)
    sp = torch.sort(torch.softmax(logits, -1), -1, descending=True).values
    u = torch.tensor([[0.05], [0.3], [0.6], [0.8], [0.95], [0.999]], device=dev)
    for p in (0.0, 0.5, 0.9, 1.0):
        got = split_mm.topp_mask_sample_tiles(sp, u, p=p)
        assert torch.equal(got, split_mm.topp_tail_plain(sp, u, p=p))


def _int_payload(dtype, shape, dev):
    x = torch.randint(-100, 100, shape, generator=_gen(dev), device=dev)
    return x.to(dtype) if not dtype.is_floating_point else (x % 7 - 3).to(dtype)


@pytest.mark.parametrize("s,block_tiles", [(8, 1), (16, 4), (100, 1), (128, 2)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.float32, torch.bfloat16])
def test_pipeline_kernels_match_plain(dev, dtype, s, block_tiles):
    """B2, B3 and B4 each against their plain versions on the same block view."""
    m, block_len, _ = scan_pipeline.block_geometry(1 << 30, s, block_tiles)
    blocks = _int_payload(dtype, (3, 5, m, s), dev)
    acc = accum_dtype_for(dtype)
    sums = scan_pipeline.block_partial_sums(blocks)
    assert torch.equal(sums, scan_pipeline.block_partial_sums_plain(blocks, acc))
    carries = scan_pipeline.carry_scan(sums)
    assert torch.equal(carries, scan_pipeline.carry_scan_plain(sums))
    for variant in ("scanu", "scanul1"):
        got = scan_pipeline.block_scan_carry(blocks, carries, variant=variant)
        want = scan_pipeline.block_scan_carry_plain(blocks, carries, variant=variant,
                                                    acc=acc)
        assert torch.equal(got, want)


_B2_DTYPES = [torch.int8, torch.uint8, torch.bool, torch.int16, torch.int32,
              torch.bfloat16, torch.float16, torch.float32]


def _b2_rows(dtype, shape, dev, seed=0):
    """Integer-valued rows of ``dtype`` (random normal for ``None``: fp32)."""
    g = _gen(dev, seed)
    if dtype is None:
        return torch.randn(shape, generator=g, device=dev)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g, device=dev) < 0.5
    lo, hi = {torch.int8: (-128, 128), torch.uint8: (0, 256),
              torch.int16: (-32768, 32768)}.get(dtype, (-1000, 1000))
    if dtype.is_floating_point:
        lo, hi = -8, 9
    return torch.randint(lo, hi, shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("n,s,block_tiles", [
    (1000, 128, 8),                                   # nb = 1
    (7, 1, 2),                                        # nb = 4 blocks of 2: rows share a CTA
    (16385, 128, 1),                                  # nb = 2, the second of 1 element
    (16384 + 3, 8, 2),                                # nb = 129, a ragged last block
    (300001, 128, 8),                                 # nb = 3, rows off 16-byte alignment
    (1 << 24, 16, 1),                                 # nb = 65536 blocks of 256
    (8191, 1, 3),                                     # blocks of 3 elements: scalars only
])
@pytest.mark.parametrize("dtype", _B2_DTYPES + [None], ids=lambda d: str(d)[6:] or "f32rand")
def test_fused_sums_and_carries_equal_b2_and_b3(dev, dtype, n, s, block_tiles):
    """The fused launch's sums are B2's bits and its carries B3's on those sums, at
    every dtype, on raw (b, n) rows whose starts are not 16-byte aligned; both
    equal the plain versions on integer inputs."""
    b = 1 if n == 1 << 24 else 3
    x = _b2_rows(dtype, (b, n), dev, seed=n)
    acc = accum_dtype_for(x.dtype)
    m, block_len, nb = scan_pipeline.block_geometry(n, s, block_tiles)
    xk, code = scan_mm.kernel_operand(x, acc, op="test")
    ops.reset_launch_counts()
    sums, carries = scan_pipeline._block_sums_carries_cuda(xk, code, acc, nb, block_len)
    assert ops.launch_counts() == _counts(block_sums=1)
    alone = scan_pipeline._block_sums_cuda(xk, code, acc, nb, block_len)
    assert torch.equal(sums, alone)
    assert torch.equal(carries, scan_pipeline._carry_scan_cuda(sums))
    if dtype is None:
        return
    pad = nb * block_len - n
    blocks = torch.nn.functional.pad(x.to(acc), (0, pad)).reshape(b, nb, m, s)
    want_s, want_c = scan_pipeline.block_sums_carries_plain(blocks, acc)
    assert torch.equal(sums, want_s) and torch.equal(carries, want_c)


@pytest.mark.parametrize("s,block_tiles", [(128, 8), (16, 1)])
def test_fused_sums_and_carries_are_deterministic(dev, s, block_tiles):
    """Five fp32 calls give the same bits, whichever CTA finished a row last."""
    x = torch.randn((4, 1 << 22), generator=_gen(dev, 7), device=dev)
    m, _, nb = scan_pipeline.block_geometry(x.shape[1], s, block_tiles)
    blocks = x.reshape(4, nb, m, s)
    first = scan_pipeline.block_sums_carries(blocks)
    assert torch.equal(first[0], scan_pipeline.block_partial_sums(blocks))
    for _ in range(5):
        again = scan_pipeline.block_sums_carries(blocks)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


@pytest.mark.parametrize("n", [1, 100, 16387, 300001])
@pytest.mark.parametrize("s,block_tiles", [(8, 1), (16, 2), (128, 8)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.float32, torch.bool])
def test_blocked_scan_kernels_match_cumsum(dev, dtype, s, block_tiles, n):
    """The unpadded kernel path, ragged rows included, against an exact cumsum."""
    x = _int_payload(torch.int32, (3, n), dev) > 0 if dtype == torch.bool else \
        _int_payload(dtype, (3, n), dev)
    for variant in ("scanu", "scanul1"):
        got = scan_pipeline.blocked_scan(x, s=s, block_tiles=block_tiles, variant=variant)
        want = torch.cumsum(x.to(got.dtype), -1, dtype=got.dtype)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 31, 33, 5000, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.bfloat16, torch.float32,
                                   torch.int64, torch.float64])
def test_split_kernel_matches_plain(dev, dtype, n):
    x = _int_payload(torch.int32, (4, n), dev).to(dtype)
    f = torch.rand((4, n), generator=_gen(dev), device=dev) < 0.5
    f[1] = True
    f[2] = False
    z, ind, cnt = split_mm.split_tiles(x, f)
    pz, pind, pcnt = split_mm.split_plain(x, f)
    assert torch.equal(z, pz) and torch.equal(ind, pind) and torch.equal(cnt, pcnt)
    order = torch.argsort((~f).to(torch.uint8), dim=-1, stable=True)
    assert torch.equal(ind.long(), order)


# ---- B5 as a tile split on two slots (tiles of split_mm.RADIX_TILE elements) ----

B5_EDGE_ROWS = [1, split_mm.RADIX_TILE - 1, split_mm.RADIX_TILE, split_mm.RADIX_TILE + 1,
                3 * split_mm.RADIX_TILE + 17]
_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _b5_hold(x, f):
    """One B5 launch, exact against its plain version and a stable argsort of the
    flags (any nonzero flag is true), n_true equal to the count of the flags."""
    ops.reset_launch_counts()
    z, ind, cnt = split_mm.split_tiles(x, f)
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(split=1)
    pz, pind, pcnt = split_mm.split_plain(x, f != 0)
    assert torch.equal(z, pz) and torch.equal(ind, pind) and torch.equal(cnt, pcnt)
    order = torch.argsort((f == 0).to(torch.uint8), dim=-1, stable=True)
    assert torch.equal(ind.long(), order) and torch.equal(z, torch.gather(x, -1, order))
    assert torch.equal(cnt.long(), (f != 0).sum(-1))


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("n", B5_EDGE_ROWS)
@pytest.mark.parametrize("word", sorted(_WORDS))
def test_split_tile_split_at_its_tile_edges(dev, word, n, b):
    """Rows ending before, at and after a tile edge, runs of one flag across
    every edge, an all-true and an all-false row, flags of 1, 2 and -1."""
    x = torch.randint(0, 1 << 7, (b, n), generator=_gen(dev), device=dev).to(_WORDS[word])
    x = x * 3 + torch.arange(n, device=dev).to(x.dtype)
    f = (torch.rand((b, n), generator=_gen(dev, 1), device=dev) < 0.5).to(torch.int8)
    f *= torch.tensor([1, 2, -1], dtype=torch.int8, device=dev)[
        torch.randint(0, 3, (b, n), generator=_gen(dev, 2), device=dev)]
    for edge in range(split_mm.RADIX_TILE, n, split_mm.RADIX_TILE):
        f[:, edge - 5:edge + 5] = f[:, edge - 5:edge - 4]
    if b > 1:
        f[1], f[2] = 1, 0
    _b5_hold(x, f)


@pytest.mark.parametrize("word", sorted(_WORDS))
def test_split_unaligned_payload_and_flags(dev, word):
    """A payload and flags that start one word and three bytes past an aligned
    address: the tile loads take the element path; exact, one launch."""
    b, n = 3, 2 * split_mm.RADIX_TILE + 5
    base = torch.randint(-100, 100, (b * n + 1,), generator=_gen(dev), device=dev)
    x = base.to(_WORDS[word])[1:].view(b, n)
    fb = torch.rand((b * n + 3,), generator=_gen(dev, 1), device=dev) < 0.3
    f = fb[3:].view(b, n)
    assert x.data_ptr() % 16 and f.data_ptr() % 16
    _b5_hold(x, f)


def test_split_more_rows_than_a_grid(dev):
    """70000 rows pass grid.y's 65535: the launch goes in chunks of rows."""
    x = torch.randint(-100, 100, (70000, 37), generator=_gen(dev), device=dev,
                      dtype=torch.int32)
    f = torch.rand(x.shape, generator=_gen(dev, 1), device=dev) < 0.5
    _b5_hold(x, f)


def test_split_is_deterministic(dev):
    x = torch.randn((4, 1 << 20), generator=_gen(dev), device=dev)
    f = torch.rand(x.shape, generator=_gen(dev, 1), device=dev) < 0.5
    first = split_mm.split_tiles(x, f)
    for _ in range(5):
        assert all(torch.equal(a, c) for a, c in zip(split_mm.split_tiles(x, f), first))


def test_pipeline_and_split_launch_counts(dev):
    x = torch.randn((4, 1 << 18), generator=_gen(dev), device=dev)
    ops.reset_launch_counts()
    scan(x, method="blocked", tile_s=16, block_tiles=8)          # 128 blocks per row
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(block_sums=1, block_scan=1)
    assert _build.LAUNCHES["block_sums_carries"] == 1
    ops.reset_launch_counts()
    scan_pipeline.carry_scan(torch.zeros((4, 128), device=dev))  # alone, B3 still launches
    assert ops.launch_counts() == _counts(carry_scan=1)
    ops.reset_launch_counts()
    scan(x, method="blocked", tile_s=128, block_tiles=16)        # one block per row
    assert ops.launch_counts()["block_scan"] == 1
    assert ops.launch_counts()["block_sums"] == ops.launch_counts()["carry_scan"] == 0
    ops.reset_launch_counts()
    m = x > 0
    v, k = compress(x, m, method="kernel")
    assert ops.launch_counts()["split"] == 1
    assert torch.equal(v, compress(x, m, method="vector")[0])
    assert torch.equal(split(x, m, method="blocked")[1], split(x, m, method="vector")[1])


def test_wrappers_count_launches_and_check_inputs(dev):
    ops.reset_launch_counts()
    x = torch.ones((2, 300), device=dev)[:, ::2]              # not contiguous
    assert torch.equal(scan_mm.scan_tiles(x, s=8)[:, -1].cpu(), torch.full((2,), 150.0))
    k = torch.zeros((2, 64), dtype=torch.int16, device=dev)
    ops.radix_sort_enc_kernel(k, bits=16, bits_per_pass=4)
    split_mm.topp_mask_sample_tiles(torch.full((2, 5), 0.2, device=dev),
                                    torch.full((2, 1), 0.5, device=dev), p=0.9)
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(scan_mm=1, radix_pass=4, topp_tail=1)
    with pytest.raises(TypeError):
        scan_mm.scan_tiles(torch.ones((2, 8), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        split_mm.radix_pass_multibit(k, torch.zeros((2, 64), dtype=torch.int32), shift=0,
                                     pass_bits=4)


def test_engine_topp_kernel_launches_per_step(dev):
    cfg = get_config("llama3-8b", smoke=True)
    params = build_model(cfg).init(0, device=dev)
    eng = ServeEngine(cfg, params, max_len=24, sampler="topp_kernel")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=_gen(dev), device=dev)
    u = torch.rand((5, 2), generator=_gen(dev), device=dev)
    ops.reset_launch_counts()
    out = eng.generate({"tokens": toks}, 5, uniforms=u)
    assert tuple(out.shape) == (2, 5)
    assert ops.launch_counts() == _counts(radix_pass=20, topp_tail=5)
    plain = ServeEngine(cfg, params, max_len=24, sampler="topp_scan")
    assert torch.equal(plain.generate({"tokens": toks}, 5, uniforms=u), out)
    logits = torch.randn((2, cfg.vocab_size), generator=_gen(dev), device=dev)
    assert torch.equal(top_p_sample(logits, temperature=0.0),
                       torch.argmax(logits, -1).to(torch.int32))


def test_engine_topp_blocked_launches_per_step(dev):
    """topp_blocked: 4 radix passes, the tail's prefix and the sample's CDF, each one
    B4 launch per sampled token; a SMOKE vocab is one block, so no B2 or B3."""
    cfg = get_config("llama3-8b", smoke=True)
    params = build_model(cfg).init(0, device=dev)
    eng = ServeEngine(cfg, params, max_len=24, sampler="topp_blocked")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=_gen(dev), device=dev)
    u = torch.rand((5, 2), generator=_gen(dev), device=dev)
    ops.reset_launch_counts()
    out = eng.generate({"tokens": toks}, 5, uniforms=u)
    assert tuple(out.shape) == (2, 5)
    counts = ops.launch_counts()
    assert counts["block_scan"] == 6 * 5
    assert counts["block_sums"] == counts["carry_scan"] == 0
    plain = ServeEngine(cfg, params, max_len=24, sampler="topp_scan")
    assert torch.equal(plain.generate({"tokens": toks}, 5, uniforms=u), out)


# ---- the segmented family (B9-B12) ----


def _seg_flags(kind, shape, dev):
    """Segment-start flags of a layout: random starts (some runs of empty-like
    adjacent starts), every element, none, only the first element, or values
    other than 1 (any nonzero byte starts a segment)."""
    if kind == "random":
        return (torch.rand(shape, generator=_gen(dev, 3), device=dev) < 0.01).to(torch.int8)
    if kind == "all":
        return torch.ones(shape, dtype=torch.int8, device=dev)
    f = torch.zeros(shape, dtype=torch.int8, device=dev)
    if kind == "first":
        f[..., 0] = 1
    if kind == "nonbool":
        f = (torch.rand(shape, generator=_gen(dev, 4), device=dev) < 0.02).to(torch.int8) * 3
    return f


def _seg_reference(x, f):
    """Exact int64 segmented scan of integer-valued ``x`` under nonzero ``f``."""
    x64 = x.to(torch.int64)
    full = torch.cumsum(x64, -1)
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device).expand(x.shape)
    start = torch.cummax(torch.where(f.expand(x.shape) != 0, pos, 0), -1).values
    base = torch.gather(full - x64, -1, start)
    return full - base


@pytest.mark.parametrize("n", [1, 100, 16387, 300001])
@pytest.mark.parametrize("flags", ["random", "all", "none", "first", "nonbool"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.float32, torch.bfloat16,
                                   torch.bool])
def test_seg_scan_kernel_matches_plain_and_reference(dev, dtype, flags, n):
    x = _int_payload(torch.int32, (3, n), dev) > 0 if dtype == torch.bool else \
        _int_payload(dtype, (3, n), dev)
    f = _seg_flags(flags, (3, n), dev)
    got = segscan_mm.seg_scan_tiles(x, f)
    plain = segscan_mm.seg_scan_tiles_plain(x, f != 0, s=16, acc=got.dtype)
    assert torch.equal(got, plain)
    assert torch.equal(got.to(torch.int64), _seg_reference(x, f))


def test_seg_scan_kernel_shares_one_row_of_flags(dev):
    """The sampler's one-hot scans: (16, n) int8 rows over one (n,) row of flags."""
    n = 50000
    x = (torch.rand((16, n), generator=_gen(dev), device=dev) < 0.1).to(torch.int8)
    f = _seg_flags("random", (n,), dev)
    got = segscan_mm.seg_scan_tiles(x, f)
    assert torch.equal(got, segscan_mm.seg_scan_tiles(x, f.expand(16, n).contiguous()))
    assert torch.equal(got.to(torch.int64), _seg_reference(x, f))


@pytest.mark.parametrize("s,block_tiles", [(8, 1), (16, 4), (100, 1), (128, 2)])
@pytest.mark.parametrize("flags", ["random", "all", "none", "nonbool"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.float32])
def test_seg_pipeline_kernels_match_plain(dev, dtype, flags, s, block_tiles):
    """B10, B11 and B12 each against their plain versions on the same block view."""
    m, _, _ = scan_pipeline.block_geometry(1 << 30, s, block_tiles)
    blocks = _int_payload(dtype, (3, 5, m, s), dev)
    fblocks = _seg_flags(flags, (3, 5, m, s), dev)
    acc = accum_dtype_for(dtype)
    ts, h = segscan_mm.seg_block_summaries(blocks, fblocks)
    pts, ph = segscan_mm.seg_block_summaries_plain(blocks, fblocks, acc)
    assert torch.equal(ts, pts) and torch.equal(h, ph)
    carries = segscan_mm.seg_carry_scan(ts, h)
    assert torch.equal(carries, segscan_mm.seg_carry_scan_plain(ts, h))
    got = segscan_mm.seg_block_scan_carry(blocks, fblocks, carries)
    assert torch.equal(got, segscan_mm.seg_block_scan_carry_plain(blocks, fblocks, carries,
                                                                  acc))


@pytest.mark.parametrize("nb", [1, 7, 8192, 70001])
def test_seg_carry_kernel_many_rounds(dev, nb):
    ts = torch.randint(-100, 100, (3, nb), generator=_gen(dev), device=dev,
                       dtype=torch.int32)
    h = (torch.rand((3, nb), generator=_gen(dev, 1), device=dev) < 0.001).to(torch.int32)
    got = segscan_mm.seg_carry_scan(ts, h)
    inc = _seg_reference(ts, h)
    want = torch.cat([torch.zeros_like(inc[:, :1]), inc[:, :-1]], -1)
    assert torch.equal(got.to(torch.int64), want)
    if nb <= 8192:
        assert torch.equal(got, segscan_mm.seg_carry_scan_plain(ts, h))


@pytest.mark.parametrize("n", [1, 100, 16387, 300001])
@pytest.mark.parametrize("s,block_tiles", [(8, 1), (16, 2), (128, 8)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.float32, torch.bool])
def test_seg_blocked_scan_kernels_match_reference(dev, dtype, s, block_tiles, n):
    """The unpadded kernel path, ragged rows included, against an exact segmented scan."""
    x = _int_payload(torch.int32, (3, n), dev) > 0 if dtype == torch.bool else \
        _int_payload(dtype, (3, n), dev)
    f = _seg_flags("random", (3, n), dev)
    got = segscan_mm.seg_blocked_scan(x, f, s=s, block_tiles=block_tiles)
    assert torch.equal(got.to(torch.int64), _seg_reference(x, f))


def test_seg_random_fp32_close_to_fp64(dev):
    """Random fp32: every kernel path within 16 ulp of the fp64 per-segment scan,
    the ulp taken at the running sum of |x| since the segment start."""
    n = 1 << 20
    x = torch.randn((2, n), generator=_gen(dev), device=dev)
    f = _seg_flags("random", (2, n), dev)
    full = torch.cumsum(x.double(), -1)
    pos = torch.arange(n, device=dev).expand(x.shape)
    start = torch.cummax(torch.where(f != 0, pos, 0), -1).values
    ref = full - torch.gather(full - x.double(), -1, start)
    absf = torch.cumsum(x.double().abs(), -1)
    scale = absf - torch.gather(absf - x.double().abs(), -1, start)
    sc = scale.float()
    ulp = torch.nextafter(sc, torch.full_like(sc, float("inf"))) - sc
    for got in (segscan_mm.seg_scan_tiles(x, f),
                segscan_mm.seg_blocked_scan(x, f, s=128, block_tiles=8),
                segscan_mm.seg_blocked_scan(x, f, s=16, block_tiles=1)):
        assert float(((got.double() - ref).abs() / ulp.double()).max()) <= 16.0


# ---- B10 as a walk from each block's end in 16-element runs (csrc/seg_summaries.cu) ----

B10_F32_ULP = 16.0                   # chip_smoke.py's B1_F32_ULP


def _b10_flags(layout, shape, dev):
    """Flags on each run's first or last element, none, all, each block's last
    element, or random values 1 to 3; ``block`` is the block length."""
    b, n, block = shape
    pos = torch.arange(n, device=dev).expand(b, n)
    run = segscan_mm.SEG_SUMMARIES_RUN
    f = {"run_first": lambda: pos % run == 0, "run_last": lambda: pos % run == run - 1,
         "none": lambda: torch.zeros((b, n), dtype=torch.bool, device=dev),
         "all": lambda: torch.ones((b, n), dtype=torch.bool, device=dev),
         "block_last": lambda: (pos % block == block - 1) | (pos == n - 1),
         "random": lambda: torch.rand((b, n), generator=_gen(dev, 5), device=dev) < 1e-3}
    f = f[layout]().to(torch.int8)
    if layout == "random":
        f *= torch.randint(1, 4, (b, n), generator=_gen(dev, 6), device=dev, dtype=torch.int8)
    return f


def _b10_hold(x, f, block_len):
    """One B10 launch on ``(b, n)`` rows cut into blocks of ``block_len`` (the
    ragged end and unaligned row starts handled in the kernel) and ``f`` per
    row or one ``(n,)`` row shared: has-boundary equal to the plain version's;
    the sums bit-equal to the fold in the kernel's order, and exact (integers)
    or within ``B10_F32_ULP`` of the fp64 trailing sum (fp32)."""
    b, n = x.shape
    nb = -(-n // block_len)
    acc = accum_dtype_for(x.dtype)
    xk, code = scan_mm.kernel_operand(x, acc, op="B10 test")
    fk, fstride = segscan_mm._flag_rows(f, x.shape)
    assert fstride == (0 if f.numel() == n else n)
    ops.reset_launch_counts()
    ts, h = segscan_mm._seg_summaries_cuda(xk, code, fk, fstride, acc, nb, block_len)
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(seg_summaries=1)
    pad = nb * block_len - n
    blocks = torch.nn.functional.pad(x, (0, pad)).reshape(b, nb, 1, block_len)
    fblocks = torch.nn.functional.pad((f != 0).expand(b, n), (0, pad)).reshape(
        b, nb, 1, block_len)
    fts, fh = segscan_mm.seg_block_summaries_plain(blocks, fblocks, acc, fold=True)
    pts, ph = segscan_mm.seg_block_summaries_plain(blocks, fblocks, acc)
    assert torch.equal(h, ph) and torch.equal(h, fh)
    assert torch.equal(ts, fts)
    if acc == torch.int32:
        assert torch.equal(ts, pts)
        return
    ref, _ = segscan_mm.seg_block_summaries_plain(blocks.double(), fblocks, torch.float64)
    scale, _ = segscan_mm.seg_block_summaries_plain(blocks.double().abs(), fblocks,
                                                    torch.float64)
    sc = scale.float().clamp(min=torch.finfo(torch.float32).tiny)
    ulp = (torch.nextafter(sc, torch.full_like(sc, float("inf"))) - sc).double()
    assert float(((ts.double() - ref).abs() / ulp).max()) <= B10_F32_ULP


@pytest.mark.parametrize("shared", [False, True], ids=["per_row", "shared"])
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("n", B5_EDGE_ROWS)
@pytest.mark.parametrize("block_len", [64, 2048, 16384])
def test_seg_summaries_at_run_and_block_edges(dev, block_len, n, b, shared):
    """Rows of 1, 4095, 4096, 4097 and 3·4096 + 17 (ragged last blocks, and row
    starts off 16-byte alignment), every flag layout, int8, int32, bf16,
    integer-valued and random fp32."""
    for layout in ("run_first", "run_last", "none", "all", "block_last", "random"):
        f = _b10_flags(layout, (1 if shared else b, n, block_len), dev)
        f = f[0] if shared else f
        for dtype in (torch.int8, torch.int32, torch.bfloat16, torch.float32):
            _b10_hold(_int_payload(dtype, (b, n), dev), f, block_len)
        _b10_hold(torch.randn((b, n), generator=_gen(dev, 7), device=dev), f, block_len)


def test_seg_summaries_fp32_is_deterministic(dev):
    """Random fp32 at the pipeline's geometry (s = 128, 8 tiles: 131072-element
    blocks): five calls give the same bits, those of the fold in the kernel's
    order."""
    n = 1 << 20
    x = torch.randn((4, n), generator=_gen(dev), device=dev)
    f = (torch.rand((4, n), generator=_gen(dev, 1), device=dev) < 1e-5).to(torch.int8)
    m, block_len, nb = scan_pipeline.block_geometry(n, 128, 8)
    blocks, fblocks = x.reshape(4, nb, m, 128), f.reshape(4, nb, m, 128)
    first = segscan_mm.seg_block_summaries(blocks, fblocks)
    for _ in range(5):
        again = segscan_mm.seg_block_summaries(blocks, fblocks)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    fold = segscan_mm.seg_block_summaries_plain(blocks, fblocks, torch.float32, fold=True)
    assert torch.equal(first[0], fold[0]) and torch.equal(first[1], fold[1])
    _b10_hold(x, f, block_len)


# ---- B1 and B9 as single passes over many CTAs a row (csrc/lookback.cuh) ----


def _edge_rows(tile):
    return [1, tile - 1, tile, tile + 1, 3 * tile + 17]


def _ctas(call, tiles, dev):
    """The CTAs one launch ran: the tile counter at the end of its workspace."""
    ws = lookback.workspace(tiles, dev)
    call(ws)
    torch.cuda.synchronize()
    return int(ws[-1])


def _edge_flags(layout, b, n, dev):
    """Segments spanning tiles, a flag on each tile's first element, none, all,
    random, or one (n,) row of flags shared by the rows."""
    pos = torch.arange(n, device=dev)
    tile = segscan_mm.seg_scan_tile(1 << 20)
    f = {"spanning": lambda: (pos % 20000 == 0).expand(b, n),
         "tile_first": lambda: (pos % tile == 0).expand(b, n),
         "none": lambda: torch.zeros((b, n), dtype=torch.bool, device=dev),
         "all": lambda: torch.ones((b, n), dtype=torch.bool, device=dev),
         "random": lambda: torch.rand((b, n), generator=_gen(dev, 5), device=dev) < 1e-3,
         "shared": lambda: torch.rand((n,), generator=_gen(dev, 6), device=dev) < 1e-3}[layout]
    return f().to(torch.int8)


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("row", range(5))
@pytest.mark.parametrize("s", [8, 16, 128])
def test_scan_tiles_kernel_at_its_group_edges(dev, s, row, b):
    """Rows of 1, G - 1, G, G + 1 and 3 G + 17 elements, G = one CTA's group
    (16384 elements: one 128×128 tile, 64 of 16×16, 256 of 8×8), both variants,
    one launch each: exact against an int32 cumsum and the plain version."""
    n = _edge_rows(scan_mm.group_geometry(s, 1 << 24)[1])[row]
    x = torch.randint(-100, 100, (b, n), generator=_gen(dev), device=dev, dtype=torch.int32)
    for variant in ("scanu", "scanul1"):
        ops.reset_launch_counts()
        got = scan_mm.scan_tiles(x, s=s, variant=variant)
        torch.cuda.synchronize()
        assert ops.launch_counts() == _counts(scan_mm=1)
        assert torch.equal(got, torch.cumsum(x, -1, dtype=torch.int32))
        assert torch.equal(got, scan_mm.scan_tiles_plain(x, s=s, variant=variant,
                                                         acc=torch.int32))


@pytest.mark.parametrize("n", [300001, 1000003])
@pytest.mark.parametrize("s", [1, 8, 16, 128])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32, torch.bfloat16])
def test_scan_tiles_kernel_ragged_rows_many_groups(dev, dtype, s, n):
    x = _int_payload(dtype, (3, n), dev)
    for variant in ("scanu", "scanul1"):
        got = scan_mm.scan_tiles(x, s=s, variant=variant)
        assert torch.equal(got, scan_mm.scan_tiles_plain(x, s=s, variant=variant,
                                                         acc=got.dtype))


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("row", range(5))
@pytest.mark.parametrize("layout", ["spanning", "tile_first", "none", "all", "random",
                                    "shared"])
def test_seg_scan_kernel_at_its_tile_edges(dev, layout, row, b):
    """Rows of 1, T - 1, T, T + 1 and 3 T + 17 elements, T = B9's tile (8192),
    one launch each: exact against an int64 segmented scan and the plain version;
    ``shared`` reads one row of flags with a row stride of 0."""
    n = _edge_rows(segscan_mm.seg_scan_tile(1 << 20))[row]
    x = torch.randint(-1000, 1000, (b, n), generator=_gen(dev), device=dev,
                      dtype=torch.int32)
    f = _edge_flags(layout, b, n, dev)
    ops.reset_launch_counts()
    got = segscan_mm.seg_scan_tiles(x, f)
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(seg_scan=1)
    assert torch.equal(got.to(torch.int64), _seg_reference(x, f))
    assert torch.equal(got, segscan_mm.seg_scan_tiles_plain(x, f.expand(x.shape) != 0, s=16,
                                                            acc=torch.int32))


@pytest.mark.parametrize("rows", [1, 16])
def test_seg_scan_kernel_sampler_rows(dev, rows):
    """The topp_segmented sampler's one-hot scans: (rows, 4 × 128256) int8 over one
    row of flags at each vocabulary row's start (63 tiles a row)."""
    n = 4 * 128256
    x = (torch.randint(0, 16, (rows, n), generator=_gen(dev), device=dev) == 3).to(torch.int8)
    f = torch.zeros(n, dtype=torch.int8, device=dev)
    f[::128256] = 1
    got = segscan_mm.seg_scan_tiles(x, f)
    assert torch.equal(got, segscan_mm.seg_scan_tiles(x, f.expand(rows, n).contiguous()))
    assert torch.equal(got.to(torch.int64), _seg_reference(x, f))


def _ulp_err(got, ref64, scale64):
    sc = scale64.float()
    spacing = (torch.nextafter(sc, torch.full_like(sc, float("inf"))) - sc).double()
    return float(((got.double() - ref64).abs() / spacing).max())


@pytest.mark.parametrize("kernel", ["scan_mm s=128", "scan_mm s=16", "scan_mm s=8 scanu",
                                    "seg_scan"])
def test_single_pass_fp32_is_deterministic(dev, kernel):
    """Random fp32, five more calls bit-equal to the first (the look-back's fold
    does not depend on timing), within 16 ulp of the fp64 scan."""
    x = torch.randn((4, 1 << 22), generator=_gen(dev), device=dev)
    if kernel == "seg_scan":
        f = _seg_flags("random", x.shape, dev)
        call = lambda: segscan_mm.seg_scan_tiles(x, f)  # noqa: E731
        pos = torch.arange(x.shape[-1], device=dev).expand(x.shape)
        start = torch.cummax(torch.where(f != 0, pos, 0), -1).values
        full = torch.cumsum(x.double(), -1)
        ref = full - torch.gather(full - x.double(), -1, start)
        absf = torch.cumsum(x.double().abs(), -1)
        scale = absf - torch.gather(absf - x.double().abs(), -1, start)
    else:
        parts = kernel.split()
        s = int(parts[1][2:])
        variant = parts[2] if len(parts) > 2 else "scanul1"
        call = lambda: scan_mm.scan_tiles(x, s=s, variant=variant)  # noqa: E731
        ref, scale = torch.cumsum(x.double(), -1), torch.cumsum(x.double().abs(), -1)
    first = call()
    for _ in range(5):
        assert torch.equal(call(), first)
    assert _ulp_err(first, ref, scale) <= 16.0


@pytest.mark.parametrize("shape", [(1, 1 << 26), (64, 1 << 20)])
def test_single_pass_forward_progress(dev, shape):
    """Far more tiles than CTAs fit on the card at once (8192 of B9, 4096 of B1,
    against 528 and 264 resident): every launch ends, exact, one CTA a tile."""
    b, n = shape
    x = torch.randint(-3, 4, shape, generator=_gen(dev), device=dev, dtype=torch.int32)
    f = (torch.rand(shape, generator=_gen(dev, 1), device=dev) < 1e-6).to(torch.int8)
    for s in (16, 128):
        groups = b * scan_mm.group_geometry(s, n)[2]
        got = {}
        assert _ctas(lambda ws: got.setdefault("x", scan_mm._scan_tiles_cuda(
            x, s=s, variant="scanul1", acc=torch.int32, ws=ws)), groups, dev) == groups
        assert torch.equal(got["x"], torch.cumsum(x, -1, dtype=torch.int32))
    tiles = b * -(-n // segscan_mm.seg_scan_tile(n))
    got = {}
    assert _ctas(lambda ws: got.setdefault("x", segscan_mm._seg_scan_cuda(
        x, 6, f, n, torch.int32, ws=ws)), tiles, dev) == tiles
    assert torch.equal(got["x"].to(torch.int64), _seg_reference(x, f))


def test_single_pass_launch_geometry(dev):
    """At (4, 2^24) one launch of B1 runs 1024 CTAs a row and B9 2048."""
    x = torch.randn((4, 1 << 24), generator=_gen(dev), device=dev)
    f = _seg_flags("random", x.shape, dev)
    assert _ctas(lambda ws: scan_mm._scan_tiles_cuda(x, s=128, variant="scanul1",
                                                     acc=torch.float32, ws=ws),
                 4 * 1024, dev) == 4 * 1024
    assert _ctas(lambda ws: segscan_mm._seg_scan_cuda(x, 0, f, 1 << 24, torch.float32, ws=ws),
                 4 * 2048, dev) == 4 * 2048


def test_single_pass_under_cuda_graph(dev):
    """B1 and B9 captured in a CUDA graph (their workspace memset included) and
    replayed on new inputs give the eager results."""
    x = torch.randn((4, 1 << 20), generator=_gen(dev), device=dev)
    f = _seg_flags("random", x.shape, dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            scan_mm.scan_tiles(x, s=128)
            segscan_mm.seg_scan_tiles(x, f)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o1 = scan_mm.scan_tiles(x, s=128)
        o2 = segscan_mm.seg_scan_tiles(x, f)
    for seed in range(3):
        x.copy_(torch.randn(x.shape, generator=_gen(dev, 10 + seed), device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(o1, scan_mm.scan_tiles(x, s=128))
        assert torch.equal(o2, segscan_mm.seg_scan_tiles(x, f))


def test_seg_launch_counts(dev):
    x = torch.randint(0, 5, (1 << 18,), generator=_gen(dev), device=dev, dtype=torch.int32)
    off = torch.tensor([0, 1000, 1000, 90000, 1 << 18], device=dev)
    ops.reset_launch_counts()
    k = segment_scan(x, off, method="kernel")
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(seg_scan=1)
    ops.reset_launch_counts()
    b = segment_scan(x, off, method="blocked", tile_s=16, block_tiles=8)   # 128 blocks
    assert ops.launch_counts() == _counts(seg_summaries=1, seg_carry=1, seg_block_scan=1)
    ops.reset_launch_counts()
    b1 = segment_scan(x, off, method="blocked", tile_s=128, block_tiles=16)  # one block
    assert ops.launch_counts() == _counts(seg_block_scan=1)
    v = segment_scan(x, off, method="vector")
    assert torch.equal(k, v) and torch.equal(b, v) and torch.equal(b1, v)
    m = x > 2
    ops.reset_launch_counts()
    zk, ck = segment_compress(x, m, off, method="kernel")
    assert ops.launch_counts() == _counts(seg_scan=1)
    zv, cv = segment_compress(x, m, off, method="vector")
    assert torch.equal(zk, zv) and torch.equal(ck, cv)


def test_engine_topp_segmented_launches_per_step(dev):
    """topp_segmented: eight segmented scans per sampled token (the softmax's
    normaliser, four radix passes, cum, cdf and the count), one B9 launch each
    under method_override("kernel"); a SMOKE batch is one block, so the
    blocked run launches B12 alone."""
    cfg = get_config("llama3-8b", smoke=True)
    params = build_model(cfg).init(0, device=dev)
    eng = ServeEngine(cfg, params, max_len=24, sampler="topp_segmented")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=_gen(dev), device=dev)
    u = torch.rand((5, 2), generator=_gen(dev), device=dev)
    plain = ServeEngine(cfg, params, max_len=24, sampler="topp_scan")
    want = plain.generate({"tokens": toks}, 5, uniforms=u)
    for method, counts in (("kernel", _counts(seg_scan=40)),
                           ("blocked", _counts(seg_block_scan=40))):
        with method_override(method):
            ops.reset_launch_counts()
            out = eng.generate({"tokens": toks}, 5, uniforms=u)
            assert ops.launch_counts() == counts
        assert torch.equal(out, want)
    rows = SegmentedBatch.from_ragged([[0.0] * 300, [], [1.0, 9.0, 1.0]])
    rows = SegmentedBatch(rows.values.to(dev), rows.offsets.to(dev))
    with method_override("kernel"):
        got = eng.sample_packed(rows, u=torch.tensor([[0.5], [0.5], [0.5]], device=dev))
    assert got.tolist()[1:] == [0, 1]


# ---- the linear recurrences (B13-B16) ----


def _lin_pair(kind, shape, dev):
    """Integer-valued pairs (exact on every path), or gated fp32 with some zeros."""
    g = _gen(dev, 5)
    if kind == "int":
        return (torch.randint(-1, 2, shape, generator=g, device=dev).float(),
                torch.randint(-3, 4, shape, generator=g, device=dev).float())
    a = torch.exp(-torch.rand(shape, generator=g, device=dev) * 0.1)
    a = torch.where(torch.rand(shape, generator=g, device=dev) < 0.001, 0.0, a)
    return a, torch.randn(shape, generator=g, device=dev)


def _lin_ref(a, b):
    """The recurrence in fp64 by log-step doubling of the affine pairs."""
    av, bv = a.double(), b.double()
    d = 1
    while d < a.shape[-1]:
        bl = torch.nn.functional.pad(bv[..., :-d], (d, 0))
        al = torch.nn.functional.pad(av[..., :-d], (d, 0), value=1.0)
        bv, av = av * bl + bv, av * al
        d *= 2
    return bv


def _lin_hold(kind, got, plain, ref):
    if kind == "int":
        assert torch.equal(got, plain) and torch.equal(got.double(), ref)
    else:
        assert torch.allclose(got.double(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 16, 100, 2048, 2049, 16387, 300001])
@pytest.mark.parametrize("kind", ["int", "gated"])
def test_linrec_scan_kernel_matches_plain(dev, kind, n):
    """B13 on rows walked by one warp (n <= 2048) and by a whole CTA."""
    a, b = _lin_pair(kind, (3, n), dev)
    got = linrec_mm.linrec_scan_tiles(a, b, s=16)
    plain = linrec_mm.linrec_scan_tiles_plain(a, b, s=16, acc=torch.float32)
    _lin_hold(kind, got, plain, _lin_ref(a, b))


@pytest.mark.parametrize("s,block_tiles", [(8, 1), (16, 4), (128, 2)])
@pytest.mark.parametrize("kind", ["int", "gated"])
def test_linrec_pipeline_kernels_match_plain(dev, kind, s, block_tiles):
    """B14, B15 and B16 each against its plain version on the same block views."""
    n = 300001
    a, b = _lin_pair(kind, (2, n), dev)
    m, block_len, nb = scan_pipeline.block_geometry(n, s, block_tiles)
    pad = nb * block_len - n
    ab = torch.nn.functional.pad(a, (0, pad), value=1.0).reshape(2, nb, m, s)
    bb = torch.nn.functional.pad(b, (0, pad)).reshape(2, nb, m, s)
    prods, lasts = linrec_mm.linrec_block_summaries(ab, bb)
    pp, pl = linrec_mm.linrec_block_summaries_plain(ab, bb, torch.float32)
    carries = linrec_mm.linrec_carry_scan(pp, pl)
    pc = linrec_mm.linrec_carry_scan_plain(pp, pl)
    out = linrec_mm.linrec_block_scan_carry(ab, bb, pc)
    po = linrec_mm.linrec_block_scan_carry_plain(ab, bb, pc, torch.float32)
    if kind == "int":
        for got, want in ((prods, pp), (lasts, pl), (carries, pc), (out, po)):
            assert torch.equal(got, want)
    else:
        for got, want in ((prods, pp), (lasts, pl), (carries, pc), (out, po)):
            assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    whole = linrec_mm.linrec_blocked_scan(a, b, s=s, block_tiles=block_tiles)
    _lin_hold(kind, whole, po.reshape(2, -1)[:, :n], _lin_ref(a, b))


@pytest.mark.parametrize("nb", [1, 7, 8192, 70001])
def test_linrec_carry_kernel_many_rounds(dev, nb):
    p, lv = _lin_pair("int", (3, nb), dev)
    got = linrec_mm.linrec_carry_scan(p, lv)
    ref = torch.nn.functional.pad(_lin_ref(p, lv), (1, 0))[..., :-1]
    assert torch.equal(got.double(), ref)


def _bits(x, y):
    """Equal bit for bit, NaN payloads included."""
    return x.shape == y.shape and torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("rows,n,s,block_tiles", [
    (3, 2 * 64 - 5, 8, 1),              # nb = 2, ragged; CTAs of 32 play B15's 32
    (3, 3 * 64 - 17, 8, 1),             # nb = 3, ragged
    (4, 1 << 24, 128, 8),               # nb = 128, the default geometry: CTAs of 1024
    (3, 300 * 256 - 100, 16, 1),        # nb = 300, ragged: CTAs of 32 play B15's 64
    (1, 1 << 24, 16, 1),                # nb = 65536, one row: CTAs of 32 play B15's 1024
    (1, 9000 * 8192 - 3, 64, 2),        # nb = 9000, one ragged row: two rounds of 1024
])
@pytest.mark.parametrize("kind", ["int", "gated", "poison"])
def test_fused_linrec_summaries_and_carries_equal_b14_and_b15(dev, kind, rows, n, s,
                                                              block_tiles):
    """The fused launch's summaries are B14's bits and its carries B15's on those
    summaries, NaN and ±inf included, whichever CTA finishes a row last; integer
    pairs also equal the plain versions."""
    a, b = _lin_pair("gated" if kind == "poison" else kind, (rows, n), dev)
    if kind == "poison":                # a few ±inf and NaN in a and in b
        g = _gen(dev, 9)
        for t in (a, b):
            at = torch.randint(0, n, (rows, 3), generator=g, device=dev)
            t.scatter_(1, at, torch.tensor([float("inf"), -float("inf"), float("nan")],
                                           device=dev).expand(rows, 3))
    m, block_len, nb = scan_pipeline.block_geometry(n, s, block_tiles)
    ops.reset_launch_counts()
    prods, lasts, carries = linrec_mm._linrec_summaries_carries_cuda(a, b, nb, block_len)
    assert ops.launch_counts() == _counts(linrec_summaries=1)
    assert _build.LAUNCHES["linrec_summaries_carries"] == 1
    p1, l1 = linrec_mm._linrec_summaries_cuda(a, b, nb, block_len)
    assert _bits(prods, p1) and _bits(lasts, l1)
    assert _bits(carries, linrec_mm._linrec_carry_cuda(prods, lasts))
    if kind == "int":
        pad = nb * block_len - n
        ab = torch.nn.functional.pad(a, (0, pad), value=1.0).reshape(rows, nb, m, s)
        bb = torch.nn.functional.pad(b, (0, pad)).reshape(rows, nb, m, s)
        want = linrec_mm.linrec_summaries_carries_plain(ab, bb, torch.float32)
        assert all(torch.equal(got, w) for got, w in zip((prods, lasts, carries), want))


@pytest.mark.parametrize("s,block_tiles", [(128, 8), (16, 1)])
def test_fused_linrec_summaries_and_carries_are_deterministic(dev, s, block_tiles):
    """Five fp32 calls give the same bits, whichever CTA finished a row last."""
    a, b = _lin_pair("gated", (4, 1 << 22), dev)
    m, _, nb = scan_pipeline.block_geometry(a.shape[1], s, block_tiles)
    ab, bb = a.reshape(4, nb, m, s), b.reshape(4, nb, m, s)
    first = linrec_mm.linrec_summaries_carries(ab, bb)
    assert all(map(_bits, first[:2], linrec_mm.linrec_block_summaries(ab, bb)))
    for _ in range(5):
        assert all(map(_bits, linrec_mm.linrec_summaries_carries(ab, bb), first))


def test_fused_linrec_summaries_and_carries_under_cuda_graph(dev):
    """The fused launch (its ticket memset included) and the two-launch pipeline,
    captured in a CUDA graph and replayed on new inputs, give the eager bits."""
    a, b = _lin_pair("gated", (4, 1 << 20), dev)
    m, _, nb = scan_pipeline.block_geometry(a.shape[1], 16, 8)
    ab, bb = a.view(4, nb, m, 16), b.view(4, nb, m, 16)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            linrec_mm.linrec_summaries_carries(ab, bb)
            linrec_mm.linrec_blocked_scan(a, b, s=16, block_tiles=8)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fused = linrec_mm.linrec_summaries_carries(ab, bb)
        whole = linrec_mm.linrec_blocked_scan(a, b, s=16, block_tiles=8)
    for seed in range(3):
        a2, b2 = _lin_pair("gated", a.shape, dev)
        a.copy_(a2.flip(-1) if seed % 2 else a2)
        b.copy_(torch.randn(b.shape, generator=_gen(dev, 20 + seed), device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert all(map(_bits, fused, linrec_mm.linrec_summaries_carries(ab, bb)))
        assert _bits(whole, linrec_mm.linrec_blocked_scan(a, b, s=16, block_tiles=8))


def test_linrec_edge_cases_hold_on_the_card(dev):
    """Zeros reset exactly, deep decay stays finite, moderate decay stays accurate."""
    a = torch.tensor([2.0, 0.0, 2.0, 2.0, 0.0, 1.0], device=dev)
    b = torch.tensor([1.0, 3.0, 1.0, 1.0, 4.0, 1.0], device=dev)
    for method in ("kernel", "blocked"):
        got = linear_scan(a, b, method=method, tile_s=2, block_tiles=1)
        assert got.tolist() == [1.0, 3.0, 7.0, 15.0, 4.0, 5.0]
        deep = linear_scan(torch.full((4096,), 0.5, device=dev), torch.ones(4096, device=dev),
                           method=method, tile_s=64)
        assert bool(deep.isfinite().all())
        assert torch.allclose(deep.double().cpu(), 2.0 - 0.5 ** torch.arange(4096.0).double(),
                              rtol=1e-5)
        for decay in (0.25, 0.05):
            am = torch.full((512,), decay, device=dev)
            bm = torch.randn(512, generator=_gen(dev), device=dev)
            got = linear_scan(am, bm, method=method, tile_s=128)
            assert torch.allclose(got.double(), _lin_ref(am, bm), rtol=3e-6, atol=3e-6)


def test_linrec_launch_counts_and_operators(dev):
    a, b = _lin_pair("int", (4, 100003), dev)
    want = _lin_ref(a, b)
    ops.reset_launch_counts()
    k = linear_scan(a, b, method="kernel")
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(linrec_scan=1)
    ops.reset_launch_counts()
    bl = linear_scan(a, b, method="blocked", tile_s=16, block_tiles=8)     # 49 blocks
    assert ops.launch_counts() == _counts(linrec_summaries=1, linrec_block_scan=1)
    assert _build.LAUNCHES["linrec_summaries_carries"] == 1
    ops.reset_launch_counts()
    linrec_mm.linrec_carry_scan(torch.ones((4, 49), device=dev), b[:, :49])  # alone: B15
    assert ops.launch_counts() == _counts(linrec_carry=1)
    ops.reset_launch_counts()
    nb1 = linear_scan(a, b, method="blocked", tile_s=16, block_tiles=1)    # 391 blocks of 256
    assert not linrec_mm.fuses_carries(391)                                # B15 launches
    assert ops.launch_counts() == _counts(linrec_summaries=1, linrec_carry=1,
                                          linrec_block_scan=1)
    ops.reset_launch_counts()
    b1 = linear_scan(a, b, method="blocked")                              # one block
    assert ops.launch_counts() == _counts(linrec_block_scan=1)
    assert torch.equal(k.double(), want) and torch.equal(bl, k) and torch.equal(b1, k)
    assert torch.equal(nb1, k)
    ops.reset_launch_counts()
    one = linear_scan(a[:, :1], b[:, :1], method="kernel", initial=2.0)
    assert not any(ops.launch_counts().values())
    assert torch.equal(one, b[:, :1] + a[:, :1] * 2.0)
    x = torch.randint(-1, 3, (3, 500), generator=_gen(dev), device=dev).float()
    for method in ("kernel", "blocked"):
        assert torch.equal(cumprod(x, method=method), torch.cumprod(x, -1))
        assert torch.equal(cummax(x, method=method), torch.cummax(x, -1).values)
        off = torch.tensor([0, 7, 7, 300, 500], device=dev)
        seg = segment_linear_scan(x, torch.ones_like(x), off, method=method, initial=1.0)
        assert torch.equal(seg, segment_linear_scan(x, torch.ones_like(x), off,
                                                    method="vector", initial=1.0))
    with pytest.raises(TypeError):
        linrec_mm.linrec_scan_tiles(a, b, accum_dtype=torch.float64)


def test_ssd_scan_on_the_kernels(dev):
    """ssd_scan on B1 + B13 and on B4 + B16 against "vector" and the fp64 oracle."""
    g = _gen(dev, 6)
    bsz, s, h, p, n = 2, 300, 4, 8, 16
    x = torch.randn((bsz, s, h, p), generator=g, device=dev)
    al = -torch.rand((bsz, s, h), generator=g, device=dev) * 0.2
    bm = torch.randn((bsz, s, h, n), generator=g, device=dev) * 0.3
    cm = torch.randn((bsz, s, h, n), generator=g, device=dev) * 0.3
    ref = ssd_scan_ref(x.double(), al.double(), bm.double(), cm.double())
    vec = ssd_scan(x, al, bm, cm, chunk=32, scan_method="vector")
    for method, want in (("kernel", _counts(scan_mm=1, linrec_scan=1)),
                         ("blocked", _counts(block_scan=1, linrec_block_scan=1))):
        ops.reset_launch_counts()
        y = ssd_scan(x, al, bm, cm, chunk=32, scan_method=method)
        torch.cuda.synchronize()
        assert ops.launch_counts() == want
        assert torch.allclose(y, vec, rtol=1e-4, atol=1e-4)
        assert torch.allclose(y.double(), ref, rtol=2e-3, atol=2e-3)


def test_engine_zamba2_launches_in_prefill_only(dev):
    """zamba2 SMOKE (5 Mamba2 layers, chunk 16, a 48-token prompt): one B1 and one B13
    per layer in prefill under "kernel", one B4 and one B16 under "blocked", and no
    linear-recurrence launch in decode; every method gives the "vector" stream."""
    cfg = get_config("zamba2-1.2b", smoke=True)
    params = build_model(cfg).init(0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=_gen(dev), device=dev)
    want = ServeEngine(cfg, params, max_len=56, sampler="greedy",
                       scan_method="vector").generate({"tokens": toks}, 5)
    for method, prefill in (("kernel", _counts(scan_mm=5, linrec_scan=5)),
                            ("blocked", _counts(block_scan=5, linrec_block_scan=5))):
        eng = ServeEngine(cfg, params, max_len=56, sampler="greedy", scan_method=method)
        ops.reset_launch_counts()
        out = eng.generate({"tokens": toks}, 5)
        assert ops.launch_counts() == prefill
        assert torch.equal(out, want)


# ---- the multi-way split (B6) and the SSD chunk kernel (B17) ----


@pytest.mark.parametrize("n", [1, 33, 5000, 300001])
@pytest.mark.parametrize("r", [1, 3, 16, 256, 2000, 29055])
@pytest.mark.parametrize("dtype", [torch.bool, torch.bfloat16, torch.float32, torch.int64])
def test_multi_split_kernel_matches_plain(dev, dtype, r, n):
    """Every payload width, R from 1 to the largest taken (2000 and 29055 run fewer
    than 32 warps), ragged rows; against a stable argsort of the digits and their
    bincount, and against the plain version where its (3, R + 1, n) one-hot fits."""
    x = _int_payload(torch.int32, (3, n), dev).to(dtype)
    d = torch.randint(0, r, (3, n), generator=_gen(dev, 1), device=dev, dtype=torch.int32)
    d[1] = r - 1                                               # one full bucket
    z, ind, cnt = split_mm.multi_split_tiles(x, d, num_buckets=r)
    if (r + 1) * n <= 1 << 26:
        pz, pind, pcnt = split_mm.multi_split_plain(x, d, r)
        assert torch.equal(z, pz) and torch.equal(ind, pind) and torch.equal(cnt, pcnt)
    order = torch.argsort(d, dim=-1, stable=True)
    assert torch.equal(ind.long(), order) and torch.equal(z, torch.gather(x, -1, order))
    for row in range(3):
        assert torch.equal(cnt[row].long(), torch.bincount(d[row].long(), minlength=r))


def test_multi_split_kernel_out_of_range_digits(dev):
    """Digits outside [0, R) go last, in order, uncounted; nothing is written out of
    bounds (a synchronize would report a fault)."""
    d = torch.randint(-40, 40, (2, 70001), generator=_gen(dev, 2), device=dev,
                      dtype=torch.int32)
    x = torch.arange(2 * 70001, device=dev, dtype=torch.int32).reshape(2, 70001)
    z, ind, cnt = split_mm.multi_split_tiles(x, d, num_buckets=10)
    torch.cuda.synchronize()
    pz, pind, pcnt = split_mm.multi_split_plain(x, d, 10)
    assert torch.equal(z, pz) and torch.equal(ind, pind) and torch.equal(cnt, pcnt)
    assert int(cnt.sum()) == int(((d >= 0) & (d < 10)).sum())


def test_multi_split_kernel_launch_count(dev):
    x = torch.randn((4, 1 << 16), generator=_gen(dev), device=dev)
    d = torch.randint(0, 16, x.shape, generator=_gen(dev, 3), device=dev)
    ops.reset_launch_counts()
    z, ind, cnt = multi_split(x, d, 16, method="kernel")
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(multi_split=1)
    zv, iv, cv = multi_split(x, d, 16, method="vector")
    assert torch.equal(z, zv) and torch.equal(ind, iv) and torch.equal(cnt, cv)
    with pytest.raises(ValueError, match="shared memory"):
        split_mm.multi_split_tiles(x, d, num_buckets=split_mm.MULTI_SPLIT_MAX_BUCKETS + 1)


# rows around the tile edge of B6's tile split (tiles of split_mm.RADIX_TILE digits)
B6_EDGE_ROWS = [1, split_mm.RADIX_TILE - 1, split_mm.RADIX_TILE, split_mm.RADIX_TILE + 1,
                3 * split_mm.RADIX_TILE + 17]


def _b6_hold(x, d, r, plain=True):
    """One B6 launch, exact against its plain version (where asked), a stable
    argsort of the slot digits (out-of-range digits last) and their bincount."""
    ops.reset_launch_counts()
    z, ind, cnt = split_mm.multi_split_tiles(x, d, num_buckets=r)
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(multi_split=1)
    if plain:
        pz, pind, pcnt = split_mm.multi_split_plain(x, d, r)
        assert torch.equal(z, pz) and torch.equal(ind, pind) and torch.equal(cnt, pcnt)
    key = torch.where((d >= 0) & (d < r), d, r).long()
    order = torch.argsort(key, dim=-1, stable=True)
    assert torch.equal(ind.long(), order) and torch.equal(z, torch.gather(x, -1, order))
    want = torch.stack([torch.bincount(row, minlength=r + 1)[:r] for row in key])
    assert torch.equal(cnt.long(), want)


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("n", B6_EDGE_ROWS)
@pytest.mark.parametrize("r", [2, 16, 256])
def test_multi_split_tile_split_at_its_tile_edges(dev, r, n, b):
    """Rows ending before, at and after a tile edge, with runs of one digit across
    every edge: one launch, exact."""
    x = torch.randn((b, n), generator=_gen(dev), device=dev)
    d = torch.randint(0, r, (b, n), generator=_gen(dev, 1), device=dev, dtype=torch.int32)
    for edge in range(split_mm.RADIX_TILE, n, split_mm.RADIX_TILE):
        d[:, edge - 5:edge + 5] = d[:, edge - 5:edge - 4]
    _b6_hold(x, d, r)


@pytest.mark.parametrize("r", [split_mm.MULTI_SPLIT_TILE_MAX_BUCKETS,
                               split_mm.MULTI_SPLIT_TILE_MAX_BUCKETS + 1])
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64, torch.float32, torch.uint8])
def test_multi_split_around_the_tile_ceiling(dev, dtype, r):
    """R = 511, the tile split's most (its downsweep's largest shared memory with
    8-byte payloads), and R = 512, the row kernel: both exact, one launch each;
    the tile split takes scratch exactly up to its ceiling."""
    x = _int_payload(torch.int32, (3, 70001), dev).to(dtype)
    d = torch.randint(-3, r + 3, x.shape, generator=_gen(dev, 2), device=dev,
                      dtype=torch.int32)
    _b6_hold(x, d, r, plain=dtype != torch.uint8)


@pytest.mark.parametrize("r", [16, split_mm.MULTI_SPLIT_TILE_MAX_BUCKETS, 5000])
def test_multi_split_out_of_range_digits_on_each_kernel(dev, r):
    """Digits below 0 and at or above R go last, in order, uncounted, on the tile
    split and the row kernel, with 8-byte payloads; nothing is written out of
    bounds (the synchronize would report a fault)."""
    d = torch.randint(-2 * r, 2 * r, (4, 3 * split_mm.RADIX_TILE + 17),
                      generator=_gen(dev, 3), device=dev, dtype=torch.int32)
    x = torch.arange(d.numel(), device=dev, dtype=torch.int64).reshape(d.shape)
    _b6_hold(x, d, r, plain=r < 1000)


# rows around the edge of B13's tiles (linrec_scan_tile: 8192 pairs for these rows)
B13_TILE = linrec_mm.linrec_scan_tile(1 << 20)


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("n", [1, B13_TILE - 1, B13_TILE, B13_TILE + 1, 3 * B13_TILE + 17])
def test_linrec_scan_kernel_at_its_tile_edges(dev, n, b):
    """One launch of B13 over all rows; integer-valued pairs with a zero of a on a
    tile's first pair and none for a tile and more: exact against the plain version
    and the fp64 recurrence."""
    a, bb = _lin_pair("int", (b, n), dev)
    a[:, B13_TILE::B13_TILE] = 0.0
    a[:, 1:B13_TILE + 100] = torch.where(a[:, 1:B13_TILE + 100] == 0, 1.0,
                                         a[:, 1:B13_TILE + 100])
    ops.reset_launch_counts()
    got = linrec_mm.linrec_scan_tiles(a, bb)
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(linrec_scan=1)
    assert torch.equal(got, linrec_mm.linrec_scan_tiles_plain(a, bb, s=16, acc=torch.float32))
    assert torch.equal(got.double(), _lin_ref(a, bb))


def _lin_ctas(a, b, dev):
    """The CTAs one B13 launch ran, from the counter after its two words a tile."""
    rows, n = a.shape
    tiles = rows * -(-n // linrec_mm.linrec_scan_tile(n))
    ws = lookback.workspace(tiles, dev, words=2)
    out = linrec_mm._linrec_scan_cuda(a, b, ws=ws)
    torch.cuda.synchronize()
    return int(ws[-1]), tiles, out


@pytest.mark.parametrize("shape", [(1, 1 << 26), (64, 1 << 20)])
def test_linrec_scan_forward_progress(dev, shape):
    """8192 tiles against the 264 CTAs resident at once: the launch ends, exact,
    one CTA a tile."""
    a, b = _lin_pair("int", shape, dev)
    ctas, tiles, out = _lin_ctas(a, b, dev)
    assert ctas == tiles == 8192
    assert torch.equal(out.double(), _lin_ref(a, b))


def test_linrec_scan_warp_path_and_tiles_either_side_of_2048(dev):
    """Rows of 2048 take the warp walk (no workspace, no look-back), rows of 2049
    two tiles of 1024 on the look-back; both exact and equal to the plain version."""
    for n in (linrec_mm.LINREC_WARP_MAX, linrec_mm.LINREC_WARP_MAX + 1):
        a, b = _lin_pair("int", (5, n), dev)
        want = linrec_mm.linrec_scan_tiles_plain(a, b, s=16, acc=torch.float32)
        if n <= linrec_mm.LINREC_WARP_MAX:
            got = linrec_mm._linrec_scan_cuda(a, b)
        else:
            ctas, tiles, got = _lin_ctas(a, b, dev)
            assert ctas == tiles == 5 * 2
        assert torch.equal(got, want) and torch.equal(got.double(), _lin_ref(a, b))


def test_linrec_scan_fp32_is_deterministic(dev):
    """Random fp32 (a in [0.9, 1) with zeros): five more calls bit-equal to the
    first, within 16 ulp of the fp64 recurrence at the scale of |a|, |b|."""
    shape = (4, 1 << 22)
    a = 0.9 + 0.1 * torch.rand(shape, generator=_gen(dev, 7), device=dev)
    a = torch.where(torch.rand(shape, generator=_gen(dev, 8), device=dev) < 1e-4, 0.0, a)
    b = torch.randn(shape, generator=_gen(dev, 9), device=dev)
    first = linrec_mm.linrec_scan_tiles(a, b)
    for _ in range(5):
        assert torch.equal(linrec_mm.linrec_scan_tiles(a, b), first)
    assert _ulp_err(first, _lin_ref(a, b), _lin_ref(a.abs(), b.abs())) <= 16.0


def test_linrec_scan_under_cuda_graph(dev):
    """B13 captured in a CUDA graph (its workspace memset included) and replayed on
    new inputs gives the eager results."""
    a, b = _lin_pair("gated", (4, 1 << 20), dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            linrec_mm.linrec_scan_tiles(a, b)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = linrec_mm.linrec_scan_tiles(a, b)
    for seed in range(3):
        b.copy_(torch.randn(b.shape, generator=_gen(dev, 20 + seed), device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, linrec_mm.linrec_scan_tiles(a, b))


def _ssd_args(dev, shape, seed, decays="mild"):
    b, s, h, p, n = shape
    g = _gen(dev, seed)
    x = torch.randn((b, s, h, p), generator=g, device=dev)
    if decays == "mild":
        al = -(torch.randn((b, s, h), generator=g, device=dev) * 0.1).abs()
    else:                                        # zamba2's init decays
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device=dev))
        al = -torch.linspace(1.0, 16.0, h, device=dev) * dt
    bm = torch.randn((b, s, h, n), generator=g, device=dev) * 0.3
    cm = torch.randn((b, s, h, n), generator=g, device=dev) * 0.3
    return x, al, bm, cm


@pytest.mark.parametrize("shape,chunk", [((1, 64, 1, 4, 2), 32), ((2, 96, 3, 8, 4), 32),
                                         ((1, 250, 2, 16, 8), 32), ((2, 48, 8, 16, 8), 16),
                                         ((2, 20, 3, 8, 4), 32), ((1, 1, 2, 5, 3), 8),
                                         ((2, 300, 4, 64, 64), 128), ((1, 200, 2, 7, 9), 50)])
@pytest.mark.parametrize("decays", ["mild", "zamba2"])
def test_ssd_chunk_kernel_matches_plain(dev, shape, chunk, decays):
    """B17 against its plain version within 2e-6·max|y| (mild decays) and against the
    fp64 oracle within the JAX package's 2e-3; finite under zamba2's decays."""
    args = _ssd_args(dev, shape, 4, decays)
    y = ssd_chunk.ssd_chunk_scan(*args, chunk=chunk)
    plain = ssd_chunk.ssd_chunk_plain(*args, chunk=chunk)
    ref = ssd_scan_ref(*(t.double() for t in args))
    assert bool(y.isfinite().all())
    assert torch.allclose(y.double(), ref, rtol=2e-3, atol=2e-3)
    if decays == "mild":
        assert float((y - plain).abs().max()) <= 2e-6 * float(plain.abs().max())


def test_ssd_chunk_kernel_reads_strides_and_checks_limits(dev):
    args = _ssd_args(dev, (2, 100, 3, 8, 4), 5)
    want = ssd_chunk.ssd_chunk_scan(*args, chunk=32)
    views = [torch.movedim(torch.movedim(t, 2, 0).contiguous(), 0, 2) for t in args]
    assert torch.equal(ssd_chunk.ssd_chunk_scan(*views, chunk=32), want)
    x, al, bm, cm = _ssd_args(dev, (1, 300, 1, 64, 64), 6)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_chunk.ssd_chunk_scan(x, al, bm, cm, chunk=256)
    with pytest.raises(NotImplementedError, match="ssd_chunk_scan has no gradient"):
        ssd_chunk.ssd_chunk_scan(x.requires_grad_(), al, bm, cm)


def test_forward_launches_b17_once_per_mamba_layer(dev, monkeypatch):
    """zamba2 SMOKE forward/loss: 5 B17 launches under "kernel" (one per Mamba2 layer),
    5 B4 + 5 B16 under "blocked", none under "vector".  Under "kernel" the logits are
    within 2e-5 of the same forward with B17's plain version on the card; against the
    CPU every method is held to twice the "vector" forward's card-to-CPU distance
    plus 2e-5 (cuBLAS and the CPU's BLAS round the other fp32 products apart by
    2e-5 to 7e-5 on this model, B17 or not)."""
    cfg = get_config("zamba2-1.2b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks.to(dev), "loss_mask": (toks % 3 > 0).to(dev)}
    gparams = _to_device(params, dev)
    card, cpu = {}, {}
    for method, want in (("kernel", _counts(ssd_chunk=5)),
                         ("blocked", _counts(block_scan=5, linrec_block_scan=5)),
                         ("vector", _counts())):
        model = build_model(dataclasses.replace(cfg, scan_method=method))
        ops.reset_launch_counts()
        card[method] = model.forward(gparams, batch).cpu()
        assert ops.launch_counts() == want
        ops.reset_launch_counts()
        total, parts = model.loss(gparams, batch)
        assert ops.launch_counts() == want
        assert float(total) == float(parts["ce"]) and bool(torch.isfinite(total))
        cpu[method] = model.forward(params, {"tokens": toks})
    floor = float((card["vector"] - cpu["vector"]).abs().max())
    for method in ("kernel", "blocked"):
        assert float((card[method] - cpu[method]).abs().max()) <= 2 * floor + 2e-5
    monkeypatch.setattr(mamba, "ssd_chunk_scan", ssd_chunk.ssd_chunk_plain)
    plain = build_model(dataclasses.replace(cfg, scan_method="kernel")).forward(gparams, batch)
    assert float((card["kernel"] - plain.cpu()).abs().max()) <= 2e-5


def _to_device(tree, dev):
    """A parameter tree moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---- B17 as a chunk-parallel pass; the column walk of B13 and B16 ----


def _ssd_hold(args, chunk, y):
    """``y`` against B17's plain version within 2e-6·max|y| and the fp64 oracle
    within 2e-3, finite."""
    plain = ssd_chunk.ssd_chunk_plain(*args, chunk=chunk)
    ref = ssd_scan_ref(*(t.double() for t in args))
    assert bool(y.isfinite().all())
    assert torch.allclose(y.double(), ref, rtol=2e-3, atol=2e-3)
    assert float((y - plain).abs().max()) <= 2e-6 * float(plain.abs().max())


@pytest.mark.parametrize("s", [1, 127, 128, 129, 3 * 128 + 17])
def test_ssd_chunk_kernel_sequence_edges(dev, s):
    """S of 1, Q - 1, Q, Q + 1 and 3Q + 17 at zamba2's widths (Q 128, N = P = 64):
    one launch, one CTA a chunk."""
    args = _ssd_args(dev, (2, s, 4, 64, 64), 11)
    x, al, bm, cm = args
    q = min(128, s)
    nc = -(-s // q)
    ws = torch.empty(-(-ssd_chunk.ssd_workspace_bytes(8, nc, 64, 64) // 8), dtype=torch.int64,
                     device=dev)
    ops.reset_launch_counts()
    y = ssd_chunk._ssd_chunk_cuda(x, al, bm, cm, q, ws=ws)
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(ssd_chunk=1)
    assert int(ws[0]) == 8 * nc
    _ssd_hold(args, 128, y)


@pytest.mark.parametrize("decays", ["mild", "zamba2"])
def test_ssd_chunk_kernel_is_deterministic(dev, decays):
    """Five more calls bit-equal to the first: the state reaches every chunk through
    the same chain, whichever CTAs ran first."""
    args = _ssd_args(dev, (2, 2048, 16, 64, 64), 12, decays)
    first = ssd_chunk.ssd_chunk_scan(*args, chunk=128)
    for _ in range(5):
        assert torch.equal(ssd_chunk.ssd_chunk_scan(*args, chunk=128), first)


def test_ssd_chunk_kernel_under_cuda_graph(dev):
    """B17 captured in a CUDA graph (its workspace memset included) and replayed on
    new inputs gives the eager results."""
    x, al, bm, cm = _ssd_args(dev, (2, 1000, 8, 64, 64), 13)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            ssd_chunk.ssd_chunk_scan(x, al, bm, cm, chunk=128)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ssd_chunk.ssd_chunk_scan(x, al, bm, cm, chunk=128)
    for seed in range(3):
        x.copy_(torch.randn(x.shape, generator=_gen(dev, 30 + seed), device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ssd_chunk.ssd_chunk_scan(x, al, bm, cm, chunk=128))


@pytest.mark.parametrize("chunk", [32, 128])
def test_ssd_chunk_kernel_single_chain_forward_progress(dev, chunk):
    """One (batch, head) of 256 chunks: every CTA waits on the one before it; the
    launch ends, one CTA a chunk, within the limits."""
    args = _ssd_args(dev, (1, 256 * chunk, 1, 64, 64), 14)
    ws = torch.empty(-(-ssd_chunk.ssd_workspace_bytes(1, 256, 64, 64) // 8), dtype=torch.int64,
                     device=dev)
    y = ssd_chunk._ssd_chunk_cuda(*args, chunk, ws=ws)
    torch.cuda.synchronize()
    assert int(ws[0]) == 256
    _ssd_hold(args, chunk, y)


@pytest.mark.parametrize("method,key", [("kernel", "linrec_scan"),
                                        ("blocked", "linrec_block_scan")])
def test_linrec_columns_one_launch_no_copies(dev, method, key):
    """The SSD's cross-chunk states, (4, 16, 64, 64, 64) along axis 1 with a decay
    shared by each (64, 64) state: one launch, no allocation beyond the output, and
    integer-valued pairs exact against the column walk's plain version and fp64."""
    a = torch.randint(-1, 2, (4, 16, 64, 1, 1), generator=_gen(dev, 16), device=dev).float()
    b = torch.randint(-3, 4, (4, 16, 64, 64, 64), generator=_gen(dev, 17), device=dev).float()
    linear_scan(a, b, axis=1, method=method, tile_s=16)          # builds and warms
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    got = linear_scan(a, b, axis=1, method=method, tile_s=16)
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(**{key: 1})
    assert torch.cuda.max_memory_allocated(dev) - before <= b.numel() * 4
    want = linrec_mm.linrec_columns_plain(a, b, 1)
    ref = torch.movedim(_lin_ref(torch.movedim(a.expand(b.shape), 1, -1),
                                 torch.movedim(b, 1, -1)), -1, 1)
    assert torch.equal(got, want) and torch.equal(got.double(), ref)


@pytest.mark.parametrize("axis,n", [(0, 2), (1, 3), (1, 17), (2, 64), (0, 64)])
@pytest.mark.parametrize("opts", [{}, dict(exclusive=True), dict(reverse=True),
                                  dict(initial=2.0, exclusive=True, reverse=True)])
def test_linrec_columns_match_plain_and_vector(dev, axis, n, opts):
    """Every axis that is not the last, full and grouped decays, the options:
    integer-valued pairs exact against the plain version and the "vector" method."""
    shape = [3, 5, 7, 8]
    shape[axis] = n
    b = torch.randint(-3, 4, shape, generator=_gen(dev, 18), device=dev).float()
    for a_shape in (shape, shape[:axis + 1] + [1] * (3 - axis)):
        a = torch.randint(-1, 2, a_shape, generator=_gen(dev, 19), device=dev).float()
        ops.reset_launch_counts()
        got = linear_scan(a, b, axis=axis, method="kernel", **opts)
        assert ops.launch_counts() == _counts(linrec_scan=1)
        init = opts.get("initial")
        plain = linrec_mm.linrec_columns_plain(
            a, b, axis, exclusive=opts.get("exclusive", False),
            reverse=opts.get("reverse", False),
            initial=None if init is None else torch.tensor(init, device=dev))
        assert torch.equal(got, plain)
        assert torch.equal(got, linear_scan(a, b, axis=axis, method="vector", **opts))


def test_linrec_columns_random_fp32_within_16_ulp(dev):
    """Random gated fp32 at the SSD shape within 16 ulp of the fp64 recurrence, on
    both methods, five more calls bit-equal."""
    a = 0.9 + 0.1 * torch.rand((4, 16, 64, 1, 1), generator=_gen(dev, 20), device=dev)
    b = torch.randn((4, 16, 64, 64, 64), generator=_gen(dev, 21), device=dev)
    rows = (torch.movedim(a.expand(b.shape), 1, -1), torch.movedim(b, 1, -1))
    ref, scale = _lin_ref(*rows), _lin_ref(rows[0].abs(), rows[1].abs())
    for method in ("kernel", "blocked"):
        got = linear_scan(a, b, axis=1, method=method, tile_s=16)
        assert _ulp_err(torch.movedim(got, 1, -1), ref, scale) <= 16.0
        for _ in range(5):
            assert torch.equal(linear_scan(a, b, axis=1, method=method, tile_s=16), got)


@pytest.mark.parametrize("method", ["kernel", "blocked"])
@pytest.mark.parametrize("a_shape,b_shape", [((2, 16, 0), (2, 16, 0)),
                                             ((0, 16, 4), (0, 16, 4)),
                                             ((2, 16, 1, 1), (2, 16, 3, 0))])
def test_linrec_columns_empty_operands(dev, method, a_shape, b_shape):
    """A short axis 1 whose operands hold no element: an empty result of the broadcast
    shape, as on the CPU, and no launch."""
    a, b = torch.ones(a_shape, device=dev), torch.ones(b_shape, device=dev)
    ops.reset_launch_counts()
    got = linear_scan(a, b, axis=1, method=method, tile_s=16)
    assert ops.launch_counts() == _counts()
    want = linear_scan(a.cpu(), b.cpu(), axis=1, method=method, tile_s=16)
    assert got.shape == want.shape == torch.broadcast_shapes(a_shape, b_shape)
    assert got.device.type == "cuda"


# ---- B8 as one thread-block cluster a row (csrc/topp_tail.cu) ----

B8_ROWS = [1, 2, 7, 8, 9, 4096, 32000, 64128, 128255, 128256, 128257, 257216, 1 << 20]
B8_UNIFORMS = [0.05, 0.3, 0.6, 0.8, 0.95, 0.999]


def _peaked_rows(b, n, dev, seed=0):
    """Sorted rows whose mass sits on at most four tokens (the logits' peaks grow with
    log n, so the tail keeps under 1e-4 of it at any n): every cut and CDF step is
    far wider than the band, so the kernel and its plain version agree exactly."""
    logits = torch.randn((b, n), generator=_gen(dev, seed), device=dev) * 0.1
    k = min(4, n)
    logits[:, :k] += torch.tensor([9.0, 8.0, 7.0, 6.0][:k], device=dev) + math.log(n)
    sp = torch.sort(torch.softmax(logits, -1), -1, descending=True).values
    u = torch.tensor([B8_UNIFORMS[r % 6] for r in range(b)], device=dev).reshape(b, 1)
    return sp, u


@pytest.mark.parametrize("b", [1, 4, 64])
@pytest.mark.parametrize("n", B8_ROWS)
def test_topp_tail_cluster_matches_plain(dev, n, b):
    """Peaked rows at and around the slices' 16-byte words, the sampler's vocabularies,
    paligemma's 257216 and a row of 2^20 (walked in rounds): the plain version's index,
    the model's (``_topp_tail_cluster``), the same over five calls, one launch each."""
    sp, u = _peaked_rows(b, n, dev)
    for p in (0.0, 0.5, 0.9, 1.0):
        ops.reset_launch_counts()
        got = split_mm.topp_mask_sample_tiles(sp, u, p=p)
        torch.cuda.synchronize()
        assert ops.launch_counts() == _counts(topp_tail=1)
        assert torch.equal(got, split_mm.topp_tail_plain(sp, u, p=p))
        assert torch.equal(got.cpu(), split_mm._topp_tail_cluster(sp.cpu(), u.cpu(), p=p))
        for _ in range(5):
            assert torch.equal(split_mm.topp_mask_sample_tiles(sp, u, p=p), got)


@pytest.mark.parametrize("n", [9, 32000, 128256, 257216, 1 << 20])
def test_topp_tail_cluster_is_its_model_on_random_rows(dev, n):
    """Flat random rows, whose cuts and steps lie inside the band: the kernel's index
    is still the model's, which repeats its arithmetic operation for operation."""
    for sigma in (1.0, 4.0):
        logits = torch.randn((4, n), generator=_gen(dev, 7), device=dev) * sigma
        sp = torch.sort(torch.softmax(logits, -1), -1, descending=True).values
        u = torch.rand((4, 1), generator=_gen(dev, 8), device=dev)
        for p in (0.5, 0.9, 1.0):
            got = split_mm.topp_mask_sample_tiles(sp, u, p=p)
            assert torch.equal(got.cpu(), split_mm._topp_tail_cluster(sp.cpu(), u.cpu(), p=p))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [9, 4096, 128256, 128257])
def test_topp_tail_cluster_unaligned_rows(dev, n, offset):
    """Rows off 16-byte alignment, read where they lie: a column slice of a wider
    tensor (row stride n + offset) and a flat buffer entered at an offset."""
    sp, u = _peaked_rows(4, n, dev)
    wide = torch.zeros((4, n + offset), device=dev)
    wide[:, offset:] = sp
    flat = torch.zeros(4 * n + offset, device=dev)
    flat[offset:] = sp.reshape(-1)
    for view in (wide[:, offset:], flat[offset:].view(4, n)):
        assert view.data_ptr() % 16 != 0
        for p in (0.5, 0.9):
            got = split_mm.topp_mask_sample_tiles(view, u, p=p)
            assert torch.equal(got, split_mm.topp_tail_plain(sp, u, p=p))
            assert torch.equal(got.cpu(), split_mm._topp_tail_cluster(sp.cpu(), u.cpu(), p=p))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("threads", [256, 512, 1024])
def test_topp_tail_design_options_are_their_models(dev, threads, cluster):
    """The design entry point's CTAs a cluster and threads a CTA: each option's index is
    its model's, on random rows at the sampler's shape and at 2^20."""
    for n in (128256, 1 << 20):
        logits = torch.randn((4, n), generator=_gen(dev, 9), device=dev) * 2
        sp = torch.sort(torch.softmax(logits, -1), -1, descending=True).values
        u = torch.rand((4, 1), generator=_gen(dev, 10), device=dev)
        out = torch.empty(4, dtype=torch.int32, device=dev)
        _build.launch("topp_tail", sp.data_ptr(), n, u.data_ptr(), out.data_ptr(), 4, n, 0.9,
                      threads, cluster, torch.cuda.current_stream(dev).cuda_stream,
                      entry="repro_topp_tail_design")
        want = split_mm._topp_tail_cluster(sp.cpu(), u.cpu(), p=0.9, cluster=cluster,
                                           threads=threads)
        assert torch.equal(out.cpu(), want)


# ---- B11 on B9's single pass, exclusive (csrc/seg_carry.cu, csrc/seg_pass.cuh) ----

B11_ROWS = [1, 7, 128, 8192, 8193, 70001, 1 << 20]


def _b11_summaries(dtype, nb, dev):
    if dtype == torch.int32:
        ts = torch.randint(-100, 100, (4, nb), generator=_gen(dev, 11), device=dev,
                           dtype=torch.int32)
    else:
        ts = torch.randn((4, nb), generator=_gen(dev, 11), device=dev)
    h = (torch.rand((4, nb), generator=_gen(dev, 12), device=dev) < 0.001).to(torch.int32)
    h[1] = 0
    h[2] = 1
    h[3] *= 7                                          # nonzero words other than 1
    return ts, h


def _b11_reference(ts, h):
    """The fp64 exclusive carries and their scale (the running ``Σ|ts|`` of each
    block's segment)."""
    v, a = _seg_ref64(ts.double(), h), _seg_ref64(ts.double().abs(), h)
    shift = lambda t: torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], -1)  # noqa: E731
    return shift(v), shift(a)


def _seg_ref64(x, h):
    full = torch.cumsum(x, -1)
    pos = torch.arange(x.shape[-1], device=x.device).expand(x.shape)
    start = torch.cummax(torch.where(h != 0, pos, 0), -1).values
    return full - torch.gather(full - x, -1, start)


@pytest.mark.parametrize("nb", B11_ROWS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_seg_carry_single_pass(dev, dtype, nb):
    """Exact on int32, within 16 ulp on fp32 at the per-segment scale, five calls
    bit-equal, one launch a call; rows of h all zero, all set, random and 7."""
    ts, h = _b11_summaries(dtype, nb, dev)
    ops.reset_launch_counts()
    got = segscan_mm.seg_carry_scan(ts, h)
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(seg_carry=1)
    assert got.dtype == dtype and bool((got[:, 0] == 0).all())
    ref, scale = _b11_reference(ts, h)
    if dtype == torch.int32:
        assert torch.equal(got.to(torch.float64), ref)
    else:
        assert _ulp_err(got, ref, scale) <= 16.0
    for _ in range(5):
        assert torch.equal(segscan_mm.seg_carry_scan(ts, h), got)


@pytest.mark.parametrize("nb", B11_ROWS)
def test_seg_carry_workspace_only_past_one_tile(dev, nb):
    """Rows of one tile launch with no workspace at all (a null pointer of 0 bytes);
    longer rows refuse one and, given it, run one CTA a tile."""
    ts, h = _b11_summaries(torch.int32, nb, dev)
    tiles = -(-nb // segscan_mm.seg_scan_tile(nb))
    out = torch.empty_like(ts)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (ts.data_ptr(), h.data_ptr(), out.data_ptr(), 4, nb, 1)
    if tiles == 1:
        _build.launch("seg_carry", *args, 0, 0, stream)
        torch.cuda.synchronize()
        assert torch.equal(out, segscan_mm.seg_carry_scan(ts, h))
        return
    with pytest.raises(RuntimeError):
        _build.launch("seg_carry", *args, 0, 0, stream)
    got = {}
    assert _ctas(lambda ws: got.setdefault("x", segscan_mm._seg_carry_cuda(ts, h, ws=ws)),
                 4 * tiles, dev) == 4 * tiles
    assert torch.equal(got["x"].to(torch.float64), _b11_reference(ts, h)[0])


# ---- continuous batching: the paged KV cache and ContinuousEngine ----

# the SMOKE model's logits on the card against the CPU (chip_smoke.py's
# smoke_reference holds its prefill to the same limit)
CARD_CPU_ATOL = 1e-4


def _smoke_model(dev):
    cfg = get_config("llama3-8b", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    return cfg, model, params, {k: _tree_to(v, dev) for k, v in params.items()}


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_paged_insert_then_gather_is_the_dense_cache_on_the_card(dev):
    cfg, model, _, params = _smoke_model(dev)
    caches = paged_kv.build_paged_caches(model, 2, 9, 8, 3, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, 10), generator=_gen(dev), device=dev)
    _, dense = model.prefill(params, {"tokens": toks}, cache_len=16)
    paged_kv.insert_request(caches, dense, 1, [4, 2])
    view = paged_kv.gather_dense(caches)["stack"]["sub0"]
    for name in ("k", "v"):
        assert torch.equal(view[name][:, 1, :16], dense["stack"]["sub0"][name][:, 0])
    assert caches["stack"]["sub0"]["pages"][:, 1].tolist() == [[4, 2, 0]] * cfg.n_layers


def test_attn_decode_paged_on_the_card_matches_the_cpu(dev):
    cfg, _, cpu_params, _ = _smoke_model(dev)
    p = {k: v[0] for k, v in cpu_params["stack"]["sub0"]["attn"].items()}
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 1, cfg.d_model), generator=g)
    pools = {name: torch.randn((7, 8, cfg.n_kv_heads, cfg.head_dim_), generator=g)
             for name in ("k", "v")}
    pages = torch.tensor([[3, 1, 5], [2, 6, 0], [0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([17, 9, 4])
    outs = []
    for d in ("cpu", dev):
        cache = {**{k: v.clone().to(d) for k, v in pools.items()}, "pages": pages.to(d)}
        y, cache = attention.attn_decode_paged({k: v.to(d) for k, v in p.items()}, x.to(d),
                                               cfg, cache, pos.to(d), cdt=torch.float32)
        outs.append((y.cpu(), cache["k"].cpu(), cache["v"].cpu()))
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= CARD_CPU_ATOL


def test_continuous_schedule_on_the_card_equals_the_cpu(dev):
    cfg, model, cpu_params, params = _smoke_model(dev)
    geom = dict(max_batch=3, page_size=4, n_pages=12, max_len=28, tick_tokens=4)
    reqs = poisson_trace(9, rate=0.5, vocab_size=cfg.vocab_size, seed=3,
                         prompt_len=(2, 12), max_new=(1, 10))
    cpu = ContinuousEngine(cfg, cpu_params, device="cpu", **geom).run(reqs)
    eng = ContinuousEngine(cfg, params, alloc_method="kernel", **geom)
    ops.reset_launch_counts()
    with DenseReplay(eng) as rep:
        card = eng.run(reqs)
    torch.cuda.synchronize()
    assert card["requests"] == cpu["requests"] and card["stats"] == cpu["stats"]
    assert ops.launch_counts() == _counts(split=eng.alloc.calls)
    assert eng.alloc.calls >= len(reqs)
    replay = rep.result()
    assert replay["bit_equal"] and replay["row_steps"] > 0, replay
    # each card stream equals the CPU's, or parts from it first at a step whose
    # greedy margin (from the CPU's logits there) lies within CARD_CPU_ATOL
    equal = 0
    for r in reqs:
        got, want = card["streams"][r.rid], cpu["streams"][r.rid]
        k = first_divergence(got, want)
        if k is None:
            equal += 1
            continue
        assert k < min(got.size, want.size), (r.rid, got, want)
        toks = torch.cat([torch.as_tensor(r.tokens), torch.as_tensor(want[:k])])[None]
        logits, _ = model.prefill(cpu_params, {"tokens": toks}, cache_len=toks.shape[1])
        assert step_margin(logits[0], 0.0, sampler="greedy") <= CARD_CPU_ATOL, (r.rid, k)
    assert equal > len(reqs) // 2


def test_kernel_allocator_picks_equal_vector_with_one_b5_an_alloc(dev):
    kern = paged_kv.PageAllocator(33, method="kernel", device=dev)
    vec = paged_kv.PageAllocator(33, method="vector", device=dev)
    g = torch.Generator().manual_seed(5)
    held = []
    for _ in range(60):
        if held and float(torch.rand((), generator=g)) < 0.45:
            ids = held.pop(int(torch.randint(len(held), (), generator=g)))
            kern.release(ids)
            vec.release(ids)
            continue
        n = int(torch.randint(1, 9, (), generator=g))
        ops.reset_launch_counts()
        k = kern.alloc(n)
        assert ops.launch_counts() == _counts(split=1)
        v = vec.alloc(n)
        assert (k is None) == (v is None)
        if k is not None:
            assert k.tolist() == v.tolist()
            held.append(k)
    assert (kern.free == vec.free).all()


# ---- the guard layer: the non-finite policies and checks on the kernel paths ----


@pytest.mark.parametrize("method,want", [("kernel", dict(scan_mm=1)),
                                         ("blocked", dict(block_sums=1, block_scan=1))])
def test_scan_policies_on_the_kernels(dev, method, want):
    """``raise`` refuses before any launch; ``sanitize`` is bit-equal to the same
    method on the input with zeros for its non-finite elements, with the launches
    of ``propagate``."""
    x = torch.randn((3, 300001), generator=_gen(dev, 3), device=dev)  # three blocks
    x[0, 5], x[1, 140000], x[2, 299999] = float("nan"), float("inf"), float("-inf")
    ops.reset_launch_counts()
    with pytest.raises(guards.NonFiniteError):
        scan(x, method=method, nonfinite="raise")
    assert ops.launch_counts() == _counts()
    got = scan(x, method=method, nonfinite="sanitize")
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(**want)
    assert torch.equal(got, scan(torch.where(torch.isfinite(x), x, 0.0), method=method))
    assert bool(torch.isfinite(got).all())


def test_segment_scan_policies_on_b9(dev):
    x = torch.randn((70001,), generator=_gen(dev, 4), device=dev)
    x[[3, 30000, 69000]] = torch.tensor([float("nan"), float("inf"), float("-inf")],
                                        device=dev)
    off = torch.tensor([0, 10, 10, 40000, 70001], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    with pytest.raises(guards.NonFiniteError):
        segment_scan(x, off, method="kernel", nonfinite="raise")
    assert ops.launch_counts() == _counts()
    got = segment_scan(x, off, method="kernel", nonfinite="sanitize")
    torch.cuda.synchronize()
    assert ops.launch_counts() == _counts(seg_scan=1)
    assert torch.equal(got, segment_scan(torch.where(torch.isfinite(x), x, 0.0), off,
                                         method="kernel"))


@pytest.mark.parametrize("n", [1, 7, 4096, 128256, 300000])
def test_b8_keeps_a_sanitized_one_hot_row_on_its_index(dev, n):
    """A one-hot row (what ``sanitize`` gives a poisoned row) samples index 0 of
    its sorted order under every uniform, the band's edge included."""
    sp = torch.zeros((6, n), device=dev)
    sp[:, 0] = 1.0
    u = torch.tensor([[0.0], [0.5], [1 - 2 ** -16], [1 - 2 ** -24], [2 ** -30], [0.999]],
                     device=dev)
    for p in (0.0, 0.9, 1.0):
        assert split_mm.topp_mask_sample_tiles(sp, u, p=p).tolist() == [0] * 6


def test_top_p_sanitize_gives_poisoned_rows_their_greedy_token(dev):
    logits = torch.randn((4, 128256), generator=_gen(dev, 5), device=dev)
    logits[1, 64128:] = float("-inf")
    logits[2] = float("-inf")
    logits[3, [7, 90000]] = float("nan")
    u = torch.rand((4, 1), generator=_gen(dev, 6), device=dev)
    ops.reset_launch_counts()
    with pytest.raises(guards.NonFiniteError):
        top_p_sample(logits, u=u, method="kernel", nonfinite="raise")
    assert ops.launch_counts() == _counts()
    tok = top_p_sample(logits, u=u, method="kernel", nonfinite="sanitize")
    assert ops.launch_counts() == _counts(radix_pass=4, topp_tail=1)
    greedy = torch.argmax(torch.where(torch.isnan(logits), float("-inf"), logits), -1)
    assert tok[2] == 0 and tok[3] == greedy[3]
    assert torch.equal(tok[:2], top_p_sample(logits[:2], u=u[:2], method="kernel",
                                             nonfinite="raise"))


def test_page_budget_guard_fires_on_the_card(dev):
    cfg, _, _, params = _smoke_model(dev)
    eng = ContinuousEngine(cfg, params, max_batch=2, page_size=8, n_pages=9, max_len=24,
                           tick_tokens=4)
    eng._pos[:] = eng.n_blocks * eng.page_size
    eng._done[:] = False
    eng._rem[:] = 1
    with guards.checks():
        with pytest.raises(guards.GuardCheckError, match="page budget"):
            eng._decode_n(2)
    reqs = poisson_trace(4, rate=0.5, vocab_size=cfg.vocab_size, seed=3,
                         prompt_len=(2, 12), max_new=(1, 10))
    plain = eng.run(reqs)
    with guards.checks():
        checked = eng.run(reqs)
    assert plain["requests"] == checked["requests"] and plain["stats"] == checked["stats"]
    assert all((plain["streams"][k] == checked["streams"][k]).all() for k in plain["streams"])


# ---- method="auto" on the card: the table's "cuda" backend and the probe ----

AUTO_OPS = ("scan", "split", "sort", "top_p_sample", "segment_scan", "linear_scan")


def _auto_fn(op, n, dtype, dev):
    """``op``'s entry point on inputs of length ``n``: a function of its keyword
    arguments (none: the default call)."""
    g = _gen(dev, n)
    x = torch.randint(-100, 100, (4, n), generator=g, device=dev)
    x = x.to(dtype) if dtype == torch.int8 else torch.randn((4, n), generator=g,
                                                            device=dev).to(dtype)
    u = torch.rand((4, 1), generator=g, device=dev)
    if op == "scan":
        return lambda **kw: scan(x, **kw)
    if op == "split":
        f = torch.rand((4, n), generator=g, device=dev) < 0.5
        return lambda **kw: split(x, f, **kw)
    if op == "sort":
        return lambda **kw: radix_sort(x, **kw)
    if op == "top_p_sample":
        return lambda **kw: top_p_sample(x * 3, p=0.9, u=u, **kw)
    if op == "segment_scan":
        cuts = torch.sort(torch.randint(0, n + 1, (max(1, n // 1024) - 1,), generator=g,
                                        device=dev)).values
        off = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), n)]).to(torch.int32)
        return lambda **kw: segment_scan(x[0], off, **kw)
    a = (0.9 + 0.1 * torch.rand((4, n), generator=g, device=dev)).to(dtype)
    return lambda **kw: linear_scan(a, x, **kw)


@pytest.mark.parametrize("op", AUTO_OPS)
def test_auto_default_call_is_its_resolved_method(dev, op):
    """At one length in each "cuda" bucket up to 2^22, for every dtype in the table:
    the default call resolves with no warning, launches what the explicit call of
    the resolved method launches, and is bit-equal to it."""
    table = autotune.load_table()["backends"]["cuda"][op]
    for dt, entries in sorted(table.items()):
        bps = [b for b, _ in entries]
        for (lo, m_want), hi in zip(entries, bps[1:] + [None]):
            n = min((lo + hi) // 2 if hi else 2 * lo, 1 << 22)
            if n < lo:
                continue
            dtype = getattr(torch, dt)
            fn = _auto_fn(op, n, dtype, dev)
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                m = autotune.resolve_method(op, n, dtype, backend="cuda")
                ops.reset_launch_counts()
                out = fn()
                torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert m == m_want, (op, dt, n)
            ops.reset_launch_counts()
            ref = fn(method=m)
            torch.cuda.synchronize()
            assert ops.launch_counts() == counts, (op, dt, n, m)
            outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            assert all(torch.equal(a, b) for a, b in zip(outs, refs)), (op, dt, n, m)


def test_forced_probe_failure_raises_before_any_launch(dev):
    x = torch.randn((4, 1 << 16), device=dev)
    for m in ("kernel", "blocked"):
        ops.reset_launch_counts()
        with guards.force_probe_failure():
            with pytest.raises(guards.KernelUnavailableError):
                scan(x, method=m)
            with method_override(m), pytest.raises(guards.KernelUnavailableError):
                segment_scan(x[0], torch.tensor([0, 1 << 16], device=dev))
        torch.cuda.synchronize()
        assert ops.launch_counts() == _counts()
        assert scan(x, method=m).shape == x.shape          # the real probe passes


# ---- the precision axis: the kernels' bits are "highest"'s under every precision ----


def _precision_calls(dev, n=70001):
    g = _gen(dev, 7)
    x = torch.randn((3, n), generator=g, device=dev)
    a = 0.9 + 0.1 * torch.rand((3, n), generator=g, device=dev)
    off = torch.tensor([0, 5, 5, 4100, 4101, 60000, n], dtype=torch.int32, device=dev)
    return {"scan": lambda **kw: scan(x, **kw),
            "segment_scan": lambda **kw: segment_scan(x, off, **kw),
            "linear_scan": lambda **kw: linear_scan(a, x, **kw),
            "segment_linear_scan": lambda **kw: segment_linear_scan(a, x, off, **kw)}


@pytest.mark.parametrize("method", ["kernel", "blocked"])
@pytest.mark.parametrize("op", ["scan", "segment_scan", "linear_scan", "segment_linear_scan"])
def test_kernel_paths_return_highest_bits_under_every_precision(dev, op, method):
    """The CUDA kernels form no triangle: "compensated" and "fast" launch what
    "highest" launches and return its bits."""
    fn = _precision_calls(dev)[op]
    ops.reset_launch_counts()
    want = fn(method=method)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert sum(launches.values()) > 0
    for p in ("compensated", "fast"):
        ops.reset_launch_counts()
        got = fn(method=method, precision=p)
        torch.cuda.synchronize()
        assert ops.launch_counts() == launches, (op, method, p)
        assert torch.equal(got, want), (op, method, p)


def test_ssd_scan_kernel_bits_under_every_precision(dev):
    g = _gen(dev, 8)
    args = (torch.randn((2, 256, 4, 8), generator=g, device=dev),
            -(torch.randn((2, 256, 4), generator=g, device=dev) * 0.01).abs(),
            torch.randn((2, 256, 4, 8), generator=g, device=dev) * 0.3,
            torch.randn((2, 256, 4, 8), generator=g, device=dev) * 0.3)
    for method in ("kernel", "blocked"):
        want = ssd_scan(*args, chunk=64, scan_method=method)
        for p in ("compensated", "fast"):
            assert torch.equal(ssd_scan(*args, chunk=64, scan_method=method, precision=p),
                               want)


def test_split_f16_on_the_card_equals_the_cpu(dev):
    """``(hi, lo, e)`` bit-equal on the card and the CPU, on rows with a max near
    2^±126, subnormal elements and maxima, values past fp16's range, zeros, NaN
    and ±inf (a NaN's fp16 payload is the device's: NaN in the same place);
    22-bit mantissas come back exactly."""
    from repro_torch.core.precision import SPLIT_SHIFT, ldexp, split_f16
    g = torch.Generator().manual_seed(3)
    mag = 0.5 + torch.randn((8, 64), generator=g).abs()
    rows = torch.cat([mag * 2.0 ** 125, mag * 2.0 ** -125, mag * 2.0 ** -140,
                      mag * 65504.0 * 3, torch.zeros((1, 64)),
                      torch.randint(-(1 << 21), 1 << 21, (4, 64), generator=g).float()
                      * 2.0 ** -20])
    rows[-1, 3], rows[-2, 7], rows[-3, [1, 9]] = float("nan"), float("inf"), float("-inf")
    for axis in (-1, -2):
        cpu = split_f16(rows, axis=axis)
        card = split_f16(rows.to(dev), axis=axis)
        for c, k in zip(cpu, card):
            k = k.cpu()
            view = torch.int16 if c.dtype == torch.float16 else c.dtype
            nan = torch.isnan(c) if c.is_floating_point() else torch.zeros_like(c, dtype=bool)
            assert torch.equal(nan, torch.isnan(k) if k.is_floating_point() else nan), axis
            assert torch.equal(c.view(view)[~nan], k.view(view)[~nan]), axis
    hi, lo, e = split_f16(rows[-4:-3].to(dev), axis=-1)
    shift = torch.tensor(-SPLIT_SHIFT, device=dev)
    assert torch.equal(ldexp(hi.float() + ldexp(lo.float(), shift), e), rows[-4:-3].to(dev))


@pytest.mark.parametrize("precision", ["highest", "compensated", "fast"])
def test_matmul_method_on_the_card_within_the_precision_bound(dev, precision):
    """``"matmul"`` runs the real split on the card: within the precision's bound of
    fp64, within twice ``"highest"``'s bound of the same call on the CPU (whose
    plain products the CPU tests hold to JAX's), ``"fast"`` further than that from
    ``"highest"``; integer-valued rows exact."""
    from repro_torch.analysis import ulp
    g = _gen(dev, 7)
    xr = torch.randn((3, 4096), generator=g, device=dev)
    got = scan(xr, method="matmul", precision=precision)
    xn = xr.double().cpu().numpy()
    e = ulp.max_ulp(got.cpu().numpy(), ulp.scan_ref(xn), ulp.scan_scale(xn))
    assert e <= ulp.ulp_bound(precision, 4096), e
    tight = 2 * ulp.ulp_bound("highest", 4096)
    cpu = scan(xr.cpu(), method="matmul", precision=precision).double().numpy()
    assert ulp.max_ulp(got.cpu().numpy(), cpu, ulp.scan_scale(xn)) <= tight
    if precision == "fast":
        hi = scan(xr, method="matmul").double().cpu().numpy()
        assert ulp.max_ulp(got.cpu().numpy(), hi, ulp.scan_scale(xn)) > tight
    xi = torch.randint(-3, 4, (3, 4096), generator=g, device=dev).float()
    assert torch.equal(scan(xi, method="matmul", precision=precision),
                       xi.double().cumsum(-1).float())


# ---------------------------------------------------------------------------
# the MoE layer's dispatch, local windows and qk-norm (deepseek, gemma2, qwen3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [24, 3000, 200_000])
def test_moe_dispatch_positions_on_the_kernels_equal_the_cumsum(dev, n):
    """Both dispatch modes on "kernel" (B9 / B1) and "blocked" (B10-B12 / B2-B4,
    more than one block at 200000) give the int64 cumsum's positions, bit-equal."""
    e = 64
    eidx = torch.randint(0, e, (1, n), generator=_gen(dev), device=dev)
    eidx[:, : n // 3] = 5                                     # a skewed run
    onehot = torch.nn.functional.one_hot(eidx, e)
    ref = torch.gather(torch.cumsum(onehot, 1) - onehot, 2, eidx[..., None])[..., 0]
    multi = scan_pipeline.block_geometry(n, 128, 8)[2] > 1
    wants = {("kernel", "segmented"): _counts(seg_scan=1),
             ("kernel", "grouped"): _counts(scan_mm=1),
             ("blocked", "segmented"): _counts(seg_block_scan=1, seg_summaries=int(multi),
                                               seg_carry=int(multi)),
             ("blocked", "grouped"): _counts(block_scan=1, block_sums=int(multi))}
    for (method, mode), want in wants.items():
        ops.reset_launch_counts()
        got = moe.dispatch_positions(eidx, e, scan_method=method, mode=mode)
        assert ops.launch_counts() == want, (method, mode)
        assert got.dtype == torch.int32 and torch.equal(got.to(torch.int64), ref)


def test_moe_forward_launches_b9_once_per_moe_layer(dev):
    """deepseek SMOKE forward/loss: 2 B9 launches under "kernel" (one a MoE layer), 2
    B12 under "blocked", none under "vector"; logits, ce and aux bit-equal across the
    three (the positions are exact); and within twice the "vector" forward's
    card-to-CPU distance plus 2e-5 of the CPU."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks.to(dev), "loss_mask": (toks % 3 > 0).to(dev)}
    gparams = _to_device(params, dev)
    out = {}
    for method, want in (("vector", _counts()), ("kernel", _counts(seg_scan=2)),
                         ("blocked", _counts(seg_block_scan=2))):
        model = build_model(dataclasses.replace(cfg, scan_method=method))
        ops.reset_launch_counts()
        logits = model.forward(gparams, batch)
        assert ops.launch_counts() == want
        ops.reset_launch_counts()
        _, parts = model.loss(gparams, batch)
        assert ops.launch_counts() == want
        out[method] = (logits, parts["ce"], parts["aux"])
        if method != "vector":
            assert all(torch.equal(a, b) for a, b in zip(out[method], out["vector"]))
    cpu = build_model(cfg).forward(params, {"tokens": toks})
    floor = float((out["vector"][0].cpu() - cpu).abs().max())
    assert floor <= 1e-3 and float(out["vector"][2]) > 0


def test_local_window_decode_ignores_the_cache_outside_it(dev):
    """gemma2 SMOKE's local layer on the card: past its window of 16, dense and paged
    decode (scalar and per-row positions) give the same bits after the cache outside
    the window is overwritten, paged equal to dense; without the window they differ."""
    cfg = get_config("gemma2-2b", smoke=True)
    p = {k: v[0] for k, v in build_model(cfg).init(0, device=dev)["stack"]["sub0"]["attn"]
         .items()}
    g = _gen(dev, 3)
    b, t, ps, pos, w = 2, 48, 8, 40, cfg.local_window
    kh, hd = cfg.n_kv_heads, cfg.head_dim_
    x = torch.randn((b, 1, cfg.d_model), generator=g, device=dev)
    k, v = (torch.randn((b, t, kh, hd), generator=g, device=dev) for _ in range(2))
    outside = torch.ones(t, dtype=torch.bool, device=dev)
    outside[pos - w + 1:pos + 1] = False
    k2, v2 = k.clone(), v.clone()
    k2[:, outside] = torch.randn_like(k2[:, outside])
    v2[:, outside] = torch.randn_like(v2[:, outside])
    table = (torch.randperm(b * t // ps, generator=g, device=dev) + 1).reshape(b, -1)

    def paged(kk, vv):
        pool = [torch.zeros((b * t // ps + 1, ps, kh, hd), device=dev) for _ in range(2)]
        pool[0][table] = kk.reshape(b, -1, ps, kh, hd)
        pool[1][table] = vv.reshape(b, -1, ps, kh, hd)
        return {"k": pool[0], "v": pool[1], "pages": table.to(torch.int32)}

    for at in (pos, torch.full((b,), pos, device=dev)):
        def dense(kk, vv, **kw):
            return attention.attn_decode(p, x, cfg, {"k": kk.clone(), "v": vv.clone()}, at,
                                         cdt=torch.float32, **kw)[0]
        y = dense(k, v, window=w)
        assert torch.equal(y, dense(k2, v2, window=w))
        yp = attention.attn_decode_paged(p, x, cfg, paged(k, v), at, cdt=torch.float32,
                                         window=w)[0]
        assert torch.equal(yp, y)
        assert torch.equal(attention.attn_decode_paged(
            p, x, cfg, paged(k2, v2), at, cdt=torch.float32, window=w)[0], y)
        assert float((dense(k, v) - y).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-moe-16b"])
def test_continuous_engine_on_local_and_moe_stacks_equals_its_dense_replay(dev, arch):
    """ContinuousEngine (greedy) on the SMOKE model on the card, the MoE dispatch on
    "kernel": every decode step's logits bit-equal to the dense replay; one B9 a MoE
    layer in each prefill and each decode step run."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), scan_method="kernel")
    params = build_model(cfg).init(0, device=dev)
    eng = ContinuousEngine(cfg, params, max_batch=2, page_size=8, n_pages=9, max_len=24,
                           tick_tokens=4, alloc_method="vector")
    reqs = poisson_trace(4, vocab_size=cfg.vocab_size, rate=0.5, seed=3, prompt_len=(9, 14),
                         max_new=(4, 8))
    runs, tick = [], eng._decode_n
    eng._decode_n = lambda n: (runs.append(n), tick(n))[1]
    ops.reset_launch_counts()
    with DenseReplay(eng) as rep:
        eng.run(reqs)
    out = rep.result()
    assert out["bit_equal"] and out["row_steps"] > 0, out
    assert out["steps"] == sum(runs)
    moe_layers = cfg.n_layers - cfg.moe.first_k_dense if cfg.moe else 0
    # each prefill, each decode step run and each of its replays: one B9 a MoE layer
    assert ops.launch_counts()["seg_scan"] == moe_layers * (len(reqs) + 2 * sum(runs))


def test_qk_norm_model_on_the_card_matches_the_cpu(dev):
    """qwen3 SMOKE (per-head q/k RMSNorm, random norm scales) prefill and two decode
    steps on the card within 1e-4 of the CPU; greedy tokens equal."""
    cfg = get_config("qwen3-4b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    for name in ("q_norm", "k_norm"):
        params["stack"]["sub0"]["attn"][name]["g"].normal_(generator=torch.Generator()
                                                           .manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(2))
    u = torch.rand((4, 2), generator=torch.Generator().manual_seed(3))
    model = build_model(cfg)
    lc, _ = model.prefill(params, {"tokens": toks}, cache_len=20)
    lg, _ = model.prefill(_to_device(params, dev), {"tokens": toks.to(dev)}, cache_len=20)
    assert float((lg.cpu() - lc).abs().max()) < 1e-4
    a = ServeEngine(cfg, params, max_len=20, sampler="greedy", device="cpu").generate(
        {"tokens": toks}, 4, uniforms=u)
    b = ServeEngine(cfg, _to_device(params, dev), max_len=20, sampler="greedy").generate(
        {"tokens": toks}, 4, uniforms=u)
    assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("method,want", [
    ("kernel", dict(scan_mm=2, linrec_scan=2)),
    ("blocked", dict(block_scan=2, linrec_block_scan=2))])
def test_mlstm_chunked_on_the_kernels_matches_the_fp64_oracle(dev, method, want):
    """The mLSTM cell on (2, 300, 4, 64), chunks of 128 (a ragged last one), q and k
    >= 0 so that its normaliser does not cancel: two scans of each kind (numerator
    and normaliser), within 2e-5 of max|h| of the fp64 sequential oracle."""
    from repro_torch.core.ssd import mlstm_chunked, mlstm_ref
    g = _gen(dev, 11)
    q, k, v = (torch.randn((2, 300, 4, 64), generator=g, device=dev) for _ in range(3))
    q, k = q.abs(), k.abs()
    i_pre = torch.randn((2, 300, 4), generator=g, device=dev)
    f_pre = torch.randn((2, 300, 4), generator=g, device=dev) + 3.0
    ops.reset_launch_counts()
    h = mlstm_chunked(q, k, v, i_pre, f_pre, chunk=128, scan_method=method)
    torch.cuda.synchronize(dev)
    assert ops.launch_counts() == _counts(**want)
    ref = mlstm_ref(*(t.double() for t in (q, k, v, i_pre, f_pre)))
    assert float((h.double() - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


def test_xlstm_prefill_and_decode_follow_the_forward_on_the_card(dev):
    """xlstm SMOKE (3 mLSTM + 1 sLSTM layers) in fp32 under "kernel" over 300 tokens
    (3 chunks of 128): the forward and a prefill of 296 launch 6 B1 + 6 B13 (two
    scans a mLSTM layer), a prefill of one chunk 6 B1 alone, a decode step none;
    prefill plus 4 decode steps within 1e-3 of the forward over the same tokens, and
    the forward within 1e-3 of the CPU's (the cell's normaliser cancels at random
    weights, so fp32 programs differ there by ~4e-4)."""
    cfg = dataclasses.replace(get_config("xlstm-350m", smoke=True), scan_method="kernel")
    params = build_model(cfg).init(0, device="cpu")
    gp = _to_device(params, dev)
    model = build_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 300),
                         generator=torch.Generator().manual_seed(4))
    ops.reset_launch_counts()
    full = model.forward(gp, {"tokens": toks.to(dev)})
    assert ops.launch_counts() == _counts(scan_mm=6, linrec_scan=6)
    ops.reset_launch_counts()
    model.prefill(gp, {"tokens": toks[:, :100].to(dev)})
    assert ops.launch_counts() == _counts(scan_mm=6)
    ops.reset_launch_counts()
    lg, caches = model.prefill(gp, {"tokens": toks[:, :296].to(dev)}, cache_len=300)
    assert ops.launch_counts() == _counts(scan_mm=6, linrec_scan=6)
    errs = [float((lg - full[:, 295]).abs().max())]
    ops.reset_launch_counts()
    for i in range(4):
        lg, caches = model.decode_step(gp, toks[:, 296 + i:297 + i].to(dev), caches, 296 + i)
        errs.append(float((lg - full[:, 296 + i]).abs().max()))
    assert ops.launch_counts() == _counts()
    assert max(errs) <= 1e-3, errs
    cpu = build_model(cfg).forward(params, {"tokens": toks})
    assert float((full.cpu() - cpu).abs().max()) <= 1e-3


def test_mla_absorbed_decode_matches_the_expanded_form_on_the_card(dev):
    """minicpm3 SMOKE's layer 0 on the card: ``mla_decode`` at position 16 after a
    prefill of 16 within 2e-5 of the last row of ``mla_full`` over the 17 tokens."""
    cfg = get_config("minicpm3-4b", smoke=True)
    p = {k: (v[0] if not isinstance(v, dict) else {"g": v["g"][0]}) for k, v in
         build_model(cfg).init(0, device=dev)["stack"]["sub0"]["attn"].items()}
    x = torch.randn((2, 17, cfg.d_model), generator=_gen(dev, 5), device=dev)
    pos = torch.arange(17, dtype=torch.int32, device=dev)[None]
    _, cache = attention.mla_full(p, x[:, :16], cfg, positions=pos[:, :16],
                                  cdt=torch.float32, return_cache=True, cache_len=20)
    dec = attention.mla_decode(p, x[:, 16:], cfg, cache, 16, cdt=torch.float32)[0]
    full = attention.mla_full(p, x, cfg, positions=pos, cdt=torch.float32)
    assert float((dec[:, 0] - full[:, 16]).abs().max()) <= 2e-5


@pytest.mark.parametrize("arch", ["whisper-small", "paligemma-3b", "minicpm3-4b"])
def test_encdec_vlm_and_mla_models_on_the_card_match_the_cpu(dev, arch):
    """The SMOKE model's prefill logits on the card within 1e-4 of the CPU's and its
    greedy stream equal, the stub embeddings from ``synth_batch``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import synth_batch
    cfg = get_config(arch, smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    batch = synth_batch(cfg, ShapeConfig("serve", 24, 2, "prefill"),
                        torch.Generator().manual_seed(2))
    off = cfg.n_img_tokens if cfg.family == "vlm" else 0
    clen = batch["tokens"].shape[1] + off + 4
    model = build_model(cfg)
    lc, _ = model.prefill(params, batch, cache_len=clen)
    lg, _ = model.prefill(_to_device(params, dev), {k: v.to(dev) for k, v in batch.items()},
                          cache_len=clen)
    assert float((lg.cpu() - lc).abs().max()) < 1e-4
    a = ServeEngine(cfg, params, max_len=clen, sampler="greedy", device="cpu").generate(
        batch, 4)
    b = ServeEngine(cfg, _to_device(params, dev), max_len=clen, sampler="greedy").generate(
        batch, 4)
    assert torch.equal(a, b.cpu())


# ---------------------------------------------------------------------------
# gradients on the card (training)
# ---------------------------------------------------------------------------


def test_matmul_f32_gradient_matches_widening(dev):
    """The fp32-output product of bf16 operands (``torch.mm(out_dtype=)``, no
    derivative of its own) has the widening path's gradients, bit for bit."""
    from repro_torch.models.layers import bmm_f32, matmul_f32
    gen = torch.Generator(device=dev).manual_seed(0)
    for fn, sa, sb in ((matmul_f32, (3, 33, 64), (64, 48)), (bmm_f32, (4, 33, 64), (4, 64, 48))):
        a = torch.randn(sa, generator=gen, device=dev).bfloat16().requires_grad_()
        b = torch.randn(sb, generator=gen, device=dev).bfloat16().requires_grad_()
        w = torch.randn(sa[:-1] + sb[-1:], generator=gen, device=dev)
        (fn(a, b) * w).sum().backward()
        a2, b2 = a.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
        (torch.matmul(a2.float(), b2.float()) * w).sum().backward()
        assert a.grad.dtype == b.grad.dtype == torch.bfloat16
        assert torch.equal(a.grad, a2.grad) and torch.equal(b.grad, b2.grad)


@pytest.mark.parametrize("method", ["kernel", "blocked"])
def test_linear_scan_adjoint_on_card(dev, method):
    """The analytic adjoint on the card: one more launch of the method's kernels in
    the backward pass (rows and the column walk), gradients within 1e-5·max of
    fp64 "vector" autograd, ``initial`` included."""
    gen = torch.Generator(device=dev).manual_seed(1)
    rows_want = (_counts(linrec_scan=1) if method == "kernel" else
                 _counts(linrec_summaries=1, linrec_block_scan=1))
    walk_want = _counts(**{"linrec_scan" if method == "kernel" else "linrec_block_scan": 1})
    cases = (((2, 300_000), (2, 300_000), -1, (2,), rows_want),
             ((2, 16, 3, 1, 1), (2, 16, 3, 4, 4), 1, (2, 3, 4, 4), walk_want))
    for sa, sb, axis, si, want in cases:
        a = 0.5 + 0.5 * torch.rand(sa, generator=gen, device=dev)
        b = torch.randn(sb, generator=gen, device=dev)
        i = torch.randn(si, generator=gen, device=dev)
        g = torch.randn(torch.broadcast_shapes(sa, sb), generator=gen, device=dev)
        xs64 = [t.double().requires_grad_() for t in (a, b, i)]
        y64 = linear_scan(xs64[0], xs64[1], axis=axis, method="vector", initial=xs64[2])
        refs = torch.autograd.grad(y64, xs64, g.double())
        xs = [t.clone().requires_grad_() for t in (a, b, i)]
        ops.reset_launch_counts()
        y = linear_scan(xs[0], xs[1], axis=axis, method=method, initial=xs[2])
        torch.cuda.synchronize()
        assert ops.launch_counts() == want
        ops.reset_launch_counts()
        got = torch.autograd.grad(y, xs, g)
        torch.cuda.synchronize()
        assert ops.launch_counts() == want
        for gt, rf in zip(got, refs):
            assert gt.shape == rf.shape
            assert float((gt.double() - rf).abs().max()) <= 1e-5 * float(rf.abs().max())


def test_kernel_methods_refuse_grad_on_card(dev):
    """Where ``jax.grad`` fails the port raises on the card too, before any launch;
    no kernel output comes back with its graph cut."""
    x = torch.randn(2, 5000, device=dev, requires_grad=True)
    off = torch.tensor([0, 1000, 5000], device=dev)
    calls = [lambda m: scan(x, method=m), lambda m: segment_scan(x, off, method=m)]
    for method in ("kernel", "blocked"):
        for call in calls:
            ops.reset_launch_counts()
            with pytest.raises(NotImplementedError, match="has no gradient"):
                call(method)
            assert not any(ops.launch_counts().values())
        with torch.no_grad():
            assert not scan(x, method=method).requires_grad
    ops.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="has no gradient"):
        split(x, x > 0, method="kernel")
    assert not any(ops.launch_counts().values())
    y = scan(x, method="vector")
    assert y.requires_grad

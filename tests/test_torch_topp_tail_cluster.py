"""The arithmetic of B8's cluster kernel against the plain tail and JAX's Pallas kernel.

``csrc/topp_tail.cu`` runs one thread-block cluster of ``TOPP_CLUSTER`` CTAs a
row: each CTA holds a slice of the row, sums it in a fixed tree (a thread's run
in order, the lanes' and the warps' totals by shuffle scans), the slices' sums
are folded left to right across the cluster, ``theta`` comes from the last
element's own ``cdf``, and the slices' counts of ``cdf < theta`` are summed.
``split_mm._topp_tail_cluster`` repeats that operation for operation (the card
tests hold the kernel's index to it on every row).  Here, on the CPU, it is held
to ``topp_tail_plain`` and to JAX's ``topp_mask_sample_tiles`` (Pallas interpret
mode) on rows whose every cut and CDF step is far wider than the band
``TOPP_BAND``, so all three must pick the same index: rows of 1 to 128256 and
2^20 (walked in rounds), clusters of 1, 2 and 8 CTAs (empty slices included),
``p`` in {0, 0.5, 0.9, 1}, uniforms in the middle of a kept step.  Its sums
stay within the rounding count that ``topp_tail.cu`` states of the fp64 sums.
Inputs are drawn with numpy from a seed.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import split_mm as jax_split_mm
from repro_torch.kernels import split_mm

CSRC = Path(split_mm.__file__).parent / "csrc"
ROWS = [1, 3, 8, 31, 33, 1000, 128256]
PS = [0.0, 0.5, 0.9, 1.0]


@functools.lru_cache(maxsize=None)
def _peaked(n: int, p: float, seed: int = 0):
    """Three sorted fp32 rows with their mass on at most four tokens (the rest under
    1e-4 of it), and per row a uniform that puts theta in the middle of one kept
    CDF step (a different step a row)."""
    rng = np.random.default_rng(seed + n)
    logits = rng.standard_normal((3, n)) * 0.1
    k = min(4, n)
    logits[:, :k] += np.array([9.0, 8.0, 7.0, 6.0])[:k] + np.log(n)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    sp = -np.sort(-(e / e.sum(-1, keepdims=True)).astype(np.float32), axis=-1)
    u = np.empty((3, 1), np.float32)
    for r, row in enumerate(sp.astype(np.float64)):
        cum = np.cumsum(row)
        kept = max(int(np.count_nonzero(cum - row <= p)), 1)
        step = r % min(kept, k)
        u[r, 0] = (cum[step] - row[step] / 2) / cum[kept - 1]
    return sp, u


@functools.lru_cache(maxsize=None)
def _jax(n: int, p: float) -> np.ndarray:
    sp, u = _peaked(n, p)
    return np.asarray(jax_split_mm.topp_mask_sample_tiles(jnp.asarray(sp), jnp.asarray(u),
                                                          p=p))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("cluster", [1, 2, 8])
@pytest.mark.parametrize("n", ROWS)
def test_cluster_model_matches_plain_and_jax(n, cluster, p):
    sp, u = _peaked(n, p)
    t_sp, t_u = torch.from_numpy(sp), torch.from_numpy(u)
    j, parts = split_mm._topp_tail_cluster(t_sp, t_u, p=p, cluster=cluster, parts=True)
    assert j.dtype == torch.int32
    np.testing.assert_array_equal(j.numpy(), split_mm.topp_tail_plain(t_sp, t_u, p=p).numpy())
    np.testing.assert_array_equal(j.numpy(), _jax(n, p))
    # the pieces the kernel passes between its CTAs: the slices' counts add up to
    # the index before the clip, theta comes from the last element's own cdf, and
    # slices past the row's end hold nothing
    slice_, rounds, _, _ = split_mm.topp_tail_geometry(n, cluster)
    assert parts["counts"].shape == parts["slice_sums"].shape == (3, rounds * cluster)
    assert torch.equal(torch.clamp(parts["counts"].sum(-1), 0, n - 1).to(torch.int32), j)
    assert torch.equal(parts["last_cdf"], parts["cdf"][:, -1])
    empty = torch.arange(rounds * cluster) * slice_ >= n
    assert not parts["slice_sums"][:, empty].any() and not parts["counts"][:, empty].any()
    assert not parts["masked_sums"][:, empty].any()


def test_cluster_model_rounds_at_2_20():
    """A row of 2^20 takes three rounds of eight slices of ``TOPP_MAX_SLICE``, 1024
    threads a CTA."""
    n, p = 1 << 20, 0.9
    assert split_mm.topp_tail_geometry(n) == (split_mm.TOPP_MAX_SLICE, 3, 1024, 55)
    sp, u = _peaked(n, p)
    t_sp, t_u = torch.from_numpy(sp), torch.from_numpy(u)
    j = split_mm._topp_tail_cluster(t_sp, t_u, p=p)
    np.testing.assert_array_equal(j.numpy(), split_mm.topp_tail_plain(t_sp, t_u, p=p).numpy())
    np.testing.assert_array_equal(j.numpy(), _jax(n, p))


@pytest.mark.parametrize("n,cluster,threads", [(128256, 8, None), (257216, 8, None),
                                               (1 << 20, 8, None), (128256, 8, 1024),
                                               (128256, 1, 1024), (32000, 2, 512)])
def test_cluster_sums_within_the_stated_roundings(n, cluster, threads):
    """On flat random rows every ``cum`` and ``cdf`` value stays within
    ``(items - 1) + 5 + 5 + (slices - 1) + 2`` roundings of the row's mass of the
    fp64 sum of the same terms (the count ``topp_tail.cu`` states), far inside
    ``TOPP_BAND`` = 256 roundings."""
    rng = np.random.default_rng(n + (threads or 0))
    e = np.exp(rng.standard_normal((2, n)) * 2.0)
    sp = torch.from_numpy(-np.sort(-(e / e.sum(-1, keepdims=True)).astype(np.float32), -1))
    u = torch.from_numpy(rng.random((2, 1), dtype=np.float32))
    _, parts = split_mm._topp_tail_cluster(sp, u, p=0.9, cluster=cluster, threads=threads,
                                           parts=True)
    _, rounds, _, items = split_mm.topp_tail_geometry(n, cluster, threads)
    roundings = (items - 1) + 5 + 5 + (rounds * cluster - 1) + 2
    assert roundings * 2.0 ** -24 < split_mm.TOPP_BAND / 2
    mass = sp.double().sum(-1, keepdim=True)
    for got, terms in ((parts["cum"], sp), (parts["cdf"], parts["masked"])):
        err = (got.double() - torch.cumsum(terms.double(), -1)).abs().max(-1).values
        assert bool((err <= roundings * 2.0 ** -24 * mass[:, 0]).all())


def test_cluster_model_reads_unsorted_rows_as_a_count():
    """B8 does not use the order: on an unsorted row the index is still the count
    of ``cdf < theta`` of the plain version."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 5000)).astype(np.float32)
    sp = torch.from_numpy(x / x.sum(-1, keepdims=True))
    u = torch.from_numpy(rng.random((2, 1), dtype=np.float32))
    for p in (0.3, 1.0):
        np.testing.assert_array_equal(split_mm._topp_tail_cluster(sp, u, p=p).numpy(),
                                      split_mm.topp_tail_plain(sp, u, p=p).numpy())


def test_geometry_matches_the_kernel_source():
    """The model's cluster, run cap and slice limit are the kernel's."""
    src = (CSRC / "topp_tail.cu").read_text()
    for name, value in (("kCluster", split_mm.TOPP_CLUSTER),
                        ("kMaxItems", split_mm.TOPP_MAX_ITEMS),
                        ("kMaxSlice", split_mm.TOPP_MAX_SLICE)):
        m = re.search(rf"constexpr (?:int|long long) {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name
    # the slice fits a CTA's 227 KB of shared memory with the shift's 4 elements
    assert (split_mm.TOPP_MAX_SLICE + 4) * 4 + 1024 <= 232448
    # a llama3 row is eight slices of 16032 elements, one round, 256 threads of 63
    assert split_mm.topp_tail_geometry(128256) == (16032, 1, 256, 63)
    # zamba2's 32000: 256 threads of 17; paligemma's 257216: one round, 512 of 63
    assert split_mm.topp_tail_geometry(32000) == (4000, 1, 256, 17)
    assert split_mm.topp_tail_geometry(257216) == (32152, 1, 512, 63)
    # every row of one round keeps within 81 roundings: runs of at most 63
    for n in (1, 9, 4096, 32000, 64128, 128256, 129025, 257216, 8 * 32256 + 1, 8 * 55296):
        slice_, rounds, threads, items = split_mm.topp_tail_geometry(n)
        assert rounds == 1 and items <= split_mm.TOPP_MAX_ITEMS and slice_ <= threads * items

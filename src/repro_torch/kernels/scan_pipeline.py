"""B2–B4: the blocked multi-core scan pipeline of paper §4 (Alg. 3).

Port of ``repro/kernels/scan_pipeline.py``.  A row is cut into blocks of
``block_len = m*s`` elements (``block_tiles`` tiles of ``s×s``, clamped so a
short row pays for one block at most), and three kernels scan it:

* :func:`block_partial_sums` (B2, ``csrc/block_sums.cu``) — phase 1's
  "vector recompute": the sum of each block, ``(b, nb, m, s) -> (b, nb)``;
* :func:`carry_scan` (B3, ``csrc/carry_scan.cu``) — phase 2: the exclusive
  prefix of the block sums, the per-block carries;
* :func:`block_scan_carry` (B4, ``csrc/block_scan.cu``) — phases 1 and 3
  fused: each block's ScanU/ScanUL1 partial scan on its ``(m, s)`` view plus
  its carry, so each element is read once and written once.

:func:`block_sums_carries` is B2 and B3 in one launch: B2's second entry point
writes the sums, and the CTA that finishes a row's last block runs B3's walk
(``csrc/carry_row.cuh``) over them, so its carries are bit for bit
:func:`carry_scan`'s.  It counts one launch, under ``block_sums`` (and, apart
from the kernels' counts, under ``block_sums_carries``).

:func:`blocked_scan` runs the pipeline in two launches, the fused sums and
carries and then B4.  With one block per row (``nb == 1``) the carries are
zero and only B4 is launched.

On CUDA tensors the wrappers launch the kernels, which mask the ragged end of
a row themselves, so :func:`blocked_scan` pads nothing there.  On CPU tensors
they run the plain versions (``*_plain``) on the zero-padded ``(b, nb, m, s)``
block view, as the JAX code does.  The plain versions build on the port's
``tile_scan_scanu`` and ``pdot``, so an integer product never goes through
torch's wrapping ``int8 @ int8``.  dtype rules follow ``accum_dtype_for``.

``precision`` reaches B4's products, as in JAX; B2 and B3 take none (their
Pallas kernels form no triangle).  On the card B4 sums in IEEE fp32 under
every precision, so its result is the bits of ``"highest"``.
"""
from __future__ import annotations

import torch

from repro_torch.core import guards
from repro_torch.core.precision import PRECISIONS, pdot
from repro_torch.core.scan import (_operand_dtype, accum_dtype_for,
                                   strictly_lower_ones, tile_scan_scanu,
                                   upper_ones)
from repro_torch.kernels import _build
from repro_torch.kernels.scan_mm import MAX_TILE, VARIANTS, kernel_operand

__all__ = ["blocked_scan", "block_partial_sums", "carry_scan", "block_sums_carries",
           "block_scan_carry", "blocked_scan_plain", "block_partial_sums_plain",
           "carry_scan_plain", "block_sums_carries_plain", "block_scan_carry_plain",
           "block_geometry"]

_CARRY_CODES = {torch.float32: 0, torch.int32: 1}


def block_geometry(n: int, s: int, block_tiles: int):
    """``(m, block_len, nb)`` of the pipeline for a row of ``n`` elements.

    Example:
        >>> block_geometry(1000, 8, 4)
        (32, 256, 4)
    """
    ell = s * s
    t = max(1, min(block_tiles, -(-n // ell)))   # tiles per block, clamped
    m = t * s
    return m, m * s, -(-n // (m * s))


# ---------------------------------------------------------------------------
# plain versions (the CPU path)
# ---------------------------------------------------------------------------


def block_partial_sums_plain(blocks: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """Block sums of ``(b, nb, m, s)`` blocks in ``acc``: ``(b, nb)``."""
    return torch.sum(blocks.to(acc), dim=(-2, -1), dtype=acc)


def carry_scan_plain(sums: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix of each row of the ``(b, nb)`` block sums."""
    inc = torch.cumsum(sums, dim=-1, dtype=sums.dtype)
    return torch.cat([torch.zeros_like(inc[:, :1]), inc[:, :-1]], dim=-1)


def block_sums_carries_plain(blocks: torch.Tensor, acc: torch.dtype):
    """:func:`block_partial_sums_plain`, then :func:`carry_scan_plain` on its sums."""
    sums = block_partial_sums_plain(blocks, acc)
    return sums, carry_scan_plain(sums)


def block_scan_carry_plain(blocks: torch.Tensor, carries: torch.Tensor, *,
                           variant: str, acc: torch.dtype,
                           precision: str = "highest") -> torch.Tensor:
    """Each ``(m, s)`` block scanned as ``A@U_s`` plus its row prefix, plus its carry.

    The row prefix is the exclusive prefix of the block's ``m`` row sums:
    their cumsum minus the row sum for ``scanu`` (``tile_scan_scanu`` on the
    rectangular block), the ``L⁻_m`` product for ``scanul1``.
    """
    if variant == "scanu":
        local = tile_scan_scanu(blocks, accum_dtype=acc, precision=precision)
    else:
        m, s = blocks.shape[-2:]
        u = upper_ones(s, _operand_dtype(blocks.dtype), blocks.device)
        local = pdot(blocks, u, acc=acc, precision=precision, exact="right")
        lm = strictly_lower_ones(m, acc, blocks.device)
        # (L⁻_m @ row_sums) for every block, as row vectors times L⁻_mᵀ
        row_prefix = pdot(local[..., -1], lm.t(), acc=acc, precision=precision,
                          exact="right")
        local = local + row_prefix[..., None]
    return local + carries.to(acc)[..., None, None]


def blocked_scan_plain(xb: torch.Tensor, *, s: int, block_tiles: int, variant: str,
                       acc: torch.dtype, precision: str = "highest") -> torch.Tensor:
    """Plain version of the whole pipeline on ``(b, n)`` rows.

    Zero-pads the rows to whole blocks, runs the three plain phases on the
    ``(b, nb, m, s)`` view (phases 1 and 2 only when ``nb > 1``) and slices
    the padding off.
    """
    b, n = xb.shape
    m, block_len, nb = block_geometry(n, s, block_tiles)
    pad = nb * block_len - n
    xp = torch.nn.functional.pad(xb.to(acc), (0, pad)) if pad else xb
    blocks = xp.reshape(b, nb, m, s)
    if nb == 1:
        carries = torch.zeros((b, 1), dtype=acc, device=xb.device)
    else:
        carries = block_sums_carries_plain(blocks, acc)[1]
    out = block_scan_carry_plain(blocks, carries, variant=variant, acc=acc,
                                 precision=precision)
    return out.reshape(b, nb * block_len)[:, :n]


# ---------------------------------------------------------------------------
# kernel launches on (b, n) rows; the kernels mask the ragged end
# ---------------------------------------------------------------------------


def _block_sums_cuda(xb, code, acc, nb, block_len):
    b, n = xb.shape
    sums = torch.empty((b, nb), dtype=acc, device=xb.device)
    if _build.record("block_sums", (xb,), (sums,)):
        return sums
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        _build.launch("block_sums", xb.data_ptr(), sums.data_ptr(), b, n, nb,
                      block_len, code, stream)
    return sums


def _block_sums_carries_cuda(xb, code, acc, nb, block_len):
    b, n = xb.shape
    sums = torch.empty((b, nb), dtype=acc, device=xb.device)
    carries = torch.empty_like(sums)
    tickets = torch.empty((b,), dtype=torch.int32, device=xb.device)
    if _build.record("block_sums", (xb,), (sums, carries)):
        return sums, carries
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        _build.launch("block_sums", xb.data_ptr(), sums.data_ptr(), carries.data_ptr(),
                      tickets.data_ptr(), tickets.numel() * tickets.element_size(), b, n,
                      nb, block_len, code, stream, entry="repro_block_sums_carries")
    _build.LAUNCHES["block_sums_carries"] += 1   # B3's walk ran in this launch too
    return sums, carries


def _carry_scan_cuda(sums):
    b, nb = sums.shape
    carries = torch.empty_like(sums)
    if _build.record("carry_scan", (sums,), (carries,)):
        return carries
    with torch.cuda.device(sums.device):
        stream = torch.cuda.current_stream(sums.device).cuda_stream
        _build.launch("carry_scan", sums.data_ptr(), carries.data_ptr(), b, nb,
                      _CARRY_CODES[sums.dtype], stream)
    return carries


def _block_scan_cuda(xb, code, carries, acc, nb, block_len, s, variant):
    b, n = xb.shape
    out = torch.empty((b, n), dtype=acc, device=xb.device)
    if _build.record("block_scan", (xb, carries), (out,)):
        return out
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        _build.launch("block_scan", xb.data_ptr(), carries.data_ptr(), out.data_ptr(),
                      b, n, nb, block_len, s, 1 if variant == "scanul1" else 0, code,
                      stream)
    return out


# ---------------------------------------------------------------------------
# the phases on the (b, nb, m, s) block view, and the whole pipeline
# ---------------------------------------------------------------------------


def block_partial_sums(blocks: torch.Tensor, *, accum_dtype=None) -> torch.Tensor:
    """Phase 1 reduction: block sums of ``(b, nb, m, s)`` blocks -> ``(b, nb)``.

    Reads the raw input only, so it does not wait on the partial scans.
    """
    if blocks.dim() != 4:
        raise ValueError(f"block_partial_sums: blocks must be (b, nb, m, s), got "
                         f"{tuple(blocks.shape)}")
    b, nb, m, s = blocks.shape
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(blocks.dtype)
    if not _build.on_card(blocks) or blocks.numel() == 0:
        return block_partial_sums_plain(blocks, acc)
    xb, code = kernel_operand(blocks.reshape(b, nb * m * s), acc, op="block_partial_sums")
    return _block_sums_cuda(xb, code, acc, nb, m * s)


def carry_scan(sums: torch.Tensor) -> torch.Tensor:
    """Phase 2: exclusive prefix of the ``(b, nb)`` block sums, per row."""
    if sums.dim() != 2:
        raise ValueError(f"carry_scan: sums must be (b, nb), got {tuple(sums.shape)}")
    if not _build.on_card(sums) or sums.numel() == 0:
        return carry_scan_plain(sums)
    if sums.dtype not in _CARRY_CODES:
        raise TypeError(f"carry_scan: the CUDA kernel takes {list(_CARRY_CODES)}, "
                        f"got {sums.dtype}")
    return _carry_scan_cuda(sums.contiguous())


def block_sums_carries(blocks: torch.Tensor, *, accum_dtype=None):
    """Phases 1 and 2 in one launch: the block sums of ``(b, nb, m, s)`` blocks and
    their exclusive prefix, ``((b, nb), (b, nb))``.

    The sums are :func:`block_partial_sums`'s and the carries :func:`carry_scan`'s
    of those sums, bit for bit.
    """
    if blocks.dim() != 4:
        raise ValueError(f"block_sums_carries: blocks must be (b, nb, m, s), got "
                         f"{tuple(blocks.shape)}")
    b, nb, m, s = blocks.shape
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(blocks.dtype)
    if not _build.on_card(blocks) or blocks.numel() == 0:
        return block_sums_carries_plain(blocks, acc)
    xb, code = kernel_operand(blocks.reshape(b, nb * m * s), acc, op="block_sums_carries")
    return _block_sums_carries_cuda(xb, code, acc, nb, m * s)


def block_scan_carry(blocks: torch.Tensor, carries: torch.Tensor, *,
                     variant: str = "scanul1", accum_dtype=None,
                     precision: str = "highest") -> torch.Tensor:
    """Fused phases 1 and 3: each block's partial scan plus its carry.

    Args:
        blocks: ``(b, nb, m, s)`` row-major block views.
        carries: ``(b, nb)`` exclusive block prefixes from :func:`carry_scan`.
        variant: ``"scanul1"`` or ``"scanu"``.
        accum_dtype: Accumulation dtype; defaults to ``accum_dtype_for``.
        precision: One of ``PRECISIONS``, already resolved: the plain
            version's products follow it; the kernels' sums do not.

    Returns:
        ``(b, nb, m, s)`` in the accumulation dtype.
    """
    variant = guards.validate_choice(variant, VARIANTS, name="variant",
                                     op="block_scan_carry")
    guards.validate_choice(precision, PRECISIONS, name="precision",
                           op="block_scan_carry")
    if blocks.dim() != 4:
        raise ValueError(f"block_scan_carry: blocks must be (b, nb, m, s), got "
                         f"{tuple(blocks.shape)}")
    b, nb, m, s = blocks.shape
    guards.validate_same_shape((b, nb), carries.shape, op="block_scan_carry",
                               a_name="blocks (b, nb)", b_name="carries")
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(blocks.dtype)
    if not _build.on_card(blocks) or blocks.numel() == 0:
        return block_scan_carry_plain(blocks, carries, variant=variant, acc=acc,
                                      precision=precision)
    if s > MAX_TILE:
        raise ValueError(f"block_scan_carry: s must be <= {MAX_TILE}, got {s}")
    xb, code = kernel_operand(blocks.reshape(b, nb * m * s), acc, op="block_scan_carry")
    out = _block_scan_cuda(xb, code, carries.to(acc).contiguous(), acc, nb, m * s, s,
                           variant)
    return out.reshape(b, nb, m, s)


def blocked_scan(x: torch.Tensor, *, s: int = 128, block_tiles: int = 8,
                 variant: str = "scanul1", accum_dtype=None,
                 precision: str = "highest") -> torch.Tensor:
    """Scan the last axis of ``x`` with the blocked pipeline (two launches).

    Args:
        x: ``(..., n)`` input; a CUDA tensor launches the kernels, a CPU
            tensor runs the plain versions.
        s: Tile side, ``1 <= s <= 128``.
        block_tiles: Tiles per block (``>= 1``), clamped to the row's tiles.
        variant: ``"scanul1"`` or ``"scanu"``.
        accum_dtype: Accumulation dtype; defaults to ``accum_dtype_for``.
        precision: One of ``PRECISIONS``, already resolved: the plain
            version's products follow it; the kernels' sums do not.

    Returns:
        The inclusive scan in the accumulation dtype, shaped like ``x``.

    Example:
        >>> blocked_scan(torch.ones(300, dtype=torch.int8), s=8)[-1].item()
        300
    """
    variant = guards.validate_choice(variant, VARIANTS, name="variant", op="blocked_scan")
    s = guards.validate_positive(s, name="s", op="blocked_scan")
    if s > MAX_TILE:
        raise ValueError(f"blocked_scan: s must be <= {MAX_TILE}, got {s}")
    block_tiles = guards.validate_positive(block_tiles, name="block_tiles",
                                           op="blocked_scan")
    guards.validate_choice(precision, PRECISIONS, name="precision", op="blocked_scan")
    acc = accum_dtype if accum_dtype is not None else accum_dtype_for(x.dtype)
    if x.numel() == 0:
        return torch.zeros(x.shape, dtype=acc, device=x.device)
    n = x.shape[-1]
    xb = x.reshape(-1, n)
    b = xb.shape[0]
    if not _build.on_card(xb):
        return blocked_scan_plain(xb, s=s, block_tiles=block_tiles, variant=variant,
                                  acc=acc, precision=precision).reshape(x.shape)
    _, block_len, nb = block_geometry(n, s, block_tiles)
    xk, code = kernel_operand(xb, acc, op="blocked_scan")
    if nb == 1:
        # one block: the carry is zero, so phases 1 and 2 are skipped
        carries = torch.zeros((b, 1), dtype=acc, device=x.device)
    else:
        carries = _block_sums_carries_cuda(xk, code, acc, nb, block_len)[1]
    return _block_scan_cuda(xk, code, carries, acc, nb, block_len, s,
                            variant).reshape(x.shape)

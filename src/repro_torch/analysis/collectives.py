"""Closed forms of the distributed operators' collective traffic.

Port of ``repro/analysis/collectives.py`` ``modeled_dist_traffic`` for the
port's own collectives.  The JAX package holds its closed forms against the
HLO of the compiled op; the port counts calls and bytes where it issues them
(``repro_torch.core.comm``), and the tests and ``chip_smoke.py`` hold those
counts to the forms here, call by call.

Bytes are counted as ``comm`` counts them: the bytes of each collective's
result on one rank (the same on every rank).  The forms differ from JAX's in
one term.  JAX's bucket exchange is a dense ``(D, C, n_local)`` buffer per
shard (``4·B·D·C·n_local`` bytes an ``all_to_all``), because XLA's
``all_to_all`` is static-shape; the port sends each element once, so a rank
receives ``4·B·C·n_local`` bytes.  ``jax_operand_bytes`` gives JAX's form
beside the port's.
"""
from __future__ import annotations

import math
from typing import Dict, List

__all__ = ["modeled_dist_traffic", "SORT_BITS"]

SORT_BITS = {"float32": 32, "bfloat16": 16, "float16": 16, "int32": 32, "int16": 16,
             "uint32": 32, "uint16": 16, "int8": 8, "uint8": 8}


def _radix_schedule(bits: int, bits_per_pass: int) -> List[int]:
    """Per-pass radix sizes ``2^k`` (a ragged final digit uses fewer bits)."""
    return [1 << min(bits_per_pass, bits - s) for s in range(0, bits, bits_per_pass)]


def _form(calls: Dict[str, int], nbytes: Dict[str, int], jax_bytes: int) -> Dict:
    return {"collective_count": sum(calls.values()), "operand_bytes": sum(nbytes.values()),
            "counts_by_kind": calls, "bytes_by_kind": nbytes, "jax_operand_bytes": jax_bytes}


def modeled_dist_traffic(op: str, *, d: int, n: int, batch: int = 1,
                         dtype: str = "float32", bits_per_pass: int = 4,
                         itemsize: int = 4, greedy: bool = False) -> Dict:
    """Closed-form collective traffic of one call of a distributed operator.

    * ``dist_sort`` (``dist_radix_sort``/``dist_sort``/``dist_topk``): per
      pass, one histogram ``all_gather`` (``4·D·batch·R`` bytes) and one
      ``all_to_all`` of ``C = 2`` int32 channels (key, index):
      ``4·batch·C·L`` bytes, ``L = ceil(n / D)``.
    * ``dist_top_p_sample``: the sort with ``C = 3`` channels (key, token,
      probability) over the 16 bf16 key bits, plus the softmax's two
      all-reduces, the two ``mcscan_local`` block-sum gathers, the
      shard-threshold gather and the two sampling all-reduces, each of
      ``batch`` scalars; with ``greedy`` (``temperature == 0``) only two
      all-reduces (the maximum and the first index that holds it).
    * ``dist_linear_scan`` / ``dist_segment_scan``: one ``all_gather`` of the
      ``(A, B)`` carry pairs, ``2·itemsize·D·batch`` bytes.
    * ``mcscan``: one ``all_gather`` of the block sums, ``itemsize·D·batch``.

    At ``d == 1`` every operator is its local sibling: no collective.

    Args:
        op: One of the operators above.
        d: Ranks in the group (``D``).
        n: Global length of the sharded axis.
        batch: Product of the leading (batch) dims.
        dtype: Key dtype name, for the sort's pass count.
        bits_per_pass: Bits retired per radix pass.
        itemsize: Accumulation-dtype bytes (linrec, segmented, mcscan).
        greedy: ``dist_top_p_sample`` at ``temperature == 0``.

    Returns:
        ``{"collective_count", "operand_bytes", "counts_by_kind",
        "bytes_by_kind", "jax_operand_bytes"}``, kinds named as in
        ``repro_torch.core.comm.KINDS``.
    """
    if d == 1:
        return _form({}, {}, 0)
    L = math.ceil(n / d)
    if op in ("dist_sort", "dist_top_p_sample"):
        if op == "dist_top_p_sample" and greedy:
            return _form({"all_reduce": 2}, {"all_reduce": 8 * batch}, 8 * batch)
        bits, c = (SORT_BITS[dtype], 2) if op == "dist_sort" else (16, 3)
        radixes = _radix_schedule(bits, bits_per_pass)
        hist = sum(4 * d * batch * r for r in radixes)
        a2a = len(radixes) * 4 * batch * c * L
        calls = {"all_gather": len(radixes), "all_to_all": len(radixes)}
        nbytes = {"all_gather": hist, "all_to_all": a2a}
        if op == "dist_top_p_sample":
            calls.update(all_gather=len(radixes) + 3, all_reduce=4)
            nbytes.update(all_gather=hist + 3 * 4 * d * batch, all_reduce=4 * 4 * batch)
        jax = sum(nbytes.values()) + (d - 1) * a2a
        return _form(calls, nbytes, jax)
    if op in ("dist_linear_scan", "dist_segment_scan"):
        b = 2 * itemsize * d * batch
        return _form({"all_gather": 1}, {"all_gather": b}, b)
    if op == "mcscan":
        b = itemsize * d * batch
        return _form({"all_gather": 1}, {"all_gather": b}, b)
    raise ValueError(f"modeled_dist_traffic: unknown op {op!r}")

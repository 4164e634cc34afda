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

The grid's training and serving (``Trainer(mesh=)``, the expert-parallel MoE)
have closed forms of their own: :func:`modeled_dp_step_traffic` for a
step's parameter gathers, gradient bucket and clip norm, and
:func:`modeled_ep_traffic` for the MoE layers' combines and what a training
pass adds to them.  Their ``jax_operand_bytes`` is None: JAX's step is one
compiled program whose collectives XLA chooses.

The CLI prints one dry-run cell's modeled collectives a step, grouped by
(kind, operand), with counts and bytes a device, largest first::

    PYTHONPATH=src python -m repro_torch.analysis.collectives --arch deepseek-moe-16b \\
        --shape train_4k [--mesh single] [--debug-mesh] [--top 15]

These are the port's closed forms for what it would issue on that grid
(``launch/dryrun.py`` ``plan_cell``), not a parsed HLO as in JAX's CLI: no
compiler runs.  The port's measured counterpart of JAX's
``measure_collectives`` is ``core/comm.py``'s counters, read around a call.
"""
from __future__ import annotations

import argparse
import collections
import math
from typing import Dict, List, Sequence

__all__ = ["modeled_dist_traffic", "modeled_dp_step_traffic", "modeled_ep_traffic",
           "sum_forms", "SORT_BITS", "main"]

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
                         itemsize: int = 4, greedy: bool = False,
                         nonfinite: str = "propagate") -> Dict:
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
      all-reduces (the maximum and the first index that holds it).  Its
      ``nonfinite`` policy adds one all-reduce of three int32 flags a row
      (``"raise"``), or that and the greedy token's two all-reduces
      (``"sanitize"``); JAX computes both on the gathered logits, outside its
      sharded body, so its form does not change.
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
        nonfinite: ``dist_top_p_sample``'s resolved non-finite policy.

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
        if op == "dist_top_p_sample" and nonfinite != "propagate":
            extra, extra_bytes = {"raise": (1, 12), "sanitize": (3, 20)}[nonfinite]
            calls["all_reduce"] += extra
            nbytes["all_reduce"] += extra_bytes * batch
        return _form(calls, nbytes, jax)
    if op in ("dist_linear_scan", "dist_segment_scan"):
        b = 2 * itemsize * d * batch
        return _form({"all_gather": 1}, {"all_gather": b}, b)
    if op == "mcscan":
        b = itemsize * d * batch
        return _form({"all_gather": 1}, {"all_gather": b}, b)
    raise ValueError(f"modeled_dist_traffic: unknown op {op!r}")


def sum_forms(*forms: Dict) -> Dict:
    """The traffic of several calls: the sum of their forms, kind by kind."""
    calls, nbytes, jax = {}, {}, 0
    for f in forms:
        for k, v in f["counts_by_kind"].items():
            calls[k] = calls.get(k, 0) + v
        for k, v in f["bytes_by_kind"].items():
            nbytes[k] = nbytes.get(k, 0) + v
        jax = None if jax is None or f["jax_operand_bytes"] is None \
            else jax + f["jax_operand_bytes"]
    return _form(calls, nbytes, jax)


def modeled_dp_step_traffic(*, data: int, block_elements: int, terms: int = 3,
                            gathered: Sequence[int] = (), norm_sets: int = 0,
                            param_itemsize: int = 4) -> Dict:
    """Closed-form collective traffic of one ``Trainer.train_step`` on a grid,
    the model's own collectives (:func:`modeled_ep_traffic`) aside.

    * the parameters split over a grid axis of more than one rank: one
      ``all_gather`` a leaf, of the whole leaf padded to the blocks' length
      (``gathered``: each such leaf's padded element count);
    * the gradient: one ``all_reduce`` over the data group (``data > 1``) of
      a flat fp32 bucket of the rank's gradient blocks (``block_elements``)
      and the ``terms`` loss values (``loss``, and ``aux`` and ``ce`` when
      ``grad_accum`` is 1), ``4·(block_elements + terms)`` bytes;
    * the clip's norm: one ``all_reduce`` of one fp32 scalar for each set of
      grid axes (of more than one rank) that splits some leaf
      (``norm_sets``).

    Args:
        data: Ranks over the grid's batch axes.
        block_elements: Elements of the rank's gradient blocks, every leaf.
        terms: Loss values that ride in the bucket.
        gathered: Padded element count of each gathered leaf.
        norm_sets: Axis sets whose squares are summed.
        param_itemsize: Bytes a parameter element.
    """
    calls, nbytes = {}, {}
    if gathered:
        calls["all_gather"] = len(gathered)
        nbytes["all_gather"] = param_itemsize * sum(gathered)
    if data > 1 or norm_sets:
        calls["all_reduce"] = (data > 1) + norm_sets
        nbytes["all_reduce"] = (4 * (block_elements + terms) if data > 1 else 0) + 4 * norm_sets
    return _form(calls, nbytes, None)


def modeled_ep_traffic(*, model: int, data: int = 1, tokens: int, d_model: int,
                       top_k: int, n_experts: int, layers: int, itemsize: int,
                       passes: int = 1, global_aux: bool = False, backward: bool = False,
                       remat: bool = False) -> Dict:
    """Closed-form collective traffic of the MoE layers on a grid.

    A MoE layer's forward pass on a ``"model"`` axis of ``model > 1`` ranks
    is one ``all_reduce`` of the rank's ``(tokens, d_model)`` parts in the
    activation dtype (the combine, ``itemsize`` bytes an element).  With
    ``global_aux`` (a training pass: the transformer's ``mode="train"``) and
    ``data > 1`` it adds one ``all_reduce`` of the ``n_experts`` fp32
    first-choice fractions.  A ``backward`` pass on ``model > 1`` ranks sums
    the gradients of the tokens and of the gate values over the model group:
    ``(tokens, d_model)`` and ``(tokens, top_k)`` in the activation dtype;
    ``remat`` recomputes the forward's collectives in it.

    Args:
        model: Ranks of the ``"model"`` axis.
        data: Ranks over the batch axes.
        tokens: This rank's tokens a pass (its rows times the sequence).
        d_model: The model width.
        top_k: Experts a token.
        n_experts: Routed experts.
        layers: MoE layers.
        itemsize: Bytes of an activation element.
        passes: Forward passes (each with its backward when ``backward``).
        global_aux: The loss's global ``aux`` (a training pass).
        backward: Each pass is differentiated.
        remat: The layer groups are recomputed in the backward pass.
    """
    calls, nbytes = {}, {}

    def add(n, b):
        calls["all_reduce"] = calls.get("all_reduce", 0) + n
        nbytes["all_reduce"] = nbytes.get("all_reduce", 0) + b

    reps = 2 if (backward and remat) else 1
    if model > 1:
        add(reps, reps * tokens * d_model * itemsize)
    if global_aux and data > 1:
        add(reps, reps * 4 * n_experts)
    if backward and model > 1:
        add(2, tokens * (d_model + top_k) * itemsize)
    scale = layers * passes
    return _form({k: v * scale for k, v in calls.items()},
                 {k: v * scale for k, v in nbytes.items()}, None)


def main(argv=None) -> int:
    """CLI entry point (see the module docstring)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import make_grid, plan_cell
    from repro_torch.models.model import ARCHS

    ap = argparse.ArgumentParser(description="a dry-run cell's modeled collectives")
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--debug-mesh", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    grid = make_grid(args.mesh, debug=args.debug_mesh)
    form, calls = plan_cell(args.arch, args.shape, grid)["collectives"]
    groups = collections.defaultdict(lambda: [0, 0])
    for kind, operand, nbytes, _ in calls:
        g = groups[(kind, operand)]
        g[0] += 1
        g[1] += nbytes
    print(f"{args.arch} × {args.shape} × {args.mesh}: {form['collective_count']} "
          f"collectives, {form['operand_bytes'] / 1e9:.3f} GB a device a step (modeled)")
    rows = sorted(groups.items(), key=lambda kv: -kv[1][1])[:args.top]
    for (kind, operand), (n, nbytes) in rows:
        print(f"  {nbytes / 1e9:9.3f} GB  n={n:4d}  {kind:<12} {operand}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The dry run: shapes, placements and bytes of every (arch × shape × mesh) cell.

Port of ``repro/launch/dryrun.py``, on the ``"meta"`` device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/

JAX's dry run lowers and compiles each cell's step against the production
meshes (512 host devices), then reads XLA's memory and cost analyses.  The
port has no compiler to ask.  It builds each cell's arguments on ``"meta"``
(:meth:`TransformerLM.init <repro_torch.models.transformer.TransformerLM.init>`
and ``empty_caches`` with ``device="meta"``: no memory, no draw), places them
with JAX's rules on ``Grid.abstract`` of ``launch/mesh.py``'s ``PRODUCTION``
or ``DEBUG`` shapes (or ``--mesh-shape DxM``), and counts bytes.  It builds
nothing on a device and starts no world.

The cells are JAX's:

* ``train_4k``: the train step's state (params in ``--param-dtype``, fp32 by
  default; AdamW's fp32 ``mu`` and ``nu`` as their parameters, or with
  ``--zero`` also split over ``"data"`` along the first whole dim that
  ``"data"`` divides, as JAX's ``zero_shard``; the int32 ``step``
  replicated) and the batch;
* ``prefill_32k``: the params (fp32: JAX's ``abstract_state(opt=False)``
  ignores ``--param-dtype``) and the batch;
* ``decode_32k`` / ``long_500k``: the params, one token a row, the caches of
  ``empty_caches(batch, seq_len)`` (sequence-sharded when the batch is 1)
  and ``pos``.

Placements: ``utils/sharding.py`` ``param_shardings``,
``training/optimizer.py`` ``opt_state_specs``, ``launch/sharding_plan.py``
``batch_specs`` and ``cache_specs``.  A device's bytes of a leaf are its
largest block: along a dim split into ``n`` parts, ``ceil(dim / n)``, which is
what XLA pads every device's block to.  JAX's jit refuses an argument whose
split dim ``n`` does not divide; no cell of the ten archs on the four grids
has one, and a ``--mesh-shape`` that makes one is planned here all the same.

A record keeps JAX's keys.  ``n_params``, ``model_flops_global`` and
``model_flops_per_chip`` (:func:`model_flops`: 6·N·D for train, 2·N·D
otherwise, ``D`` the tokens of a step) and ``bytes_per_device.arguments``
are JAX's numbers for the cell.  ``bytes_per_device.output`` follows this
rule, where JAX reads XLA's choice: the train step returns its state (as
placed) and an fp32 loss; the prefill returns fp32 last-position logits
``(B, padded_vocab)`` placed as the batch and the caches of ``cache_len =
seq_len`` placed as a decode cell's; a decode step returns the int32 sampled
tokens ``(B,)`` placed as the batch and its caches.  ``temp``, ``alias`` and
``code`` are None, as are ``compile_s``, ``roofline`` and
``useful_fraction``: no compiler runs, so there is no temporary buffer, no
donation analysis and no code size.  ``lower_s`` is the planning time.
``collectives`` is the port's own modeled traffic of one step on that grid
(``analysis/collectives.py``): :func:`modeled_dp_step_traffic` for a train
step (``Trainer(mesh=)``: the split parameters gathered, the gradient bucket,
the clip's norms) and :func:`modeled_ep_traffic` for the MoE layers'
expert-parallel combines (every step of a MoE arch on a ``"model"`` axis of
more than one rank).  The arguments are JAX's layout; the port's engines and
trainer hold each model group's parameters whole (ROADMAP Queue C).

:func:`plan_cell` is the counterpart of JAX's ``lower_cell``: it returns the
plan (the arguments and outputs with their placements, and the modeled
collectives) instead of a lowered computation; :func:`run_cell` makes the
record.  Exit codes are JAX's: 1 when a cell failed, else 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.analysis.collectives import (modeled_dp_step_traffic, modeled_ep_traffic,
                                              sum_forms)
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import DEBUG, PRODUCTION
from repro_torch.launch.sharding_plan import batch_specs, cache_specs
from repro_torch.models.model import ARCHS, build_model, cell_supported, get_config, \
    input_specs
from repro_torch.models.transformer import _DTYPES
from repro_torch.training import optimizer as opt_lib
from repro_torch.utils.sharding import (Grid, Placement, dp_axes, param_shardings,
                                        replicated)

__all__ = ["SkipCell", "abstract_state", "model_flops", "plan_cell", "run_cell",
           "leaf_bytes", "tree_bytes", "make_grid", "main"]

META = torch.device("meta")


class SkipCell(Exception):
    pass


def abstract_state(model, opt: bool = True, param_dtype: str = "float32") -> Dict:
    """The params (and AdamW state) on ``"meta"``: shapes and dtypes, no memory."""
    params = model.init(device=META, dtype=_DTYPES[param_dtype])
    if not opt:
        return params
    return {"params": params, "opt": opt_lib.adamw_init(params)}


def model_flops(n_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for prefill and decode (JAX's
    ``analysis/roofline.py`` ``model_flops`` without ``n_active``)."""
    return (6.0 if kind == "train" else 2.0) * n_params * tokens


def make_grid(mesh_kind: str, *, debug: bool = False, mesh_shape=None) -> Grid:
    """The abstract grid of a cell: ``(D, M)`` ``("data", "model")`` for
    ``mesh_shape``, else ``launch/mesh.py``'s ``DEBUG`` or ``PRODUCTION``
    shape for one pod (``"single"``) or two (``"multi"``)."""
    if mesh_shape is not None:
        return Grid.abstract(tuple(mesh_shape), ("data", "model"))
    shape, names = (DEBUG if debug else PRODUCTION)[mesh_kind == "multi"]
    return Grid.abstract(shape, names)


def _block(pl: Placement):
    """The largest block's shape: ``ceil(dim / parts)`` along each split dim."""
    return tuple(math.ceil(n / pl.grid.size_of(e)) for n, e in zip(pl.shape, pl.entries()))


def leaf_bytes(x: torch.Tensor, pl: Placement) -> int:
    """One device's bytes of ``x`` placed by ``pl`` (its largest block)."""
    return math.prod(_block(pl)) * x.element_size()


def tree_bytes(tree, places) -> int:
    """One device's bytes of a tree of tensors and the tree of their placements."""
    if isinstance(tree, dict):
        return sum(tree_bytes(tree[k], places[k]) for k in tree)
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(t, p) for t, p in zip(tree, places))
    return leaf_bytes(tree, places)


def _zero_shard(pl: Placement) -> Placement:
    """JAX's ``zero_shard``: also split over ``"data"`` along the first whole dim
    that ``"data"`` divides (and is at least as long as)."""
    n = pl.grid.shape["data"]
    parts = list(pl.entries())
    for i, (dim, a) in enumerate(zip(pl.shape, parts)):
        if a is None and dim % n == 0 and dim >= n:
            parts[i] = "data"
            break
    return dataclasses.replace(pl, spec=tuple(parts))


def _dt(t) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}[t]


def _collectives(cfg, shape, grid: Grid, params, pspecs, rows: int, seq: int):
    """The port's modeled collectives of one step of the cell (module docstring):
    ``(form, calls)``, the closed forms summed and the calls they count, each
    ``(kind, operand, bytes a device)``."""
    dp = grid.size_of(dp_axes(grid))
    model = grid.shape.get("model", 1)
    forms, calls = [], []
    if shape.kind == "train":
        places = opt_lib.tree_leaves(pspecs)
        split = [pl for pl in places if pl.split_axes()]
        pdt = opt_lib.tree_leaves(params)[0]
        padded = [tuple(b * pl.grid.size_of(e) for b, e in zip(_block(pl), pl.entries()))
                  for pl in split]
        block = sum(math.prod(_block(pl)) for pl in places)
        norm_sets = len({pl.split_axes() for pl in split})
        forms.append(modeled_dp_step_traffic(
            data=dp, block_elements=block, terms=3,
            gathered=[math.prod(p) for p in padded], norm_sets=norm_sets,
            param_itemsize=pdt.element_size()))
        calls += [("all_gather", f"{_dt(pdt.dtype)}{list(p)}",
                   math.prod(p) * pdt.element_size()) for p in padded]
        if dp > 1:
            calls.append(("all_reduce", f"f32[{block + 3}]", 4 * (block + 3)))
        calls += [("all_reduce", "f32[]", 4)] * norm_sets
    if cfg.moe is not None and model > 1 and cfg.moe.n_experts % model == 0:
        m, train = cfg.moe, shape.kind == "train"
        cdt = _DTYPES[cfg.dtype]
        t, layers = rows * seq, cfg.n_layers - m.first_k_dense
        forms.append(modeled_ep_traffic(
            model=model, data=dp, tokens=t, d_model=cfg.d_model, top_k=m.top_k,
            n_experts=m.n_experts, layers=layers, itemsize=cdt.itemsize,
            global_aux=train, backward=train, remat=cfg.remat))
        reps = 2 if (train and cfg.remat) else 1
        combine = ("all_reduce", f"{_dt(cdt)}[{t}, {cfg.d_model}]",
                   t * cfg.d_model * cdt.itemsize)
        layer = [combine] * reps
        if train and dp > 1:
            layer += [("all_reduce", f"f32[{m.n_experts}]", 4 * m.n_experts)] * reps
        if train:
            layer += [combine, ("all_reduce", f"{_dt(cdt)}[{t}, {m.top_k}]",
                                t * m.top_k * cdt.itemsize)]
        calls += layer * layers
    return sum_forms(*forms), calls


def plan_cell(arch: str, shape_name: str, mesh: Grid, *, scan_method: str = "matmul",
              overrides: Optional[Dict] = None) -> Dict:
    """JAX's ``lower_cell`` on ``"meta"``: the cell's plan, not a lowered program.

    Returns ``{"chips", "n_params", "kind", "arguments", "outputs",
    "collectives"}``: ``arguments`` and ``outputs`` map a name to ``(tree of
    meta tensors, tree of placements)``; ``collectives`` is ``(form, calls)``,
    the modeled traffic of a step and the calls it counts, each ``(kind,
    operand, bytes a device)``.  ``overrides`` takes JAX's ``zero``,
    ``param_dtype`` and ``moe_capacity`` and any config field.  Raises
    :class:`SkipCell` with JAX's reason for a cell the arch does not run.
    """
    cfg = get_config(arch)
    over = dict(overrides or {})
    zero = over.pop("zero", False)
    param_dtype = over.pop("param_dtype", "float32")
    cap = over.pop("moe_capacity", None)
    cfg = dataclasses.replace(cfg, scan_method=scan_method, scan_layers=False, **over)
    if cap is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise SkipCell(why)
    model = build_model(cfg)
    b = shape.global_batch
    dp = mesh.size_of(dp_axes(mesh))
    rows = b // dp if b % dp == 0 else b        # a rank's rows (batch_specs' rule)

    if shape.kind == "train":
        state = abstract_state(model, param_dtype=param_dtype)
        pspecs = param_shardings(mesh, state["params"])
        ospecs = opt_lib.opt_state_specs(pspecs)
        if zero:
            mu = opt_lib.tree_map(_zero_shard, ospecs["mu"])
            ospecs = {"mu": mu, "nu": mu, "step": ospecs["step"]}
        sspecs = {"params": pspecs, "opt": ospecs}
        batch = input_specs(cfg, shape)
        loss = torch.empty((), dtype=torch.float32, device=META)
        return {"chips": mesh.size, "kind": "train",
                "n_params": sum(x.numel() for x in opt_lib.tree_leaves(state["params"])),
                "arguments": {"state": (state, sspecs),
                              "batch": (batch, batch_specs(mesh, batch))},
                "outputs": {"state": (state, sspecs), "loss": (loss, replicated(mesh, ()))},
                "collectives": _collectives(cfg, shape, mesh, state["params"], pspecs,
                                            rows, shape.seq_len)}

    params = abstract_state(model, opt=False)
    pspecs = param_shardings(mesh, params)
    n_params = sum(x.numel() for x in opt_lib.tree_leaves(params))
    caches = model.empty_caches(b, shape.seq_len, device=META)
    cspecs = cache_specs(mesh, caches, seq_sharded=b == 1)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        logits = {"logits": torch.empty((b, cfg.padded_vocab), dtype=torch.float32,
                                        device=META)}
        arguments = {"params": (params, pspecs), "batch": (batch, batch_specs(mesh, batch))}
        outputs = {"logits": (logits, batch_specs(mesh, logits)), "caches": (caches, cspecs)}
        seq = shape.seq_len
    else:
        tokens = {"tokens": torch.empty((b, 1), dtype=torch.int32, device=META)}
        pos = torch.empty((), dtype=torch.int32, device=META)
        sampled = {"tokens": torch.empty((b,), dtype=torch.int32, device=META)}
        arguments = {"params": (params, pspecs), "tokens": (tokens, batch_specs(mesh, tokens)),
                     "caches": (caches, cspecs), "pos": (pos, replicated(mesh, ()))}
        outputs = {"tokens": (sampled, batch_specs(mesh, sampled)), "caches": (caches, cspecs)}
        seq = 1
    return {"chips": mesh.size, "kind": shape.kind, "n_params": n_params,
            "arguments": arguments, "outputs": outputs,
            "collectives": _collectives(cfg, shape, mesh, params, pspecs, rows, seq)}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, debug: bool = False,
             scan_method: str = "matmul", overrides: Optional[Dict] = None,
             mesh_shape=None, tag: str = "") -> Dict:
    """The record of one cell (module docstring); raises :class:`SkipCell`."""
    mesh = make_grid(mesh_kind, debug=debug, mesh_shape=mesh_shape)
    t0 = time.time()
    plan = plan_cell(arch, shape_name, mesh, scan_method=scan_method, overrides=overrides)
    plan_s = time.time() - t0
    shape = SHAPES[shape_name]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mflops = model_flops(plan["n_params"], tokens, shape.kind)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": plan["chips"],
        "tag": tag, "status": "ok", "lower_s": round(plan_s, 3), "compile_s": None,
        "n_params": plan["n_params"],
        "bytes_per_device": {
            "arguments": sum(tree_bytes(*v) for v in plan["arguments"].values()),
            "output": sum(tree_bytes(*v) for v in plan["outputs"].values()),
            "temp": None, "alias": None, "code": None,
        },
        "roofline": None,
        "model_flops_global": mflops,
        "model_flops_per_chip": mflops / plan["chips"],
        "useful_fraction": None,
        "collectives": plan["collectives"][0],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="write JSON records here")
    ap.add_argument("--debug-mesh", action="store_true", help="8-rank debug grid")
    ap.add_argument("--scan-method", default="matmul", choices=["matmul", "vector"])
    ap.add_argument("--zero", action="store_true", help="ZeRO-1 opt sharding")
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--mesh-shape", default=None,
                    help="override logical mesh as DxM, e.g. 32x8")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--tag", default="", help="perf-iteration tag for the record")
    args = ap.parse_args(argv)

    overrides = {}
    if args.zero:
        overrides["zero"] = True
    if args.param_dtype != "float32":
        overrides["param_dtype"] = args.param_dtype
    if args.capacity_factor is not None:
        overrides["moe_capacity"] = args.capacity_factor
    mesh_shape = None
    if args.mesh_shape:
        d, m = args.mesh_shape.split("x")
        mesh_shape = (int(d), int(m))

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s, mk) for a in archs for s in shapes for mk in meshes]

    records, failed = [], 0
    for arch, shape, mk in cells:
        tag = f"{arch} × {shape} × {mk}"
        try:
            rec = run_cell(arch, shape, mk, debug=args.debug_mesh,
                           scan_method=args.scan_method, overrides=overrides,
                           mesh_shape=mesh_shape, tag=args.tag)
            by = rec["bytes_per_device"]
            c = rec["collectives"]
            print(f"[dryrun] OK  {tag}: arguments {by['arguments'] / 1e9:.3f} GB/device, "
                  f"output {by['output'] / 1e9:.3f} GB, {c['collective_count']} modeled "
                  f"collectives {c['operand_bytes'] / 1e9:.3f} GB a step "
                  f"(plan {rec['lower_s']}s)", flush=True)
        except SkipCell as e:
            rec = {"arch": arch, "shape": shape, "mesh": mk, "status": "skip",
                   "reason": str(e)}
            print(f"[dryrun] SKIP {tag}: {e}", flush=True)
        except Exception as e:  # noqa: BLE001 -- a failed cell is a record, as in JAX
            rec = {"arch": arch, "shape": shape, "mesh": mk, "status": "fail",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            print(f"[dryrun] FAIL {tag}: {type(e).__name__}: {e}", flush=True)
            failed += 1
        records.append(rec)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            suffix = f"_{args.tag}" if args.tag else ""
            fname = os.path.join(
                args.out, f"dryrun_{arch}_{shape}_{mk}{suffix}.json".replace("/", "_"))
            with open(fname, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"[dryrun] {len(records) - failed}/{len(records)} cells passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

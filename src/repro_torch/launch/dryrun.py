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
``model_flops_per_chip`` (``analysis/roofline.py`` ``model_flops``: 6·N·D
for train, 2·N·D otherwise, ``D`` the tokens of a step) and
``bytes_per_device.arguments`` are JAX's numbers for the cell.
``bytes_per_device.output`` follows this rule, where JAX reads XLA's choice:
the train step returns its state (as placed) and an fp32 loss; the prefill
returns fp32 last-position logits ``(B, padded_vocab)`` placed as the batch
and the caches of ``cache_len = seq_len`` placed as a decode cell's; a decode
step returns the int32 sampled tokens ``(B,)`` placed as the batch and its
caches.  ``temp``, ``alias``, ``code`` and ``compile_s`` are None: no
compiler runs, so there is no temporary buffer, no donation analysis and no
code size.  ``lower_s`` is the planning time, ``count_s`` the count's.

``roofline`` is ``analysis/roofline.py``'s ``Roofline`` of one rank's step
(:func:`count_step`), run on ``"meta"`` under its counter as JAX's
``lower_cell`` defines the step: the train step is ``Trainer.train_step``
(``loss``, its backward, where remat recomputes each group and the recompute
is counted, and ``adamw_update``); the prefill ``prefill(cache_len=seq_len)``; a decode step
``decode_step`` at position ``seq_len - 1`` and the argmax.  The rank's rows
are :func:`plan_cell`'s (the batch over the data axes, when they divide it).
Every leaf enters whole: the port's engines and ``Trainer(mesh=)`` hold the
leaves JAX splits over ``"model"`` whole (ROADMAP Queue C, "the model group
computes redundantly"), so a rank counts the whole leaf, every expert of a
MoE layer included, and ZeRO-1 leaves the step unchanged.  Its collectives
are the modeled calls below.  Kernels on ``scan_method`` ``"kernel"`` or
``"blocked"`` count their recorded bytes and launch nothing on ``"meta"``.
``useful_fraction`` is JAX's ``model_flops_per_chip / roofline.flops``; the
port's ``flops`` are the products alone (JAX's XLA count includes
elementwise work).  ``collectives`` is the port's own modeled traffic of one
step on that grid (``analysis/collectives.py``): :func:`modeled_dp_step_traffic`
for a train step (``Trainer(mesh=)``: the split parameters gathered, the
gradient bucket, the clip's norms) and :func:`modeled_ep_traffic` for the MoE
layers' expert-parallel combines (every step of a MoE arch on a ``"model"``
axis of more than one rank).  The arguments are JAX's layout.

:func:`plan_cell` is the counterpart of JAX's ``lower_cell``: it returns the
plan (the arguments and outputs with their placements, and the modeled
collectives) instead of a lowered computation; :func:`run_cell` makes the
record.  Exit codes are JAX's: 1 when a cell failed, else 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.collectives import (modeled_dp_step_traffic, modeled_ep_traffic,
                                              sum_forms)
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import DEBUG, PRODUCTION
from repro_torch.launch.sharding_plan import batch_specs, cache_specs
from repro_torch.models.model import ARCHS, build_model, cell_supported, get_config, \
    input_specs
from repro_torch.models.transformer import _DTYPES
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.trainer import Trainer
from repro_torch.utils.sharding import (Grid, Placement, dp_axes, param_shardings,
                                        replicated)

__all__ = ["SkipCell", "abstract_state", "plan_cell", "count_step", "serve_step", "run_cell",
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
    ``(kind, operand, bytes a device, group)``, ``group`` the ranks it spans."""
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
                   math.prod(p) * pdt.element_size(), grid.size_of(pl.split_axes()))
                  for p, pl in zip(padded, split)]
        if dp > 1:
            calls.append(("all_reduce", f"f32[{block + 3}]", 4 * (block + 3), dp))
        calls += [("all_reduce", "f32[]", 4, grid.size_of(axes))
                  for axes in sorted({pl.split_axes() for pl in split})]
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
                   t * cfg.d_model * cdt.itemsize, model)
        layer = [combine] * reps
        if train and dp > 1:
            layer += [("all_reduce", f"f32[{m.n_experts}]", 4 * m.n_experts, dp)] * reps
        if train:
            layer += [combine, ("all_reduce", f"{_dt(cdt)}[{t}, {m.top_k}]",
                                t * m.top_k * cdt.itemsize, model)]
        calls += layer * layers
    return sum_forms(*forms), calls


def _config(arch: str, scan_method: str, over: tuple):
    """The arch's config with ``scan_method``, layers unrolled, and ``over``'s
    ``(field, value)`` pairs: ``moe_capacity`` or any config field."""
    cfg = dataclasses.replace(get_config(arch), scan_method=scan_method, scan_layers=False,
                              **{k: v for k, v in over if k != "moe_capacity"})
    cap = dict(over).get("moe_capacity")
    if cap is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    return cfg


def plan_cell(arch: str, shape_name: str, mesh: Grid, *, scan_method: str = "matmul",
              overrides: Optional[Dict] = None) -> Dict:
    """JAX's ``lower_cell`` on ``"meta"``: the cell's plan, not a lowered program.

    Returns ``{"chips", "n_params", "kind", "rows", "arguments", "outputs",
    "collectives"}``: ``rows`` is a rank's rows of the batch; ``arguments`` and
    ``outputs`` map a name to ``(tree of meta tensors, tree of placements)``;
    ``collectives`` is ``(form, calls)``, the modeled traffic of a step and the
    calls it counts, each ``(kind, operand, bytes a device, group)``.  ``overrides`` takes JAX's ``zero``,
    ``param_dtype`` and ``moe_capacity`` and any config field.  Raises
    :class:`SkipCell` with JAX's reason for a cell the arch does not run.
    """
    over = dict(overrides or {})
    zero = over.pop("zero", False)
    param_dtype = over.pop("param_dtype", "float32")
    cfg = _config(arch, scan_method, tuple(over.items()))
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
        return {"chips": mesh.size, "kind": "train", "rows": rows,
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
    return {"chips": mesh.size, "kind": shape.kind, "n_params": n_params, "rows": rows,
            "arguments": arguments, "outputs": outputs,
            "collectives": _collectives(cfg, shape, mesh, params, pspecs, rows, seq)}


def _rank_rows(tree, rows: int):
    """A batch tree with its leading (batch) axis cut to one rank's ``rows``."""
    return {k: torch.empty((rows, *v.shape[1:]), dtype=v.dtype, device=META)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def count_step(arch: str, shape_name: str, rows: int, *, scan_method: str = "matmul",
               param_dtype: str = "float32", over: tuple = ()) -> rl.Count:
    """One rank's step of the cell on ``"meta"`` under ``analysis/roofline.py``'s
    counter, as JAX's ``lower_cell`` defines the step (module docstring), on
    ``rows`` rows of the batch.  ``over``: the config's overrides as sorted
    ``(field, value)`` pairs (``moe_capacity`` among them).  Cached: the count
    is a function of these arguments alone."""
    cfg = _config(arch, scan_method, over)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        # Trainer's step on one device: loss, backward (remat recomputes each
        # group), AdamW in place
        tr = Trainer(cfg, opt_lib.AdamWConfig(), param_dtype=_DTYPES[param_dtype],
                     device=META)
        state = tr.init_state()
        batch = _rank_rows(input_specs(cfg, shape), rows)
        with rl.counting() as count:
            tr.train_step(state, batch)
        return count
    model = build_model(cfg)
    params = abstract_state(model, opt=False)
    if shape.kind == "prefill":
        batch = _rank_rows(input_specs(cfg, shape), rows)
        with rl.counting() as count:
            model.prefill(params, batch, cache_len=shape.seq_len)
        return count
    caches = model.empty_caches(rows, shape.seq_len, device=META)
    tokens = torch.empty((rows, 1), dtype=torch.int32, device=META)
    with rl.counting() as count:
        serve_step(model, params, tokens, caches, shape.seq_len - 1)
    return count


def serve_step(model, params, tokens, caches, pos: int) -> torch.Tensor:
    """JAX's ``serve_step``: one ``decode_step`` at ``pos`` (the caches written in
    place) and its greedy tokens, int32 ``(B,)``."""
    logits, _ = model.decode_step(params, tokens, caches, pos)
    return torch.argmax(logits, -1).to(torch.int32)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, debug: bool = False,
             scan_method: str = "matmul", overrides: Optional[Dict] = None,
             mesh_shape=None, tag: str = "") -> Dict:
    """The record of one cell (module docstring); raises :class:`SkipCell`."""
    mesh = make_grid(mesh_kind, debug=debug, mesh_shape=mesh_shape)
    t0 = time.time()
    plan = plan_cell(arch, shape_name, mesh, scan_method=scan_method, overrides=overrides)
    plan_s = time.time() - t0
    shape = SHAPES[shape_name]
    over = dict(overrides or {})
    over.pop("zero", None)              # the rank's step is the same under ZeRO-1
    param_dtype = over.pop("param_dtype", "float32")
    count = count_step(arch, shape_name, plan["rows"], scan_method=scan_method,
                       param_dtype=param_dtype if shape.kind == "train" else "float32",
                       over=tuple(sorted(over.items())))
    roof = rl.analyze(count, plan["collectives"][1])
    count_s = time.time() - t0 - plan_s
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mflops = rl.model_flops(plan["n_params"], tokens, shape.kind)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": plan["chips"],
        "tag": tag, "status": "ok", "lower_s": round(plan_s, 3), "compile_s": None,
        "count_s": round(count_s, 3), "rows": plan["rows"],
        "n_params": plan["n_params"],
        "bytes_per_device": {
            "arguments": sum(tree_bytes(*v) for v in plan["arguments"].values()),
            "output": sum(tree_bytes(*v) for v in plan["outputs"].values()),
            "temp": None, "alias": None, "code": None,
        },
        "roofline": roof.to_dict(),
        "model_flops_global": mflops,
        "model_flops_per_chip": mflops / plan["chips"],
        "useful_fraction": (mflops / plan["chips"]) / roof.flops if roof.flops else 0.0,
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
            r = rec["roofline"]
            print(f"[dryrun] OK  {tag}: compute {r['compute_s'] * 1e3:.2f}ms memory "
                  f"{r['memory_s'] * 1e3:.2f}ms collective {r['collective_s'] * 1e3:.2f}ms "
                  f"-> {r['bottleneck']}; arguments {by['arguments'] / 1e9:.3f} GB/device, "
                  f"output {by['output'] / 1e9:.3f} GB, {c['collective_count']} modeled "
                  f"collectives {c['operand_bytes'] / 1e9:.3f} GB a step "
                  f"(plan {rec['lower_s']}s, count {rec['count_s']}s)", flush=True)
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

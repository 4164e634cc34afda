"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b --smoke \\
      --device cpu --steps 40 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt

Port of ``repro/launch/train.py``: the same flags, plus ``--device``.  Without
``--device`` it trains on the GPU.  Batches come from ``SyntheticLM`` (a noisy
bigram chain the model learns within tens of steps); AdamW warms up over 20
steps and decays over ``--steps``.  Checkpoints go to ``--ckpt-dir`` every
``--ckpt-every`` steps, and re-running the same command resumes from the
latest one (the batches are a function of the step).  The recurrences train on
``scan_method="auto"`` (the config's) and on ``"vector"``/``"matmul"``; the
methods ``"kernel"`` and ``"blocked"`` of the SSD's chunk scan have no
gradient, in JAX too, and raise.

``--mesh debug|prod|prod-multi`` trains data-parallel on JAX's grids (4 data ×
2 model; 16 × 16; 2 × 16 × 16): the launcher starts a ``torch.distributed``
world of the grid's size, a process a rank (``launch/world.py`` ``run_world``,
gloo, its rendezvous and logs in ``--world-dir`` or a temporary directory),
and every rank runs the ``Trainer`` on ``launch.mesh``'s grid; the losses
printed are the whole batch's.  ``--batch`` must divide over the data axes
(times ``--grad-accum``)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke \\
      --device cpu --mesh debug --steps 3 --batch 8 --seq 32
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import tempfile

from repro_torch.core import comm
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import ARCHS, get_config
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import Trainer

MESHES = {"debug": mesh_lib.DEBUG[False], "prod": mesh_lib.PRODUCTION[False],
          "prod-multi": mesh_lib.PRODUCTION[True]}


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="llama3-8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", *MESHES], default="none")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M example model)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--world-dir", default=None,
                    help="--mesh: the world's rendezvous and logs (default: a temporary "
                         "directory)")
    ap.add_argument("--world-timeout", type=float, default=1800.0)
    return ap.parse_args(argv)


def main(argv=None):
    """Train as the flags say; with ``--mesh`` start the world and return rank
    0's ``{"losses", ...}`` (the state stays on the ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if args.mesh != "none":
        from repro_torch.launch.world import run_world

        shape, _ = MESHES[args.mesh]
        workdir = args.world_dir or tempfile.mkdtemp(prefix="train_world_")
        out = run_world("repro_torch.launch.train:rank_main", math.prod(shape),
                        {"argv": argv}, workdir=workdir, timeout=args.world_timeout)[0]
        if out["losses"]:
            print(f"[train] final loss {out['losses'][-1]:.4f} "
                  f"(start {out['losses'][0]:.4f})")
        return out
    return _train(args, None)


def rank_main(argv) -> dict:
    """One rank of a ``--mesh`` run (``run_world`` calls it): build the grid on
    the world and train on it."""
    args = _parse(argv)
    grid = (mesh_lib.make_debug_mesh() if args.mesh == "debug" else
            mesh_lib.make_production_mesh(multi_pod=args.mesh == "prod-multi"))
    out = _train(args, grid, log=print if comm.axis_index() == 0 else (lambda *_: None))
    return {"losses": out["losses"]}


def _train(args, grid, log=print):
    cfg = get_config(args.arch, smoke=args.smoke)
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.layers:
        over["n_layers"] = args.layers
    if over:
        cfg = dataclasses.replace(cfg, **over)

    trainer = Trainer(cfg, AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
                      mesh=grid, ckpt_dir=args.ckpt_dir, grad_accum=args.grad_accum,
                      device=args.device)
    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    out = trainer.fit(src, args.steps, log_every=10, log=log,
                      ckpt_every=args.ckpt_every if args.ckpt_dir else 0)
    if out["losses"] and grid is None:
        print(f"[train] final loss {out['losses'][-1]:.4f} (start {out['losses'][0]:.4f})")
    return out


if __name__ == "__main__":
    main()

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
gradient, in JAX too, and raise.  ``--mesh`` takes only ``none``: the mesh
comes with its slice (ROADMAP Queue A item 11).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import ARCHS, get_config
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import Trainer


def main(argv=None):
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
    ap.add_argument("--mesh", choices=["none"], default="none")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M example model)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.layers:
        over["n_layers"] = args.layers
    if over:
        cfg = dataclasses.replace(cfg, **over)

    trainer = Trainer(cfg, AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
                      ckpt_dir=args.ckpt_dir, grad_accum=args.grad_accum,
                      device=args.device)
    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    out = trainer.fit(src, args.steps, log_every=10,
                      ckpt_every=args.ckpt_every if args.ckpt_dir else 0)
    if out["losses"]:
        print(f"[train] final loss {out['losses'][-1]:.4f} (start {out['losses'][0]:.4f})")
    return out


if __name__ == "__main__":
    main()

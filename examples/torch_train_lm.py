"""End-to-end training on the PyTorch port: train an LM on synthetic structured
data with checkpointing and resume, then generate from it with the scan-based
sampler.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200          # ~10M params
    PYTHONPATH=src python examples/torch_train_lm.py --size 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --device cpu

The port's counterpart of ``examples/train_lm.py``: the same arguments and
defaults (the checkpoint directory under the temporary directory), plus
``--device``; it trains on the GPU unless given ``--device cpu``.  Re-running
the same command resumes from the latest checkpoint (the batches are a
function of the step), so killing it mid-run shows the fault tolerance.  The
parameter count comes from an init on the ``"meta"`` device.  The trainer's
step times are printed beside the device's name.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.guards import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import Trainer


def make_cfg(size: str) -> ModelConfig:
    if size == "100m":
        return ModelConfig(name="lm-100m", family="decoder", n_layers=12,
                           d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                           vocab_size=4096, dtype="float32", remat=False)
    return ModelConfig(name="lm-10m", family="decoder", n_layers=8,
                       d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                       vocab_size=1024, dtype="float32", remat=False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", choices=["10m", "100m"], default="10m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, op="torch_train_lm")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    cfg = make_cfg(args.size)
    n = cfg.param_count()
    print(f"[example] {cfg.name}: {n / 1e6:.1f}M params")

    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    tr = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
                 ckpt_dir=args.ckpt_dir, device=dev)
    out = tr.fit(src, args.steps, log_every=20, ckpt_every=50,
                 log=lambda msg: print(f"{msg} on {where}"))
    losses = out["losses"]
    if losses:
        print(f"[example] loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print(f"[example] already trained to step {args.steps} in {args.ckpt_dir}")

    eng = ServeEngine(cfg, out["state"]["params"], max_len=args.seq + 32, top_p=0.9,
                      sampler="topp_scan", device=dev)
    prompt = src.batch_at(10_000)["tokens"][:2, :16]
    gen = eng.generate({"tokens": prompt}, 16,
                       torch.Generator(device=dev).manual_seed(1)).cpu().numpy()
    print("[example] prompt tail :", prompt[:, -6:])
    print("[example] generation  :", gen[:, :12])
    ok = gen.shape == (2, 16) and bool(np.all((gen >= 0) & (gen < cfg.vocab_size))) \
        and all(np.isfinite(losses))
    return {"checks": {"finite losses and generated ids": ok}, "n_params": n,
            "losses": losses, "generation": gen}


if __name__ == "__main__":
    main()

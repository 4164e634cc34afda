"""Serving launcher: batched generation with the scan-based top-p sampler.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --batch 2 --prompt-len 16 --new-tokens 8 --sampler topp_scan

Without ``--device`` it runs on the GPU (``--sampler topp_kernel`` then runs
the B7/B8 kernels, ``--sampler topp_blocked`` the B4 block scan, and
``--sampler topp_segmented`` its segmented scans on the method that
``REPRO_SCAN_METHOD`` names: ``kernel`` for B9, ``blocked`` for B10–B12).
``--arch zamba2-1.2b`` serves the Mamba2 hybrid, whose SSD layers run on the
method that ``REPRO_SCAN_METHOD`` names: ``kernel`` for B1 and B13,
``blocked`` for B4 and B16; ``--arch xlstm-350m`` runs its mLSTM layers' prefill
the same way (B1 + B13, or B4 + B16).  ``--arch whisper-small`` and ``--arch
paligemma-3b`` serve with stub ``enc_embed`` / ``img_embed`` inputs
(``models/model.py`` ``synth_batch``; the VLM's image tokens count in its
``max_len``), ``--arch minicpm3-4b`` with MLA's absorbed decode.  Weights and
inputs are random, made from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.model import ARCHS, build_model, get_config, synth_batch
from repro_torch.models.transformer import _DTYPES
from repro_torch.serving.engine import ServeEngine



def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--sampler", choices=ServeEngine.SAMPLERS, default="topp_scan")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device, dtype=_DTYPES[cfg.dtype])
    off = cfg.n_img_tokens if cfg.family == "vlm" else 0
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.new_tokens + off,
                      top_p=args.top_p, sampler=args.sampler, device=args.device)
    gen = torch.Generator(device=eng.device).manual_seed(args.seed + 1)
    batch = synth_batch(cfg, ShapeConfig("serve", args.prompt_len, args.batch, "prefill"),
                        gen)
    t0 = time.perf_counter()
    toks = eng.generate(batch, args.new_tokens, gen)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    print(f"[serve] generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s) sampler={args.sampler} "
          f"device={eng.device}")
    print(toks[:, :12].cpu().numpy())
    return toks


if __name__ == "__main__":
    main()

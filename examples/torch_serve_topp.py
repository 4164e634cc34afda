"""Batched serving on the PyTorch port with the paper's scan-based top-p sampler
(paper §6.5).

    PYTHONPATH=src python examples/torch_serve_topp.py --batch 4 --new-tokens 12 [--device cpu]

The port's counterpart of ``examples/serve_topp.py``: the same arguments and
defaults, the reduced (SMOKE) config of ``--arch``, every sampler over one
prompt batch.  It runs on the GPU unless given ``--device cpu``.  Every
sampler takes the same uniforms (drawn once from a seeded
``torch.Generator``), so ``topp_scan``, ``topp_kernel`` and the other top-p
samplers print the same token rows, up to the CUDA kernel B8's band
(``csrc/topp_tail.cu``).  Times are printed beside the device's name.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.guards import resolve_device
from repro_torch.models.model import ARCHS, build_model, get_config, synth_batch
from repro_torch.serving.engine import ServeEngine

SAMPLERS = ("topp_scan", "topp_kernel", "topp_blocked", "topp_segmented", "topp_xla",
            "greedy")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCHS), default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, op="torch_serve_topp")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    cfg = get_config(args.arch, smoke=True)       # the reduced config
    params = build_model(cfg).init(0, device=dev)
    batch = synth_batch(cfg, ShapeConfig("serve", args.prompt_len, args.batch, "prefill"),
                        torch.Generator(device=dev).manual_seed(1))
    uniforms = torch.rand((args.new_tokens, args.batch),
                          generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    tokens = {}
    for sampler in SAMPLERS:
        eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.new_tokens
                          + cfg.n_img_tokens, top_p=0.9, sampler=sampler, device=dev)
        t0 = time.perf_counter()
        toks = eng.generate(batch, args.new_tokens, uniforms=uniforms).cpu().numpy()
        dt = time.perf_counter() - t0
        tokens[sampler] = toks
        print(f"[serve] {sampler:14s} {toks.shape} in {dt:5.2f}s on {where} "
              f"-> {toks[0, :8]}")
    ok = all(t.shape == (args.batch, args.new_tokens) and (t >= 0).all()
             and (t < cfg.vocab_size).all() for t in tokens.values())
    print("[serve] every sampler gave (batch, new_tokens) ids in the vocabulary:", ok)
    return {"checks": {"token shapes and ids": ok}, "tokens": tokens,
            "uniforms": uniforms.cpu().numpy()}


if __name__ == "__main__":
    main()

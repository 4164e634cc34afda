"""Quickstart on the PyTorch port: the paper's matmul scan as a drop-in cumsum,
and the scan-based operators.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``, on the same numpy
inputs.  It runs on the GPU unless given ``--device cpu``.  Where the JAX
example calls the Pallas kernel ``repro.kernels.scan_kernel``, this one calls
``scan(method="kernel")``: the hand-written CUDA kernel B1 on the card, its
plain PyTorch version on CPU tensors.  Torch's Philox and JAX's threefry draw
different bits, so the top-p sampler takes its uniforms from numpy (``u=``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import compress, radix_sort, scan, top_p_sample, topk
from repro_torch.core.guards import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, op="torch_quickstart")

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def close(a, b):
        return bool(torch.allclose(a, b, atol=1e-2))

    # 1) prefix sum on the tensor cores: scan(z) = A@U + L^-@A@1  (paper Eq. 1)
    x = on(np.random.default_rng(0).standard_normal(100_000), torch.float32)
    y_auto = scan(x)                            # method="auto": the tuning table picks
    y_mm = scan(x, method="matmul", variant="scanul1", tile_s=128)
    y_vec = scan(x, method="vector")            # torch.cumsum, the baseline
    checks = {"matmul scan == cumsum": close(y_mm, y_vec),
              "auto scan == cumsum": close(y_auto, y_vec)}
    print("matmul scan == cumsum:", checks["matmul scan == cumsum"])
    print("auto scan == cumsum:  ", checks["auto scan == cumsum"])

    # 2) int8 mask scan (int8 in, int32 out)
    mask = on(np.random.default_rng(1).random(10_000) < 0.3, torch.int8)
    positions = scan(mask, exclusive=True)      # destination offsets, int32
    n_true = int(positions[-1] + mask[-1])
    print("mask scan dtype:", positions.dtype, "n_true:", n_true)

    # 3) the hand-written CUDA tile scan B1 (its plain version on CPU tensors)
    y_k = scan(x[:16384], method="kernel", tile_s=128)
    checks["kernel scan matches"] = close(y_k, y_vec[:16384])
    print("cuda kernel matches:", checks["kernel scan matches"])

    # 3b) the paper's §4 blocked multi-core pipeline (B2 block sums, B3 carry
    #     scan, B4 block scan with the carry added)
    y_b = scan(x, method="blocked", tile_s=128, block_tiles=4)
    checks["blocked pipeline matches"] = close(y_b, y_vec)
    print("blocked pipeline matches:", checks["blocked pipeline matches"])

    # 4) scan-based operators (paper §5)
    vals = on(np.random.default_rng(2).standard_normal(4096), torch.float16)
    sorted_vals, order = radix_sort(vals, descending=True)
    print("radix sort descending head:", sorted_vals[:4].cpu().numpy())
    kept, count = compress(vals, vals > 0)
    print("compress kept", int(count), "of", vals.shape[0])
    tv, ti = topk(vals, 5)
    print("top-5:", tv.cpu().numpy())

    # 5) nucleus sampling as in the paper's Llama3 case study
    logits = on(np.random.default_rng(3).standard_normal((2, 1000)) * 2, torch.float32)
    u = on(np.random.default_rng(4).random((2, 1)), torch.float32)
    toks = top_p_sample(logits, p=0.9, u=u)
    print("top-p samples:", toks.cpu().numpy())

    def host(t):
        return t.cpu().numpy()

    return {"checks": checks, "y_auto": host(y_auto), "y_mm": host(y_mm),
            "y_vec": host(y_vec), "positions": host(positions), "n_true": n_true,
            "y_kernel": host(y_k), "y_blocked": host(y_b), "sorted": host(sorted_vals),
            "order": host(order), "kept": host(kept), "count": int(count),
            "topk_values": host(tv), "topk_indices": host(ti), "u": host(u),
            "top_p": host(toks)}


if __name__ == "__main__":
    main()

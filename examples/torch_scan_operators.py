"""The paper's operator zoo on the PyTorch port, at realistic AI-workload shapes:
MoE dispatch offsets by an int8 mask scan, radix-sort top-k, weighted sampling,
compress, split and the segmented operators.

    PYTHONPATH=src python examples/torch_scan_operators.py [--device cpu]

The port's counterpart of ``examples/scan_operators.py``, on the same numpy
inputs.  It runs on the GPU unless given ``--device cpu``.  Torch's Philox and
JAX's threefry draw different bits, so the samplers take their uniforms from
numpy (``u=``); ``split(method="kernel")`` is the hand-written CUDA kernel B5
on the card (its plain version on CPU tensors).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (SegmentedBatch, compress, scan, segment_cumsum, segment_sort,
                              segment_top_p_sample, segment_topk, split, topk,
                              weighted_sample)
from repro_torch.core.guards import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, op="torch_scan_operators")
    rng = np.random.default_rng(0)

    def on(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def host(t):
        return t.cpu().numpy()

    out = {}
    # --- MoE dispatch: position-in-expert = exclusive int8 mask scan (paper Fig. 9) ---
    T, E = 8192, 64
    expert_of = on(rng.integers(0, E, T), torch.int64)
    onehot = (expert_of[:, None] == torch.arange(E, device=dev)[None, :]).to(torch.int8)
    pos_in_expert = scan(onehot, axis=0, exclusive=True)          # int32
    my_pos = torch.gather(pos_in_expert, 1, expert_of[:, None])[:, 0]
    print("MoE dispatch: max position-in-expert =", int(my_pos.max()), "(~T/E =", T // E, ")")
    out["pos_in_expert"] = host(pos_in_expert)

    # --- token filtering (compress == masked_select) ---
    scores = on(rng.standard_normal(T), torch.float32)
    kept, n = compress(scores, scores > 1.0)
    print(f"compress: kept {int(n)}/{T} tokens above threshold")
    out["kept"], out["n_kept"] = host(kept), int(n)

    # --- vocabulary top-k via descending radix sort (fp16: 16 key bits) ---
    logits = on(rng.standard_normal(4096), torch.float16)
    v, i = topk(logits, 8)
    print("top-8 logits:", host(v))
    out["topk_values"], out["topk_indices"] = host(v), host(i)

    # --- weighted sampling by inverse transform on the scanned CDF ---
    w = on(rng.random(100_000), torch.float32)
    u = on(np.random.default_rng(1).random((8, 1)), torch.float32)
    samples = weighted_sample(w.expand(8, -1), u=u)
    print("weighted samples (support 100k):", host(samples))
    out["weighted_u"], out["weighted"] = host(u), host(samples)

    # --- stable split keeps relative order (the radix-sort building block) ---
    x = torch.arange(10, dtype=torch.float32, device=dev)
    z, ind, nt = split(x, x % 3 == 0)
    print("split([0..9], %3==0):", host(z).astype(int), "n_true =", int(nt))

    # --- the same split as ONE launch of the CUDA kernel B5 ---
    zk, indk, ntk = split(x, x % 3 == 0, method="kernel")
    checks = {"split(method='kernel') matches": bool(torch.equal(z, zk))
              and bool(torch.equal(ind, indk)) and int(nt) == int(ntk)}
    print("split(method='kernel') matches:", checks["split(method='kernel') matches"],
          "— mask scan and scatter in one kernel")
    out["split"], out["split_indices"], out["split_n_true"] = host(z), host(ind), int(nt)

    # --- segmented subsystem: the same operators over a packed ragged batch ---
    docs = [rng.standard_normal(k).astype(np.float32) for k in (5, 0, 3, 9)]
    sb = SegmentedBatch.from_ragged(docs)
    sb = SegmentedBatch(sb.values.to(dev), sb.offsets.to(dev))
    print("packed batch:", sb.num_segments, "segments, lengths", host(sb.lengths))
    cs = segment_cumsum(sb)
    print("per-segment cumsum (carry resets at boundaries):", host(cs).round(2))
    sv, sperm = segment_sort(sb, bits_per_pass=4)       # radix sort per segment
    print("segment_sort head:", host(sv[:5]).round(2))
    tv, ti, tc = segment_topk(sb, k=2)
    print("per-segment top-2:", host(tv).round(2), "counts", host(tc))
    # ragged nucleus sampling: no padding to the longest row
    us = on(np.random.default_rng(2).random((sb.num_segments, 1)), torch.float32)
    tok = segment_top_p_sample(sb.values * 3, sb.offsets, p=0.9, u=us)
    print("segment_top_p_sample tokens (segment-local):", host(tok))
    out.update(docs=docs, segment_cumsum=host(cs), segment_sort=host(sv),
               segment_perm=host(sperm), segment_topk_values=host(tv),
               segment_topk_indices=host(ti), segment_topk_counts=host(tc),
               segment_u=host(us), segment_top_p=host(tok), checks=checks)
    return out


if __name__ == "__main__":
    main()

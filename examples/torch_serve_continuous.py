"""Continuous batching on the PyTorch port: paged KV cache, FCFS scheduler, ticks
of eager decode steps.

A seeded Poisson trace of ragged requests is served by ``ContinuousEngine``
(fixed page pool, strict-FCFS admission, ``tick_tokens`` decode steps a tick),
then each stream is checked against a solo ``ServeEngine.generate`` call with
the request's own uniform stream: the exact-stream contract.

    PYTHONPATH=src python examples/torch_serve_continuous.py --requests 6 [--device cpu]

The port's counterpart of ``examples/serve_continuous.py``: the same arguments
and defaults, the reduced (SMOKE) config of ``--arch``.  It runs on the GPU
unless given ``--device cpu``.  Where the JAX example counts the
``lax.while_loop``\\ s of its staged tick (``count_while_loops``, not ported),
this one prints the host syncs a tick on the card
(``torch.cuda.set_sync_debug_mode``; one a tick plus each admission's).  A
request carries a ``seed``: its uniforms are ``torch.rand((max_new_tokens,))``
from a ``torch.Generator`` on the device seeded with it.  Times are printed
beside the device's name.
"""
from __future__ import annotations

import argparse
import time
import warnings

import numpy as np
import torch

from repro_torch.core.guards import resolve_device
from repro_torch.models.model import ARCHS, build_model, get_config
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import ContinuousEngine, poisson_trace


def _run_counting_syncs(eng, trace, dev):
    """``eng.run(trace)``, its seconds and, on the card, the host syncs it made."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        res = eng.run(trace)
        return res, time.perf_counter() - t0, None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            res = eng.run(trace)
            dt = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res, dt, sum("synchroniz" in str(w.message) for w in caught)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCHS), default="llama3-8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--n-pages", type=int, default=13)
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--sampler", default="greedy", choices=ContinuousEngine.SAMPLERS)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, op="torch_serve_continuous")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    cfg = get_config(args.arch, smoke=True)       # the reduced config
    params = build_model(cfg).init(0, device=dev)
    eng = ContinuousEngine(cfg, params, max_batch=args.max_batch, page_size=args.page_size,
                           n_pages=args.n_pages, max_len=32, sampler=args.sampler,
                           tick_tokens=4, device=dev)
    trace = poisson_trace(args.requests, rate=args.rate, vocab_size=cfg.vocab_size,
                          seed=17, prompt_len=(3, 10), max_new=(2, 8))
    res, dt, syncs = _run_counting_syncs(eng, trace, dev)
    st = res["stats"]
    print(f"[serve] {st['reqs']} requests, {st['total_tokens']} tokens in {dt:5.2f}s on "
          f"{where} over {st['steps']} virtual steps / {st['ticks']} ticks; peak pages "
          f"{st['peak_pages']}/{st['pool_capacity']} (util {st['peak_util']:.0%})")
    if syncs is None:
        print("[serve] host syncs a tick: not measured on the CPU")
    else:
        print(f"[serve] host syncs a tick: {syncs / st['ticks']:.2f} ({syncs} in "
              f"{st['ticks']} ticks, admissions included)")
    for rid, info in res["requests"].items():
        print(f"[serve]   {rid}: arrived {info['arrival_step']:3d} admitted "
              f"{info['admit_step']:3d} finished {info['finish_step']:3d} "
              f"({info['n_tokens']} tokens)")

    # exact-stream contract: continuous == solo dense, per request
    solo = ServeEngine(cfg, params, max_len=eng.n_blocks * args.page_size,
                       sampler=args.sampler, device=dev)
    matched = 0
    for r in trace:
        gen = torch.Generator(device=dev).manual_seed(int(r.seed))
        u = torch.rand((r.max_new_tokens,), generator=gen, device=dev)
        ref = solo.generate({"tokens": torch.as_tensor(r.tokens, device=dev)[None]},
                            r.max_new_tokens, uniforms=u[:, None]).cpu().numpy()[0]
        matched += bool(np.array_equal(res["streams"][r.rid], ref))
    ok = matched == len(trace)
    print(f"[serve] {matched} of {len(trace)} continuous streams match their solo "
          "ServeEngine decode token for token")
    return {"checks": {"streams match solo decode": ok}, "streams": res["streams"],
            "stats": st, "requests": res["requests"], "host_syncs": syncs}


if __name__ == "__main__":
    main()

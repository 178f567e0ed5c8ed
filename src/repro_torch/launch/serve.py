"""Serving launcher: batched requests against a reduced model.

``python -m repro_torch.launch.serve --arch qwen3-1.7b --requests 6``

The JAX package's flags, plus ``--device`` (default ``cuda``: the kernels
on the card; ``cpu`` runs their plain versions).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, reduced
from ..devices import resolve_device
from ..nn import init_params
from ..serve import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--numerics", default="fp32",
                    help="NumericsSpec alias / spec / plan string")
    ap.add_argument("--block-size", type=int, default=8,
                    help="KV lines per paged-cache block")
    ap.add_argument("--chunk", type=int, default=8,
                    help="prompt tokens spliced per prefill chunk")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch)).with_(numerics=args.numerics,
                                               param_dtype="float32",
                                               remat="none")
    params = init_params(torch.Generator().manual_seed(args.seed), cfg,
                         device=device)
    sc = ServeConfig(max_batch=args.max_batch,
                     max_len=args.prompt_len + args.max_new + 2,
                     temperature=args.temperature, seed=args.seed,
                     block_size=args.block_size,
                     prefill_chunk=args.chunk)
    engine = ServingEngine(cfg, params, sc)

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(3, cfg.vocab_size,
                            size=rng.integers(4, args.prompt_len + 1))
               for _ in range(args.requests)]
    t0 = time.time()
    outs = engine.run(prompts, max_new=args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total_new = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        print(f"[serve] req {i}: prompt_len={len(prompts[i])} → {o}")
    print(f"[serve] {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s batched)")
    print(f"[serve] occupancy {engine.occupancy:.2f}/{sc.max_batch} slots, "
          f"{engine.stats['prefill_chunks']} prefill chunks, "
          f"{engine.stats['decode_steps']} decode steps, "
          f"{engine.bm.available}/{engine.bm.capacity} blocks free")
    print(f"[serve] matmul path: {engine.matmul_path} on {device.type}")
    return outs


if __name__ == "__main__":
    main()

"""Batched serving: chunked prefill + paged KV cache + continuous batching.

Run:  python -m repro_torch.examples.serve_batched --arch yi-6b
[--device cpu]
(reduced-config model; the ``decode_32k`` cell of
``repro_torch.launch.dryrun`` runs this paged decode step at full size on
a fake production mesh.)

Prompts are spliced into the paged cache a chunk at a time (at most one
chunk per engine step, so prefills never stall concurrent decodes);
finished slots refill from the admission queue without draining the
batch.  See ``repro_torch.examples.quickstart`` §7 for the async
submit/poll surface and the paged-cache budget math.

The matmul path is selected by ``--numerics`` — a ``NumericsSpec`` alias
or spec string resolved once by the engine into a
``repro_torch.core.spec.LNSRuntime``:

* ``fp32`` / ``bf16``      — float matmuls;
* ``lns16-exact``          — the ⊞-MAC (pairwise-tree order);
* ``lns16-exact-pallas``   — the fused forward ⊞-MAC kernel (CUDA on the
  card, its plain version on the CPU): batched serving on the same kernel
  datapath that training uses.  Equivalently:
  ``lns16-exact,backend=pallas``.
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
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--numerics", default="fp32",
                    help="NumericsSpec alias or spec string: fp32 | "
                    "lns16-exact | lns16-exact-pallas (the kernel path) | "
                    "'lns16-exact,backend=pallas' | ...")
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
    params = init_params(0, cfg, device=device)
    engine = ServingEngine(cfg, params,
                           ServeConfig(max_batch=3, max_len=40,
                                       temperature=args.temperature,
                                       block_size=args.block_size,
                                       prefill_chunk=args.chunk))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=rng.integers(4, 12))
               for _ in range(args.requests)]
    t0 = time.time()
    outs = engine.run(prompts, max_new=args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    for i, o in enumerate(outs):
        print(f"req {i}: {len(prompts[i])} prompt toks → {o}")
    n = sum(len(o) for o in outs)
    print(f"[serve] {args.requests} requests, {n} new tokens, "
          f"{n/dt:.1f} tok/s (continuous batching over 3 slots)")
    print(f"[serve] occupancy {engine.occupancy:.2f}/3 slots, "
          f"{engine.stats['prefill_chunks']} prefill chunks, "
          f"{engine.bm.available}/{engine.bm.capacity} blocks free")
    print(f"[serve] numerics spec: {engine.numerics.spec}")
    print(f"[serve] batch served by: {engine.matmul_path} on {device.type}")
    return outs


if __name__ == "__main__":
    main()

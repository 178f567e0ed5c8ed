#!/usr/bin/env python3
"""Time the fused forward ⊞-MAC kernel and the fused train step of two
checkouts of the port on one CUDA card, interleaved.

    python3 scripts/ab_fused_step.py --roots OLD NEW NEW OLD [--out FILE]

Each root is the top of a checkout (its ``src/repro_torch`` is imported,
and its ``kernels/csrc/lns_mac.cu`` built); each runs in a process of its
own, in the order given, so that a drift of the card or the host over the
call shows as a difference between the two runs of one root.  A run
measures, at the paper MLP's shapes (784–100–10, batch 5, lns16, LUT Δ,
weight decay 0.01):

* ``mac_kernel`` with the forward epilogue, as the fused step launches it
  for the hidden and the output layer: ms per launch on the card alone
  (CUDA events around 200 launches queued behind a spin kernel) and ms
  per call with the wrapper;
* the fused train step: ms per step on the host clock over 100 steps, three
  times.

It prints one JSON line per run and a table; ``--out`` also writes the
runs to a JSON file.  The runs' output codes of the kernel are hashed, so
that the table shows whether the checkouts computed the same.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

SEED, BATCH = 0, 5


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_host(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_device(torch, fn, reps, host_ms):
    """ms per launch with no host gap: a spin kernel holds the stream
    while the host enqueues the launches behind it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_spin = torch.cuda.Event(enable_timing=True)
    spun = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t_spin.record()
    torch.cuda._sleep(int(3 * reps * host_ms * 1e-3 * 2.0e9))
    spun.record()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if t_spin.elapsed_time(spun) < enqueue_ms:
        raise AssertionError("the spin ended before the enqueue did")
    return start.elapsed_time(end) / reps


def run_one(root: str) -> dict:
    """Measure the checkout at ``root`` in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "src"))
    os.chdir(root)
    import torch
    from repro_torch.core import DELTA_DEFAULT, LNS16, beta_code, encode
    from repro_torch.kernels import build
    from repro_torch.kernels import lns_matmul as K
    from repro_torch.paper import datasets
    from repro_torch.paper.mlp import MLPConfig, make_mlp
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card is available")
    t0 = time.time()
    build.load_library()
    out = dict(root=root, card=nvidia_smi_line(),
               build_s=time.time() - t0,
               ptxas=[ln.strip() for ln in build.build_report().splitlines()
                      if "registers" in ln])
    fmt, spec, dev = LNS16, DELTA_DEFAULT, torch.device("cuda")
    rk = torch.Generator().manual_seed(SEED + 1)

    def operand(shape, scale, zero_frac):
        v = torch.randn(shape, generator=rk) * scale
        v[torch.rand(shape, generator=rk) < zero_frac] = 0.0
        return encode(v, fmt).to(dev)

    beta = beta_code(0.01, fmt)
    digest = hashlib.sha256()
    for (m, k, n), name, ep in (
            ((BATCH, 784, 100), "hidden",
             K.FwdEpilogue(bias=True, llrelu_beta=beta, emit_z_sign=True)),
            ((BATCH, 100, 10), "out", K.FwdEpilogue(bias=True))):
        x, w, b = (operand((m, k), 1.0, 0.5), operand((k, n), 0.05, 0.02),
                   operand((n,), 0.1, 0.2))

        def launch(x=x, w=w, b=b, ep=ep):
            return K.mac_cuda(x.code, x.sign, w.code, w.sign,
                              a_contract_axis=1, b_contract_axis=0, fmt=fmt,
                              spec=spec, fwd_epilogue=ep, bias_code=b.code,
                              bias_sign=b.sign)
        for plane in launch():
            digest.update(plane.cpu().numpy().tobytes())
        host_ms = time_host(torch, launch, 200)
        out[f"{name}_ms"] = time_device(torch, launch, 200, host_ms)
        out[f"{name}_call_ms"] = host_ms
    out["kernel_out_sha256"] = digest.hexdigest()[:16]

    model = make_mlp("lns", MLPConfig(spec="lns16-train-pallas",
                                      weight_decay=0.01), "cuda")
    params = model.init(torch.Generator().manual_seed(SEED))
    xs, ys, _, _, _ = datasets.load("mnist", "data", SEED)

    def steps(params, lo, count):
        for i in range(lo, lo + count):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            params, loss = model.train_step(params, xs[sl], ys[sl])
        torch.cuda.synchronize()
        return params, float(loss)

    params, _ = steps(params, 0, 5)
    out["step_ms"] = []
    for rep in range(3):
        t0 = time.perf_counter()
        params, loss = steps(params, 5 + 100 * rep, 100)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3 / 100)
    out["loss"] = loss
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", help="checkouts, in run order")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="write the runs to this JSON file")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.one)), flush=True)
        return 0
    if not args.roots:
        ap.error("--roots is required")
    runs = []
    for root in args.roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True,
                             text=True, timeout=600)
        if res.returncode:
            sys.stderr.write(res.stdout + res.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(f"{'root':40s} {'hidden ms':>10s} {'out ms':>9s} "
          f"{'step ms (3 x 100 steps)':>30s}  out hash")
    for r in runs:
        steps = " ".join(f"{s:.3f}" for s in r["step_ms"])
        print(f"{r['root'][-40:]:40s} {r['hidden_ms']:10.5f} "
              f"{r['out_ms']:9.5f} {steps:>30s}  {r['kernel_out_sha256']}")
    print(runs[0]["card"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

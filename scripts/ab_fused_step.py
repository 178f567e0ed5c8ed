#!/usr/bin/env python3
"""Time the ⊞-MAC and ⊞-SGD kernels and the fused train step of several
checkouts of the port on one CUDA card, interleaved.

    python3 scripts/ab_fused_step.py --roots OLD NEW NEW OLD [--out FILE]

Each root is the top of a checkout (its ``src/repro_torch`` is imported,
and its ``kernels/csrc/lns_mac.cu`` built); each runs in a process of its
own, in the order given, so that a drift of the card or the host over the
call shows as a difference between the two runs of one root.  A run
measures, at the paper MLP's shapes (784–100–10, batch 5, lns16, LUT Δ,
weight decay 0.01), ms per launch on the card alone (CUDA events around
200 launches queued behind a spin kernel) and ms per call with the
wrapper, for:

* the forward ⊞-MAC of the hidden and the output layer, with the forward
  epilogue (``hidden``, ``out``: ``lns_matmul_fused``, as the fused step
  launches it) and with the epilogue off (``plain_hidden``,
  ``plain_out``: ``lns_matmul``, as the unfused step does);
* the launches of the contractions over the batch: the dW-update of w1
  and w2 (``dwu_w1``, ``dwu_w2``), the plain dW (``dw_w1``, ``dw_w2``),
  the w1 partials at S = 5 (``part_w1``) and the dX (``dx``);
* the elementwise ⊞-SGD at n = 10, 100 and 78400 (``upd10``, ``upd100``,
  ``upd78400``);
* the ⊞-reduce of the segmented step's combine, S = 5 partials read in
  place: one launch per parameter (``box_w1``, ``box_b1``, ``box_w2``,
  ``box_b2``: 78400, 100, 1000 and 10 rows) and, where the checkout has
  the grouped launch, all four in one (``box_all``, checked against the
  four);
* the plain dW at batches of 8 to 32 (``dw_w1_b8`` ... ``dw_w2_b32``), on
  each side of the short form's threshold, where a checkout has one;
* the launch floor, an empty kernel (``floor``), where the checkout's
  library has one;
* the cycles of one ⊞-MAC step at 1.98 GHz: the plain forward's time at a
  contraction of 2 × 784 less its time at 784, over 784 steps;
* the fused train step: ms per step on the host clock over 100 steps,
  three times;
* the build: ``ptxas``' lines (registers, spills) for every instantiation
  of ``mac_kernel``, ``mac_short_kernel``, ``update_kernel`` and
  ``boxsum_kernel``, and from
  ``cuobjdump -sass`` the inner loop of ``mac_kernel<kLut>`` that holds the
  most instructions (its address range, its instruction count and its
  count of each opcode) and the instruction count of each instantiation
  of ``boxsum_kernel<kLut, ...>``.

It prints one JSON line per run and a table; ``--out`` also writes the
runs to a JSON file.  The output codes of every kernel launch are hashed,
so that the table shows whether the checkouts computed the same.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

SEED, BATCH = 0, 5
CLOCK_HZ = 1.98e9  # the H100 SXM's boost clock


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


KERNELS = ("mac_kernel", "mac_short_kernel", "update_kernel",
           "boxsum_kernel")


def ptxas_lines(report: str) -> list:
    """(kernel, usage) of every instantiation of ``KERNELS`` in ptxas' -v
    report: each "Compiling entry function" line is followed by its spill
    line and its "Used N registers" line."""
    out, name, spill = [], None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), ""
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            if any(re.search(rf"\d{k}I", name) for k in KERNELS):
                out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def sass_functions(text: str) -> dict:
    """{mangled name: [(address, instruction)]} of a cuobjdump -sass
    listing."""
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        out[name] = [(int(a, 16), t.strip()) for a, t in
                     re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
    return out


def inner_loop(ins: list) -> dict:
    """The innermost loop (a backward branch whose range holds no other)
    with the most instructions: its range, length and opcode counts."""
    back = []
    for addr, text in ins:
        m = re.search(r"\bBRA\b(?:[^,]*,)?\s*0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            back.append((int(m.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in back
             if not any(lo <= l2 and h2 < hi for l2, h2 in back)]
    lo, hi = max(inner, key=lambda x: x[1] - x[0])
    body = [t for a, t in ins if lo <= a <= hi]
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
                              for t in body)
    return dict(range=f"{lo:#x}-{hi:#x}", instructions=len(body),
                opcodes=dict(ops.most_common()))


def lut_loop(build) -> dict:
    """The inner loop of ``mac_kernel<kLut>`` in the built library, and
    the instruction count of each ``boxsum_kernel<kLut, ...>``."""
    lib, _ = build._build(build.CSRC / "lns_mac.cu")
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs = sass_functions(text)
    name = next(n for n in funcs if "mac_kernelILi0E" in n)
    box = {re.search(r"boxsum_kernelI(\w+?)EEv", n).group(1): len(ins)
           for n, ins in funcs.items() if "boxsum_kernelILi0E" in n}
    return dict(function=name, boxsum_instructions=box,
                **inner_loop(funcs[name]))


def run_one(root: str) -> dict:
    """Measure the checkout at ``root`` in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "src"))
    os.chdir(root)
    import torch
    from repro_torch.core import (DELTA_DEFAULT, LNS16, LogSGDConfig,
                                  UpdateEpilogue, beta_code, encode)
    from repro_torch.kernels import build
    from repro_torch.kernels import lns_boxsum as B
    from repro_torch.kernels import lns_matmul as K
    from repro_torch.paper import datasets
    from repro_torch.paper.mlp import MLPConfig, make_mlp
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card is available")
    t0 = time.time()
    build.load_library()
    out = dict(root=root, card=nvidia_smi_line(),
               build_s=time.time() - t0,
               ptxas=ptxas_lines(build.build_report()),
               lut_loop=lut_loop(build))
    fmt, spec, dev = LNS16, DELTA_DEFAULT, torch.device("cuda")
    rk = torch.Generator().manual_seed(SEED + 1)

    def operand(shape, scale, zero_frac):
        v = torch.randn(shape, generator=rk) * scale
        v[torch.rand(shape, generator=rk) < zero_frac] = 0.0
        return encode(v, fmt).to(dev)

    beta = beta_code(0.01, fmt)
    hidden_ep = K.FwdEpilogue(bias=True, llrelu_beta=beta, emit_z_sign=True)
    out_ep = K.FwdEpilogue(bias=True)
    up = UpdateEpilogue.from_sgd(LogSGDConfig(lr=0.01, weight_decay=0.01),
                                 fmt)
    digest = hashlib.sha256()
    launches = {}  # label → launch
    # The forward: (shape, name, launches as (key prefix, epilogue or None)).
    for (m, k, n), name, runs in (
            ((BATCH, 784, 100), "hidden", (("", hidden_ep), ("plain_", None))),
            ((BATCH, 100, 10), "out", (("", out_ep), ("plain_", None))),
            ((BATCH, 2 * 784, 100), "hidden2x", (("plain_", None),))):
        x, w, b = (operand((m, k), 1.0, 0.5), operand((k, n), 0.05, 0.02),
                   operand((n,), 0.1, 0.2))
        for key, ep in runs:
            kw = {} if ep is None else dict(
                fwd_epilogue=ep, bias_code=b.code, bias_sign=b.sign)
            launches[f"{key}{name}"] = (
                lambda x=x, w=w, kw=kw: K.mac_cuda(
                    x.code, x.sign, w.code, w.sign, a_contract_axis=1,
                    b_contract_axis=0, fmt=fmt, spec=spec, **kw))
    # The contractions over the batch: dW-update, dW, partials, dX.
    dw = dict(a_contract_axis=0, b_contract_axis=0, fmt=fmt, spec=spec)
    for (m, k, n), name in (((BATCH, 784, 100), "w1"),
                            ((BATCH, 100, 10), "w2")):
        x, d, w = (operand((m, k), 1.0, 0.5), operand((m, n), 0.1, 0.1),
                   operand((k, n), 0.05, 0.02))
        launches[f"dwu_{name}"] = (
            lambda x=x, d=d, w=w: K.mac_cuda(
                x.code, x.sign, d.code, d.sign, update_epilogue=up,
                w_code=w.code, w_sign=w.sign, **dw))
        launches[f"dw_{name}"] = (
            lambda x=x, d=d: K.mac_cuda(x.code, x.sign, d.code, d.sign, **dw))
        if name == "w1":
            launches["part_w1"] = (
                lambda x=x, d=d: K.mac_cuda(x.code, x.sign, d.code, d.sign,
                                            segments=BATCH, **dw))
        # Batches on each side of the short form's threshold.
        for bt in (8, 12, 16, 20, 24, 32):
            xb, db = operand((bt, k), 1.0, 0.5), operand((bt, n), 0.1, 0.1)
            launches[f"dw_{name}_b{bt}"] = (
                lambda x=xb, d=db: K.mac_cuda(x.code, x.sign, d.code, d.sign,
                                              **dw))
    dy, w2 = operand((BATCH, 10), 0.1, 0.1), operand((100, 10), 0.05, 0.02)
    launches["dx"] = (lambda: K.mac_cuda(
        dy.code, dy.sign, w2.code, w2.sign, a_contract_axis=1,
        b_contract_axis=1, fmt=fmt, spec=spec))
    for n in (10, 100, 78400):
        w, g = operand((n,), 0.1, 0.2), operand((n,), 0.1, 0.1)
        launches[f"upd{n}"] = (lambda w=w, g=g: K.update_cuda(
            w.code, w.sign, g.code, g.sign, epilogue=up, fmt=fmt, spec=spec))
    combine = []
    for n, name in ((78400, "w1"), (100, "b1"), (1000, "w2"), (10, "b2")):
        part = operand((BATCH, n), 0.1, 0.1)
        combine.append((part.code.T, part.sign.T))
        launches[f"box_{name}"] = (lambda c=part.code.T, s=part.sign.T:
                                   B.boxsum_cuda(c, s, fmt=fmt, spec=spec))
    if getattr(build, "BOXSUM_MAX_SETS", 0) >= len(combine):
        launches["box_all"] = lambda: B.boxsum_many_cuda(combine, fmt=fmt,
                                                         spec=spec)
    out["ms"], out["call_ms"] = {}, {}
    for label, launch in launches.items():
        if label == "box_all":
            # Not hashed (a parent has no grouped launch): held to the four
            # launches one parameter each.
            for got, (c, s) in zip(launch(), combine):
                want = B.boxsum_cuda(c, s, fmt=fmt, spec=spec)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError("box_all differs from box_*")
        else:
            for plane in launch():
                digest.update(plane.cpu().numpy().tobytes())
        host_ms = time_host(torch, launch, 200)
        out["ms"][label] = time_device(torch, launch, 200, host_ms)
        out["call_ms"][label] = host_ms
    lib = build.load_library()
    if hasattr(lib, "lns_empty_launch"):
        from repro_torch.kernels._common import launch_empty
        host_ms = time_host(torch, lambda: launch_empty(dev), 200)
        out["ms"]["floor"] = time_device(torch, lambda: launch_empty(dev),
                                         200, host_ms)
    out["short_steps"] = (lib.lns_short_steps()
                          if hasattr(lib, "lns_short_steps") else None)
    out["kernel_out_sha256"] = digest.hexdigest()[:16]
    out["step_cycles"] = ((out["ms"]["plain_hidden2x"]
                           - out["ms"]["plain_hidden"])
                          * 1e-3 / 784 * CLOCK_HZ)

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
    labels = list(runs[0]["ms"])
    for r in runs[1:]:
        labels += [k for k in r["ms"] if k not in labels]
    print(f"{'ms on the card':16s} " + " ".join(
        f"{r['root'][-12:]:>12s}" for r in runs))
    for label in labels:
        print(f"{label:16s} " + " ".join(
            f"{r['ms'][label]:12.6f}" if label in r["ms"] else f"{'-':>12s}"
            for r in runs))
    for key, fmt in (("step_cycles", "{:12.1f}"),
                     ("short_steps", "{!s:>12s}"),
                     ("kernel_out_sha256", "{:>12s}")):
        print(f"{key:16s} " + " ".join(fmt.format(r[key]) for r in runs))
    print(f"{'step ms':16s} " + " ".join(
        f"{min(r['step_ms']):12.3f}" for r in runs) + "  (least of 3)")
    seen = set()
    for r in runs:
        if r["root"] in seen:
            continue
        seen.add(r["root"])
        print(r["root"])
        for ln in r["ptxas"]:
            print(f"  ptxas {ln}")
        loop = r["lut_loop"]
        print(f"  LUT loop {loop['range']}: {loop['instructions']} "
              f"instructions; {json.dumps(loop['opcodes'])}")
        print(f"  boxsum_kernel<kLut, ...> instructions: "
              f"{json.dumps(loop['boxsum_instructions'])}")
    print(runs[0]["card"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Quickstart: the LNS number system, the paper's MLP, and the kernels.

Run:  python -m repro_torch.examples.quickstart [--device cpu]

Ten sections, every subsystem: LNS arithmetic, the multiplication-free
matmul and its kernel, the numerics spec, log-domain training and its
data-parallel reduce, per-layer plans, fused epilogues and the block
tuner, serving, telemetry, plan search, and fault drills.  On ``cuda``
the ⊞-MAC runs the hand-written kernels; on ``cpu`` their plain versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import (DELTA_DEFAULT, LNS16, DeltaEngine, NumericsPlan,
                    NumericsSpec, boxdot, boxplus, decode, encode,
                    lns_matmul)
from ..devices import resolve_device
from ..kernels import autotune
from ..kernels.lns_matmul import lns_matmul_kernel, lns_matmul_trainable
from ..paper import run_experiment
from ..paper.mlp import MLPConfig, make_mlp

#: Steps of each §4 / §5 training run, and of each plan-search evaluation.
STEPS, SEARCH_STEPS = 80, 6


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def section1(device):
    print("=== 1. LNS arithmetic (paper Sec. 2-3) ===")
    fmt = LNS16
    eng = DeltaEngine(DELTA_DEFAULT, fmt)      # 20-entry LUT, d_max=10, r=1/2
    x = encode(torch.tensor(3.25, device=device), fmt)
    y = encode(torch.tensor(-1.5, device=device), fmt)
    print(f"3.25    → code={int(x.code)} sign={int(x.sign)}")
    print(f"3.25 ⊡ -1.5 = {float(decode(boxdot(x, y, fmt), fmt)):.4f}  "
          f"(exact: -4.875)")
    print(f"3.25 ⊞ -1.5 = {float(decode(boxplus(x, y, eng), fmt)):.4f}  "
          f"(exact: 1.75)")


def operands(device):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 64)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    return (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device),
            a @ b)


def section2(device):
    print("\n=== 2. Multiplication-free matmul (eq. 10) ===")
    fmt, eng = LNS16, DeltaEngine(DELTA_DEFAULT, LNS16)
    a, b, ab = operands(device)
    z = decode(lns_matmul(encode(a, fmt), encode(b, fmt), eng),
               fmt).cpu().numpy()
    print(f"emulated ⊞-MAC matmul median rel err vs float: "
          f"{np.median(np.abs(z - ab) / np.abs(ab)):.3f}")
    zk = decode(lns_matmul_kernel(encode(a, fmt), encode(b, fmt), fmt=fmt,
                                  spec=DELTA_DEFAULT), fmt).cpu().numpy()
    lane = "CUDA kernel" if a.is_cuda else "kernel's plain version"
    print(f"⊞-MAC {lane} (sequential order) matches emulation "
          f"structurally; median rel err: "
          f"{np.median(np.abs(zk - ab) / np.abs(ab)):.3f}")


def section3(device):
    print("\n=== 3. One spec, every numerics axis (NumericsSpec → "
          "LNSRuntime) ===")
    # Every axis of the arithmetic lives in ONE frozen, serializable
    # descriptor; str() round-trips to the canonical form.
    fmt = LNS16
    spec = NumericsSpec.parse("lns16-train-pallas")
    print(f"spec: {spec}")
    print(f"  fmt={spec.fmt.name} delta={spec.delta_spec.kind} "
          f"quantize={spec.quantize} backend={spec.backend} "
          f"reduce.mode={spec.reduce.mode}")
    print(f"  with_(backend='emulate') → {spec.with_(backend='emulate')}")
    print(f"  parse('lns16-train-emulate,backend=pallas') → "
          f"{NumericsSpec.parse('lns16-train-emulate,backend=pallas')}")
    # The spec resolved once is an LNSRuntime; the backend key is parsed
    # and printed, and the tensors' device picks the lane (the kernels on
    # a card, their plain versions on the CPU), bit-exact either way.
    _, b, _ = operands(device)
    for be_name in ("emulate", "pallas"):
        rt = spec.with_(backend=be_name).runtime(block_m=8, block_n=8,
                                                 block_k=16)
        dy = encode(torch.ones((4, 3), device=device), fmt)
        dx = rt.matmul.matmul_dx(dy, encode(b, fmt))  # dY ⊞ Bᵀ
        print(f"backward dX on {be_name:7s}: first code = "
              f"{int(dx.code[0, 0])}")
    # torch.autograd flows through the same ⊞-MAC path (a custom autograd
    # Function: no float matmul in either direction).
    a, b, _ = operands(device)
    a.requires_grad_()
    g, = torch.autograd.grad(lns_matmul_trainable(
        a, b, numerics="lns16-train-pallas,delta=lut640", block_m=8,
        block_n=8, block_k=16).sum(), a)
    print(f"torch.autograd through the ⊞-MAC: gA.shape = "
          f"{tuple(g.shape)}")


def section4(device):
    print("\n=== 4. End-to-end log-domain training (paper Sec. 4-5) ===")
    r = run_experiment("lns", "mnist", numerics="lns16-train-emulate",
                       epochs=1, max_steps_per_epoch=STEPS, device=device)
    print(f"LNS-16 LUT MLP, {STEPS} steps: val acc {r.val_curve[-1]:.3f}")
    r = run_experiment("float", "mnist", epochs=1,
                       max_steps_per_epoch=STEPS, device=device)
    print(f"float32 MLP,   {STEPS} steps: val acc {r.val_curve[-1]:.3f}")
    print("(python -m repro_torch.benchmarks.table1_accuracy runs the "
          "Table-1 grid)")
    # The data-parallel switch rides the same spec: reduce.* selects the
    # gradient-reduce semantics, so any rank count dividing
    # reduce.grad_segments yields bit-identical weight codes
    # (repro_torch.examples.train_data_parallel runs 1/2/4 ranks).
    from ..distributed.lns_dp import run_device_count_invariance_check
    ok, _ = run_device_count_invariance_check(
        (1,), steps=2, batch=8, device=device.type,
        numerics="lns16-train-pallas,reduce.grad_segments=4")
    print(f"DP ⊞-allreduce schedule == single-device sequential baseline: "
          f"{ok}")


def section5(device):
    print("\n=== 5. Per-layer mixed-format plans (NumericsPlan) ===")
    # The hidden layer (the bulk of the MACs) drops to lns12 while the
    # softmax-critical output layer keeps lns16.
    plan = NumericsPlan.parse("lns16-train-emulate;hidden=fmt:lns12")
    print(f"plan: {plan}")
    print(f"  hidden resolves to fmt={plan.resolve('hidden').fmt.name}, "
          f"out to fmt={plan.resolve('out').fmt.name}")
    r16 = run_experiment("lns", "mnist", numerics="lns16-train-emulate",
                         epochs=1, max_steps_per_epoch=STEPS, device=device)
    r12 = run_experiment("lns", "mnist", numerics=plan, epochs=1,
                         max_steps_per_epoch=STEPS, device=device)
    print(f"uniform lns16          : val acc {r16.val_curve[-1]:.3f}")
    print(f"lns12 hidden / lns16 out: val acc {r12.val_curve[-1]:.3f} "
          f"(Δ {r12.val_curve[-1] - r16.val_curve[-1]:+.3f} — the 12-bit "
          f"hidden layer costs little; the paper's accuracy cliff lives in "
          f"the softmax/output path, which stays 16-bit)")


def section6(device):
    print("\n=== 6. Fused epilogues + autotuned blocks (one pass per "
          "matmul) ===")
    # Bias ⊞, llrelu, the format-boundary requantize and the ⊞-SGD run at
    # the kernels' accumulator flush (MLPConfig.fused, bit-identical to
    # the unfused composition).  blocks=auto defers the tiled ⊞-MAC's rows
    # per block to the tuner (kernels/autotune.py), which measures on the
    # card and keeps its choices under .lns_autotune/; the CPU lane's
    # plain versions read no launch parameter, so there it answers the
    # default, 4 rows.
    rng = np.random.default_rng(0)
    xb = rng.uniform(0, 1, size=(64, 784)).astype(np.float32)
    yb = rng.integers(0, 10, size=(64,)).astype(np.int32)
    picks = autotune.prime_matmul(64, 784, 100, fmt=LNS16,
                                  spec=DELTA_DEFAULT)
    autotune.prime_matmul(64, 100, 10, fmt=LNS16, spec=DELTA_DEFAULT)
    print(f"autotuned hidden-layer blocks: {picks}")
    steps = {}
    for name, cfg in (
            ("unfused", MLPConfig(spec="lns16-train-pallas", fused=False)),
            ("fused", MLPConfig(spec="lns16-train-pallas,blocks=auto",
                                fused=True))):
        model = make_mlp("lns", cfg, device)
        p = model.init(_gen())

        def fn(model=model, p=p):
            return model.train_step(p, xb, yb)[0]["w1"].code.cpu()
        fn()                                         # warm
        steps[name] = [fn, float("inf")]
    for _ in range(3):                # interleaved best-of-reps
        for slot in steps.values():
            t0 = time.perf_counter()
            slot[0]()
            slot[1] = min(slot[1], time.perf_counter() - t0)
    before, after = steps["unfused"][1] * 1e3, steps["fused"][1] * 1e3
    same = torch.equal(steps["unfused"][0](), steps["fused"][0]())
    print(f"unfused step, default blocks: {before:8.1f} ms")
    print(f"fused step,   blocks=auto   : {after:8.1f} ms "
          f"({before / after:.2f}x; weight codes bit-identical: {same})")


def section7(device):
    print("\n=== 7. Serving: chunked prefill + paged KV cache + batching ===")
    # max_len becomes a token budget over fixed-size KV blocks:
    #   blocks/request = ceil(min(max_len, prompt + max_new) / block_size)
    # reserved in full at admission; block 0 is the null write sink.
    from ..nn import init_params
    from ..nn.config import ModelConfig
    from ..serve import TERMINAL, ServeConfig, ServingEngine
    scfg = ModelConfig(name="qs-serve", family="dense", n_layers=2,
                       d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                       vocab_size=64, d_head=16, vocab_pad_to=64,
                       numerics="fp32", param_dtype="float32", remat="none",
                       q_chunk=8)
    sc = ServeConfig(max_batch=2, max_len=24, block_size=4, prefill_chunk=4)
    engine = ServingEngine(scfg, init_params(0, scfg, device=device), sc)
    print(f"pool: {engine.bm.capacity} blocks x {sc.block_size} lines "
          f"= {engine.bm.capacity * sc.block_size}-token budget "
          f"({sc.max_batch} slots x max_len {sc.max_len})")
    rng = np.random.default_rng(0)
    rids = [engine.submit(rng.integers(3, 64, size=n), max_new=4,
                          deadline_steps=50) for n in (5, 7, 3)]
    while any(engine.poll(r).state not in TERMINAL for r in rids):
        engine.step()
    for r in rids:
        req = engine.poll(r)
        blocks = engine.bm.blocks_for(min(sc.max_len,
                                          req.prompt_len + req.max_new))
        print(f"  rid {r}: {req.state} prompt={req.prompt_len} "
              f"reserved {blocks} blocks -> {list(req.output)}")
    engine.bm.check_conserved()   # free-list conservation: no leaks
    print(f"occupancy {engine.occupancy:.2f}/{sc.max_batch} slots, "
          f"{engine.stats['prefill_chunks']} prefill chunks, "
          f"{engine.bm.available}/{engine.bm.capacity} blocks free again")
    print(f"numerics (fused-infer dispatch): {engine.matmul_path}")


def section8(device):
    print("\n=== 8. Watching your numerics: the obs telemetry subsystem ===")
    # Telemetry is observer-only: train_step_metrics gives train_step's
    # weight codes plus int32 taps; per-layer opt-in via the plan's
    # `metrics` axis (off | counters | full).
    from ..obs import DHIST_EDGES, MetricsRegistry, host_taps
    cfg = MLPConfig(n_in=24, n_hidden=16, n_out=10, lr=0.01,
                    spec="lns16-train-emulate;hidden=fmt:lns12,"
                         "metrics:full", matmul_block=8)
    model = make_mlp("lns", cfg, device)
    p = model.init(_gen())
    x = np.random.default_rng(0).normal(size=(8, 24)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, 10, size=(8,))
    (p2, _), taps = model.train_step_metrics(p, x, y)
    p2_plain, _ = model.train_step(p, x, y)
    same = torch.equal(p2["w1"].code, p2_plain["w1"].code)
    if not same:
        raise RuntimeError("metrics-on weight codes differ from "
                           "metrics-off")
    print(f"metrics-on == metrics-off weight codes: {same} "
          f"({len(taps)} tap labels collected)")
    # Structured sinks: the registry folds taps (with each layer's lane,
    # the device's) into labeled rows; JsonlSink flushes them per step.
    #   python -m repro_torch.launch.train --arch ... --metrics out.jsonl
    reg = MetricsRegistry(base_labels={"spec": str(model.plan)})
    lanes = model.lanes()
    reg.merge_numerics_taps(host_taps(taps), lanes=lanes)
    sat = reg.counter_value("numerics.sat", layer="hidden", op="act",
                            lane=lanes["hidden"])
    el = reg.counter_value("numerics.elems", layer="hidden", op="act",
                           lane=lanes["hidden"])
    print(f"hidden/act saturation: {sat}/{el} codes at lns12 code_max")
    dh = [r for r in reg.rows() if r["kind"] == "bucketed_histogram"
          and r["layer"] == "hidden"][0]
    print(f"Δ-LUT occupancy (edges {DHIST_EDGES}): {dh['counts']} — last "
          f"bucket is |d| beyond the paper LUT's d_max (Δ≈0 region)")


def section9(device):
    print("\n=== 9. Plan autosearch: derive the mixed plan automatically ===")
    # Sweep per-layer fmt rules, score each by short-horizon accuracy vs
    # the anchor and a datapath cost, keep the Pareto frontier.  Seeded
    # and journaled:  python -m repro_torch.launch.search --smoke
    from ..search import PlanSearch, SearchConfig, SearchSpace
    from ..search.report import frontier_table
    space = SearchSpace.for_paper_mlp("lns16-train-emulate",
                                      fmts=("lns16", "lns12"))
    cfg = SearchConfig(epochs=1, steps_per_epoch=SEARCH_STEPS, batch_size=5,
                       seed=0, refine_generations=1, refine_population=2)
    search = PlanSearch(space, cfg, device=device)
    try:
        res = search.run()
    finally:
        search.close()
    print(f"evaluated {len(res.evals)} candidate plans "
          f"(narrowing order from obs counters: {', '.join(res.order)})")
    print(frontier_table(res.frontier, res.winner))
    print("winning plan — paste into python -m repro_torch.launch.train:")
    print(f"  --numerics '{res.winner['plan']}'")


def section10(device):
    print("\n=== 10. Fault drill: inject → detect → recover ===")
    # A seed-keyed FaultPlan flips code bits, pins lanes at saturation,
    # corrupts Δ entries or drops DP partials; guardrails watch the §8
    # taps and recover (rollback, per-layer widening, recompute).
    #   python -m repro_torch.launch.drill --smoke
    from ..resil import GuardConfig, GuardedTrainer
    cfg = MLPConfig(n_in=12, n_hidden=9, n_out=4, lr=0.01, momentum=0.9,
                    spec="lns16-train-emulate;hidden=fmt:lns12,metrics:full",
                    matmul_block=8,
                    faults="seed=7,start=3;hidden=sat_lanes:4")
    model = make_mlp("lns", cfg, device)
    p = model.init(_gen())
    trainer = GuardedTrainer(model, p, model.init_momentum(p),
                             guard=GuardConfig(sat_frac=0.10))
    rng = np.random.default_rng(5)
    for _ in range(5):
        r = trainer.step(rng.normal(size=(8, 12)).astype(np.float32),
                         rng.integers(0, 4, size=(8,)))
        if r["action"]:
            print(f"step {r['step']}: "
                  f"{[a.kind for a in r['alerts']]} → {r['action']}")
    print(f"recovery events: {[e['action'] for e in trainer.events]} — "
          f"hidden widened from lns12 to lns16 under a "
          f"stuck-at-saturation storm")


SECTIONS = (section1, section2, section3, section4, section5, section6,
            section7, section8, section9, section10)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for section in SECTIONS:
        section(device)


if __name__ == "__main__":
    main()

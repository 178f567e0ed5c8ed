#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero before
the result line:

1. the card: ``torch.cuda.get_device_name(0)`` and nvidia-smi's name and
   power limit;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel on the card bit for bit against its plain PyTorch
   version on the card, at the training steps' shapes (batch 5), at the
   predict shape (batch 500) and at ragged shapes, over the Δ kinds
   (lut / bitshift / exact), the formats (lns16 / lns12), the epilogues,
   the segment counts S ∈ {1, 2, 4, 5, 8} of the segment-partial dW and
   the reduce lengths K ∈ {1, 5, 37, 128} of the ⊞-reduce, alone and as
   1, 2, 4 and 8 row sets of one grouped launch (steps 1, 2, 5, 12, 13,
   37 and 128; an all-zero row; exact cancellations); both forms of
   the ⊞-MAC on each side of the library's threshold T (CT ∈ {1, T,
   T + 1}) for C ∈ {1, 10, 33, 100}, and the ⊞-SGD at n ∈ {1, 10, 100,
   257, 1000, 78400}; and the Δ-index sweep: a two-step contraction whose
   second ⊞ meets every difference of the format with both sign
   relations, for LUT steps that are powers of two and one that is not,
   and for a table of the kernels' largest size, through the short form
   and again, after T + 1 zero-code steps, through the tiled form; the
   same differences through the ⊞-reduce for every Δ kind;
4. hold ``encode`` (all 256 pixel values) and ``lns_value_to_code`` (every
   lns16 / lns12 code) on the card against the CPU lane, and count how
   many exact-Δ codes the card and the CPU round differently;
5. the main paths: ``run_experiment`` trains the full-width 784–100–10
   MLP for 20 steps of batch 5 on synthetic ``mnist`` with
   ``lns16-train-pallas`` on the card, then evaluates, for three steps:
   the fused step; the unfused step (``fused=False``); and the segmented
   data-parallel step (``reduce.grad_segments=5``), once with no process
   group and once inside a one-rank NCCL group.  Each run on the card
   must give the weight codes and accuracies of the same run on the CPU
   lane, and its launch counters (set to 0 just before it, read just
   after) the launches its step makes.  Then
   ``run_device_count_invariance_check((1,))`` trains the small MLP with
   momentum in one NCCL rank of its own process and holds its codes to
   ``reference_train_step`` on the card;
6. times: ms per train step of each path and of the float and fixed-point
   baselines (``float``; ``fxp16-sr``, 16-bit fixed point with stochastic
   rounding), the launch floor (an empty kernel), and each kernel and its
   plain version by CUDA events at the launches of the path that runs it;
   the segmented step's combine as the one grouped ⊞-reduce launch it
   makes, and for comparison as one launch per parameter;
7. the Table 1 baselines: with TF32 off, ``run_experiment`` trains the
   float MLP and the fixed-point MLP at 16 and 12 bits, each without and
   with stochastic rounding, 20 steps of batch 5 on the card and on the
   CPU lane: the float weights must agree within the stated tolerance, the
   int32 codes and accuracies exactly, and the card runs launch no LNS
   kernel (counters set to 0 before, read after).  Then the Table 1 grid
   (the eight configs of ``repro_torch.benchmarks.table1_accuracy``) on
   the card, one epoch of 150 steps each, a line per run with its test
   accuracy and wall seconds;
8. telemetry, faults and guardrails: ``train_step_metrics`` of the fused,
   unfused and segmented steps at full width (and the fused step at
   ``metrics=full``, the Δ-table occupancy replay), each path's launch
   counters set to 0 just before it and read just after, must give the
   card's ``train_step`` codes and the CPU lane's codes and taps;
   ``train_step_faults`` under bit flips, stuck lanes, a corrupted Δ
   table and (segmented) segment faults must give the CPU lane's codes,
   so the threefry on the card draws the CPU's bits; the three drills of
   ``repro_torch.launch.drill`` on the card must give the CPU lane's rows
   but for ``lane``; then ms per step of ``train_step``,
   ``train_step_metrics`` and ``train_step_faults`` in turns;
9. the LM training path (``lns_matmul_trainable``): (a) kernel rows 5, 2
   and 6 at LM shapes (a forward over 2048, dX over 8192 and over 50 432,
   dW over 256 tokens, ragged R and C, and the full-width head's three
   products) bit for bit against their plain versions on the card; (b) the four ``reduced()`` dense configs under
   ``fp32`` and ``lns16-train-pallas``, 3 AdamW steps on the card against
   the CPU lane (fp32: every step's loss within rtol 1e-5; lns16-train:
   the first step's within 1e-2), each row launched once per LNS linear
   and CE chunk a step; (c) olmo-1b at full width, 2 layers, batch 2 ×
   seq 128: losses, ms per step, a profiled step, peak memory and each
   row's card ms against its bound at the step's shapes; (d) ``python -m
   repro_torch.launch.train`` with checkpoints and metrics, relaunched to
   resume at step 4;
10. MoE, MLA and serving: (a) every distinct shape of rows 5, 2 and 6 in
   (c)'s step and of row 1 (the fused forward with no epilogue, which
   ``linear_infer`` runs) at (d)'s decode and prefill shapes, held bit for
   bit against the plain version: every output over a contraction cut to
   40 steps, and, launched at full shape, the outputs of the first, last
   and one interior row and column tile; (b) ``reduced()``
   deepseek-moe-16b and deepseek-v2-lite-16b card vs CPU as 9b; (c)
   deepseek-v2-lite-16b at full width, 1 dense + 1 MoE layer, batch 2 ×
   seq 128, 3 AdamW steps: losses, ms per step, a profiled step, peak
   memory and each row's card ms against its bound; (d) a
   ``ServingEngine`` on the card, greedy, over the full-width 2-layer
   deepseek-v2-lite-16b (paged MLA, MoE) and ``reduced(olmo-1b)`` (paged
   GQA): two runs equal to each other and to the port's
   ``reference_generate`` on the card, the pool conserved, tokens a
   second, a timed decode step and row 1's card ms and bound, and the
   plain version timed at the largest decode shape (the head); then
   ``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
   --numerics lns16-train-pallas``;
11. the ssm, hybrid and enc-dec families: (a) every distinct shape of
   rows 5, 2 and 6 in (c)'s steps and of row 5 at (d)'s full-width decode
   shapes, held as 10a holds; (b) ``reduced()`` mamba2-370m, zamba2-7b
   and seamless-m4t-medium card vs CPU as 9b; (c) at full width under
   ``lns16-train-pallas``, 3 AdamW steps each: mamba2-370m (2 layers,
   batch 1 × seq 512, two SSD chunks of 256), zamba2-7b (7 layers: a
   group of 6 and the shared block, then a tail layer; 1 × 512),
   seamless-m4t-medium (1 encoder and 1 decoder layer, 2 × 128 tokens
   over 128 frames): losses, ms per step, a profiled step, peak memory,
   each row's card ms against its bound, the launches against the count
   of ``lm_linears`` (each linear by its own rows and repeats); (d)
   ``reference_generate`` on the card, greedy, 16 new tokens, twice, for
   the reduced configs and full-width mamba2-370m: the runs equal, row 5
   once per serving linear and head a step, tokens a second, a timed
   decode step beside row 5's card ms; (e) ``python -m
   repro_torch.launch.train --arch zamba2-7b`` with checkpoints,
   relaunched to resume at step 4.
12. the plan search and the block autotuner: (a) the tiled ⊞-MAC at 1, 2
   and 8 rows a block (phases 3 and 9-11 hold 4) bit for bit against the
   plain version, with and without the forward epilogue, for the lut,
   bitshift and exact Δ kinds in lns16 and lns12, at CT ∈ {13, 45, 784},
   R ∈ {1, 4, 5, 16, 37}, C ∈ {1, 33, 100}, and at a 9c forward shape and
   the 10d decode head over 40 steps; (b) the tuner, its cache in a
   temporary directory: each rows per block of the MLP's products, the
   predict forward, the 10d decode head and a 9c forward timed by CUDA
   events beside its bound, the choice persisted and served again from
   the cache, a corrupt cache quarantined, short-form and ⊞-reduce
   lookups writing nothing; (c) the fused MLP's 20 steps under
   ``blocks=auto`` and ``blocks=1x32x32`` and a reduced olmo-1b step
   under ``blocks=auto`` giving the default's codes and launches; (d)
   ``python -m repro_torch.launch.search --smoke --selfcheck-resume``'s
   ``main`` on the card, its JSON equal to the same search on the CPU
   lane in a worker process, then ``--measure --max-evals 3``.
13. sharded execution, in a one-rank process group over the card (NCCL)
   and the CPU (gloo), each lane through a (data=1, model=1) mesh: (a) the
   reduced olmo-1b, deepseek-moe-16b, deepseek-v2-lite-16b and zamba2-7b
   through ``make_train_step(rt=Runtime(mesh=...))``, card vs CPU lane
   as 9b (``FAMILY_HOLDS`` for zamba2-7b); (b) 9c's olmo-1b through the
   mesh and without it in the same call: losses and every parameter equal
   bit for bit, ms per step, device ms, launches and peak memory of each;
   (c) 10c's deepseek-v2-lite-16b likewise: the assignments ``moe_ep``
   drops at tp 1 and the loss gap to the dropless steps, a finding; (d)
   ``decode_step_paged`` of reduced deepseek-v2-lite-16b under the mesh
   (``moe_ep`` at tp 1 with its capacity drops, row 1), teacher-forced,
   card vs CPU lane; ``moe_ep_replicated`` needs tp > 1 and runs only in
   the 2- and 4-rank gloo tests.
14. the dry run and the example twins: (a) ``python -m
   repro_torch.launch.dryrun`` in child processes (a fake world needs a
   process with no group) for olmo-1b's three cells and
   deepseek-v2-lite-16b's ``decode_32k`` (paged, MoE, MLA) on the fake
   (16, 16) world: every cell ok, each rank's argument and temporary GiB
   and GB on the wire per collective kind; (b) the dry run against the
   card: 9c's shapes in the config's own bf16 numerics, dry-run on a fake
   (1, 1) world in a child process and run on the card through a
   one-rank mesh (as phase 13's) between ``reset_peak_memory_stats`` and
   ``max_memory_allocated``: the arguments' bytes within 1% of what the
   card allocates for them and the predicted peak within 10% of the
   measured one, the tracker's split at the peak printed; (c) the
   ``quickstart`` and ``serve_batched`` twins of ``examples/`` on the
   card in child processes, each exiting 0; (d) row 1 at 13d's shapes
   (one paged decode step of reduced deepseek-v2-lite-16b, 4 slots): each
   product's card ms by CUDA events and its bound, their launches equal
   to 13d's a step.

Phase 3 also holds the tiled ⊞-MAC past 65535 row tiles (262 149 rows).

The line before the last is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``.  Runs in well under the 1200 s limit
on one card; needs no network.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks: 3.35 TB/s of HBM (NVIDIA data sheet).  int32 ops: an
# SM issues at most one warp instruction a clock in each of its 4
# sub-partitions, 128 lanes a clock, at the 1.98 GHz boost clock behind
# the data sheet's 67 TFLOP/s float32, on 132 SMs.  The INT32 pipe's 64
# lanes a clock are no ceiling: IMAD issues on the FMA pipe beside it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# int32 operations per ⊞-MAC step, counted from csrc/lns_mac.cu: the
# product (stage_product, 5) and mac_step with a LUT Δ (18, its table load
# included).  The ⊞ of the epilogues (boxplus with a LUT Δ) is 30.  Per
# output at flush: the forward epilogue (bias ⊞ 30, llReLU 5, requantize
# 8) and the ⊞-SGD (scalar ⊡ 6 + ⊞ 30, once for lr, again for momentum
# and weight decay).  The ⊞-reduce (boxsum_kernel) folds a row's steps
# after the first with mac_step (18, plus the zero code's compare and
# select and the sign's shift: 21); the first step and the result's sign
# take a compare, a select and a shift each (6 a row).  Phase 9c counts
# the tiled chain's steps from its SASS instead (mac_step_instructions).
OPS_PER_MAC = 23
OPS_BOXPLUS = 30
OPS_BOXSUM_STEP = 18 + 3
OPS_BOXSUM_ROW = 6
OPS_FWD_EPILOGUE = OPS_BOXPLUS + 13
OPS_SGD_TERM = 6 + OPS_BOXPLUS


def boxsum_ops(rows: int, steps: int) -> int:
    """int32 operations of a ⊞-reduce of ``rows`` rows of ``steps``."""
    return rows * (OPS_BOXSUM_STEP * max(steps - 1, 0) + OPS_BOXSUM_ROW)


SEED = 0
BATCH = 5
STEPS = 20
PREDICT_BATCH = 500


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ data --

def operands(torch, rk, shape, *, scale, zero_frac, fmt, device):
    """LNS operand of ``shape`` from a seeded normal, a share of it exact
    zeros (the ⊞ identity paths)."""
    from repro_torch.core import encode
    v = torch.randn(shape, generator=rk) * scale
    v[torch.rand(shape, generator=rk) < zero_frac] = 0.0
    return encode(v, fmt).to(device)


def fwd_case(torch, rk, m, k, n, fmt, device):
    x = operands(torch, rk, (m, k), scale=1.0, zero_frac=0.5, fmt=fmt,
                 device=device)
    w = operands(torch, rk, (k, n), scale=0.05, zero_frac=0.02, fmt=fmt,
                 device=device)
    b = operands(torch, rk, (n,), scale=0.1, zero_frac=0.2, fmt=fmt,
                 device=device)
    return x, w, b


# ------------------------------------------------------------- phase 3 --

def compare_kernels(torch, device):
    """Every kernel against its plain version on the card; returns
    {kernel: max |code difference|} and the number of cases."""
    from repro_torch.core import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_EXACT,
                                  LNS12, LNS16, LogSGDConfig, UpdateEpilogue,
                                  beta_code)
    from repro_torch.kernels import KERNEL_WRAPPERS
    from repro_torch.kernels import lns_matmul as K

    worst = {name: 0 for name in KERNEL_WRAPPERS}
    cases = 0

    def check(name, got, want, label):
        nonlocal cases
        cases += 1
        if len(got) != len(want):
            raise AssertionError(f"{name} {label}: {len(got)} planes vs "
                                 f"{len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{name} {label} plane {i}: "
                                     f"{g.dtype}{tuple(g.shape)} vs "
                                     f"{w.dtype}{tuple(w.shape)}")
            err = int((g.long() - w.long()).abs().max())
            worst[name] = max(worst[name], err)
            if err:
                raise AssertionError(f"{name} {label} plane {i}: max |diff| "
                                     f"{err}")

    rk = torch.Generator().manual_seed(SEED)
    sgd_cases = {
        "plain": LogSGDConfig(lr=0.01),
        "mom+wd": LogSGDConfig(lr=0.01, weight_decay=0.01, momentum=0.9),
    }
    shapes = {"step": (BATCH, 784, 100), "step-out": (BATCH, 100, 10),
              "ragged": (37, 53, 45)}
    for spec in (DELTA_DEFAULT, DELTA_BITSHIFT, DELTA_EXACT):
        for fmt, other in ((LNS16, LNS12), (LNS12, LNS16)):
            beta = beta_code(0.01, fmt)
            fwd_eps = {
                "none": K.FwdEpilogue(),
                "bias": K.FwdEpilogue(bias=True),
                "hidden": K.FwdEpilogue(bias=True, llrelu_beta=beta,
                                        emit_z_sign=True),
                "hidden+dst": K.FwdEpilogue(bias=True, llrelu_beta=beta,
                                            dst_fmt=other, emit_z_sign=True),
            }
            for sname, (m, k, n) in shapes.items():
                x, w, b = fwd_case(torch, rk, m, k, n, fmt, device)
                for ename, ep in fwd_eps.items():
                    label = f"{spec.kind}/{fmt.name}/{sname}/{ename}"
                    bc = b.code if ep.bias else None
                    bs = b.sign if ep.bias else None
                    got = K.lns_matmul_fused(x.code, x.sign, w.code, w.sign,
                                             fmt=fmt, spec=spec, epilogue=ep,
                                             bias_code=bc, bias_sign=bs)
                    want = K.mac_plain(x.code, x.sign, w.code, w.sign,
                                       a_contract_axis=1, b_contract_axis=0,
                                       fmt=fmt, spec=spec, fwd_epilogue=ep,
                                       bias_code=bc, bias_sign=bs)
                    check("lns_matmul_fused", got, want, label)
                # dX: dY (m, n) against W (k, n).
                dy = operands(torch, rk, (m, n), scale=0.1, zero_frac=0.1,
                              fmt=fmt, device=device)
                wk = operands(torch, rk, (k, n), scale=0.05, zero_frac=0.02,
                              fmt=fmt, device=device)
                got = K.lns_matmul_dx(dy.code, dy.sign, wk.code, wk.sign,
                                      fmt=fmt, spec=spec)
                want = K.mac_plain(dy.code, dy.sign, wk.code, wk.sign,
                                   a_contract_axis=1, b_contract_axis=1,
                                   fmt=fmt, spec=spec)
                check("lns_matmul_dx", got, want,
                      f"{spec.kind}/{fmt.name}/{sname}")
                for gname, cfg in sgd_cases.items():
                    ep = UpdateEpilogue.from_sgd(cfg, fmt)
                    mom = (operands(torch, rk, (k, n), scale=0.01,
                                    zero_frac=0.3, fmt=fmt, device=device)
                           if ep.has_momentum else None)
                    mkw = dict(m_code=None if mom is None else mom.code,
                               m_sign=None if mom is None else mom.sign)
                    got = K.lns_matmul_dw_update(
                        x.code, x.sign, dy.code, dy.sign, w_code=wk.code,
                        w_sign=wk.sign, epilogue=ep, fmt=fmt, spec=spec,
                        **mkw)
                    want = K.mac_plain(
                        x.code, x.sign, dy.code, dy.sign, a_contract_axis=0,
                        b_contract_axis=0, fmt=fmt, spec=spec,
                        update_epilogue=ep, w_code=wk.code, w_sign=wk.sign,
                        **mkw)
                    label = f"{spec.kind}/{fmt.name}/{sname}/{gname}"
                    check("lns_matmul_dw_update", got, want, label)
                    g = operands(torch, rk, (n,), scale=0.1, zero_frac=0.1,
                                 fmt=fmt, device=device)
                    wb = b
                    mb = (operands(torch, rk, (n,), scale=0.01,
                                   zero_frac=0.3, fmt=fmt, device=device)
                          if ep.has_momentum else None)
                    ukw = dict(epilogue=ep, fmt=fmt, spec=spec,
                               m_code=None if mb is None else mb.code,
                               m_sign=None if mb is None else mb.sign)
                    got = K.lns_fused_update(wb.code, wb.sign, g.code,
                                             g.sign, **ukw)
                    want = K.update_plain(wb.code, wb.sign, g.code, g.sign,
                                          **ukw)
                    check("lns_fused_update", got, want, label)
    # The predict shape and the step's dW shapes at batch 500, lut.
    for fmt in (LNS16, LNS12):
        beta = beta_code(0.01, fmt)
        ep = K.FwdEpilogue(bias=True, llrelu_beta=beta, emit_z_sign=True)
        x, w, b = fwd_case(torch, rk, PREDICT_BATCH, 784, 100, fmt, device)
        kw = dict(fmt=fmt, spec=DELTA_DEFAULT, bias_code=b.code,
                  bias_sign=b.sign)
        got = K.lns_matmul_fused(x.code, x.sign, w.code, w.sign, epilogue=ep,
                                 **kw)
        want = K.mac_plain(x.code, x.sign, w.code, w.sign, a_contract_axis=1,
                           b_contract_axis=0, fwd_epilogue=ep, **kw)
        check("lns_matmul_fused", got, want, f"lut/{fmt.name}/predict")
        dy = operands(torch, rk, (PREDICT_BATCH, 100), scale=0.1,
                      zero_frac=0.1, fmt=fmt, device=device)
        up = UpdateEpilogue.from_sgd(sgd_cases["mom+wd"], fmt)
        mom = operands(torch, rk, (784, 100), scale=0.01, zero_frac=0.3,
                       fmt=fmt, device=device)
        args = dict(fmt=fmt, spec=DELTA_DEFAULT, update_epilogue=up,
                    w_code=w.code, w_sign=w.sign, m_code=mom.code,
                    m_sign=mom.sign)
        got = K.mac_cuda(x.code, x.sign, dy.code, dy.sign, a_contract_axis=0,
                         b_contract_axis=0, **args)
        want = K.mac_plain(x.code, x.sign, dy.code, dy.sign,
                           a_contract_axis=0, b_contract_axis=0, **args)
        check("lns_matmul_dw_update", got, want, f"lut/{fmt.name}/batch500")
        got = K.lns_matmul_dx(dy.code, dy.sign, w.code, w.sign, fmt=fmt,
                              spec=DELTA_DEFAULT)
        want = K.mac_plain(dy.code, dy.sign, w.code, w.sign,
                           a_contract_axis=1, b_contract_axis=1, fmt=fmt,
                           spec=DELTA_DEFAULT)
        check("lns_matmul_dx", got, want, f"lut/{fmt.name}/batch500")
    compare_unfused_and_segmented(torch, device, rk, check)
    compare_forms(torch, device, rk, check)
    compare_index_sweep(torch, device, rk, check)
    torch.cuda.synchronize()
    return worst, cases


def compare_unfused_and_segmented(torch, device, rk, check):
    """The plain forward, plain dW, segment-partial dW and ⊞-reduce
    kernels against their plain versions on the card."""
    from repro_torch.core import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_EXACT,
                                  LNS12, LNS16)
    from repro_torch.kernels import lns_matmul as K
    from repro_torch.kernels.lns_boxsum import boxsum_plain, lns_boxsum
    shapes = {"step": (BATCH, 784, 100), "step-out": (BATCH, 100, 10),
              "ragged": (40, 53, 45), "batch500": (PREDICT_BATCH, 784, 100)}
    for spec in (DELTA_DEFAULT, DELTA_BITSHIFT, DELTA_EXACT):
        for fmt in (LNS16, LNS12):
            kw = dict(fmt=fmt, spec=spec)
            for sname, (m, k, n) in shapes.items():
                label = f"{spec.kind}/{fmt.name}/{sname}"
                x, w, _ = fwd_case(torch, rk, m, k, n, fmt, device)
                check("lns_matmul",
                      K.lns_matmul(x.code, x.sign, w.code, w.sign, **kw),
                      K.mac_plain(x.code, x.sign, w.code, w.sign,
                                  a_contract_axis=1, b_contract_axis=0, **kw),
                      label)
                dy = operands(torch, rk, (m, n), scale=0.1, zero_frac=0.1,
                              fmt=fmt, device=device)
                planes = (x.code, x.sign, dy.code, dy.sign)
                dw = dict(a_contract_axis=0, b_contract_axis=0, **kw)
                check("lns_matmul_dw", K.lns_matmul_dw(*planes, **kw),
                      K.mac_plain(*planes, **dw), label)
                for seg in (1, 2, 4, 5, 8):
                    if m % seg == 0:
                        check("lns_matmul_dw_partials",
                              K.lns_matmul_dw_partials(
                                  *planes, num_segments=seg, **kw),
                              K.mac_plain(*planes, segments=seg, **dw),
                              f"{label}/S{seg}")
            # The ⊞-reduce over K steps of ragged rows, read in place as the
            # combine reads (S, E) partials and dense; step 1 cancels step 0
            # exactly on every other row.
            for k in (1, 5, 37, 128):
                a = operands(torch, rk, (k, 7845), scale=1.0, zero_frac=0.2,
                             fmt=fmt, device=device)
                if k > 1:
                    a.code[1, ::2] = a.code[0, ::2]
                    a.sign[1, ::2] = a.sign[0, ::2] ^ 1
                for lay, (c, sg) in (
                        ("view", (a.code.T, a.sign.T)),
                        ("dense", (a.code.T.contiguous(),
                                   a.sign.T.contiguous()))):
                    check("lns_boxsum", lns_boxsum(c, sg, **kw),
                          boxsum_plain(c, sg, **kw),
                          f"{spec.kind}/{fmt.name}/K{k}/{lay}")
            # The combine's shapes: S = 5 slots of w1, b1, w2, b2, one
            # launch each and all four in one grouped launch.
            combine = []
            for e in (78400, 100, 1000, 10):
                a = operands(torch, rk, (BATCH, e), scale=0.1, zero_frac=0.1,
                             fmt=fmt, device=device)
                check("lns_boxsum", lns_boxsum(a.code.T, a.sign.T, **kw),
                      boxsum_plain(a.code.T, a.sign.T, **kw),
                      f"{spec.kind}/{fmt.name}/combine{e}")
                combine.append((a.code.T, a.sign.T))
            check_many(check, combine, kw, f"{spec.kind}/{fmt.name}/combine")
            # 1, 2, 4 and 8 row sets of one launch, their bounds inside a
            # block: each with an all-zero row, and step 1 cancelling step 0
            # exactly on every other row.
            parts = []
            for k, e in GROUPED_SETS:
                a = operands(torch, rk, (k, e), scale=1.0, zero_frac=0.2,
                             fmt=fmt, device=device)
                a.code[:, 1] = fmt.zero_code
                a.sign[:, 1] = 0
                if k > 1:
                    a.code[1, 2::2] = a.code[0, 2::2]
                    a.sign[1, 2::2] = a.sign[0, 2::2] ^ 1
                parts.append(a)
            for n in (1, 2, 4, 8):
                sets = [(a.code.T, a.sign.T) for a in parts[:n]]
                check_many(check, sets, kw,
                           f"{spec.kind}/{fmt.name}/sets{n}/view")
                check_many(check, [(c.contiguous(), sg.contiguous())
                                   for c, sg in sets], kw,
                           f"{spec.kind}/{fmt.name}/sets{n}/dense")


#: (steps, rows) of the row sets of phase 3's grouped ⊞-reduce launches.
GROUPED_SETS = ((5, 301), (1, 37), (13, 100), (128, 9), (2, 1000), (12, 3),
                (37, 64), (5, 10))


def check_many(check, sets, kw, label):
    """One grouped ⊞-reduce launch over ``sets`` against the plain version
    of each set."""
    from repro_torch.kernels.lns_boxsum import boxsum_plain, lns_boxsum_many
    got = lns_boxsum_many(sets, **kw)
    want = [boxsum_plain(c, sg, **kw) for c, sg in sets]
    check("lns_boxsum", [t for pair in got for t in pair],
          [t for pair in want for t in pair], label)


def compare_forms(torch, device, rk, check):
    """Both forms of the ⊞-MAC on each side of the library's threshold T
    (CT ∈ {1, T, T + 1}) for C ∈ {1, 10, 33, 100} at a ragged R = 13: the
    forward with no epilogue and with each forward epilogue, the dX, and
    the dW-update with and without momentum; the segment partials at
    S ∈ {1, 5} for batches 5 and 40; the ⊞-SGD at n ∈ {1, 10, 100, 257,
    1000, 78400}, with and without momentum."""
    from repro_torch.core import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_EXACT,
                                  LNS12, LNS16, LogSGDConfig, UpdateEpilogue,
                                  beta_code)
    from repro_torch.kernels import build
    from repro_torch.kernels import lns_matmul as K
    t_short = build.load_library().lns_short_steps()
    r = 13
    for spec in (DELTA_DEFAULT, DELTA_BITSHIFT, DELTA_EXACT):
        for fmt, other in ((LNS16, LNS12), (LNS12, LNS16)):
            kw = dict(fmt=fmt, spec=spec)
            beta = beta_code(0.01, fmt)
            fwd_eps = {
                "bias": K.FwdEpilogue(bias=True),
                "hidden": K.FwdEpilogue(bias=True, llrelu_beta=beta,
                                        emit_z_sign=True),
                "hidden+dst": K.FwdEpilogue(bias=True, llrelu_beta=beta,
                                            dst_fmt=other, emit_z_sign=True),
            }
            ups = {g: UpdateEpilogue.from_sgd(cfg, fmt) for g, cfg in (
                ("decay", LogSGDConfig(lr=0.01, weight_decay=0.01)),
                ("mom+decay", LogSGDConfig(lr=0.01, weight_decay=0.01,
                                           momentum=0.9)))}
            for ct in (1, t_short, t_short + 1):
                for c in (1, 10, 33, 100):
                    label = f"{spec.kind}/{fmt.name}/CT{ct}/C{c}"
                    x, w, b = fwd_case(torch, rk, r, ct, c, fmt, device)
                    fwd = dict(a_contract_axis=1, b_contract_axis=0, **kw)
                    check("lns_matmul",
                          K.lns_matmul(x.code, x.sign, w.code, w.sign, **kw),
                          K.mac_plain(x.code, x.sign, w.code, w.sign, **fwd),
                          f"{label}/none")
                    for ename, ep in fwd_eps.items():
                        bk = dict(bias_code=b.code, bias_sign=b.sign)
                        check("lns_matmul_fused",
                              K.lns_matmul_fused(x.code, x.sign, w.code,
                                                 w.sign, epilogue=ep, **bk,
                                                 **kw),
                              K.mac_plain(x.code, x.sign, w.code, w.sign,
                                          fwd_epilogue=ep, **bk, **fwd),
                              f"{label}/{ename}")
                    dy = operands(torch, rk, (r, ct), scale=0.1,
                                  zero_frac=0.1, fmt=fmt, device=device)
                    wt = operands(torch, rk, (c, ct), scale=0.05,
                                  zero_frac=0.02, fmt=fmt, device=device)
                    check("lns_matmul_dx",
                          K.lns_matmul_dx(dy.code, dy.sign, wt.code, wt.sign,
                                          **kw),
                          K.mac_plain(dy.code, dy.sign, wt.code, wt.sign,
                                      a_contract_axis=1, b_contract_axis=1,
                                      **kw), label)
                    xb = operands(torch, rk, (ct, r), scale=1.0,
                                  zero_frac=0.5, fmt=fmt, device=device)
                    db = operands(torch, rk, (ct, c), scale=0.1,
                                  zero_frac=0.1, fmt=fmt, device=device)
                    wr = operands(torch, rk, (r, c), scale=0.05,
                                  zero_frac=0.02, fmt=fmt, device=device)
                    mr = operands(torch, rk, (r, c), scale=0.01,
                                  zero_frac=0.3, fmt=fmt, device=device)
                    for gname, up in ups.items():
                        mk = (dict(m_code=mr.code, m_sign=mr.sign)
                              if up.has_momentum else {})
                        wk = dict(w_code=wr.code, w_sign=wr.sign, **mk, **kw)
                        check("lns_matmul_dw_update",
                              K.lns_matmul_dw_update(
                                  xb.code, xb.sign, db.code, db.sign,
                                  epilogue=up, **wk),
                              K.mac_plain(xb.code, xb.sign, db.code, db.sign,
                                          a_contract_axis=0,
                                          b_contract_axis=0,
                                          update_epilogue=up, **wk),
                              f"{label}/{gname}")
            for batch in (5, 40):
                for c in (1, 33, 100):
                    x = operands(torch, rk, (batch, r), scale=1.0,
                                 zero_frac=0.5, fmt=fmt, device=device)
                    dy = operands(torch, rk, (batch, c), scale=0.1,
                                  zero_frac=0.1, fmt=fmt, device=device)
                    planes = (x.code, x.sign, dy.code, dy.sign)
                    for seg in (1, 5):
                        check("lns_matmul_dw_partials",
                              K.lns_matmul_dw_partials(
                                  *planes, num_segments=seg, **kw),
                              K.mac_plain(*planes, a_contract_axis=0,
                                          b_contract_axis=0, segments=seg,
                                          **kw),
                              f"{spec.kind}/{fmt.name}/B{batch}/C{c}/S{seg}")
            for gname, up in ups.items():
                for n in (1, 10, 100, 257, 1000, 78400):
                    w, g, m = (operands(torch, rk, (n,), scale=s,
                                        zero_frac=z, fmt=fmt, device=device)
                               for s, z in ((0.1, 0.2), (0.1, 0.1),
                                            (0.01, 0.3)))
                    uk = dict(epilogue=up, **kw, **(
                        dict(m_code=m.code, m_sign=m.sign)
                        if up.has_momentum else {}))
                    check("lns_fused_update",
                          K.lns_fused_update(w.code, w.sign, g.code, g.sign,
                                             **uk),
                          K.update_plain(w.code, w.sign, g.code, g.sign,
                                         **uk),
                          f"{spec.kind}/{fmt.name}/n{n}/{gname}")
    # The tiled form past the 65535 row tiles of 4 that grid y once held
    # (ROADMAP queue 3 item 10): R = 262 149 rows, the forward and the dX
    # (W through strides), one launch each, over one column tile (C = 8)
    # and over two (C = 40: grid x's row tile and column tile are the
    # block index's quotient and remainder).
    r, ct = 262149, 40
    kw = dict(fmt=LNS16, spec=DELTA_DEFAULT)
    x = operands(torch, rk, (r, ct), scale=1.0, zero_frac=0.2, fmt=LNS16,
                 device=device)
    for c in (8, 40):
        for row, bshape, ba in (("lns_matmul", (ct, c), 0),
                                ("lns_matmul_dx", (c, ct), 1)):
            w = operands(torch, rk, bshape, scale=0.05, zero_frac=0.05,
                         fmt=LNS16, device=device)
            check(row, getattr(K, row)(x.code, x.sign, w.code, w.sign,
                                       **kw),
                  K.mac_plain(x.code, x.sign, w.code, w.sign,
                              a_contract_axis=1, b_contract_axis=ba, **kw),
                  f"R{r}/C{c}/CT{ct} past 65535 row tiles")


def sweep_operands(torch, fmt, swap, device):
    """A (R, 2) and B (2, C) whose second ⊞ step meets every difference d
    from 0 to code_max − min_nz, with equal and with opposite signs.
    Output (r, c) folds the products min_nz + min(r·W + c mod W, D) and
    min_nz, the first of sign 1 in the columns c ≥ W; ``swap`` folds them
    in the other order."""
    from repro_torch.core import LNSArray
    lo, hi, w = fmt.min_nonzero_code, fmt.code_max, 256
    rows = (hi - lo) // w + 1
    a_c = torch.full((rows, 2), lo, dtype=torch.int32)
    a_c[:, 0] = torch.clamp(lo + torch.arange(rows) * w, max=hi)
    b_c = torch.zeros((2, 2 * w), dtype=torch.int32)
    b_c[0] = torch.arange(2 * w) % w
    a_s = torch.zeros((rows, 2), dtype=torch.int8)
    b_s = torch.zeros((2, 2 * w), dtype=torch.int8)
    b_s[0, w:] = 1
    if swap:
        a_c, a_s, b_c, b_s = a_c.flip(1), a_s.flip(1), b_c.flip(0), b_s.flip(0)
    return (LNSArray(a_c.contiguous().to(device), a_s.contiguous().to(device)),
            LNSArray(b_c.contiguous().to(device), b_s.contiguous().to(device)))


def compare_index_sweep(torch, device, rk, check):
    """The Δ index on the card: the two-step sweep of every difference
    through the plain forward, for tables whose step is a power of two
    (the shift) and one whose step is not (the multiply-high), and a table
    of the kernels' largest size; the ⊞-SGD and ⊞-reduce kernels once at
    each table.  The two-step sweep takes the short form; the same sweep
    after T + 1 zero-code steps takes the tiled form (a zero accumulator
    takes the first product, so the codes are the same).  Then the
    ⊞-reduce over every difference, at each table and the bit-shift and
    exact Δ."""
    from repro_torch.core import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_EXACT,
                                  DELTA_SOFTMAX, LNS12, LNS16, DeltaSpec,
                                  LogSGDConfig, UpdateEpilogue)
    from repro_torch.kernels import build
    from repro_torch.kernels import lns_matmul as K
    from repro_torch.kernels.lns_boxsum import boxsum_plain, lns_boxsum
    pad = build.load_library().lns_short_steps() + 1
    specs = (DELTA_DEFAULT, DELTA_SOFTMAX, DeltaSpec("lut", 9.0, 0.375),
             DeltaSpec("lut", 16.0, 1.0 / 64.0))
    for spec in specs:
        for fmt in (LNS16, LNS12):
            kw = dict(fmt=fmt, spec=spec)
            name = f"lut{spec.table_size}/r{spec.r}/{fmt.name}"
            for swap in (False, True):
                a, b = sweep_operands(torch, fmt, swap, device)
                label = f"{name}/sweep{'-swapped' if swap else ''}"
                short = K.lns_matmul(a.code, a.sign, b.code, b.sign, **kw)
                check("lns_matmul", short,
                      K.mac_plain(a.code, a.sign, b.code, b.sign,
                                  a_contract_axis=1, b_contract_axis=0, **kw),
                      label)
                a_c = torch.cat([torch.full((a.code.shape[0], pad),
                                            fmt.zero_code, dtype=torch.int32,
                                            device=device), a.code], 1)
                a_s = torch.cat([a.sign.new_zeros((a.sign.shape[0], pad)),
                                 a.sign], 1)
                b_c = torch.cat([b.code.new_zeros((pad, b.code.shape[1])),
                                 b.code])
                b_s = torch.cat([b.sign.new_zeros((pad, b.sign.shape[1])),
                                 b.sign])
                tiled = K.lns_matmul(a_c, a_s, b_c, b_s, **kw)
                check("lns_matmul", tiled,
                      K.mac_plain(a_c, a_s, b_c, b_s, a_contract_axis=1,
                                  b_contract_axis=0, **kw),
                      f"{label}/tiled")
                check("lns_matmul", tiled, short, f"{label}/tiled=short")
            ep = UpdateEpilogue.from_sgd(
                LogSGDConfig(lr=0.01, weight_decay=0.01, momentum=0.9), fmt)
            w, g, m = (operands(torch, rk, (100,), scale=s, zero_frac=0.1,
                                fmt=fmt, device=device)
                       for s in (0.1, 0.1, 0.01))
            uk = dict(epilogue=ep, m_code=m.code, m_sign=m.sign, **kw)
            check("lns_fused_update",
                  K.lns_fused_update(w.code, w.sign, g.code, g.sign, **uk),
                  K.update_plain(w.code, w.sign, g.code, g.sign, **uk), name)
            p = operands(torch, rk, (5, 1000), scale=0.1, zero_frac=0.1,
                         fmt=fmt, device=device)
            check("lns_boxsum", lns_boxsum(p.code.T, p.sign.T, **kw),
                  boxsum_plain(p.code.T, p.sign.T, **kw), name)
    for spec in specs + (DELTA_BITSHIFT, DELTA_EXACT):
        for fmt in (LNS16, LNS12):
            kw = dict(fmt=fmt, spec=spec)
            name = (f"lut{spec.table_size}/r{spec.r}/{fmt.name}"
                    if spec.kind == "lut" else f"{spec.kind}/{fmt.name}")
            # Rows (min_nz + d, min_nz) for every d, with equal and opposite
            # signs, in both orders; again after 13 zero-code steps.
            lo, hi = fmt.min_nonzero_code, fmt.code_max
            d = torch.arange(0, hi - lo + 1, dtype=torch.int32)
            code = torch.stack([lo + d, torch.full_like(d, lo)], 1).repeat(2, 1)
            sign = torch.zeros_like(code, dtype=torch.int8)
            sign[len(d):, 1] = 1
            for swap in (False, True):
                c, sg = (code.flip(1), sign.flip(1)) if swap else (code, sign)
                c, sg = c.contiguous().to(device), sg.contiguous().to(device)
                label = f"{name}/boxsum-sweep{'-swapped' if swap else ''}"
                check("lns_boxsum", lns_boxsum(c, sg, **kw),
                      boxsum_plain(c, sg, **kw), label)
                c = torch.cat([torch.full((c.shape[0], 13), fmt.zero_code,
                                          dtype=torch.int32, device=device),
                               c], 1)
                sg = torch.cat([sg.new_zeros((sg.shape[0], 13)), sg], 1)
                check("lns_boxsum", lns_boxsum(c, sg, **kw),
                      boxsum_plain(c, sg, **kw), f"{label}/after13")


# ------------------------------------------------------------- phase 4 --

def compare_float_ops(torch, device):
    """Card vs CPU for the float32 ops; returns mismatch counts."""
    from repro_torch.core import (DELTA_EXACT, LNS12, LNS16, DeltaEngine,
                                  LNSArray, encode, lns_value_to_code)
    out = {}
    pix = torch.arange(256, dtype=torch.float32) / 255.0
    for fmt in (LNS16, LNS12):
        a, b = encode(pix, fmt), encode(pix.to(device), fmt)
        out[f"encode/{fmt.name}"] = int(
            ((a.code != b.code.cpu()) | (a.sign != b.sign.cpu())).sum())
        codes = torch.arange(fmt.zero_code, fmt.code_max + 1,
                             dtype=torch.int32)
        for s in (0, 1):
            x = LNSArray(codes, torch.full_like(codes, s, dtype=torch.int8))
            got = lns_value_to_code(x.to(device), fmt).cpu()
            out[f"lns_value_to_code/{fmt.name}/sign{s}"] = int(
                (got != lns_value_to_code(x, fmt)).sum())
        eng = DeltaEngine(DELTA_EXACT, fmt)
        d = torch.arange(0, 2 * fmt.code_max + 2, dtype=torch.int32)
        for op in ("plus", "minus"):
            cpu = getattr(eng, op)(d)
            card = getattr(eng, op)(d.to(device)).cpu()
            out[f"exact_delta_{op}/{fmt.name}"] = int((cpu != card).sum())
    return out


# ------------------------------------------------------------- phase 5 --

SEGMENTED = "lns16-train-pallas,reduce.grad_segments=5"


def path_launches(pbatches):
    """path → (run_experiment keywords, kernel launches of one run): 20
    steps, then ``pbatches`` predict batches of 2 forward launches."""
    fwd = 2 * STEPS + 2 * pbatches
    return {
        "fused": (dict(numerics="lns16-train-pallas"),
                  dict(lns_matmul_fused=fwd, lns_matmul_dx=STEPS,
                       lns_matmul_dw_update=2 * STEPS,
                       lns_fused_update=2 * STEPS)),
        "unfused": (dict(numerics="lns16-train-pallas", fused=False),
                    dict(lns_matmul=fwd, lns_matmul_dx=STEPS,
                         lns_matmul_dw=2 * STEPS)),
        "segmented": (dict(numerics=SEGMENTED),
                      dict(lns_matmul_fused=fwd, lns_matmul_dx=STEPS,
                           lns_matmul_dw_partials=2 * STEPS,
                           lns_boxsum=STEPS,
                           lns_fused_update=4 * STEPS)),
    }


def nccl_group():
    """A one-rank NCCL process group on card 0 (file store in a temporary
    directory); returns a function that ends it."""
    import torch
    import torch.distributed as dist
    tmp = tempfile.TemporaryDirectory()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp.name}/store",
                            world_size=1, rank=0)

    def end():
        dist.destroy_process_group()
        tmp.cleanup()
    return end


def main_path(torch):
    """Each path on the card and on the CPU lane; returns {run: (card
    result, card s, launch counts)} and the predict batches per run."""
    import torch.distributed as dist
    from repro_torch.kernels import (KERNEL_WRAPPERS, launch_counts,
                                     reset_launch_counts)
    from repro_torch.paper import datasets, run_experiment
    common = dict(epochs=1, max_steps_per_epoch=STEPS, batch_size=BATCH,
                  seed=SEED)
    x, y, xt, _, _ = datasets.load("mnist", "data", SEED)
    n_val = len(x) // 6
    pbatches = math.ceil(n_val / PREDICT_BATCH) + math.ceil(
        len(xt) / PREDICT_BATCH)
    paths = path_launches(pbatches)
    runs = [("fused", "fused", False), ("unfused", "unfused", False),
            ("segmented", "segmented", False),
            ("segmented-nccl", "segmented", True)]
    cpu, out = {}, {}
    for run, path, in_group in runs:
        kw, want = paths[path]
        want = dict(dict.fromkeys(KERNEL_WRAPPERS, 0), **want)
        end = nccl_group() if in_group else None
        try:
            if in_group and not (dist.is_initialized()
                                 and dist.get_backend() == "nccl"):
                raise AssertionError("no NCCL group around the run")
            reset_launch_counts()
            t0 = time.time()
            card = run_experiment("lns", "mnist", device="cuda", **common,
                                  **kw)
            torch.cuda.synchronize()
            card_s = time.time() - t0
            counts = launch_counts()
        finally:
            if end is not None:
                end()
        if counts != want:
            raise AssertionError(f"{run}: launch counts {counts}, expected "
                                 f"{want}")
        if path not in cpu:
            cpu[path] = run_experiment("lns", "mnist", device="cpu",
                                       **common, **kw)
        ref = cpu[path]
        for k, (c, s) in card.params.items():
            cc, cs = ref.params[k]
            if not ((c == cc).all() and (s == cs).all()):
                raise AssertionError(f"{run}: {k} on the card differs from "
                                     f"the CPU lane after {STEPS} steps")
        if card.val_curve != ref.val_curve or card.test_acc != ref.test_acc:
            raise AssertionError(f"{run}: accuracy card {card.val_curve}/"
                                 f"{card.test_acc} vs cpu {ref.val_curve}/"
                                 f"{ref.test_acc}")
        out[run] = (card, card_s, {k: v for k, v in counts.items() if v})
    return out, pbatches


# ------------------------------------------------------------- phase 6 --

def time_host(torch, fn, reps):
    """ms per call of back-to-back calls, by CUDA events: the time the
    caller waits, host work of the wrapper included."""
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
    """ms per launch on the card alone: a spin kernel holds the stream
    while the host enqueues ``reps`` launches behind it, so the events
    see the launches back to back with no host gap.  Fails if the spin
    ended before the host finished enqueueing."""
    cycles = int(3 * reps * host_ms * 1e-3 * 2.0e9)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spun = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t_spin = torch.cuda.Event(enable_timing=True)
    t_spin.record()
    torch.cuda._sleep(cycles)
    spun.record()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if t_spin.elapsed_time(spun) < enqueue_ms:
        raise AssertionError(f"spin of {t_spin.elapsed_time(spun):.2f} ms "
                             f"ended before {enqueue_ms:.2f} ms of enqueue")
    return start.elapsed_time(end) / reps


def step_launches(torch, device):
    """The kernel launches of one train step of the path that runs each
    kernel, at their real shapes, as (kernel, label, kernel call, plain
    call, bytes, int32 ops, in the step): the fused step for kernels 1-4,
    the unfused step for the plain forward and dW, the segmented step for
    the segment-partial dW and the ⊞-reduce.  The ⊞-reduce's launches one
    parameter each are timed for comparison and are not in the step."""
    from repro_torch.core import (DELTA_DEFAULT, LNS16, LogSGDConfig,
                                  UpdateEpilogue, beta_code)
    from repro_torch.kernels import lns_matmul as K
    fmt, spec = LNS16, DELTA_DEFAULT
    rk = torch.Generator().manual_seed(SEED + 1)
    up = UpdateEpilogue.from_sgd(LogSGDConfig(lr=0.01, weight_decay=0.01),
                                 fmt)
    beta = beta_code(0.01, fmt)
    out = []

    def mac(name, label, a, b, axes, extra, out_planes, epi_ops, **kw):
        r = a.shape[1 - axes[0]]
        ct = a.shape[axes[0]]
        c = b.shape[1 - axes[1]]
        slots = kw.get("segments") or 1
        args = dict(a_contract_axis=axes[0], b_contract_axis=axes[1],
                    fmt=fmt, spec=spec, **kw)
        nbytes = 5 * (a.code.numel() + b.code.numel()) + extra \
            + out_planes * r * c * slots
        ops = r * c * ct * OPS_PER_MAC + r * c * epi_ops
        out.append((name, label,
                    lambda: K.mac_cuda(a.code, a.sign, b.code, b.sign,
                                       **args),
                    lambda: K.mac_plain(a.code, a.sign, b.code, b.sign,
                                        **args), nbytes, ops, True))

    for (m, k, n), label, ep in (
            ((BATCH, 784, 100), "hidden (5,784)x(784,100)",
             K.FwdEpilogue(bias=True, llrelu_beta=beta, emit_z_sign=True)),
            ((BATCH, 100, 10), "out (5,100)x(100,10)",
             K.FwdEpilogue(bias=True))):
        x, w, b = fwd_case(torch, rk, m, k, n, fmt, device)
        mac("lns_matmul_fused", label, x, w, (1, 0), 5 * n,
            (6 if ep.emit_z_sign else 5), OPS_FWD_EPILOGUE,
            fwd_epilogue=ep, bias_code=b.code, bias_sign=b.sign)
    dy = operands(torch, rk, (BATCH, 10), scale=0.1, zero_frac=0.1, fmt=fmt,
                  device=device)
    w2 = operands(torch, rk, (100, 10), scale=0.05, zero_frac=0.02, fmt=fmt,
                  device=device)
    mac("lns_matmul_dx", "dX (5,10)x(100,10)^T", dy, w2, (1, 1), 0, 5, 0)
    for (m, k, n), label in (((BATCH, 784, 100), "w1 (784,100)"),
                             ((BATCH, 100, 10), "w2 (100,10)")):
        x = operands(torch, rk, (m, k), scale=1.0, zero_frac=0.5, fmt=fmt,
                     device=device)
        d = operands(torch, rk, (m, n), scale=0.1, zero_frac=0.1, fmt=fmt,
                     device=device)
        w = operands(torch, rk, (k, n), scale=0.05, zero_frac=0.02, fmt=fmt,
                     device=device)
        mac("lns_matmul_dw_update", label, x, d, (0, 0), 5 * k * n, 5,
            2 * OPS_SGD_TERM, update_epilogue=up, w_code=w.code,
            w_sign=w.sign)
    for n, label in ((100, "b1 (100,)"), (10, "b2 (10,)")):
        w = operands(torch, rk, (n,), scale=0.1, zero_frac=0.2, fmt=fmt,
                     device=device)
        g = operands(torch, rk, (n,), scale=0.1, zero_frac=0.1, fmt=fmt,
                     device=device)
        kw = dict(epilogue=up, fmt=fmt, spec=spec)
        out.append(("lns_fused_update", label,
                    lambda w=w, g=g, kw=kw: K.update_cuda(
                        w.code, w.sign, g.code, g.sign, **kw),
                    lambda w=w, g=g, kw=kw: K.update_plain(
                        w.code, w.sign, g.code, g.sign, **kw),
                    15 * n, n * 2 * OPS_SGD_TERM, True))
    # The unfused step: plain forward per layer, plain dW per layer.
    for (m, k, n), label in (((BATCH, 784, 100), "hidden (5,784)x(784,100)"),
                             ((BATCH, 100, 10), "out (5,100)x(100,10)")):
        x, w, _ = fwd_case(torch, rk, m, k, n, fmt, device)
        mac("lns_matmul", label, x, w, (1, 0), 0, 5, 0)
    for (m, k, n), label in (((BATCH, 784, 100), "w1 (784,100)"),
                             ((BATCH, 100, 10), "w2 (100,10)")):
        x = operands(torch, rk, (m, k), scale=1.0, zero_frac=0.5, fmt=fmt,
                     device=device)
        d = operands(torch, rk, (m, n), scale=0.1, zero_frac=0.1, fmt=fmt,
                     device=device)
        mac("lns_matmul_dw", label, x, d, (0, 0), 0, 5, 0)
        # The segmented step: 5 one-row segments.
        mac("lns_matmul_dw_partials", f"{label} x 5 segments", x, d, (0, 0),
            0, 5, 0, segments=BATCH)
    # The segmented step's combine: (5, E) partials of w1, b1, w2, b2
    # reduced in place as E rows of 5 steps, in the one grouped launch the
    # step makes, and one launch per parameter for comparison.
    from repro_torch.kernels.lns_boxsum import (boxsum_cuda,
                                                boxsum_many_cuda,
                                                boxsum_plain)
    sets = []
    for e, label in ((78400, "w1 (78400,5)"), (100, "b1 (100,5)"),
                     (1000, "w2 (1000,5)"), (10, "b2 (10,5)")):
        p = operands(torch, rk, (BATCH, e), scale=0.1, zero_frac=0.1,
                     fmt=fmt, device=device)
        sets.append((p.code.T, p.sign.T))
        out.append(("lns_boxsum", f"{label} alone",
                    lambda p=p: boxsum_cuda(p.code.T, p.sign.T, fmt=fmt,
                                            spec=spec),
                    lambda p=p: boxsum_plain(p.code.T, p.sign.T, fmt=fmt,
                                             spec=spec),
                    5 * BATCH * e + 5 * e, boxsum_ops(e, BATCH), False))
    rows = sum(c.shape[0] for c, _ in sets)
    out.append(("lns_boxsum", "w1+b1+w2+b2 grouped (79510,5)",
                lambda: boxsum_many_cuda(sets, fmt=fmt, spec=spec),
                lambda: [boxsum_plain(c, sg, fmt=fmt, spec=spec)
                         for c, sg in sets],
                5 * BATCH * rows + 5 * rows, boxsum_ops(rows, BATCH),
                True))
    return out


def step_model(torch, name):
    """(model, step) of a timed path: the LNS paths of phase 5 and the
    baselines (``float``, ``fxp16-sr``), weight decay 0.01; ``step(params,
    i)`` trains on batch ``i`` of synthetic ``mnist``."""
    from repro_torch.paper import datasets
    from repro_torch.paper.mlp import MLPConfig, make_mlp
    x, y, _, _, _ = datasets.load("mnist", "data", SEED)
    if name in BASELINES:
        backend, kw = BASELINES[name]
        model = make_mlp(backend, MLPConfig(weight_decay=0.01, **kw), "cuda")
    else:
        kw = path_launches(0)[name][0]
        model = make_mlp("lns", MLPConfig(spec=kw["numerics"],
                                          fused=kw.get("fused", True),
                                          weight_decay=0.01), "cuda")
    sr = name in BASELINES and BASELINES[name][1].get("stochastic_round")

    def step(params, i):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        if sr:
            return model.train_step(params, x[sl], y[sl],
                                    torch.Generator().manual_seed(i))
        return model.train_step(params, x[sl], y[sl])
    return model, step


def time_step(torch, name):
    """ms per train step of path ``name`` on the card (host clock around
    100 steps ending in a synchronize), and a torch.profiler view of 10
    steps: device time per kernel and the device's busy share of the
    profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model, step = step_model(torch, name)
    params = model.init(torch.Generator().manual_seed(SEED))

    def steps(params, lo, n):
        for i in range(lo, lo + n):
            params, loss = step(params, i)
        torch.cuda.synchronize()
        return params, loss

    params, _ = steps(params, 0, 5)
    n = 100
    t0 = time.perf_counter()
    params, loss = steps(params, 5, n)
    ms = (time.perf_counter() - t0) * 1e3 / n
    if not math.isfinite(float(loss)):
        raise AssertionError(f"loss {float(loss)} is not finite")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(params, 105, 10)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # Kernel rows only: an operator's row repeats its kernels' time.
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    return ms, wall_us, rows


# ------------------------------------------------------------- phase 7 --

#: The baselines' timed steps (phase 6) by name: (backend, MLPConfig keys).
BASELINES = {"float": ("float", {}),
             "fxp16-sr": ("fxp", dict(bits=16, stochastic_round=True))}
#: The float run on the card against the CPU lane: cuBLAS and the CPU sum
#: the float32 products in other orders.
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6
#: Steps of each Table 1 grid run (one epoch).
GRID_STEPS = 150


def baselines(torch, card):
    """Phase 7: the float and fixed-point baselines through
    ``run_experiment``, card against CPU lane, then the Table 1 grid on the
    card.  Returns the launch counts of the card runs (none expected: the
    baselines reach no kernel)."""
    from repro_torch.benchmarks.table1_accuracy import CONFIGS, config_tag
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.paper import run_experiment
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on: the float baseline must run its "
                             "products in float32")
    log("7 baselines", "torch.backends.cuda.matmul.allow_tf32 False, "
        "float32 matmul precision 'highest'")
    common = dict(epochs=1, max_steps_per_epoch=STEPS, batch_size=BATCH,
                  seed=SEED)
    runs = [("float", {})] + [("fxp", dict(bits=b, stochastic_round=sr))
                              for b in (16, 12) for sr in (False, True)]
    reset_launch_counts()
    for backend, kw in runs:
        t0 = time.time()
        card_run = run_experiment(backend, "mnist", device="cuda", **common,
                                  **kw)
        torch.cuda.synchronize()
        card_s = time.time() - t0
        cpu_run = run_experiment(backend, "mnist", device="cpu", **common,
                                 **kw)
        label = config_tag("mnist", backend, kw)
        if backend == "float":
            worst = 0.0
            for k, w in card_run.params.items():
                ref = cpu_run.params[k]
                worst = max(worst, float(abs(w - ref).max()))
                if not (abs(w - ref) <= FLOAT_ATOL
                        + FLOAT_RTOL * abs(ref)).all():
                    raise AssertionError(f"{label}: {k} on the card differs "
                                         f"from the CPU lane beyond rtol "
                                         f"{FLOAT_RTOL}, atol {FLOAT_ATOL}")
            log("7 baselines", f"{label}: {STEPS} steps + evaluate in "
                f"{card_s:.2f} s on the card; weights within rtol "
                f"{FLOAT_RTOL}, atol {FLOAT_ATOL} of the CPU lane, largest "
                f"difference {worst:.3e}; test acc card {card_run.test_acc} "
                f"cpu {cpu_run.test_acc}")
            continue
        for k, w in card_run.params.items():
            if w.dtype != cpu_run.params[k].dtype or not (
                    w == cpu_run.params[k]).all():
                raise AssertionError(f"{label}: {k} on the card differs "
                                     f"from the CPU lane after {STEPS} "
                                     f"steps")
        if (card_run.val_curve, card_run.test_acc) != (cpu_run.val_curve,
                                                       cpu_run.test_acc):
            raise AssertionError(f"{label}: accuracy card "
                                 f"{card_run.val_curve}/{card_run.test_acc}"
                                 f" vs cpu {cpu_run.val_curve}/"
                                 f"{cpu_run.test_acc}")
        log("7 baselines", f"{label}: {STEPS} steps + evaluate in "
            f"{card_s:.2f} s on the card; int32 weight codes and accuracy "
            f"equal to the CPU lane; val acc {card_run.val_curve}, test acc "
            f"{card_run.test_acc}")
    counts = {k: v for k, v in launch_counts().items() if v}
    log("7 baselines", f"kernel launches of the five card runs: "
        f"{counts or 'none'} (the baselines reach no LNS kernel)")
    log("7 table1", f"the Table 1 grid on synthetic mnist, 1 epoch of "
        f"{GRID_STEPS} steps of batch {BATCH}, seed {SEED}, on {card}")
    for backend, kw in CONFIGS:
        t0 = time.time()
        r = run_experiment(backend, "mnist", epochs=1,
                           max_steps_per_epoch=GRID_STEPS, device="cuda",
                           **kw)
        torch.cuda.synchronize()
        if not 0.0 <= r.test_acc <= 1.0:
            raise AssertionError(f"{backend} {kw}: test acc {r.test_acc}")
        log("7 table1", f"table1/{config_tag('mnist', backend, kw)}: test "
            f"acc {r.test_acc:.4f}, val acc {r.val_curve[-1]:.4f}, "
            f"{time.time() - t0:.2f} s wall on {card}")
    return counts


# ------------------------------------------------------------- phase 8 --

#: The faulted steps' plan: bit flips of w and of the activations and two
#: stuck lanes in the hidden layer in the window [2, 4), three corrupted
#: entries in each of the output layer's Δ tables.
FAULTS = ("seed=3,start=2,stop=4;hidden=flip_w:0.01,flip_act:0.01,"
          "sat_lanes:2;out=lut:3")
#: The segmented step's plan adds a dropped and a duplicated segment.
SEG_FAULTS = FAULTS + ";hidden=drop_seg:1;out=dup_seg:2"
#: path → (spec, MLPConfig keywords, kernel launches per step).
PHASE8_PATHS = {
    "fused": ("lns16-train-pallas", {},
              dict(lns_matmul_fused=2, lns_matmul_dx=1,
                   lns_matmul_dw_update=2, lns_fused_update=2)),
    "unfused": ("lns16-train-pallas", {"fused": False},
                dict(lns_matmul=2, lns_matmul_dx=1, lns_matmul_dw=2)),
    "segmented": (SEGMENTED, {},
                  dict(lns_matmul_fused=2, lns_matmul_dx=1,
                       lns_matmul_dw_partials=2, lns_boxsum=1,
                       lns_fused_update=4)),
    "fused-full": ("lns16-train-pallas;hidden=metrics:full", {},
                   dict(lns_matmul_fused=2, lns_matmul_dx=1,
                        lns_matmul_dw_update=2, lns_fused_update=2)),
}
PHASE8_STEPS = 8
PHASE8_TIMED = 40


def _codes(params):
    from repro_torch.paper import params_to_numpy
    return params_to_numpy(params)


def _equal_codes(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(a[k][0], b[k][0])
               and np.array_equal(a[k][1], b[k][1]) for k in b)


def _counted(torch, fn):
    """Run ``fn`` with the launch counters set to 0 just before and read
    just after; returns (fn's result, the counts that are not 0)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in launch_counts().items() if v}


def _phase8_model(path, device, faults=None):
    from repro_torch.paper.mlp import MLPConfig, make_mlp
    spec, kw, _ = PHASE8_PATHS[path]
    return make_mlp("lns", MLPConfig(spec=spec, momentum=0.9,
                                     weight_decay=0.01, faults=faults, **kw),
                    device)


def _expect(path, counts, steps, what):
    want = {k: v * steps for k, v in PHASE8_PATHS[path][2].items()}
    if counts != want:
        raise AssertionError(f"{what} {path}: launch counts {counts}, "
                             f"expected {want}")


def phase8_metrics(torch, x, y, init):
    """``train_step_metrics`` of each path on the card against the card's
    ``train_step`` and the CPU lane's metrics step; returns per path the
    launch counts of the card's metrics run."""
    from repro_torch.obs import host_taps
    from repro_torch.paper import params_from_numpy
    import numpy as np
    out = {}
    for path in PHASE8_PATHS:
        steps = 3 if path == "fused-full" else PHASE8_STEPS
        runs = {}
        for device, entry in (("cuda", "plain"), ("cuda", "metrics"),
                              ("cpu", "metrics")):
            model = _phase8_model(path, device)
            params = params_from_numpy(init, device)
            mom = model.init_momentum(params)

            def run():
                nonlocal params, mom
                codes, taps = [], []
                for i in range(steps):
                    sl = slice(i * BATCH, (i + 1) * BATCH)
                    if entry == "plain":
                        params, mom, _ = model.train_step(params, x[sl],
                                                          y[sl], mom)
                    else:
                        (params, mom, _), t = model.train_step_metrics(
                            params, x[sl], y[sl], mom)
                        taps.append(host_taps(t))
                    codes.append((_codes(params), _codes(mom)))
                return codes, taps
            if device == "cuda":
                runs[entry], counts = _counted(torch, run)
                _expect(path, counts, steps, f"{entry} step")
                if entry == "metrics":
                    out[path] = counts
            else:
                runs["cpu"] = run()
        for i in range(steps):
            card, plain, cpu = (runs["metrics"][0][i], runs["plain"][0][i],
                                runs["cpu"][0][i])
            for part in (0, 1):
                if not _equal_codes(card[part], plain[part]):
                    raise AssertionError(f"metrics {path}: codes differ from "
                                         f"the card's train_step, step {i}")
                if not _equal_codes(card[part], cpu[part]):
                    raise AssertionError(f"metrics {path}: codes differ from "
                                         f"the CPU lane, step {i}")
            ct, pt = runs["metrics"][1][i], runs["cpu"][1][i]
            if sorted(ct) != sorted(pt) or not all(
                    np.array_equal(ct[k], pt[k]) for k in pt):
                raise AssertionError(f"metrics {path}: taps differ from the "
                                     f"CPU lane, step {i}")
        log("8 metrics", f"{path}: {steps} steps of train_step_metrics on "
            f"the card; codes equal to the card's train_step and to the CPU "
            f"lane, {len(ct)} taps equal to the CPU lane's at every step"
            + (f" (hidden dhist {ct['hidden/fwd/dhist'].tolist()})"
               if "hidden/fwd/dhist" in ct else "")
            + f"; launches {out[path]}")
    return out


def phase8_faults(torch, x, y, init):
    """``train_step_faults`` of the fused, unfused and segmented steps on
    the card against the CPU lane, 6 steps, the step an int or a tensor
    on the model's device in turns."""
    from repro_torch.paper import params_from_numpy
    out = {}
    for path in ("fused", "unfused", "segmented"):
        plan = SEG_FAULTS if path == "segmented" else FAULTS
        runs = {}
        for device in ("cuda", "cpu"):
            model = _phase8_model(path, device, plan)
            params = params_from_numpy(init, device)
            mom = model.init_momentum(params)
            on = getattr(model, "inner", model).device

            def run():
                nonlocal params, mom
                codes = []
                for i in range(6):
                    sl = slice(i * BATCH, (i + 1) * BATCH)
                    step = (torch.tensor(i, dtype=torch.int32, device=on)
                            if i % 2 else i)
                    params, mom, _ = model.train_step_faults(
                        params, x[sl], y[sl], step, mom)
                    codes.append((_codes(params), _codes(mom)))
                return codes
            if device == "cuda":
                runs[device], counts = _counted(torch, run)
                _expect(path, counts, 6, "faults step")
                out[path] = counts
            else:
                runs[device] = run()
        for i, (card, cpu) in enumerate(zip(runs["cuda"], runs["cpu"])):
            if not (_equal_codes(card[0], cpu[0])
                    and _equal_codes(card[1], cpu[1])):
                raise AssertionError(f"faults {path}: codes differ from the "
                                     f"CPU lane after step {i}")
        log("8 faults", f"{path}: 6 steps of train_step_faults under "
            f"{plan!r} on the card; weight and momentum codes equal to the "
            f"CPU lane after every step; launches {out[path]}")
    return out


def phase8_drills(torch):
    """The three drills on the card against the CPU lane; returns the card
    run's launch counts."""
    from repro_torch.launch.drill import run_scenarios
    card, counts = _counted(torch, lambda: run_scenarios(device="cuda"))
    cpu = run_scenarios(device="cpu")
    for c, h in zip(card, cpu):
        if c.pop("lane") != "cuda" or h.pop("lane") != "cpu" or c != h:
            raise AssertionError(f"drill {c['mode']}: card row {c} differs "
                                 f"from the CPU lane's {h}")
        log("8 drills", f"{c['mode']}: inject@{c['inject_step']} "
            f"detect@{c['detect_step']} action {c['recovery_action']} "
            f"acc_delta {c['acc_delta_post']:+.6f}; row equal to the CPU "
            f"lane's but for lane")
    for k in ("lns_matmul_fused", "lns_matmul_dx", "lns_matmul_dw_update",
              "lns_fused_update", "lns_matmul_dw_partials", "lns_boxsum"):
        if not counts.get(k):
            raise AssertionError(f"the drills on the card never launched "
                                 f"{k}: {counts}")
    log("8 drills", f"launches of the three card drills: {counts}")
    return counts


def phase8_times(torch, x, y, init, card):
    """ms per step of the fused step's three entry points on the card,
    host clock around ``PHASE8_TIMED`` steps ending in a synchronize, in
    turns (plain, metrics, faults, faults, metrics, plain); then
    torch.profiler over 5 more steps of each: kernel launches and device
    time per step, and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.paper import params_from_numpy
    models = {"train_step": _phase8_model("fused", "cuda"),
              "train_step_metrics": _phase8_model("fused", "cuda"),
              "train_step_faults": _phase8_model("fused", "cuda", FAULTS)}
    state = {}
    for e, model in models.items():
        params = params_from_numpy(init, "cuda")
        state[e] = (params, model.init_momentum(params))

    def steps(entry, lo, n):
        model = models[entry]
        params, mom = state[entry]
        for i in range(lo, lo + n):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            if entry == "train_step":
                params, mom, _ = model.train_step(params, x[sl], y[sl], mom)
            elif entry == "train_step_metrics":
                (params, mom, _), _ = model.train_step_metrics(
                    params, x[sl], y[sl], mom)
            else:
                # Inside the fault window [2, 4).
                params, mom, _ = model.train_step_faults(
                    params, x[sl], y[sl], 3, mom)
        torch.cuda.synchronize()
        state[entry] = (params, mom)

    ms = {e: [] for e in models}
    for e in models:
        steps(e, 0, 5)
    lo = 5
    for e in ("train_step", "train_step_metrics", "train_step_faults",
              "train_step_faults", "train_step_metrics", "train_step"):
        t0 = time.perf_counter()
        steps(e, lo, PHASE8_TIMED)
        ms[e].append((time.perf_counter() - t0) * 1e3 / PHASE8_TIMED)
        lo += PHASE8_TIMED
    for e, runs in ms.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps(e, lo, 5)
        rows = sorted(((getattr(ev, "self_device_time_total", 0), ev.count,
                        ev.key) for ev in prof.key_averages()
                       if getattr(ev, "device_type", None)
                       == DeviceType.CUDA), reverse=True)
        dev_us = sum(r[0] for r in rows) / 5
        log("8 times", f"fused {e}: {runs[0]:.3f} / {runs[1]:.3f} ms per "
            f"step (two turns of {PHASE8_TIMED} steps); "
            f"{sum(r[1] for r in rows) / 5:.0f} kernel launches and "
            f"{dev_us:.1f} us of device time per step (torch.profiler, 5 "
            f"steps; busy share {dev_us / 1e3 / min(runs):.4f}) on {card}")
        for dev, count, key in rows[:4]:
            log("8 times", f"fused {e} {dev / 5:10.2f} us/step "
                f"{count / 5:6.1f} launches/step  {key[:70]}")
    return ms


def phase8(torch, card):
    """Phase 8; returns the launch counts of each card run."""
    from repro_torch.paper import datasets, params_to_numpy
    from repro_torch.paper.mlp import MLPConfig, make_mlp
    x, y, _, _, _ = datasets.load("mnist", "data", SEED)
    init = params_to_numpy(make_mlp("lns", MLPConfig(), "cpu").init(
        torch.Generator().manual_seed(SEED)))
    counts = dict(metrics=phase8_metrics(torch, x, y, init),
                  faults=phase8_faults(torch, x, y, init),
                  drills=phase8_drills(torch))
    phase8_times(torch, x, y, init, card)
    return counts


# ------------------------------------------------------------- phase 9 --

LM_DENSE = ("olmo-1b", "qwen3-1.7b", "yi-6b", "command-r-35b")
#: The ⊞-MAC rows of ``lns_matmul_trainable``: forward, dX, dW.
LM_ROWS = ("lns_matmul", "lns_matmul_dx", "lns_matmul_dw")
LM_STEPS = 3
#: 9b, lns16-train: the card's teacher-forced parameter update against the
#: CPU lane's, relative L2 over the tree (the CPU tests' bound against the
#: JAX package, tests/test_torch_lm_lns_steps.py).
LM_UPDATE_RTOL = 0.5
#: 9c: olmo-1b at full width, depth cut to 2 layers, batch 2 × seq 128.
FULL_LAYERS, FULL_BATCH, FULL_SEQ = 2, 2, 128


def lm_operands(torch, device, row, r, c, ct, fmt=None):
    """Seeded operands of one ⊞-MAC launch of ``row`` with an (R, C)
    output over CT steps, drawn and encoded on ``device``, in the layouts
    the LM step passes: forward x (R, CT) and w (CT, C); dX dy (R, CT) and
    w (C, CT); dW x (CT, R) and dy (CT, C)."""
    from repro_torch.core import LNS16, encode
    fmt = fmt or LNS16
    rk = torch.Generator(device=device).manual_seed(SEED + r + c + ct)
    a_shape = (ct, r) if row == "lns_matmul_dw" else (r, ct)
    b_shape = (c, ct) if row == "lns_matmul_dx" else (ct, c)
    a = torch.randn(a_shape, generator=rk, device=device)
    b = torch.randn(b_shape, generator=rk, device=device) * 0.05
    return encode(a, fmt), encode(b, fmt)


def full_width_cfg():
    """9c's model: olmo-1b as published, depth cut to ``FULL_LAYERS``."""
    from repro_torch.configs import get_config
    return get_config("olmo-1b").with_(
        n_layers=FULL_LAYERS, numerics="lns16-train-pallas", remat="none")


def lm_kernels(torch, device):
    """9a: rows 5, 2 and 6 at LM shapes on the card, bit for bit against
    their plain versions on the card.  Returns {row: max |diff|}, the
    number of cases and the plain version's ms at each of 9c's
    shapes."""
    from repro_torch.core import DELTA_DEFAULT, LNS12, LNS16
    from repro_torch.kernels import lns_matmul as K
    rk = torch.Generator().manual_seed(SEED + 9)
    worst = dict.fromkeys(LM_ROWS, 0)
    # (row, label, a shape, b shape, a / b contracted axis, format)
    cases = [
        ("lns_matmul", "fwd (64x2048).(2048x200)", (64, 2048), (2048, 200),
         1, 0, LNS16),
        ("lns_matmul_dw", "dW over 256 tokens into 2048x160", (256, 2048),
         (256, 160), 0, 0, LNS16),
        ("lns_matmul", "ragged fwd (37x203).(203x45)", (37, 203), (203, 45),
         1, 0, LNS16),
        ("lns_matmul_dx", "ragged dX (37x45).(203x45)T", (37, 45),
         (203, 45), 1, 1, LNS12),
        ("lns_matmul_dw", "ragged dW (61x203)T.(61x45)", (61, 203), (61, 45),
         0, 0, LNS12),
    ]
    for row, label, ashape, bshape, aa, ba, fmt in cases:
        a = operands(torch, rk, ashape, scale=1.0, zero_frac=0.2, fmt=fmt,
                     device=device)
        b = operands(torch, rk, bshape, scale=0.05, zero_frac=0.05, fmt=fmt,
                     device=device)
        kw = dict(fmt=fmt, spec=DELTA_DEFAULT)
        got = getattr(K, row)(a.code, a.sign, b.code, b.sign, **kw)
        want = K.mac_plain(a.code, a.sign, b.code, b.sign,
                           a_contract_axis=aa, b_contract_axis=ba, **kw)
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"9a {label}: {g.dtype}{tuple(g.shape)}"
                                     f" vs {w.dtype}{tuple(w.shape)}")
            err = int((g.long() - w.long()).abs().max())
            worst[row] = max(worst[row], err)
            if err:
                raise AssertionError(f"9a {label}: max |diff| {err}")
        log("9a lm kernels", f"{row} {label}: bit-exact against the plain "
            f"version on the card")
    # Every distinct product of 9c's full-width step (olmo-1b, 256
    # tokens): the blocks' (d_model 2048, d_ff 8192; their dX over 8192
    # among them) and the head's (vocab 50 432), each row at its shape;
    # the plain version is timed once each (host clock ending in a
    # synchronize).  A narrow dX over the head's 50 432 steps, (4 x 8),
    # shares the head dX's plain run, whose loop costs the same at any
    # width: each output of the plain version depends only on its row
    # and column, so the narrow operands are appended to the head's and
    # their block of the result is read back.
    plain_ms = {}
    cfg = full_width_cfg()
    kw = dict(fmt=LNS16, spec=DELTA_DEFAULT)
    for row, r, c, ct, _ in lm_products(cfg, FULL_BATCH, FULL_SEQ):
        a, b = lm_operands(torch, device, row, r, c, ct)
        aa = 0 if row == "lns_matmul_dw" else 1
        ba = 1 if row == "lns_matmul_dx" else 0
        got = getattr(K, row)(a.code, a.sign, b.code, b.sign, **kw)
        narrow = row == "lns_matmul_dx" and ct == cfg.padded_vocab
        if narrow:
            na = operands(torch, rk, (4, ct), scale=1.0, zero_frac=0.2,
                          fmt=LNS16, device=device)
            nb = operands(torch, rk, (8, ct), scale=0.05, zero_frac=0.05,
                          fmt=LNS16, device=device)
            ngot = K.lns_matmul_dx(na.code, na.sign, nb.code, nb.sign, **kw)
            a = type(a)(torch.cat([a.code, na.code]),
                        torch.cat([a.sign, na.sign]))
            b = type(b)(torch.cat([b.code, nb.code]),
                        torch.cat([b.sign, nb.sign]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = K.mac_plain(a.code, a.sign, b.code, b.sign,
                           a_contract_axis=aa, b_contract_axis=ba, **kw)
        torch.cuda.synchronize()
        plain_ms[row, r, c, ct] = (time.perf_counter() - t0) * 1e3
        if narrow:
            nerr = max(int((g.long() - w[r:, c:].long()).abs().max())
                       for g, w in zip(ngot, want))
            worst[row] = max(worst[row], nerr)
            if nerr:
                raise AssertionError(f"9a narrow dX (4 x 8) over {ct}: max "
                                     f"|diff| {nerr}")
            log("9a lm kernels", f"{row} narrow dX (4 x 8) over {ct}: "
                f"bit-exact against the plain version on the card")
            want = [w[:r, :c] for w in want]
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        worst[row] = max(worst[row], err)
        if err:
            raise AssertionError(f"9a {row} ({r} x {c}) over {ct} at full "
                                 f"width: max |diff| {err}")
        log("9a lm kernels", f"{row} 9c's ({r} x {c}) over {ct}: bit-exact "
            f"against the plain version on the card (plain "
            f"{plain_ms[row, r, c, ct]:.1f} ms)")
        del got, want
    return worst, len(cases) + len(plain_ms) + 1, plain_ms


def lm_train(torch, arch, numerics, device, steps=LM_STEPS, cfg=None,
             params=None, batch=2, seq=32, forced=None, keep=False,
             mesh=None):
    """``steps`` AdamW steps of ``arch`` on ``device``, from the seeded
    CPU init (the same parameters on both lanes); returns the losses, the
    launch counts (counters set to 0 just before the steps, read just
    after), each step's host ms and (the last state, or with ``keep``
    the state before the first step and after each, the step function,
    the dataset).  ``forced``: states (of another lane) to start each step
    from, in place of the last step's.  ``mesh``: the steps run through
    ``Runtime(mesh=mesh)`` on the state and batches cut by
    ``train_state_specs`` / ``batch_specs`` (phase 13)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.distributed.sharding import batch_specs, shard_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.nn import Runtime, init_params
    from repro_torch.nn.config import ShapeCell
    from repro_torch.optim.optimizers import AdamWConfig
    from repro_torch.pytree import tree_map
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, train_state_specs)
    if cfg is None:
        cfg = reduced(get_config(arch)).with_(numerics=numerics,
                                              remat="none")
    if params is None:
        params = init_params(SEED, cfg, device=device)
    opt, tc = AdamWConfig(lr=1e-3), TrainConfig(grad_clip=1.0)

    def place(state):
        return state if mesh is None else shard_tree(
            state, train_state_specs(state), mesh)
    state = place(init_train_state(params, opt, tc))
    step = make_train_step(cfg, opt, Runtime(mesh=mesh), tc)
    ds = SyntheticLMDataset(cfg, ShapeCell("lm", seq, batch, "train"),
                            DataConfig(seed=SEED))
    losses, ms = [], []
    states = [state] if keep else None
    reset_launch_counts()
    for i in range(steps):
        b = ds.batch_on(i, device)
        if mesh is not None:
            b = shard_tree(b, batch_specs(b), mesh)
        if forced is not None:
            state = place(tree_map(lambda t: t.to(device), forced[i]))
        t0 = time.perf_counter()
        state, m = step(state, b)
        if keep:
            states.append(state)
        losses.append(float(m["loss"]))
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v for k, v in launch_counts().items() if v}
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{arch} {numerics}: losses {losses}")
    return losses, counts, ms, (states if keep else state, step, ds)


def lm_linears(cfg, serving=False):
    """(K, N, over) of every LNS linear of one train step's forward, in
    order, one entry per call: ``over`` is "tokens" (the decoder's
    positions), "frames" (the enc-dec encoder's) or "input" (frames of
    data: ``frontend_proj``, whose input needs no gradient, so no dX).  Per layer the
    attention's (GQA: wq, wk, wv, wo; MLA: wq, w_dkv, w_ukv, wo), the
    MLP's (dense layers) or the shared experts' (MoE layers; the routed
    experts are float einsums, no ⊞-MAC), Mamba2's ``in_proj`` and
    ``out_proj``; the hybrid's shared block once per group of
    ``attn_every`` Mamba2 layers, then the tail; the enc-dec family's
    ``frontend_proj`` and encoder layers over the frames, then per decoder
    layer the self-attention, the cross-attention (``wq``, ``wo`` over
    the tokens, ``wk``, ``wv`` over the frames) and the MLP.  ``serving``:
    those of one serving forward (``decode_step``, ``linear_infer``)
    below the head instead, where MLA is absorbed (its w_ukv a float
    einsum), the moe family's dense stack runs all its layers, as the
    reference's decode does, and the enc-dec encoder does not run (the
    cross-attention's K and V are taken again from ``enc_out`` at every
    step).  Stub frontends of the dense and vlm families are not
    counted."""
    d = cfg.d_model

    def tok(pairs):
        return [(k, n, "tokens") for k, n in pairs]
    if cfg.attn_kind == "mla":
        m, h = cfg.mla, cfg.n_heads
        attn = [(d, h * (m.nope_head_dim + m.rope_head_dim)),
                (d, m.kv_lora_rank + m.rope_head_dim)]
        if not serving:
            attn.append((m.kv_lora_rank,
                         h * (m.nope_head_dim + m.v_head_dim)))
        attn.append((h * m.v_head_dim, d))
    else:
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        attn = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d)]
    ff = cfg.d_ff
    mlp = [(d, ff)] * (2 if cfg.mlp_kind == "glu" else 1) + [(ff, d)]
    fam = cfg.family
    if fam in ("ssm", "hybrid"):
        s = cfg.ssm
        d_in = s.expand * d
        mamba = tok([(d, 2 * d_in + 2 * s.n_groups * s.d_state
                      + d_in // s.head_dim), (d_in, d)])
        if fam == "ssm":
            return mamba * cfg.layers
        k = cfg.hybrid.attn_every
        groups = cfg.layers // k
        return (mamba * k + tok(attn + mlp)) * groups \
            + mamba * (cfg.layers - groups * k)
    if fam in ("encdec", "audio"):
        e = cfg.encdec
        frames = [(k_, n, "frames") for k_, n in attn + mlp]
        cross = [(attn[0][0], attn[0][1], "tokens"),
                 (attn[1][0], attn[1][1], "frames"),
                 (attn[2][0], attn[2][1], "frames"),
                 (attn[3][0], attn[3][1], "tokens")]
        dec = (tok(attn) + cross + tok(mlp)) * e.n_dec_layers
        if serving:
            return dec
        front = [(d, d, "input")] if cfg.frontend else []
        return front + frames * e.n_enc_layers + dec
    if fam != "moe":
        return tok(attn + mlp) * cfg.layers
    fd = cfg.moe.first_dense_layers
    sh = cfg.moe.n_shared * cfg.moe.d_expert
    shared = [(d, sh), (d, sh), (sh, d)] if sh else []
    return tok(attn + mlp) * (max(fd, 1) if serving else fd) \
        + tok(attn + shared) * max(cfg.layers - fd, 1)


def lm_products(cfg, batch, seq, frames=None):
    """(row, R, C, CT, launches) of every ⊞-MAC launch of one train step
    under ``lns16-train`` with ``remat="none"``: per LNS linear (K → N over
    M rows: batch × seq tokens, or batch × ``frames`` frames, ``seq`` when
    None) the forward (M, N) over K, dX (M, K) over N (but for an input
    of data) and dW (K, N) over M; the head once per CE chunk."""
    chunks = max(seq // cfg.ce_chunk, 1)
    frames = batch * (frames or seq)
    rows = {"tokens": batch * seq, "frames": frames, "input": frames}
    out = {}
    for k, n, over, m, times in [(k, n, over, rows[over], 1)
                                 for k, n, over in lm_linears(cfg)] + [
            (cfg.d_model, cfg.padded_vocab, "tokens",
             batch * (seq // chunks), chunks)]:
        for key in (("lns_matmul", m, n, k), ("lns_matmul_dx", m, k, n),
                    ("lns_matmul_dw", k, n, m)):
            if key[0] != "lns_matmul_dx" or over != "input":
                out[key] = out.get(key, 0) + times
    return [key + (c,) for key, c in out.items()]


def lm_expected(cfg, seq):
    """Launches of each row in one train step: once per LNS linear call
    (dX but for an input of data) and once per CE chunk."""
    lin = lm_linears(cfg)
    out = dict.fromkeys(LM_ROWS, len(lin) + max(seq // cfg.ce_chunk, 1))
    out["lns_matmul_dx"] -= sum(over == "input" for _, _, over in lin)
    return out


def mac_step_instructions():
    """Instructions a thread of the tiled ``mac_kernel<kLut>`` issues per
    ⊞-MAC step: its SASS inner loop in the built library (``lut_loop`` of
    ``scripts/ab_fused_step.py``, by ``cuobjdump``) over the ``kTileK``
    steps that loop unrolls, and the loop."""
    import re
    sys.path.insert(0, str(ROOT / "scripts"))
    from ab_fused_step import lut_loop
    from repro_torch.kernels import build
    src = (build.CSRC / "lns_mac.cu").read_text()
    tile_k = int(re.search(r"constexpr int kTileK = (\d+);", src).group(1))
    loop = lut_loop(build)
    return loop["instructions"] / tile_k, loop


def lm_time_products(torch, device, products, card, plain_ms, tag="9c lm"):
    """Card ms of each row's launches in one full-width step (CUDA events
    around each distinct shape, times its launches), the plain version's
    (9a's time at that shape, times its launches; None where ``plain_ms``
    is None: not measured), and each row's bound
    from this step's shapes: the bytes, and the instructions the tiled
    chain issues per step, at one warp instruction a clock per SM
    sub-partition."""
    from repro_torch.core import DELTA_DEFAULT, LNS16
    from repro_torch.kernels import lns_matmul as K
    per_step, loop = mac_step_instructions()
    log(f"{tag} times", f"mac_kernel<kLut>'s inner loop {loop['range']}: "
        f"{loop['instructions']} instructions, {per_step:.4f} a ⊞-MAC step "
        f"a thread; opcodes {loop['opcodes']}")
    rows = {}
    for row, r, c, ct, times in products:
        a, b = lm_operands(torch, device, row, r, c, ct)
        fn = getattr(K, row)
        kw = dict(epilogue=K.FwdEpilogue()) \
            if row == "lns_matmul_fused" else {}

        def call():
            fn(a.code, a.sign, b.code, b.sign, fmt=LNS16,
               spec=DELTA_DEFAULT, **kw)
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(2):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 2
        ops = r * c * ct * per_step
        nbytes = (r * ct + ct * c + r * c) * 5
        log(f"{tag} times", f"{row} R={r} C={c} CT={ct}: {ms:.4f} ms a "
            f"launch x {times} (bound {max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3:.4f} ms) on {card}")
        q = rows.setdefault(row, dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0,
                                      launches=0))
        q["ms"] += ms * times
        if plain_ms is None:
            q["plain_ms"] = None
        else:
            q["plain_ms"] += plain_ms[row, r, c, ct] * times
        q["bytes"] += nbytes * times
        q["ops"] += ops * times
        q["launches"] += times
    for q in rows.values():
        tb, to = q["bytes"] / HBM_BYTES_PER_S, q["ops"] / INT32_OPS_PER_S
        q["bound_ms"] = max(tb, to) * 1e3
        q["bound_by"] = "bytes" if tb > to else "operations"
    return rows


def lm_full_width(torch, device, card, plain_ms, cfg=None, name="olmo-1b",
                  tag="9c", fp32=True, batch=FULL_BATCH, seq=FULL_SEQ):
    """9c: olmo-1b as published (d_model 2048, 16 × 128 heads, d_ff 8192,
    vocab 50 304 padded to 50 432), depth cut to 2 layers, batch 2 × seq
    128, lns16-train-pallas, AdamW, 3 steps on the card; 10c and 11c the
    same for ``cfg`` (``name``) at ``batch`` × ``seq`` (the enc-dec
    family over as many frames).  ``plain_ms``: the plain version's time
    at each of the step's shapes.  ``fp32``: the same steps under fp32
    too.  Returns ({row: timing}, launches, {"ms": the steps' host ms,
    "peak_gib": peak memory, "busy": device time over the step})."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.nn import init_params
    cfg = cfg or full_width_cfg()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device=device).manual_seed(SEED),
                         cfg, device=device)
    losses, counts, ms, (state, step, ds) = lm_train(
        torch, name, None, device, cfg=cfg, params=params,
        batch=batch, seq=seq)
    want = {k: v * LM_STEPS for k, v in lm_expected(cfg, seq).items()}
    if counts != want:
        raise AssertionError(f"{tag} launch counts {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    if fp32:
        fp, _, fp_ms, _ = lm_train(
            torch, name, None, device, cfg=cfg.with_(numerics="fp32"),
            params=params, batch=batch, seq=seq)
        log(f"{tag} full width", f"the same steps under fp32 (cuBLAS, no "
            f"LNS kernel): losses {fp}; ms per step {fp_ms}")
    depth = f"{cfg.encdec.n_enc_layers} + {cfg.encdec.n_dec_layers}" \
        if cfg.encdec else cfg.layers
    log(f"{tag} full width", f"{name} d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} -> "
        f"{cfg.padded_vocab}, {depth} layers, batch {batch} x seq "
        f"{seq}: losses {losses}; ms per step {ms} (host clock ending "
        f"in a synchronize; the first includes warm-up); launches {counts}; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB on {card}")
    reset_launch_counts()

    def one_step():
        float(step(state, ds.batch_on(LM_STEPS, device))[1]["loss"])
    dev_us, kern, wall_us = profile_call(torch, one_step)
    one = {k: v for k, v in launch_counts().items() if v}
    step_ms = sum(ms[1:]) / len(ms[1:])
    if dev_us:
        log(f"{tag} profile", f"one step: {dev_us:.1f} us of device time in "
            f"{sum(k[1] for k in kern)} kernel launches ({one} of the ⊞-MAC "
            f"rows); busy share {dev_us / (step_ms * 1e3):.4f} of the "
            f"unprofiled step ({step_ms:.3f} ms, the mean of steps 2-"
            f"{LM_STEPS}; {dev_us / wall_us:.4f} of the {wall_us:.1f} us "
            f"profiled step) on {card}")
        for dev, count, key in kern[:6]:
            log(f"{tag} profile", f"{dev:12.1f} us {count:5d} launches  "
                f"{key[:70]}")
    else:
        log(f"{tag} profile", "torch.profiler saw no device time: not "
            "measured")
    del state, params
    rows = lm_time_products(torch, device, lm_products(cfg, batch, seq),
                            card, plain_ms, tag=f"{tag} lm")
    for row, q in rows.items():
        plain = "not measured" if q["plain_ms"] is None \
            else f"{q['plain_ms']:.1f} ms"
        log(f"{tag} lm times", f"{row} per full-width step: {q['ms']:.3f} "
            f"ms on the card in {q['launches']} launches; plain {plain}; "
            f"bound {q['bound_ms']:.3f} ms by {q['bound_by']} on {card}")
    return rows, dict(counts), dict(
        ms=ms, peak_gib=peak / 2**30,
        busy=dev_us / (step_ms * 1e3) if dev_us else None)


def lm_cli(torch, tmp, arch="qwen3-1.7b", tag="9d"):
    """9d (11e): the train CLI on the card with checkpoints and metrics
    for reduced ``arch``, then a relaunch that resumes at step 4."""
    import json as _json
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_cli
    common = ["--arch", arch, "--ckpt-every", "2", "--numerics",
              "lns16-train-pallas", "--batch", "2", "--seq", "32",
              "--log-every", "1", "--ckpt-dir", f"{tmp}/ckpt"]
    reset_launch_counts()
    first = train_cli.main(["--steps", "4", "--metrics", f"{tmp}/a.jsonl"]
                           + common)
    second = train_cli.main(["--steps", "6", "--metrics", f"{tmp}/b.jsonl"]
                            + common)
    counts = {k: v for k, v in launch_counts().items() if v}
    if len(first) != 4 or len(second) != 2:
        raise AssertionError(f"{tag}: {len(first)} then {len(second)} steps; "
                             f"the relaunch must resume at step 4")
    rows = [_json.loads(x) for x in open(f"{tmp}/b.jsonl")]
    keys = {"kind", "name", "value", "component", "arch", "spec", "layer",
            "op", "lane", "step", "loss", "step_time_ms"}
    counters = [r for r in rows if r["kind"] == "counter"]
    # Parameters outside the known layer paths (final_norm) carry no lane,
    # as in the reference.
    if not counters or any(set(r) - {"lane"} != keys - {"lane"}
                           for r in counters) \
            or {r["step"] for r in counters} != {5, 6} \
            or {r["lane"] for r in counters if "lane" in r} != {"cuda"}:
        raise AssertionError(f"{tag}: metrics rows {rows[:2]}")
    if rows[-1]["kind"] != "summary":
        raise AssertionError(f"{tag}: no summary row")
    log(f"{tag} train cli", f"{arch}: 4 steps then a relaunch to 6 that "
        f"resumed at step "
        f"4: losses {first} / {second}; {len(rows)} JSONL rows with the "
        f"reference's keys; launches {counts}")
    return counts


def update_gap(before, after_cpu, after_card):
    """Relative L2 distance, over the whole tree, of the card's parameter
    update from the CPU lane's, both from the same state ``before``."""
    from repro_torch.pytree import tree_leaves
    num = den = 0.0
    for p0, p1, q1 in zip(tree_leaves(before["params"]),
                          tree_leaves(after_cpu["params"]),
                          tree_leaves(after_card["params"])):
        u = p1.double() - p0.double()
        num += float(((q1.cpu().double() - p0.double() - u) ** 2).sum())
        den += float((u ** 2).sum())
    return math.sqrt(num / den)


def card_vs_cpu(torch, device, archs, tag, holds=None, meshes=None):
    """9b / 10b / 11b / 13a: each ``reduced()`` config of ``archs`` under
    ``fp32`` and ``lns16-train-pallas``, 3 AdamW steps on the card against
    the CPU lane, each row's launches against the products the code
    predicts; returns the launches of the card runs.  ``holds``: arch →
    its lns16-train (first step's loss rtol, every step's, update
    relative L2), 9b's (1e-3, 1e-2, ``LM_UPDATE_RTOL``) where absent.
    ``meshes``: device type → the mesh each lane's steps run under."""
    meshes = meshes or {}
    from repro_torch.configs import get_config, reduced
    launches = dict.fromkeys(LM_ROWS, 0)
    cpu = torch.device("cpu")
    for arch in archs:
        lns = (holds or {}).get(arch, (1e-3, 1e-2, LM_UPDATE_RTOL))
        for numerics, rtols in (("fp32", (1e-5, 1e-5, None)),
                                ("lns16-train-pallas", lns)):
            t1 = time.time()
            # fp32: both lanes free-running, every step's loss held at
            # 1e-5.  lns16-train: teacher-forced, each card step from the
            # CPU lane's state before it (free-running, float ulps part the
            # lanes after the first update); the first step's loss held at
            # 1e-3, every step's at 1e-2 (a later step's start is no
            # longer the seeded init, and its gap reads up to 1.26e-3:
            # ROADMAP queue 3 item 7) and its update at LM_UPDATE_RTOL;
            # or at ``holds``.
            forced = numerics != "fp32"
            hl, _, _, (hstates, _, _) = lm_train(torch, arch, numerics, cpu,
                                                 keep=True,
                                                 mesh=meshes.get("cpu"))
            cl, counts, ms, (cstates, _, _) = lm_train(
                torch, arch, numerics, device, keep=True,
                forced=hstates if forced else None,
                mesh=meshes.get("cuda"))
            cfg = reduced(get_config(arch))
            want = {} if numerics == "fp32" else {
                k: v * LM_STEPS for k, v in lm_expected(cfg, 32).items()}
            if counts != want:
                raise AssertionError(f"{tag} {arch} {numerics}: launch "
                                     f"counts {counts}, expected {want}")
            gaps = [abs(a - b) / abs(b) for a, b in zip(cl, hl)]
            upd = [update_gap(h0, h1, c1) for h0, h1, c1 in
                   zip(hstates, hstates[1:], cstates[1:])] if forced else []
            if gaps[0] > rtols[0] or max(gaps) > rtols[1] \
                    or max(upd, default=0.0) > (rtols[2] or 0.0):
                raise AssertionError(f"{tag} {arch} {numerics}: card {cl} "
                                     f"vs cpu {hl}; update gaps {upd}")
            for k, v in counts.items():
                launches[k] += v
            log(f"{tag} lm card vs cpu", f"{arch} {numerics}"
                f"{' (teacher-forced)' if forced else ''}: losses card {cl} "
                f"cpu {hl} (rel gaps {gaps}); update relative L2 {upd}; "
                f"launches {counts}; card ms per step "
                f"{[round(x, 1) for x in ms]}; {time.time() - t1:.1f} s")
            del hstates, cstates
    return launches


def phase9(torch, device, card):
    """Phase 9; returns ({row: max |diff|}, {row: LM step timing},
    {row: launches of the LM runs on the card})."""
    t0 = time.time()
    worst, n, plain_ms = lm_kernels(torch, device)
    log("9a lm kernels", f"{n} cases in {time.time() - t0:.1f} s")
    launches = card_vs_cpu(torch, device, LM_DENSE, "9b")
    rows, counts, _ = lm_full_width(torch, device, card, plain_ms)
    for k, v in counts.items():
        launches[k] += v
    with tempfile.TemporaryDirectory() as tmp:
        for k, v in lm_cli(torch, tmp).items():
            launches[k] += v
    log("9 lm", f"phase 9 in {time.time() - t0:.1f} s")
    return worst, rows, launches


# ------------------------------------------------------------ phase 10 --

MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v2-lite-16b")
#: 10c / 10d: deepseek-v2-lite-16b as published, depth cut to 1 dense + 1
#: MoE layer.
MOE_FULL_ARCH, MOE_FULL_LAYERS = "deepseek-v2-lite-16b", 2
#: 10a: every output of each shape is held over a contraction cut to
#: ``SHORT_CT`` steps (past ``kShortSteps``: the tiled form, one whole tile
#: of 32 steps and a remainder); the plain version is timed over the
#: first ``PLAIN_STEPS`` steps of the full contraction (logged as an
#: extrapolation, not measured at the full length).
SHORT_CT, PLAIN_STEPS = 40, 32
#: 10d: the engine's geometry and requests.
SERVE_BATCH, SERVE_CHUNK, SERVE_BLOCK, SERVE_NEW = 4, 16, 16, 16
SERVE_PROMPTS = (5, 12, 23, 40, 31, 8)
SERVE_MAX_LEN = 64


def moe_full_cfg(numerics="lns16-train-pallas"):
    from repro_torch.configs import get_config
    return get_config(MOE_FULL_ARCH).with_(
        n_layers=MOE_FULL_LAYERS, numerics=numerics, remat="none")


def serve_products(cfg, rows, head_rows, frame_rows=0,
                   row="lns_matmul_fused"):
    """(``row``, R, C, CT, launches) of one serving forward at ``rows``
    tokens: every linear (the enc-dec cross-attention's K and V at
    ``frame_rows``: batch × the memory's frames), and the head at
    ``head_rows`` (``rows`` in a decode step; 1 in a prefill chunk, which
    keeps its last valid position).  Row 1 for the paged engine's
    ``linear_infer``, row 5 for ``decode_step``'s ``linear``."""
    out = {}
    for k, n, r in [(k, n, frame_rows if over == "frames" else rows)
                    for k, n, over in lm_linears(cfg, True)] + [
            (cfg.d_model, cfg.padded_vocab, head_rows)]:
        key = (row, r, n, k)
        out[key] = out.get(key, 0) + 1
    return [key + (c,) for key, c in out.items()]


def _tile_rows(n, w, rng):
    """The first and last ``w`` indices of ``range(n)`` and those of one
    interior tile of ``w`` drawn by ``rng``: a kernel's first, last and
    one middle tile."""
    picked = set(range(min(w, n))) | set(range(max(n - w, 0), n))
    if n > 3 * w:
        t = int(rng.integers(1, n // w - 1)) * w
        picked |= set(range(t, t + w))
    return sorted(picked)


def moe_kernels(torch, device):
    """10a: every distinct ⊞-MAC shape of 10c's full-width step (rows 5,
    2 and 6 on deepseek-v2-lite-16b's MLA, dense-FFN, shared-expert and
    head products over 256 tokens) and of 10d's serving (row 1, the fused
    forward with no epilogue, at decode (4 rows) and prefill (16 rows)
    shapes), held by :func:`hold_products`."""
    cfg = moe_full_cfg()
    with plain_pool() as pool:
        worst, n, finish = hold_products(
            torch, device, lm_products(cfg, FULL_BATCH, FULL_SEQ)
            + serve_products(cfg, SERVE_BATCH, SERVE_BATCH)
            + serve_products(cfg, SERVE_CHUNK, 1), "10a", SEED + 10, pool)
        finish()
    return worst, n


#: Worker processes of the plain version's long runs (10a, 11a).
PLAIN_WORKERS = 4


def plain_pool():
    """A pool of ``PLAIN_WORKERS`` spawned processes for the plain version
    on the host (each a thread of its own); leaving the ``with`` block
    waits for them and stops them."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=PLAIN_WORKERS, initializer=_plain_worker_init,
        mp_context=multiprocessing.get_context("spawn"))


def _plain_worker_init():
    import torch
    torch.set_num_threads(1)


def _plain_run(a_code, a_sign, b_code, b_sign, pk):
    """The plain ⊞-MAC on host tensors, in a worker of :func:`plain_pool`."""
    from repro_torch.kernels import lns_matmul as K
    return K.mac_plain(a_code, a_sign, b_code, b_sign, **pk)


def hold_products(torch, device, products, tag, seed, pool):
    """Every distinct (row, R, C, CT) of ``products`` on the card against
    the plain version, bit for bit, twice:

    * every output, at the shape's (R, C) over a contraction cut to
      ``SHORT_CT`` steps (the tiled form still: whole tiles of steps and a
      remainder), against the plain version on the card: every block's
      row and column tile;
    * at the full contraction, the outputs of the first, last and one
      random interior row and column tile.  Each output of the plain
      version depends only on its row and column, so those rows and
      columns of every shape of one form and contraction length are
      stacked into one plain run, and each shape's block is read back.
      That run is the CPU lane's, on the same operands copied to the
      host, in a worker of ``pool`` (the runs of one call in parallel, and
      beside the card's later work): on blocks this small each step of
      the plain loop is launch-bound on the card, and a head's dX walks
      up to 256 256 steps (the two lanes are bit-exact, phases 3 and 9a).

    The plain version of row 1 with the empty epilogue is row 5's (the
    epilogue is the identity).  The plain version's time at the full
    contraction is not measured here: each shape's plain run over its
    first ``PLAIN_STEPS`` steps is timed on the card and logged, with
    that time scaled to the contraction as an extrapolation.  Returns
    ({row: max |diff|}, the number of shapes, ``finish``): ``finish()``
    waits for the plain runs, holds the edge tiles against them and
    completes the first dict."""
    import numpy as np
    from repro_torch.core import DELTA_DEFAULT, LNS16
    from repro_torch.kernels import lns_matmul as K
    kw = dict(fmt=LNS16, spec=DELTA_DEFAULT)
    rng = np.random.default_rng(seed)
    log_tag = f"{tag} kernels"
    groups = {}
    for row, r, c, ct, _ in products:
        form = {"lns_matmul_fused": "lns_matmul"}.get(row, row)
        groups.setdefault((form, ct), {})[row, r, c, ct] = None
    worst, n, pending = {}, 0, []

    def fail_on(err, row, what):
        worst[row] = max(worst.get(row, 0), err)
        if err:
            raise AssertionError(f"{tag} {row} {what}: max |diff| {err}")

    for (form, ct), shapes in groups.items():
        dw, dx = form == "lns_matmul_dw", form == "lns_matmul_dx"
        pk = dict(a_contract_axis=0 if dw else 1,
                  b_contract_axis=1 if dx else 0, **kw)
        if form == "lns_matmul":
            pk["fwd_epilogue"] = K.FwdEpilogue()
        a_parts, b_parts, blocks = [], [], []
        for row, r, c, _ in shapes:
            fn = getattr(K, row)
            ep = dict(epilogue=K.FwdEpilogue()) \
                if row == "lns_matmul_fused" else {}
            a, b = lm_operands(torch, device, form, r, c, SHORT_CT)
            got = fn(a.code, a.sign, b.code, b.sign, **ep, **kw)
            want = K.mac_plain(a.code, a.sign, b.code, b.sign, **pk)
            fail_on(max(int((g.long() - w.long()).abs().max())
                        for g, w in zip(got, want)),
                    row, f"({r} x {c}) over {SHORT_CT}, every output")
            del a, b, got, want
            a, b = lm_operands(torch, device, form, r, c, ct)
            got = fn(a.code, a.sign, b.code, b.sign, **ep, **kw)
            ri = torch.tensor(_tile_rows(r, 4, rng), device=device)
            ci = torch.tensor(_tile_rows(c, 32, rng), device=device)
            blocks.append((row, r, c, [g[ri][:, ci].cpu() for g in got]))
            a_parts.append([t.index_select(1 if dw else 0, ri).cpu()
                            for t in (a.code, a.sign)])
            b_parts.append([t.index_select(0 if dx else 1, ci).cpu()
                            for t in (b.code, b.sign)])
            steps = min(ct, PLAIN_STEPS)
            a_cut = [t[:steps] if dw else t[:, :steps]
                     for t in (a.code, a.sign)]
            b_cut = [t[:, :steps] if dx else t[:steps]
                     for t in (b.code, b.sign)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            K.mac_plain(*a_cut, *b_cut, **pk)
            torch.cuda.synchronize()
            cut_ms = (time.perf_counter() - t0) * 1e3
            log(log_tag, f"{row} ({r} x {c}) over {ct}: the plain "
                f"version on the card over its first {steps} steps "
                f"{cut_ms:.3f} ms (extrapolated to the whole contraction, "
                f"not measured: {cut_ms * ct / steps:.1f} ms)")
            del a, b, got, a_cut, b_cut
        a_axis, b_axis = (1 if dw else 0), (0 if dx else 1)
        pending.append((ct, blocks, pool.submit(
            _plain_run,
            *[torch.cat([p[i] for p in a_parts], a_axis) for i in (0, 1)],
            *[torch.cat([p[i] for p in b_parts], b_axis) for i in (0, 1)],
            pk)))
        n += len(shapes)

    def finish():
        t0 = time.time()
        for ct, blocks, future in pending:
            want = future.result()
            r0 = c0 = 0
            for row, r, c, got in blocks:
                h, w = got[0].shape
                fail_on(max(int((g.long() - q[r0:r0 + h, c0:c0 + w].long()
                                 ).abs().max()) for g, q in zip(got, want)),
                        row, f"({r} x {c}) over {ct}")
                log(log_tag, f"{row} ({r} x {c}) over {ct}: bit-exact "
                    f"against the plain version (CPU lane) at {h} x {w} "
                    f"outputs of the first, last and one interior row and "
                    f"column tile; every output bit-exact over {SHORT_CT} "
                    f"steps (card)")
                r0, c0 = r0 + h, c0 + w
        log(log_tag, f"the plain runs' edge tiles held; waited "
            f"{time.time() - t0:.1f} s for them")
    return worst, n, finish


def _serve_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(3, cfg.vocab_size, size=n) for n in SERVE_PROMPTS]


def serve_engine(torch, device, card, cfg, params, name):
    """10d: a ``ServingEngine`` on the card (greedy, ``SERVE_BATCH``
    slots, chunk ``SERVE_CHUNK``, blocks of ``SERVE_BLOCK``), run twice
    over ``SERVE_PROMPTS``: the same outputs, equal to the port's
    ``reference_generate`` on the card for every request, the pool
    conserved, row 1 launched once per serving linear per decode step and
    prefill chunk and nothing else.  Returns the row-1 launches, the
    engine's stats and its tokens a second."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeConfig, ServingEngine, \
        reference_generate
    sc = ServeConfig(max_batch=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                     block_size=SERVE_BLOCK, prefill_chunk=SERVE_CHUNK)
    prompts = _serve_prompts(cfg)
    outs, launches = [], 0
    n_lin = len(lm_linears(cfg, True)) + 1
    for rep in range(2):
        eng = ServingEngine(cfg, params, sc)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.run(prompts, max_new=SERVE_NEW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        eng.bm.check_conserved()
        st = eng.stats
        want = {"lns_matmul_fused": n_lin * (st["decode_steps"]
                                             + st["prefill_chunks"])}
        if counts != want:
            raise AssertionError(f"10d {name}: launches {counts}, expected "
                                 f"{want}")
        launches += counts["lns_matmul_fused"]
        tokens = sum(len(o) for o in out)
        log("10d serve", f"{name} run {rep + 1}: {len(prompts)} requests, "
            f"{tokens} tokens in {dt:.3f} s ({tokens / dt:.2f} tokens a "
            f"second, host clock ending in a synchronize); "
            f"{st['decode_steps']} decode steps, {st['prefill_chunks']} "
            f"prefill chunks, occupancy {eng.occupancy:.2f}; row-1 launches "
            f"{counts['lns_matmul_fused']} ({n_lin} a forward) on {card}")
        outs.append(out)
    if outs[0] != outs[1]:
        raise AssertionError(f"10d {name}: the engine's two runs differ: "
                             f"{outs}")
    t0 = time.perf_counter()
    refs = [reference_generate(cfg, params, p, SERVE_NEW,
                               max_len=SERVE_MAX_LEN) for p in prompts]
    if outs[0] != refs:
        raise AssertionError(f"10d {name}: engine {outs[0]} vs "
                             f"reference_generate {refs}")
    log("10d serve", f"{name}: the engine's outputs equal the port's "
        f"reference_generate on the card for all {len(prompts)} requests "
        f"(the oracle in {time.perf_counter() - t0:.1f} s); outputs "
        f"{outs[0]}")
    return launches, eng.stats


def serve_decode_times(torch, device, card, cfg, params):
    """10d: ms of one ``decode_step_paged`` with every slot active (CUDA
    events and host clock), its row-1 launches, and row 1's card ms,
    plain ms and bound at each decode shape, the largest (the head) on its
    own line."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.nn import decode_step_paged, init_paged_caches
    from repro_torch.core.spec import TORCH_DTYPES
    w = -(-SERVE_MAX_LEN // SERVE_BLOCK)
    caches = init_paged_caches(cfg, 1 + SERVE_BATCH * w, SERVE_BLOCK,
                               TORCH_DTYPES[cfg.param_dtype], device=device)
    bt = torch.arange(1, 1 + SERVE_BATCH * w, dtype=torch.int32,
                      device=device).reshape(SERVE_BATCH, w)
    pos = torch.arange(20, 20 + SERVE_BATCH, dtype=torch.int32,
                       device=device)
    tok = torch.arange(3, 3 + SERVE_BATCH, dtype=torch.int32,
                       device=device)[:, None]
    act = torch.ones(SERVE_BATCH, dtype=torch.bool, device=device)

    def call():
        with torch.no_grad():
            return decode_step_paged(params, tok, caches, bt, pos, act, cfg)
    call()
    torch.cuda.synchronize()
    reset_launch_counts()
    call()
    one = {k: v for k, v in launch_counts().items() if v}
    host_ms = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 3
    log("10d serve", f"decode_step_paged, {SERVE_BATCH} slots active at "
        f"positions 20-{19 + SERVE_BATCH}: {step_ms:.3f} ms a step by CUDA "
        f"events, host clock {host_ms} ms; launches {one} on {card}")
    dev_us, kern, _ = profile_call(torch, call)
    if dev_us:
        log("10d profile", f"one decode step: {dev_us:.1f} us of device "
            f"time in {sum(k[1] for k in kern)} kernel launches; busy share "
            f"{dev_us / (step_ms * 1e3):.4f} on {card}")
        for dev, count, key in kern[:6]:
            log("10d profile", f"{dev:12.1f} us {count:5d} launches  "
                f"{key[:70]}")
    else:
        log("10d profile", "torch.profiler saw no device time: not "
            "measured")
    return one, step_ms


def serve_head_plain(torch, device, head):
    """10d: the plain version's ms at the largest decode shape (the head),
    over its whole contraction on the card (host clock ending in a
    synchronize), its every output held bit for bit against row 1's."""
    from repro_torch.core import DELTA_DEFAULT, LNS16
    from repro_torch.kernels import lns_matmul as K
    row, r, c, ct, _ = head
    kw = dict(fmt=LNS16, spec=DELTA_DEFAULT)
    a, b = lm_operands(torch, device, "lns_matmul", r, c, ct)
    got = K.lns_matmul_fused(a.code, a.sign, b.code, b.sign,
                             epilogue=K.FwdEpilogue(), **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = K.mac_plain(a.code, a.sign, b.code, b.sign, a_contract_axis=1,
                       b_contract_axis=0, fwd_epilogue=K.FwdEpilogue(), **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    if err:
        raise AssertionError(f"10d {row} ({r} x {c}) over {ct}: max |diff| "
                             f"{err}")
    log("10d row 1", f"{row} ({r} x {c}) over {ct}: every output bit-exact "
        f"against the plain version on the card; plain {ms:.1f} ms")
    return ms


def profile_call(torch, fn):
    """(device µs, [(µs, launches, kernel)] largest first, wall µs) of one
    call of ``fn`` under torch.profiler, the wall time ending in a
    synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us, kern = 0.0, []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            dev_us += dev
            kern.append((dev, e.count, e.key))
    kern.sort(reverse=True)
    return dev_us, kern, wall_us


def phase10(torch, device, card):
    """Phase 10; returns ({row: max |diff|}, {row: 10c step timing},
    {row 1 serving timing}, {row: launches of phase 10's card runs})."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as serve_cli
    from repro_torch.nn import init_params
    t0 = time.time()
    worst, n = moe_kernels(torch, device)
    log("10a kernels", f"{n} shapes in {time.time() - t0:.1f} s")
    launches = card_vs_cpu(torch, device, MOE_ARCHS, "10b")
    log("10b lm card vs cpu", f"in {time.time() - t0:.1f} s")
    cfg = moe_full_cfg()
    rows, counts, _ = lm_full_width(torch, device, card, None, cfg=cfg,
                                 name=MOE_FULL_ARCH, tag="10c", fp32=False)
    for k, v in counts.items():
        launches[k] += v
    log("10c full width", f"in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    params = init_params(torch.Generator(device=device).manual_seed(SEED),
                         cfg, device=device)
    served, stats = serve_engine(torch, device, card, cfg, params,
                                 f"{MOE_FULL_ARCH} full width, "
                                 f"{MOE_FULL_LAYERS} layers")
    one, step_ms = serve_decode_times(torch, device, card, cfg, params)
    served += one.get("lns_matmul_fused", 0)
    decode = serve_products(cfg, SERVE_BATCH, SERVE_BATCH)
    prefill = serve_products(cfg, SERVE_CHUNK, 1)
    serve_rows = {}
    for what, prods in (("decode", decode), ("prefill", prefill)):
        q = lm_time_products(torch, device, prods, card, None,
                             tag="10d row 1")["lns_matmul_fused"]
        serve_rows[what] = q
        log("10d row 1", f"per {what} forward at full width: {q['ms']:.4f} "
            f"ms on the card in {q['launches']} launches; plain not "
            f"measured; bound {q['bound_ms']:.4f} ms by {q['bound_by']} on "
            f"{card}")
    head = max(decode, key=lambda p: p[1] * p[2] * p[3])
    head_plain_ms = serve_head_plain(torch, device, head)
    q = lm_time_products(torch, device, [head], card,
                         {head[:4]: head_plain_ms},
                         tag="10d row 1")["lns_matmul_fused"]
    serve_rows["largest_decode"] = dict(q, shape=head[1:4])
    log("10d row 1", f"largest decode shape (R, C, CT) = {head[1:4]}: "
        f"{q['ms']:.4f} ms on the card, bound {q['bound_ms']:.4f} ms by "
        f"{q['bound_by']}, plain {q['plain_ms']:.1f} ms (measured at the "
        f"full shape); the decode step {step_ms:.3f} ms makes "
        f"{one.get('lns_matmul_fused', 0)} row-1 launches on {card}")
    del params
    torch.cuda.empty_cache()
    small = reduced(get_config("olmo-1b")).with_(
        numerics="lns16-train-pallas", remat="none", param_dtype="float32")
    s_params = init_params(SEED, small, device=device)
    n_small, _ = serve_engine(torch, device, card, small, s_params,
                              "reduced(olmo-1b), paged GQA")
    served += n_small
    reset_launch_counts()
    outs = serve_cli.main(["--arch", MOE_FULL_ARCH, "--numerics",
                           "lns16-train-pallas"])
    counts = {k: v for k, v in launch_counts().items() if v}
    if not outs or set(counts) != {"lns_matmul_fused"}:
        raise AssertionError(f"10d serve CLI: outputs {outs}, launches "
                             f"{counts}")
    served += counts["lns_matmul_fused"]
    log("10d serve cli", f"repro_torch.launch.serve.main (the CLI's entry "
        f"point) with --arch {MOE_FULL_ARCH} --numerics lns16-train-pallas: "
        f"{len(outs)} requests served on the card; launches {counts}")
    launches["lns_matmul_fused"] = served
    log("10", f"phase 10 in {time.time() - t0:.1f} s")
    return worst, rows, serve_rows, launches


# ------------------------------------------------------------ phase 11 --

FAMILY_ARCHS = ("mamba2-370m", "zamba2-7b", "seamless-m4t-medium")
#: 11c: each model at its published widths, depth cut: (config overrides,
#: batch, seq).  mamba2-370m 2 of 48 layers, two SSD chunks of 256;
#: zamba2-7b 7 of 81 layers (one group of 6 and the shared block, then a
#: tail layer); seamless-m4t-medium 1 encoder and 1 decoder layer of 12
#: each, over as many frames as tokens.
FAMILY_FULL = {"mamba2-370m": ({"n_layers": 2}, 1, 512),
               "zamba2-7b": ({"n_layers": 7}, 1, 512),
               "seamless-m4t-medium": ({"encdec": (1, 1)}, 2, 128)}
#: 11b, lns16-train card vs CPU lane: arch → (first step's loss rtol,
#: every step's, update relative L2).  mamba2-370m at 9b's holds;
#: zamba2-7b and seamless-m4t-medium at the bounds of their CPU tests
#: against the JAX package (tests/test_torch_lm_families_lns_steps.py:
#: TIERS; ROADMAP queue 3 item 13): card and CPU part the same way, by
#: float32 ulps that move codes (a first try at 9b's holds read 2.66e-3
#: for zamba2-7b's first step and 0.560 for its update).
FAMILY_HOLDS = {"zamba2-7b": (1e-2, 1e-2, 0.75),
                "seamless-m4t-medium": (2e-2, 2e-2, 0.9)}
#: 11d: ``reference_generate``'s prompt length, new tokens and positions.
GEN_PROMPT, GEN_NEW, GEN_MAX_LEN = 8, 16, 32


def family_full_cfg(arch):
    from repro_torch.configs import get_config
    from repro_torch.nn.config import EncDecConfig
    kw = dict(FAMILY_FULL[arch][0])
    if "encdec" in kw:
        kw["encdec"] = EncDecConfig(*kw["encdec"])
    return get_config(arch).with_(numerics="lns16-train-pallas",
                                  remat="none", **kw)


def family_generate(torch, device, card):
    """11d: ``reference_generate`` on the card, greedy, ``GEN_NEW`` new
    tokens, twice for each reduced config and for full-width mamba2-370m
    (2 layers): the two runs equal, row 5 launched once per serving
    linear and once for the head at each ``decode_step``; tokens a
    second; then one full-width decode step timed (CUDA events) beside
    row 5's card time at its shapes.  Returns (row-5 launches, the decode
    step's ms, row 5's timing at the decode shapes)."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.spec import TORCH_DTYPES
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.nn import decode_step, init_decode_caches, init_params
    from repro_torch.serve import reference_generate
    full = family_full_cfg("mamba2-370m")
    cases = [(f"reduced({a})", reduced(get_config(a)).with_(
        numerics="lns16-train-pallas", remat="none"))
        for a in FAMILY_ARCHS] + [("mamba2-370m full width, 2 layers", full)]
    launches = 0
    for name, cfg in cases:
        params = init_params(torch.Generator(device=device).manual_seed(
            SEED), cfg, device=device)
        if cfg is full:
            full_params = params
        prompt = np.random.default_rng(SEED).integers(
            3, cfg.vocab_size, size=GEN_PROMPT)
        outs = []
        for rep in range(2):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = reference_generate(cfg, params, prompt, GEN_NEW,
                                     max_len=GEN_MAX_LEN)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: v for k, v in launch_counts().items() if v}
            steps = len(prompt) + len(out) - 1
            want = {"lns_matmul": steps * (len(lm_linears(cfg, True)) + 1)}
            if counts != want:
                raise AssertionError(f"11d {name}: launches {counts}, "
                                     f"expected {want}")
            launches += counts["lns_matmul"]
            log("11d generate", f"{name} run {rep + 1}: {len(out)} tokens "
                f"after a prompt of {len(prompt)} in {dt:.3f} s "
                f"({len(out) / dt:.2f} new tokens a second, {steps} "
                f"decode steps, host clock ending in a synchronize); "
                f"row-5 launches {counts['lns_matmul']} on {card}")
            outs.append(out)
        if outs[0] != outs[1]:
            raise AssertionError(f"11d {name}: two runs differ: {outs}")
        log("11d generate", f"{name}: the two runs are equal: {outs[0]}")
    caches = init_decode_caches(full, 1, GEN_MAX_LEN,
                                TORCH_DTYPES[full.param_dtype],
                                device=device)
    tok = torch.full((1, 1), 5, dtype=torch.int32, device=device)
    pos = torch.zeros(1, dtype=torch.int32, device=device)

    def call():
        with torch.no_grad():
            return decode_step(full_params, tok, caches, pos, full)
    call()
    torch.cuda.synchronize()
    reset_launch_counts()
    call()
    one = {k: v for k, v in launch_counts().items() if v}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        call()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 5
    q = lm_time_products(torch, device,
                         serve_products(full, 1, 1, row="lns_matmul"), card,
                         None, tag="11d row 5")["lns_matmul"]
    log("11d decode", f"mamba2-370m full width, 2 layers, one decode_step "
        f"of 1 sequence: {step_ms:.3f} ms by CUDA events; row 5 "
        f"{q['ms']:.4f} ms of it in {q['launches']} launches "
        f"({q['ms'] / step_ms:.4f}), bound {q['bound_ms']:.4f} ms by "
        f"{q['bound_by']}; launches {one} on {card}")
    return launches, step_ms, q


def phase11(torch, device, card):
    """Phase 11; returns ({row: max |diff|}, {arch: ({row: 11c step
    timing}, step stats)}, the 11d decode timing, {row: launches of
    phase 11's card runs})."""
    t0 = time.time()
    products = []
    for arch in FAMILY_ARCHS:
        _, batch, seq = FAMILY_FULL[arch]
        products += lm_products(family_full_cfg(arch), batch, seq)
    products += serve_products(family_full_cfg("mamba2-370m"), 1, 1,
                               row="lns_matmul")
    with plain_pool() as pool:
        worst, n, finish = hold_products(torch, device, products, "11a",
                                         SEED + 11, pool)
        log("11a kernels", f"{n} shapes on the card in "
            f"{time.time() - t0:.1f} s; their edge tiles' plain runs go on "
            f"in {PLAIN_WORKERS} host processes")
        launches, rows, q, step_ms = phase11_runs(torch, device, card, t0)
        finish()
    log("11", f"phase 11 in {time.time() - t0:.1f} s")
    return worst, rows, dict(q, step_ms=step_ms), launches


def phase11_runs(torch, device, card, t0):
    """11b-11e; returns ({row: launches}, {arch: 11c timing}, the 11d row
    5 timing, the 11d decode step's ms)."""
    launches = card_vs_cpu(torch, device, FAMILY_ARCHS, "11b",
                           holds=FAMILY_HOLDS)
    log("11b lm card vs cpu", f"in {time.time() - t0:.1f} s")
    rows = {}
    for arch in FAMILY_ARCHS:
        _, batch, seq = FAMILY_FULL[arch]
        torch.cuda.empty_cache()
        r, counts, stats = lm_full_width(
            torch, device, card, None, cfg=family_full_cfg(arch), name=arch,
            tag="11c", fp32=False, batch=batch, seq=seq)
        rows[arch] = (r, stats)
        for k, v in counts.items():
            launches[k] += v
        log("11c full width", f"{arch} in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    n_gen, step_ms, q = family_generate(torch, device, card)
    launches["lns_matmul"] += n_gen
    log("11d generate", f"in {time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        for k, v in lm_cli(torch, tmp, arch="zamba2-7b", tag="11e").items():
            launches[k] += v
    return launches, rows, q, step_ms


# ------------------------------------------------------------ phase 12 --

#: 12a: the tiled form's rows per block held besides phase 3's 4, and the
#: shapes.  12b: the shapes the tuner times, as autotune's (op, (R, C,
#: CT)): the MLP forward at predict's batch of 500, the 10d decode head
#: (row 1 at 4 rows over d_model 2048 into the 102 400-entry vocabulary)
#: and one 9c forward (olmo-1b's up-projection over 256 tokens); the MLP's
#: three products of each layer at batch 5 are primed on top.
ROWS_ALT = (1, 2, 8)
ROWS_CT, ROWS_R, ROWS_C = (13, 45, 784), (1, 4, 5, 16, 37), (1, 33, 100)
ROWS_LM = (("lns_matmul", 256, 8192, 2048),
           ("lns_matmul_fused", 4, 102400, 2048))
TUNE_SHAPES = (("fwd", (500, 100, 784)), ("fwd", (500, 10, 100)),
               ("fwd", (4, 102400, 2048)), ("fwd", (256, 8192, 2048)))
#: 12d: the search's files, and how long its CPU-lane twin may take.
SEARCH_FILES = ("--journal", "journal.jsonl", "--out", "search.json",
                "--report", "report.md", "--winner-out", "winner.txt")
SEARCH_CPU_TIMEOUT = 900


def tiled_rows(torch, device):
    """12a: the tiled ⊞-MAC at 1, 2 and 8 rows a block, bit for bit against
    the plain version: the forward with no epilogue and with the hidden
    layer's (bias, llReLU, requantize, z sign), for the lut, bitshift and
    exact Δ kinds, lns16 and lns12, at every (CT, R, C) of ``ROWS_CT`` ×
    ``ROWS_R`` × ``ROWS_C``, against the CPU lane's plain version of the
    same operands in :func:`plain_pool`'s workers (the two lanes are
    bit-exact, phase 3), once a case; then ``ROWS_LM``'s shapes, every
    output over a contraction cut to ``SHORT_CT`` steps, against the plain
    version on the card.  Returns ({row: max |diff|}, cases)."""
    from repro_torch.core import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_EXACT,
                                  LNS12, LNS16, LNSArray, beta_code)
    from repro_torch.kernels import lns_matmul as K
    worst = {"lns_matmul": 0, "lns_matmul_fused": 0}
    cases = 0

    def hold(row, got, want, label):
        nonlocal cases
        for rows, planes in got.items():
            err = max(int((g.long() - w.long()).abs().max())
                      for g, w in zip(planes, want))
            worst[row] = max(worst[row], err)
            if len(planes) != len(want) or err:
                raise AssertionError(f"12a {row} {label} at {rows} rows a "
                                     f"block: max |diff| {err}")
            cases += 1

    rk = torch.Generator().manual_seed(SEED + 12)
    pending = []
    with plain_pool() as pool:
        for spec in (DELTA_DEFAULT, DELTA_BITSHIFT, DELTA_EXACT):
            for fmt, other in ((LNS16, LNS12), (LNS12, LNS16)):
                kw = dict(fmt=fmt, spec=spec)
                ep = K.FwdEpilogue(bias=True,
                                   llrelu_beta=beta_code(0.01, fmt),
                                   dst_fmt=other, emit_z_sign=True)
                for ct in ROWS_CT:
                    for r in ROWS_R:
                        for c in ROWS_C:
                            host = fwd_case(torch, rk, r, ct, c, fmt, "cpu")
                            x, w, b = (t.to(device) for t in host)
                            planes = (x.code, x.sign, w.code, w.sign)
                            bk = dict(bias_code=b.code, bias_sign=b.sign)
                            # Private copies: the pool's feeder thread moves
                            # what it sends into shared memory later.
                            hx, hw, hb = (LNSArray(t.code.clone(),
                                                   t.sign.clone())
                                          for t in host)
                            hplanes = (hx.code, hx.sign, hw.code, hw.sign)
                            fwd = dict(a_contract_axis=1, b_contract_axis=0,
                                       **kw)
                            for row, call, pk in (
                                    ("lns_matmul", lambda n: K.lns_matmul(
                                        *planes, block_rows=n, **kw), fwd),
                                    ("lns_matmul_fused",
                                     lambda n: K.lns_matmul_fused(
                                         *planes, epilogue=ep, block_rows=n,
                                         **bk, **kw),
                                     dict(fwd, fwd_epilogue=ep,
                                          bias_code=hb.code,
                                          bias_sign=hb.sign))):
                                got = {n: [t.cpu() for t in call(n)]
                                       for n in ROWS_ALT}
                                pending.append((
                                    row, got, pool.submit(
                                        _plain_run, *hplanes, pk),
                                    f"{spec.kind}/{fmt.name}/CT{ct}/R{r}"
                                    f"/C{c}"))
        kw = dict(fmt=LNS16, spec=DELTA_DEFAULT)
        for row, r, c, ct in ROWS_LM:
            a, b = lm_operands(torch, device, "lns_matmul", r, c, SHORT_CT)
            planes = (a.code, a.sign, b.code, b.sign)
            ep = dict(epilogue=K.FwdEpilogue()) \
                if row == "lns_matmul_fused" else {}
            hold(row, {n: getattr(K, row)(*planes, block_rows=n, **ep, **kw)
                       for n in ROWS_ALT},
                 K.mac_plain(*planes, a_contract_axis=1, b_contract_axis=0,
                             **kw), f"({r} x {c}) over {SHORT_CT} of {ct}")
            del a, b, planes
        torch.cuda.synchronize()
        for row, got, future, label in pending:
            hold(row, got, future.result(), label)
    return worst, cases


@contextlib.contextmanager
def tuner_cache():
    """The autotuner's cache in a temporary directory for the block
    (``LNS_AUTOTUNE_DIR``), its in-memory caches emptied on entry and
    exit."""
    import os
    from repro_torch.kernels import autotune
    old = os.environ.get("LNS_AUTOTUNE_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["LNS_AUTOTUNE_DIR"] = tmp
        autotune.clear_caches()
        try:
            yield
        finally:
            autotune.clear_caches()
            if old is None:
                os.environ.pop("LNS_AUTOTUNE_DIR", None)
            else:
                os.environ["LNS_AUTOTUNE_DIR"] = old


def mac_bound(r, c, ct):
    """The bound of one forward ⊞-MAC launch at (R, C, CT), as phase 6
    reckons rows 1 and 5: (bytes, int32 operations, ms, by)."""
    nbytes = 5 * (r * ct + ct * c + r * c)
    ops = r * c * ct * OPS_PER_MAC
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return nbytes, ops, max(t_b, t_o) * 1e3, \
        "bytes" if t_b > t_o else "operations"


def tuner_on_card(torch, card):
    """12b: the autotuner on the card, its cache in a temporary directory:
    each tiled candidate of ``TUNE_SHAPES`` and of the MLP's products
    (``prime_matmul`` at batch 5) timed by CUDA events and printed beside
    its bound; a second lookup served from the cache; a corrupt cache
    quarantined; short-form and ⊞-reduce lookups writing nothing.  Returns
    {row: {"op RxCxCT": {rows: ms, ..., bound_ms, chosen}}}."""
    import os
    import warnings
    from repro_torch.core import DELTA_DEFAULT, LNS16
    from repro_torch.kernels import autotune, build
    lib = build.load_library()
    if (lib.lns_short_steps(), lib.lns_max_table()) != (
            autotune.SHORT_STEPS, autotune.MAX_TABLE):
        raise AssertionError("12b: the tuner's copies of kShortSteps / "
                             "kMaxTab disagree with the library")
    kw = dict(fmt=LNS16, spec=DELTA_DEFAULT)
    rows_of = {"fwd": "lns_matmul", "dx": "lns_matmul_dx",
               "dw": "lns_matmul_dw"}
    table, timed = {}, {}

    def measure(op, shape, blocks):
        ms = autotune._measure_ms(autotune._bench_launcher(
            op, shape, blocks, LNS16, DELTA_DEFAULT, False), reps=5)
        timed[op, shape, blocks] = ms
        return ms

    def record(op, shape, chosen):
        r, c, ct = shape
        _, _, bound, by = mac_bound(r, c, ct)
        ms = {str(b[0]): timed[op, shape, b]
              for b in autotune.candidate_blocks(op, shape)}
        table.setdefault(rows_of[op], {})[f"{op} {r}x{c}x{ct}"] = dict(
            ms, bound_ms=bound, bound_by=by, chosen=chosen[0])
        log("12b tuner", f"{op} ({r}, {c}, {ct}): "
            + ", ".join(f"{w} rows {t:.5f} ms" for w, t in ms.items())
            + f"; bound {bound:.5f} ms by {by}; chose {chosen[0]} rows "
            f"on {card}")

    with tuner_cache():
        for m, k, n in ((BATCH, 784, 100), (BATCH, 100, 10)):
            got = autotune.prime_matmul(m, k, n, **kw, measure=True,
                                        measure_fn=measure)
            for op, shape in (("fwd", (m, n, k)), ("dx", (m, k, n)),
                              ("dw", (k, n, m))):
                if autotune.tiled(op, shape):
                    record(op, shape, got[op])
                elif got[op] != autotune.fixed_geometry(op, shape):
                    raise AssertionError(f"12b {op} {shape}: {got[op]}")
        for op, shape in TUNE_SHAPES:
            record(op, shape, autotune.lookup(op, shape, **kw,
                                              measure=True,
                                              measure_fn=measure))
        n_entries = len(autotune._load_disk())

        def refuse(*a):
            raise AssertionError("12b: a cached lookup measured again")
        autotune.clear_caches()
        for op, shape in TUNE_SHAPES:
            want = table["lns_matmul"][
                f"{op} {'x'.join(map(str, shape))}"]["chosen"]
            if autotune.lookup(op, shape, **kw, measure=True,
                               measure_fn=refuse)[0] != want:
                raise AssertionError(f"12b {op} {shape}: the cache "
                                     f"gave another choice")
        for op, shape in (("dw", (784, 100, BATCH)),
                          ("dx", (BATCH, 100, 10)),
                          ("dw_partials", (784, 100, 1)),
                          ("boxsum", (78400, 1, 5))):
            got = autotune.lookup(op, shape, **kw, measure=True,
                                  measure_fn=refuse)
            if got != autotune.fixed_geometry(op, shape):
                raise AssertionError(f"12b {op} {shape}: {got}")
        if len(autotune._load_disk()) != n_entries:
            raise AssertionError("12b: a fixed-geometry lookup wrote a "
                                 "cache entry")
        path = autotune.cache_path()
        with open(path, "w") as f:
            f.write('{"env": ')
        autotune.clear_caches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            autotune.lookup("fwd", (BATCH, 100, 784), **kw,
                            measure=True, measure_fn=lambda *a: 1.0)
        if not (os.path.exists(path + ".corrupt")
                and any("quarantined" in str(w.message)
                        for w in caught)):
            raise AssertionError("12b: the corrupt cache was not "
                                 "quarantined")
        log("12b tuner", f"{n_entries} entries persisted (every tiled "
            f"shape, no fixed-geometry op); the second lookups served "
            f"from the cache; a torn cache file quarantined")
    return table


def tiles_change_nothing(torch, device):
    """12c: the fused MLP's 20 steps and evaluation under ``blocks=auto``
    (the tuner's cache filled by a first, uncounted run) and
    ``blocks=1x32x32`` give the default's codes and accuracies and its
    launches (counters set to 0 before each counted run, read after); one
    reduced olmo-1b step under ``blocks=auto`` gives the default's loss and
    state bit for bit.  Returns {row: launches of the counted runs}."""
    from repro_torch.kernels import (KERNEL_WRAPPERS, autotune,
                                     launch_counts, reset_launch_counts)
    from repro_torch.paper import datasets, run_experiment
    from repro_torch.pytree import tree_leaves
    common = dict(epochs=1, max_steps_per_epoch=STEPS, batch_size=BATCH,
                  seed=SEED, device="cuda")
    x, _, xt, _, _ = datasets.load("mnist", "data", SEED)
    pbatches = math.ceil(len(x) // 6 / PREDICT_BATCH) + math.ceil(
        len(xt) / PREDICT_BATCH)
    want = dict(dict.fromkeys(KERNEL_WRAPPERS, 0),
                **path_launches(pbatches)["fused"][1])
    launches = dict.fromkeys(KERNEL_WRAPPERS, 0)
    with tuner_cache():
        base = run_experiment("lns", "mnist",
                              numerics="lns16-train-pallas", **common)
        for spec in ("lns16-train-pallas,blocks=auto",
                     "lns16-train-pallas,blocks=1x32x32"):
            if spec.endswith("auto"):
                run_experiment("lns", "mnist", numerics=spec, **common)
            reset_launch_counts()
            run = run_experiment("lns", "mnist", numerics=spec,
                                 **common)
            torch.cuda.synchronize()
            counts = launch_counts()
            if counts != want:
                raise AssertionError(f"12c {spec}: launches {counts}, "
                                     f"expected {want}")
            for k, v in counts.items():
                launches[k] += v
            for k, (c, s) in run.params.items():
                bc, bs = base.params[k]
                if not ((c == bc).all() and (s == bs).all()):
                    raise AssertionError(f"12c {spec}: {k} differs "
                                         f"from the default's")
            if (run.val_curve, run.test_acc) != (base.val_curve,
                                                 base.test_acc):
                raise AssertionError(f"12c {spec}: accuracy differs")
            log("12c tiles", f"{spec}: {STEPS} fused steps + evaluate "
                f"on the card, codes and accuracy equal to the "
                f"default's; launches {counts}")
        outs = {}
        for spec in ("lns16-train-pallas",
                     "lns16-train-pallas,blocks=auto"):
            if spec.endswith("auto"):
                lm_train(torch, "olmo-1b", spec, device, steps=1)
            losses, counts, _, (state, _, _) = lm_train(
                torch, "olmo-1b", spec, device, steps=1)
            outs[spec] = (losses, counts, tree_leaves(state))
        (l0, c0, s0), (l1, c1, s1) = outs.values()
        same = [torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b for a, b in zip(s0, s1)]
        if l0 != l1 or c0 != c1 or len(s0) != len(s1) or not all(same):
            raise AssertionError("12c: olmo-1b under blocks=auto "
                                 "differs from the default")
        for k, v in c1.items():
            launches[k] += v
        log("12c tiles", f"reduced olmo-1b, one step under blocks=auto: "
            f"loss {l1[0]} and every state tensor equal to the "
            f"default's; launches {c1}; "
            f"{len(autotune._load_disk())} shapes tuned")
    return launches


def start_cpu_search(tmp):
    """12d's CPU-lane twin: the same search in a worker process (the
    plain versions), started early so that it runs beside the card's
    work; returns the process, its directory and its log."""
    import os
    cwd = Path(tmp) / "cpu"
    cwd.mkdir()
    out = open(cwd / "log.txt", "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="4")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.search", "--smoke",
         "--selfcheck-resume", "--device", "cpu", "--data-dir",
         str(ROOT / "data"), *SEARCH_FILES], cwd=cwd, env=env, stdout=out,
        stderr=subprocess.STDOUT)
    return proc, cwd, out


def search_on_card(torch, tmp, cpu_run):
    """12d: ``python -m repro_torch.launch.search --smoke
    --selfcheck-resume --device cuda`` (its ``main``, in this process, so
    that the launch counters see it; counters set to 0 just before, read
    just after), its JSON equal to the CPU-lane twin's; then ``--measure
    --max-evals 3``.  Returns {row: launches of the smoke search}."""
    import os
    import repro_torch.launch.search as cli
    from repro_torch.kernels import launch_counts, reset_launch_counts
    card_dir = Path(tmp) / "card"
    card_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(card_dir)
    try:
        reset_launch_counts()
        t0 = time.time()
        try:
            result = cli.main(["--smoke", "--selfcheck-resume", "--device",
                               "cuda", "--data-dir", str(ROOT / "data"),
                               *SEARCH_FILES])
        except SystemExit as e:
            if e.code not in (None, 0):
                raise AssertionError(f"12d: the search exited {e.code}")
        torch.cuda.synchronize()
        card_s = time.time() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        for row in ("lns_matmul_fused", "lns_matmul_dx",
                    "lns_matmul_dw_update", "lns_fused_update"):
            if not counts.get(row):
                raise AssertionError(f"12d: the search launched no {row}")
        log("12d search", f"--smoke --selfcheck-resume on the card: "
            f"{len(result.evals)} evaluations, exit 0 in {card_s:.1f} s; "
            f"winner {result.winner and result.winner['plan']!r}; launches "
            f"{counts}")
        measured = cli.main(["--measure", "--max-evals", "3",
                             "--device", "cuda", "--data-dir",
                             str(ROOT / "data"), "--journal",
                             "measure.jsonl", "--out", "measure.json",
                             "--report", "measure.md", "--winner-out",
                             "measure.txt"])
        for row in measured.evals:
            log("12d search", f"--measure: {row['plan']}: "
                f"{row.get('ms_per_step', float('nan')):.4f} ms per train "
                f"step (the tuner's timer: CUDA events behind a spin, best "
                f"of 3), acc {row['acc']:.4f}")
    finally:
        os.chdir(cwd)
    proc, cpu_dir, out = cpu_run
    try:
        rc = proc.wait(timeout=SEARCH_CPU_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
    if rc != 0:
        raise AssertionError(f"12d: the CPU-lane search exited {rc}:\n"
                             + (cpu_dir / "log.txt").read_text()[-3000:])
    card_json = json.loads((card_dir / "search.json").read_text())
    cpu_json = json.loads((cpu_dir / "search.json").read_text())
    if card_json != cpu_json:
        raise AssertionError("12d: the card's search JSON differs from the "
                             "CPU lane's")
    log("12d search", f"the card's JSON ({len(card_json['rows'])} rows: "
        f"acc, cost, frontier, winner) equal to the CPU lane's "
        f"(worker process)")
    return counts


def phase12(torch, device, card):
    """Phase 12; returns ({row: max |diff|}, {row: rows-per-block timing
    table}, {row: launches of 12c and 12d's counted runs})."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        cpu_run = start_cpu_search(tmp)
        try:
            worst, cases = tiled_rows(torch, device)
            log("12a rows per block", f"{cases} cases bit-exact at "
                f"{ROWS_ALT} rows a block in {time.time() - t0:.1f} s")
            table = tuner_on_card(torch, card)
            log("12b tuner", f"in {time.time() - t0:.1f} s")
            launches = tiles_change_nothing(torch, device)
            log("12c tiles", f"in {time.time() - t0:.1f} s")
            for k, v in search_on_card(torch, tmp, cpu_run).items():
                launches[k] += v
        finally:
            proc = cpu_run[0]
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            cpu_run[2].close()
    log("12", f"phase 12 in {time.time() - t0:.1f} s")
    return worst, table, launches


# ------------------------------------------------------------ phase 13 --

#: 13a: the reduced configs through the one-rank mesh, card vs CPU lane.
MESH_ARCHS = ("olmo-1b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
              "zamba2-7b")
#: 13d: the paged decode's geometry (reduced deepseek-v2-lite-16b).
MESH_DECODE_SLOTS, MESH_DECODE_BLOCK, MESH_DECODE_STEPS = 4, 16, 4


def mesh_group(torch):
    """A one-rank process group over the card (NCCL) and the CPU (gloo),
    and a (data=1, model=1) mesh on each: ({device type: mesh}, a function
    that ends the group)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    tmp = tempfile.TemporaryDirectory()
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{tmp.name}/store",
                            world_size=1, rank=0)
    meshes = {t: make_mesh((1, 1), ("data", "model"), t)
              for t in ("cuda", "cpu")}

    def end():
        dist.destroy_process_group()
        tmp.cleanup()
    return meshes, end


def mesh_step_pair(torch, device, card, cfg, name, tag, meshes, batch, seq,
                   equal):
    """The same 3 AdamW steps of ``cfg`` on the card with no mesh and
    through the one-rank mesh; with ``equal`` the losses and every
    parameter must be bit-equal.  Logs ms per step, a profiled step's
    device ms, launches and peak memory of each; returns the mesh run's
    (losses, launches, the no-mesh losses, dropped assignments)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.nn import init_params
    from repro_torch.nn.moe import collect_drops
    from repro_torch.pytree import tree_leaves
    params = init_params(torch.Generator(device=device).manual_seed(SEED),
                         cfg, device=device)
    runs = {}
    for what, mesh in (("no mesh", None), ("mesh", meshes["cuda"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with collect_drops() as drops:
            losses, counts, ms, (state, step, ds) = lm_train(
                torch, name, None, device, cfg=cfg, params=params,
                batch=batch, seq=seq, mesh=mesh)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = sum(int(a) for a, _ in drops)
        dropped = sum(int(b) for _, b in drops)
        reset_launch_counts()
        b = ds.batch_on(LM_STEPS, device)
        if mesh is not None:
            from repro_torch.distributed.sharding import (batch_specs,
                                                          shard_tree)
            b = shard_tree(b, batch_specs(b), mesh)
        dev_us, _, wall_us = profile_call(
            torch, lambda: float(step(state, b)[1]["loss"]))
        runs[what] = (losses, counts, state["params"])
        dev = f"{dev_us / 1e3:.3f} ms" if dev_us else "not measured"
        log(f"{tag} {what}", f"{name}, batch {batch} x seq {seq}: losses "
            f"{losses}; ms per step {[round(x, 3) for x in ms]} (host "
            f"clock ending in a synchronize; the first includes warm-up); "
            f"a profiled step's device time {dev} of {wall_us / 1e3:.3f} ms; "
            f"launches {counts}; max_memory_allocated {peak:.3f} GiB"
            + (f"; {dropped} of {n} expert assignments dropped"
               if n else "") + f" on {card}")
    (l0, c0, p0), (l1, c1, p1) = runs["no mesh"], runs["mesh"]
    if c0 != c1:
        raise AssertionError(f"{tag}: launches {c1} through the mesh, "
                             f"{c0} without")
    if equal:
        same = l0 == l1 and all(torch.equal(a, b) for a, b in
                                zip(tree_leaves(p0), tree_leaves(p1)))
        if not same:
            raise AssertionError(f"{tag}: the one-rank mesh's steps differ "
                                 f"from the no-mesh steps: losses {l1} vs "
                                 f"{l0}")
        log(tag, "the one-rank mesh's losses and every parameter after 3 "
            "steps equal the no-mesh run's, bit for bit")
    return l1, c1, l0, (n, dropped)


def mesh_decode(torch, device, card, meshes):
    """13d: ``decode_step_paged`` of reduced deepseek-v2-lite-16b under
    lns16-train-pallas through the one-rank mesh (row 1), teacher-forced:
    the CPU lane decodes greedily through the mesh, and the card steps
    through the same tokens with and without it.  At tp 1 a one-token
    step's length divides the model axis, so ``moe_block`` takes
    ``moe_ep``, as the JAX package's dispatch does; ``moe_ep_replicated``
    needs tp > 1 and runs only in the 2- and 4-rank gloo tests.  Every
    step's logits through the mesh within 0.3 relative L2 of the CPU
    lane's (the lns16-train serving tier of
    ``tests/test_torch_serve_model.py``), and the same row-1 launches with
    and without the mesh; the assignments ``moe_ep``'s per-expert capacity
    drops and the gap to the no-mesh logits (the dropless MoE reference)
    are a finding.  Returns the card's row-1 launches through the mesh."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding import cache_specs, shard_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.nn import (Runtime, decode_step_paged,
                                init_paged_caches, init_params)
    from repro_torch.nn.moe import collect_drops
    cfg = reduced(get_config("deepseek-v2-lite-16b")).with_(
        numerics="lns16-train-pallas", remat="none")
    b, blk, steps = MESH_DECODE_SLOTS, MESH_DECODE_BLOCK, MESH_DECODE_STEPS
    w = -(-steps // blk)
    bt = 1 + torch.arange(b * w, dtype=torch.int32).reshape(b, w)
    gen = torch.Generator().manual_seed(SEED)
    first = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                          dtype=torch.int32)

    def run(dev, mesh, forced=None):
        params = init_params(SEED, cfg, device=dev)
        caches = init_paged_caches(cfg, 1 + b * w, blk, torch.float32,
                                   device=dev)
        if mesh is not None:
            caches = shard_tree(caches, cache_specs(caches, paged=True),
                                mesh)
        tok, toks, logits = first.to(dev), [first], []
        reset_launch_counts()
        with torch.no_grad(), collect_drops() as drops:
            for i in range(steps):
                lg, caches = decode_step_paged(
                    params, tok, caches, bt.to(dev),
                    torch.full((b,), i, dtype=torch.int32, device=dev),
                    torch.ones((b,), dtype=torch.bool, device=dev), cfg,
                    Runtime(mesh=mesh))
                tok = torch.argmax(lg[:, -1], -1, keepdim=True).to(
                    torch.int32) if forced is None else \
                    forced[i + 1].to(dev)
                toks.append(tok.cpu())
                logits.append(lg.cpu().double())
        dropped = (sum(int(a) for a, _ in drops),
                   sum(int(d) for _, d in drops))
        return (toks, logits, {k: v for k, v in launch_counts().items() if v},
                dropped)
    cpu_toks, cpu_lg, _, cpu_drops = run(torch.device("cpu"), meshes["cpu"])
    card_toks, card_lg, counts, drops = run(device, meshes["cuda"], cpu_toks)
    _, plain_lg, plain_counts, _ = run(device, None, cpu_toks)
    def rel(xs, ys):
        return [float((a - c).norm() / c.norm()) for a, c in zip(xs, ys)]
    gaps = rel(card_lg, cpu_lg)
    agree = [bool(torch.equal(a[:, -1].argmax(-1), c[:, -1].argmax(-1)))
             for a, c in zip(card_lg, cpu_lg)]
    log("13d decode", f"reduced deepseek-v2-lite-16b lns16-train-pallas, "
        f"{b} slots, {steps} decode_step_paged steps (moe_ep at tp 1, "
        f"paged MLA), the card teacher-forced on the CPU lane's greedy "
        f"tokens {torch.cat(cpu_toks, 1).tolist()}: logits relative L2 card "
        f"vs cpu per step {gaps} (tier 0.3); greedy tokens equal per step "
        f"{agree}; moe_ep dropped {drops[1]} of {drops[0]} expert "
        f"assignments on the card, {cpu_drops[1]} of {cpu_drops[0]} on the "
        f"cpu lane; the card's logits through the mesh vs without it "
        f"(dropless), relative L2 per step {rel(card_lg, plain_lg)}; card "
        f"launches "
        f"{counts} through the mesh, {plain_counts} without, on {card}")
    if max(gaps) > 0.3:
        raise AssertionError(f"13d: card vs cpu logits gaps {gaps}")
    if set(counts) != {"lns_matmul_fused"} or counts != plain_counts:
        raise AssertionError(f"13d: launches {counts} vs {plain_counts}")
    return counts["lns_matmul_fused"]


def phase13(torch, device, card):
    """Phase 13, sharded execution through a one-rank mesh (NCCL on the
    card, gloo for the CPU lane); returns ({row: launches}, {what: the
    numbers for the JSON line})."""
    t0 = time.time()
    meshes, end = mesh_group(torch)
    try:
        launches = card_vs_cpu(torch, device, MESH_ARCHS, "13a",
                               holds=FAMILY_HOLDS, meshes=meshes)
        log("13a mesh card vs cpu", f"in {time.time() - t0:.1f} s")
        t1 = time.time()
        _, counts, _, _ = mesh_step_pair(
            torch, device, card, full_width_cfg(), "olmo-1b", "13b",
            meshes, FULL_BATCH, FULL_SEQ, equal=True)
        for k, v in counts.items():
            launches[k] += v
        log("13b full width", f"in {time.time() - t1:.1f} s")
        t1 = time.time()
        l1, counts, l0, (n, dropped) = mesh_step_pair(
            torch, device, card, moe_full_cfg(), MOE_FULL_ARCH, "13c",
            meshes, FULL_BATCH, FULL_SEQ, equal=False)
        for k, v in counts.items():
            launches[k] += v
        log("13c full width", f"the mesh's moe_ep at tp 1 caps each expert "
            f"at cap_e: {dropped} of {n} assignments dropped over the 3 "
            f"steps; loss gap to the no-mesh (dropless) steps "
            f"{[a - b for a, b in zip(l1, l0)]}; in {time.time() - t1:.1f} "
            f"s")
        launches["lns_matmul_fused"] = mesh_decode(torch, device, card,
                                                   meshes)
    finally:
        end()
    log("13", f"phase 13 in {time.time() - t0:.1f} s")
    return launches


#: 14a: the dry run's cells (arch, --cell) on the fake (16, 16) world.
DRY_CELLS = (("olmo-1b", "all"), ("deepseek-v2-lite-16b", "decode_32k"))
#: 14b: the dry run's holds against the card.
DRY_ARG_RTOL, DRY_PEAK_RTOL = 0.01, 0.10
#: 14c: the example twins run on the card.
EXAMPLES = ("quickstart", "serve_batched")
CHILD_TIMEOUT = 600


def start_child(args, threads=None):
    """``python3 <args>`` with the port on the path (and ``threads``
    OpenMP threads), started."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return subprocess.Popen([sys.executable] + list(args), env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_child(proc, what):
    """The output of a :func:`start_child` process, or an AssertionError
    naming ``what`` with the end of its output; the process never
    outlives the call."""
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode:
        raise AssertionError(f"{what} exited {proc.returncode}: "
                             f"{(out + err)[-3000:]}")
    return out


def child(args, what):
    return finish_child(start_child(args), what)


def start_dryrun_cells(tmp):
    """14a's CLI runs, one child process for each of ``DRY_CELLS`` (a fake
    world needs a process with no group), each with its own output."""
    return [(arch, cell, Path(tmp) / f"dryrun_{i}.json", start_child(
        ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--cell", cell,
         "--out", str(Path(tmp) / f"dryrun_{i}.json")], threads=1))
        for i, (arch, cell) in enumerate(DRY_CELLS)]


def dryrun_cells(runs):
    """14a: the dry-run CLI's cells on the fake (16, 16) world; every cell
    must read ok."""
    res = {}
    for arch, cell, out, proc in runs:
        last = finish_child(proc, f"14a dryrun {arch} {cell}")
        log("14a dryrun", last.rstrip().splitlines()[-1])
        res.update(json.loads(out.read_text()))
    bad = [k for k, r in res.items() if not r.get("ok")]
    if bad or len(res) != 4:
        raise AssertionError(f"14a: cells not ok: {bad} of {sorted(res)}")
    for key, r in res.items():
        coll = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                         sorted(r["collectives"].items()))
        log("14a dryrun", f"{key}: per rank of {r['world']}, arguments "
            f"{r['arg_bytes'] / 2**30:.3f} GiB, temporaries "
            f"{r['temp_bytes'] / 2**30:.3f} GiB (peak "
            f"{(r['arg_bytes'] + r['temp_bytes']) / 2**30:.3f}), alias "
            f"{r['alias_bytes'] / 2**30:.3f} GiB, flops {r['flops']:.4e}, "
            f"bytes accessed {r['bytes_accessed']:.4e}; GB on the wire by "
            f"kind: {coll}; {r['trace_s']} s (counted on the host's CPU, "
            f"no device)")


def dry_14b_cfg():
    """14b's model: 9c's (olmo-1b at published widths, ``FULL_LAYERS``
    layers) in the config's own numerics (bf16) and remat."""
    from repro_torch.configs import get_config
    return get_config("olmo-1b").with_(n_layers=FULL_LAYERS)


DRY_14B = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import chip_smoke as C
from repro_torch.launch import dryrun as D
from repro_torch.nn.config import ShapeCell
with D.fake_world((1, 1), ("data", "model")) as mesh:
    rec = D.run_cell(C.dry_14b_cfg(),
                     ShapeCell("14b", C.FULL_SEQ, C.FULL_BATCH, "train"),
                     mesh)
print(json.dumps(rec))
"""


def card_bytes(torch, device, cell, mesh):
    """(arguments' bytes, peak bytes over the step) of 14b's step built by
    ``build_cell`` on the card, both less what was allocated before the
    arguments, and the loss; the cyclic collector off during the step, as
    in the dry run."""
    import gc
    from repro_torch.launch import dryrun as D
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    fn, args, _ = D.build_cell(dry_14b_cfg(), cell, mesh, device=device)
    torch.cuda.synchronize()
    arg_bytes = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    gc.disable()
    try:
        loss = float(fn(*args)[1]["loss"])
        torch.cuda.synchronize()
    finally:
        gc.enable()
    return arg_bytes, torch.cuda.max_memory_allocated() - base, loss


def dry_vs_card(torch, device, card, dry):
    """14b: the dry run's bytes for 9c's bf16 step against the card's
    allocator: arguments within ``DRY_ARG_RTOL`` of what the card
    allocates for them, the predicted peak within ``DRY_PEAK_RTOL`` of
    ``max_memory_allocated`` over the step.  The held call is the
    process's second: in the first step that runs
    ``torch.utils.checkpoint`` (remat ``block``), torch imports
    ``torch._dynamo`` on the way, and ``torch.fx``'s ``wrap`` keeps its
    calling frames (the step's among them) in a reference cycle, which
    holds the unclipped gradients until the collector runs; that call is
    printed beside.  A bf16 matmul runs first, so that cuBLAS's workspace
    is allocated before either."""
    from repro_torch.nn.config import ShapeCell
    cell = ShapeCell("14b", FULL_SEQ, FULL_BATCH, "train")
    w = torch.ones((64, 64), dtype=torch.bfloat16, device=device)
    (w @ w).sum().item()
    del w
    meshes, end = mesh_group(torch)
    try:
        first = card_bytes(torch, device, cell, meshes["cuda"])
        t0 = time.perf_counter()
        arg_bytes, peak, loss = card_bytes(torch, device, cell,
                                           meshes["cuda"])
        call_s = time.perf_counter() - t0
    finally:
        end()
    rec = json.loads(finish_child(dry, "14b dry run").splitlines()[-1])
    want = rec["arg_bytes"] + rec["temp_bytes"]
    g = 2**30
    split = ", ".join(f"{k} {v / g:.4f}" for k, v in
                      sorted(rec["peak_split"].items(), key=lambda kv: -kv[1]))
    log("14b dry vs card", f"olmo-1b bf16, {FULL_LAYERS} layers, batch "
        f"{FULL_BATCH} x seq {FULL_SEQ}, AdamW, grad_clip 1.0, remat "
        f"{dry_14b_cfg().remat}, through a (1, 1) mesh: arguments "
        f"{rec['arg_bytes'] / g:.4f} GiB predicted (meta, fake world) vs "
        f"{arg_bytes / g:.4f} GiB allocated on the card; peak "
        f"{want / g:.4f} GiB predicted vs {peak / g:.4f} GiB "
        f"max_memory_allocated (the process's first such step: "
        f"{first[1] / g:.4f} GiB); loss {loss:.5f} ({first[2]:.5f} first); "
        f"init and step {call_s:.1f} s on {card}")
    log("14b dry vs card", f"the dry run's live GiB at the peak by what "
        f"they hold: {split}; flops {rec['flops']:.4e}, bytes accessed "
        f"{rec['bytes_accessed']:.4e}, outputs {rec['out_bytes'] / g:.4f} "
        f"GiB, aliased {rec['alias_bytes'] / g:.4f} GiB")
    if abs(rec["arg_bytes"] - arg_bytes) > DRY_ARG_RTOL * arg_bytes:
        raise AssertionError(f"14b: arguments {rec['arg_bytes']} predicted, "
                             f"{arg_bytes} allocated")
    if abs(want - peak) > DRY_PEAK_RTOL * peak:
        raise AssertionError(f"14b: peak {want} predicted, {peak} measured")


def run_examples():
    """14c: the example twins on the card, each in a child process."""
    for name in EXAMPLES:
        t0 = time.time()
        out = child(["-m", f"repro_torch.examples.{name}"],
                    f"14c {name}").rstrip().splitlines()
        log("14c examples", f"python -m repro_torch.examples.{name} exit 0 "
            f"in {time.time() - t0:.1f} s; its last line: {out[-1]}")


def mesh_decode_rows(torch, device, card, decode_launches=None):
    """14d: row 1's card ms and bound at 13d's shapes, per decode step
    (``serve_products`` of 13d's model at ``MESH_DECODE_SLOTS`` rows);
    the products must launch as often a step as 13d's
    ``decode_launches`` over its steps (unchecked when None: phase 14
    run alone)."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("deepseek-v2-lite-16b")).with_(
        numerics="lns16-train-pallas", remat="none")
    products = serve_products(cfg, MESH_DECODE_SLOTS, MESH_DECODE_SLOTS)
    q = lm_time_products(torch, device, products, card, None,
                         tag="14d 13d row 1")["lns_matmul_fused"]
    want = q["launches"] if decode_launches is None else \
        decode_launches // MESH_DECODE_STEPS
    if q["launches"] != want:
        raise AssertionError(f"14d: {q['launches']} row-1 launches a step "
                             f"from the model's linears, 13d makes {want}")
    log("14d 13d row 1", f"{q['launches']} launches a decode step: "
        f"{q['ms']:.4f} ms on the card (CUDA events, each shape's launch "
        f"times its count), bound {q['bound_ms']:.4f} ms by "
        f"{q['bound_by']} on {card}")


def phase14(torch, device, card, decode_launches=None):
    """Phase 14: the dry run (14a, 14b), the example twins (14c) and row
    1 at 13d's shapes (14d; ``decode_launches``: 13d's row-1 launches).
    The dry runs are child processes on the host's CPU, started first and
    read after the card's work."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        runs = start_dryrun_cells(tmp)
        dry = start_child(["-c", DRY_14B], threads=1)
        try:
            dry_vs_card(torch, device, card, dry)
            log("14b dry vs card", f"in {time.time() - t0:.1f} s")
            t1 = time.time()
            run_examples()
            log("14c examples", f"in {time.time() - t1:.1f} s")
            mesh_decode_rows(torch, device, card, decode_launches)
            dryrun_cells(runs)
            log("14a dryrun", f"read {time.time() - t0:.1f} s after its "
                f"start")
        finally:
            for proc in [r[3] for r in runs] + [dry]:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    log("14", f"phase 14 in {time.time() - t0:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              f"root of the repository", file=sys.stderr)
        return 1
    from repro_torch.distributed import run_device_count_invariance_check
    from repro_torch.kernels import KERNEL_WRAPPERS, build
    device = torch.device("cuda")

    name = torch.cuda.get_device_name(0)
    card = nvidia_smi_line()
    log("1 device", f"{name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; device count {torch.cuda.device_count()}")
    print(card, flush=True)

    t0 = time.time()
    build.load_library()
    log("2 build", f"built and loaded in {time.time() - t0:.2f} s")
    for line in build.build_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("2 build", line.strip())

    t0 = time.time()
    worst, cases = compare_kernels(torch, device)
    log("3 kernels", f"{cases} cases bit-exact against the plain versions "
        f"on the card in {time.time() - t0:.1f} s; max |diff| {worst}")

    mism = compare_float_ops(torch, device)
    log("4 float ops", f"card vs CPU mismatches: {json.dumps(mism)}")
    main_keys = [k for k in mism if not k.startswith("exact_delta")]
    if any(mism[k] for k in main_keys):
        raise AssertionError("encode / lns_value_to_code differ between "
                             "the card and the CPU lane")

    runs, pbatches = main_path(torch)
    for run, (card_run, card_s, counts) in runs.items():
        log("5 main path", f"{run}: {STEPS} steps of batch {BATCH} + "
            f"evaluate in {card_s:.2f} s on the card; weights and accuracy "
            f"equal to the CPU lane; val acc {card_run.val_curve}, test acc "
            f"{card_run.test_acc}; launches {counts} ({pbatches} predict "
            f"batches)")
    t0 = time.time()
    ok, ranks = run_device_count_invariance_check(
        (1,), momentum=0.9, timeout=300)
    if not (ok and ranks[1]["matches_reference"]):
        raise AssertionError("a one-rank NCCL run of the segmented step "
                             "differs from reference_train_step")
    log("5 ranks", f"run_device_count_invariance_check((1,)) on the card: "
        f"one NCCL rank in its own process, 3 segmented steps with "
        f"momentum, weight and momentum codes equal to "
        f"reference_train_step, in {time.time() - t0:.1f} s")
    launches = {}
    for _, _, counts in runs.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for path in ("fused", "unfused", "segmented") + tuple(BASELINES):
        step_ms, wall_us, prof_rows = time_step(torch, path)
        log("6 times", f"{path}: {step_ms:.3f} ms per train step on {card}")
        dev_us = sum(r[0] for r in prof_rows)
        if prof_rows:
            log("6 profile", f"{path}, 10 steps: {dev_us / 10:.1f} us of "
                f"device time in {sum(r[1] for r in prof_rows) / 10:.0f} "
                f"kernel launches per step; busy share "
                f"{dev_us / 10 / (step_ms * 1e3):.4f} of the unprofiled step "
                f"({dev_us / wall_us:.4f} of the {wall_us / 10:.1f} us "
                f"profiled step)")
            for dev, count, key in prof_rows[:8]:
                log("6 profile", f"{path} {dev / 10:10.2f} us/step  "
                    f"{count / 10:6.1f} launches/step  {key[:80]}")
        else:
            log("6 profile", f"{path}: torch.profiler saw no device time: "
                "busy share not measured")
    from repro_torch.kernels._common import launch_empty
    host_ms = time_host(torch, lambda: launch_empty(device), 200)
    floor_ms = time_device(torch, lambda: launch_empty(device), 200, host_ms)
    log("6 times", f"launch floor (an empty kernel of one warp): "
        f"{floor_ms:.5f} ms on the card ({host_ms:.5f} ms per call with the "
        f"wrapper) on {card}")
    rows = {}
    for kname, label, kern, plain, nbytes, ops, in_step in step_launches(
            torch, device):
        host_ms = time_host(torch, kern, 200)
        ms = time_device(torch, kern, 200, host_ms)
        plain_ms = time_host(torch, plain, 5)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S > ops / INT32_OPS_PER_S \
            else "operations"
        log("6 times", f"{kname} {label}: {ms:.5f} ms on the card "
            f"({host_ms:.5f} ms per call with the wrapper; plain "
            f"{plain_ms:.4f} ms; bound {bound_ms:.6f} ms by {by}; floor "
            f"{floor_ms:.5f} ms){'' if in_step else ' [not in the step]'} "
            f"on {card}")
        if not in_step:
            continue
        r = rows.setdefault(kname, dict(ms=0.0, plain_ms=0.0, bytes=0,
                                        ops=0, launches=0))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bytes"] += nbytes
        r["ops"] += ops
        r["launches"] += 1
    for kname, r in rows.items():
        log("6 times", f"{kname} per step: {r['ms']:.6f} ms on the card in "
            f"{r['launches']} launches; floor {r['launches'] * floor_ms:.5f} "
            f"ms")
    mm = "src/repro/kernels/lns_matmul/lns_matmul.py"
    replaces = {
        "lns_matmul_fused": f"{mm}:599", "lns_matmul_dx": f"{mm}:539",
        "lns_matmul_dw_update": f"{mm}:622",
        "lns_fused_update": "src/repro/kernels/lns_matmul/update.py:65",
        "lns_matmul": f"{mm}:528", "lns_matmul_dw": f"{mm}:555",
        "lns_matmul_dw_partials": f"{mm}:571",
        "lns_boxsum": "src/repro/kernels/lns_boxsum/lns_boxsum.py:69",
    }
    kernels = []
    for kname in KERNEL_WRAPPERS:
        r = rows[kname]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S
        t_ops = r["ops"] / INT32_OPS_PER_S
        kernels.append(dict(
            name=kname, route="cuda",
            source="src/repro_torch/kernels/csrc/lns_mac.cu",
            replaces=replaces[kname], launches=launches[kname],
            max_abs_err=worst[kname], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes > t_ops else "operations",
            library_ms=None))
    log("6 times", "JSON ms / plain_ms / bound_ms are per train step of the "
        "path that runs the kernel (the sum over that step's launches); ms "
        "is card time alone, plain_ms the plain version's time; launches "
        "are summed over the phase-5 runs on the card")

    t0 = time.time()
    if baselines(torch, card):
        raise AssertionError("a baseline run launched an LNS kernel")
    log("7 baselines", f"phase 7 in {time.time() - t0:.1f} s")
    t0 = time.time()
    phase8(torch, card)
    log("8 obs+resil", f"phase 8 in {time.time() - t0:.1f} s")
    lm_worst, lm_rows, lm_launches = phase9(torch, device, card)
    for k in kernels:
        if k["name"] in LM_ROWS:
            row = k["name"]
            q = lm_rows[row]
            k["max_abs_err"] = max(k["max_abs_err"], lm_worst[row])
            k["launches"] += lm_launches[row]
            k.update(lm_route="lns_matmul_trainable",
                     lm_launches_per_step=q["launches"], lm_ms=q["ms"],
                     lm_plain_ms=q["plain_ms"], lm_bound_ms=q["bound_ms"],
                     lm_bound_by=q["bound_by"])
    log("9 lm", "JSON lm_ms / lm_plain_ms / lm_bound_ms are per full-width "
        "olmo-1b step (phase 9c); launches include phase 9's card runs")
    moe_worst, moe_rows, serve_rows, moe_launches = phase10(torch, device,
                                                            card)
    for k in kernels:
        row = k["name"]
        if row in moe_worst:
            k["max_abs_err"] = max(k["max_abs_err"], moe_worst[row])
        k["launches"] += moe_launches.get(row, 0)
        if row in moe_rows:
            q = moe_rows[row]
            k.update(moe_route="lns_matmul_trainable (MLA, MoE shared "
                               "experts, head)",
                     moe_launches_per_step=q["launches"], moe_ms=q["ms"],
                     moe_bound_ms=q["bound_ms"], moe_bound_by=q["bound_by"])
        if row == "lns_matmul_fused":
            for what, q in serve_rows.items():
                k.update({f"serve_{what}_launches": q["launches"],
                          f"serve_{what}_ms": q["ms"],
                          f"serve_{what}_bound_ms": q["bound_ms"],
                          f"serve_{what}_bound_by": q["bound_by"]})
            k["serve_largest_decode_plain_ms"] = \
                serve_rows["largest_decode"]["plain_ms"]
    log("10", "JSON moe_* are per full-width deepseek-v2-lite-16b step "
        "(phase 10c); serve_* are row 1 per serving forward (10d: decode at "
        f"{SERVE_BATCH} rows, prefill at {SERVE_CHUNK}, and the largest "
        "decode shape, whose plain version alone is timed at full length); "
        "launches include phase 10's card runs")
    fam_worst, fam_rows, fam_decode, fam_launches = phase11(torch, device,
                                                            card)
    for k in kernels:
        row = k["name"]
        if row not in LM_ROWS:
            continue
        k["max_abs_err"] = max(k["max_abs_err"], fam_worst.get(row, 0))
        k["launches"] += fam_launches[row]
        k["families"] = {
            arch: dict(launches_per_step=r[row]["launches"], ms=r[row]["ms"],
                       bound_ms=r[row]["bound_ms"],
                       bound_by=r[row]["bound_by"], step_ms=stats["ms"],
                       peak_gib=stats["peak_gib"], busy=stats["busy"])
            for arch, (r, stats) in fam_rows.items()}
        if row == "lns_matmul":
            k["family_decode"] = dict(
                launches=fam_decode["launches"], ms=fam_decode["ms"],
                bound_ms=fam_decode["bound_ms"],
                bound_by=fam_decode["bound_by"],
                step_ms=fam_decode["step_ms"])
    log("11", "JSON families are per full-width step of phase 11c "
        "(mamba2-370m, zamba2-7b, seamless-m4t-medium); family_decode is "
        "row 5 per decode_step of full-width mamba2-370m (11d); launches "
        "include phase 11's card runs")
    rpb_worst, rpb_table, rpb_launches = phase12(torch, device, card)
    for k in kernels:
        row = k["name"]
        k["max_abs_err"] = max(k["max_abs_err"], rpb_worst.get(row, 0))
        k["launches"] += rpb_launches.get(row, 0)
        if row in rpb_table:
            k["rows_per_block_ms"] = rpb_table[row]
    log("12", "JSON rows_per_block_ms: the tiled form's card ms (device "
        "time by CUDA events behind a spin, best of 5) at 1, 2, 4 and 8 "
        "rows a block per tuned shape "
        "(12b; lns_matmul holds the forward shapes, which the tuner times "
        "through the unfused launch), its bound and the tuner's choice; "
        "launches include 12c's and 12d's counted runs")
    mesh_launches = phase13(torch, device, card)
    for k in kernels:
        row = k["name"]
        if row in mesh_launches:
            k["launches"] += mesh_launches[row]
            k["mesh_launches"] = mesh_launches[row]
    log("13", "JSON mesh_launches are phase 13's card runs through the "
        "one-rank mesh (13a-13d); launches include them")
    phase14(torch, device, card, mesh_launches["lns_matmul_fused"])
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)

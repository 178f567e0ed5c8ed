"""Data-parallel LNS training with the deterministic ⊞ gradient reduce.

Run:  python -m repro_torch.examples.train_data_parallel [--device cpu]

Trains the paper MLP on 1, 2 and 4 ranks — gloo ranks on the CPU, or
NCCL ranks with one card each (``--device cuda`` raises when the host has
fewer cards than ranks) — and verifies the reduction-order contract of
``repro_torch/distributed/lns_dp.py``, for the uniform lns16 spec and for
a mixed lns12/lns16 per-layer ``NumericsPlan``.  The reduce semantics are
one axis of the unified descriptor (``reduce.mode`` /
``reduce.grad_segments`` / ``reduce.schedule``):

* ``reduce.mode=boxplus``    — per-segment dW partial codes are gathered
  in canonical segment order and ⊞-combined with a fixed sequential
  schedule → **bit-identical weight codes at every rank count**, equal to
  the single-process sequential baseline.
* ``reduce.mode=float-psum`` — decode → all-reduce → re-encode: faster
  on the wire, within quantization-level tolerance but NOT bit-stable.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import LNS16, decode
from ..devices import resolve_device
from ..distributed.lns_dp import (run_device_count_invariance_check,
                                  run_on_ranks)
from ..paper import params_from_numpy, run_experiment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL ranks, a card each) or cpu (gloo)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type

    print(f"=== 1. Rank-count invariance ({device} ranks: "
          f"{'gloo' if device == 'cpu' else 'NCCL'}) ===")
    ok, runs = run_device_count_invariance_check(
        (1, 2, 4), steps=3, batch=8, verbose=True, device=device,
        numerics="lns16-train-pallas,reduce.mode=boxplus,"
                 "reduce.grad_segments=4")
    print(f"boxplus reduce: 1/2/4-rank weight codes bit-identical to the "
          f"sequential baseline: {ok}")

    print("\n=== 2. The float-psum escape hatch ===")
    _, runs_f = run_device_count_invariance_check(
        (2,), steps=3, batch=8, device=device,
        numerics="lns16-train-pallas,reduce.mode=float-psum,"
                 "reduce.grad_segments=4")
    w_box, w_psm = (decode(params_from_numpy(r[2]["params"], "cpu")["w1"],
                           LNS16).numpy() for r in (runs, runs_f))
    dev = np.max(np.abs(w_box - w_psm) / (np.abs(w_box) + 1e-6))
    print(f"float-psum weights drift from the ⊞ schedule by ≤ {dev:.3%} "
          f"(reordering error, bounded by the Δ approximation — not "
          f"bit-exact)")

    print("\n=== 3. Mixed per-layer formats keep the invariance ===")
    # A NumericsPlan trains the hidden layer in lns12 while the
    # softmax-critical output layer stays lns16; each parameter's gradient
    # partials ⊞-combine under its own layer's Δ engine, so the
    # rank-count-invariance contract survives mixed formats unchanged.
    ok_m, _ = run_device_count_invariance_check(
        (1, 2, 4), steps=3, batch=8, verbose=True, device=device,
        numerics="lns16-train-pallas,reduce.grad_segments=4;"
                 "hidden=fmt:lns12")
    print(f"mixed lns12/lns16 plan: 1/2/4-rank weight codes bit-identical: "
          f"{ok_m}")

    print("\n=== 4. The same switch through the paper harness ===")
    # run_experiment(..., data_parallel=2) runs on each rank of a group of
    # 2 (the reference's shard_map runs it from one process).
    acc, secs = run_on_ranks(2, experiment_rank, {}, device=device)[0]
    print(f"run_experiment(..., data_parallel=2, numerics='lns16-train-"
          f"emulate,reduce.grad_segments=4'): "
          f"val acc {acc:.3f} in {secs:.1f}s")
    return ok, ok_m, acc


def experiment_rank(rank, world, job, device):
    """§4 on one rank: (the last validation accuracy, seconds)."""
    r = run_experiment("lns", "mnist", epochs=1, batch_size=8,
                       max_steps_per_epoch=10, data_parallel=world,
                       numerics="lns16-train-emulate,reduce.grad_segments=4",
                       device=device)
    return r.val_curve[-1], r.seconds


if __name__ == "__main__":
    main()

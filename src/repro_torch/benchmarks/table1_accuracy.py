"""Paper Table 1: test accuracy of float / linear fixed-point / LNS training.

    python -m repro_torch.benchmarks.table1_accuracy [quick|full] [--device cpu]

Grid: {float} ∪ {fxp, lns} × {12, 16} bits (+ lns bit-shift variants), per
dataset, on the card unless ``--device cpu``.  Results are cached to
``results/table1_<mode>.json`` beside this file, each with the name of the
device that ran it; printed rows are ``name,microseconds,test_acc=...,
device``.  The linear fixed-point baselines use stochastic rounding on the
weight update (12-bit linear training without it collapses; the no-SR
ablation is a row of its own); the LNS runs need none.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..paper import run_experiment

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "results")

QUICK = dict(epochs=4, max_steps_per_epoch=150)
FULL = dict(epochs=20, max_steps_per_epoch=None)

CONFIGS = [
    ("float", dict()),
    ("fxp", dict(bits=16, stochastic_round=True)),
    ("fxp", dict(bits=12, stochastic_round=True)),
    ("fxp", dict(bits=12)),                      # no-SR ablation
    ("lns", dict(bits=16, approx="lut")),
    ("lns", dict(bits=12, approx="lut")),
    ("lns", dict(bits=16, approx="bitshift")),
    ("lns", dict(bits=12, approx="bitshift")),
]


def config_tag(dataset: str, backend: str, kw: dict) -> str:
    return "_".join([dataset, backend]
                    + [f"{k}={v}" for k, v in sorted(kw.items())])


def device_name(device) -> str:
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run(datasets=("mnist",), mode="quick", force=False, device="cuda"):
    """Train every config of the grid not yet cached; returns the rows."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    cache = os.path.join(RESULTS_DIR, f"table1_{mode}.json")
    results = {}
    if os.path.exists(cache) and not force:
        with open(cache) as f:
            results = json.load(f)
    budget = QUICK if mode == "quick" else FULL
    rows = []
    for ds in datasets:
        for backend, kw in CONFIGS:
            tag = config_tag(ds, backend, kw)
            if tag not in results:
                t0 = time.time()
                r = run_experiment(backend, ds, **kw, **budget,
                                   device=device)
                results[tag] = dict(test_acc=r.test_acc,
                                    val_curve=r.val_curve,
                                    seconds=time.time() - t0,
                                    device=device_name(device))
                with open(cache, "w") as f:
                    json.dump(results, f, indent=1)
            rr = results[tag]
            rows.append((f"table1/{tag}", rr["seconds"] * 1e6,
                         f"test_acc={rr['test_acc']:.4f}", rr["device"]))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="quick",
                    choices=("quick", "full"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--force", action="store_true",
                    help="train again what the cache holds")
    args = ap.parse_args(argv)
    ds = ("mnist", "fmnist", "emnistd", "emnistl") if args.mode == "full" \
        else ("mnist",)
    for r in run(ds, args.mode, args.force, args.device):
        print(",".join(map(str, r)))


if __name__ == "__main__":
    main()

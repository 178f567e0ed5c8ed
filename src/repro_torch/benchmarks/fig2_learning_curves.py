"""Paper Fig. 2: validation-accuracy learning curves, 12/16-bit log vs
linear, from the cached Table 1 runs (their ``val_curve``).

    python -m repro_torch.benchmarks.fig2_learning_curves [quick|full]
"""
from __future__ import annotations

import json
import os
import sys

from .table1_accuracy import RESULTS_DIR


def run(mode="quick"):
    cache = os.path.join(RESULTS_DIR, f"table1_{mode}.json")
    if not os.path.exists(cache):
        return [("fig2/missing", 0.0, "run table1 first")]
    with open(cache) as f:
        results = json.load(f)
    rows = []
    for tag, rr in sorted(results.items()):
        curve = ";".join(f"{v:.3f}" for v in rr["val_curve"])
        rows.append((f"fig2/{tag}", rr["seconds"] * 1e6, f"curve={curve}",
                     rr["device"]))
    return rows


if __name__ == "__main__":
    for r in run(sys.argv[1] if len(sys.argv) > 1 else "quick"):
        print(",".join(map(str, r)))

"""Paper Fig. 1: Δ+ approximation quality (LUT size 20 & bit-shift vs exact).

    python -m repro_torch.benchmarks.fig1_delta_approx

Prints the max / mean absolute approximation error over d ∈ [0, 12] of each
Δ approximation at both paper formats (host numpy float64 over the port's
tables; no device).  The microseconds column is the host's time per point.
"""
from __future__ import annotations

import time

import numpy as np

from ..core import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_SOFTMAX, LNS12,
                    LNS16, DeltaEngine, delta_minus_float, delta_plus_float)


def run():
    rows = []
    d = np.linspace(0.0, 12.0, 2401)
    exact_p = delta_plus_float(d)
    pos = d > 0.5
    exact_m = delta_minus_float(d[pos])
    for fmt in (LNS16, LNS12):
        for name, spec in [("lut20", DELTA_DEFAULT),
                           ("lut640", DELTA_SOFTMAX),
                           ("bitshift", DELTA_BITSHIFT)]:
            eng = DeltaEngine(spec, fmt)
            t0 = time.perf_counter()
            ap = eng.plus_float(d)
            us = (time.perf_counter() - t0) * 1e6 / d.size
            err_p = np.abs(ap - exact_p)
            err_m = np.abs(eng.minus_float(d[pos]) - exact_m)
            rows.append((f"fig1/delta_{name}_{fmt.name}", us,
                         f"max_err_plus={err_p.max():.4f};"
                         f"mean_err_plus={err_p.mean():.5f};"
                         f"max_err_minus_d>.5={err_m.max():.4f}"))
    return rows


if __name__ == "__main__":
    for r in run():
        print(",".join(map(str, r)))

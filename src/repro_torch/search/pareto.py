"""Pareto frontier over plan-search evaluations (pure, deterministic).

The search optimizes two objectives per candidate plan:

* ``acc_delta`` — short-horizon validation-accuracy delta vs the anchor
  plan (maximize; 0.0 for the anchor itself, negative = worse);
* ``time_cost`` — the datapath cost to minimize.  In the deterministic
  default mode this is the model cost proxy (per-layer MACs × format
  bits × Δ-engine factor — :meth:`~repro_torch.search.space.SearchSpace.cost`),
  with ``measure=True`` it is the measured train-step time from the
  autotuner's best-of-reps timer (``kernels/autotune.py: _measure_ms``:
  CUDA events on the card).

Every function here is a pure function of its row dicts — no RNG, no
clock — so the frontier (and the winner) of a seeded search is
run-twice-identical, which is what lets the JSONL journal double as a
resume cache (``search/driver.py``) and the emitted
``BENCH_plan_search.json`` be byte-stable.
"""
from __future__ import annotations

ACC_KEY = "acc_delta"
COST_KEY = "time_cost"


def dominates(a: dict, b: dict) -> bool:
    """True iff ``a`` is at least as good as ``b`` on both objectives and
    strictly better on one (maximize ``acc_delta``, minimize
    ``time_cost``)."""
    ge_acc = a[ACC_KEY] >= b[ACC_KEY]
    le_cost = a[COST_KEY] <= b[COST_KEY]
    strict = a[ACC_KEY] > b[ACC_KEY] or a[COST_KEY] < b[COST_KEY]
    return ge_acc and le_cost and strict


def pareto_frontier(rows) -> list:
    """The non-dominated rows, sorted by (cost asc, acc desc, plan).

    Duplicate plan strings keep their first occurrence (the journal
    replays evaluations in order, so the first row is the canonical
    one).  Rows whose objectives tie exactly all stay on the frontier —
    neither dominates the other — so equal-cost equal-accuracy plans are
    all reported.
    """
    seen, unique = set(), []
    for r in rows:
        if r["plan"] not in seen:
            seen.add(r["plan"])
            unique.append(r)
    front = [r for r in unique
             if not any(dominates(o, r) for o in unique)]
    return sorted(front,
                  key=lambda r: (r[COST_KEY], -r[ACC_KEY], r["plan"]))


def select_winner(rows, *, max_acc_drop: float):
    """The cheapest feasible frontier point, or ``None``.

    Feasible = ``acc_delta >= -max_acc_drop`` (the search's accuracy
    budget vs the anchor).  Ties break by higher accuracy, then by plan
    string — fully deterministic.
    """
    feasible = [r for r in pareto_frontier(rows)
                if r[ACC_KEY] >= -max_acc_drop]
    if not feasible:
        return None
    return min(feasible,
               key=lambda r: (r[COST_KEY], -r[ACC_KEY], r["plan"]))

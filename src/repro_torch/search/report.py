"""Render a plan-search result: frontier table + per-layer rationale.

The report answers two questions a user pastes into a PR: *which plans
are worth running* (the Pareto frontier, winner marked, every row
attributable by its canonical plan string) and *why the search decided
what it did per layer* (the obs-counter evidence that ranked the
narrowing order, and what the winner changed vs the anchor —
:func:`~repro_torch.core.plan.plan_diff`).
"""
from __future__ import annotations

from ..core.plan import NumericsPlan, plan_diff


def frontier_table(rows, winner=None) -> str:
    """Fixed-width frontier table (rows = frontier dicts, cost asc)."""
    win_plan = winner["plan"] if winner else None
    header = (f"{'':2} {'acc':>7} {'d_acc':>8} {'cost':>12} "
              f"{'ms/step':>8}  plan")
    lines = [header, "-" * len(header)]
    for r in rows:
        ms = r.get("ms_per_step")
        ms_s = f"{ms:8.2f}" if ms is not None else f"{'-':>8}"
        mark = "*" if r["plan"] == win_plan else ""
        lines.append(f"{mark:2} {r['acc']:7.4f} {r['acc_delta']:+8.4f} "
                     f"{r['cost']:12.4g} {ms_s}  {r['plan']}")
    return "\n".join(lines)


def _layer_rationale(result, space) -> list:
    """One line per known layer path: evidence → decision."""
    anchor_plan = space.anchor_plan()
    winner = result.winner
    win_plan = NumericsPlan.parse(winner["plan"]) if winner else None
    lines = []
    for path in space.known_paths:
        ev = result.evidence.get(path, {})
        sat, elems = int(ev.get("sat", 0)), int(ev.get("elems", 0))
        upper = int(ev.get("upper_dhist", 0))
        sig = (f"sat={sat}/{elems or '?'} upper-dLUT={upper}"
               if ev else "no probe evidence")
        a_flat = anchor_plan.resolve(path)._flat()
        if win_plan is None:
            lines.append(f"{path}: {sig} -> no feasible winner")
            continue
        w_flat = win_plan.resolve(path)._flat()
        changes = {k: (a_flat[k], w_flat[k]) for k in ("fmt", "delta",
                                                       "interpret")
                   if a_flat[k] != w_flat[k]}
        if changes:
            what = ", ".join(f"{k} {a}->{b}"
                             for k, (a, b) in sorted(changes.items()))
            lines.append(f"{path}: {sig} -> narrowed ({what})")
        else:
            lines.append(f"{path}: {sig} -> kept {a_flat['fmt']}")
    return lines


def render_report(result, space, config) -> str:
    """The full human-readable report (markdown-friendly plain text)."""
    c = config
    lines = ["# Plan autosearch report", ""]
    lines.append(f"anchor: `{space.anchor_plan()}`")
    lines.append(f"budget: {c.epochs} epoch(s) x {c.steps_per_epoch} "
                 f"steps, batch {c.batch_size}, seed {c.seed}, "
                 f"max acc drop {c.max_acc_drop}")
    status = "complete" if result.complete \
        else "BUDGET EXHAUSTED - resume from the journal"
    lines.append(f"evaluations: {len(result.evals)} ({status})")
    if result.anchor:
        lines.append(f"anchor accuracy: {result.anchor.get('acc', 0):.4f}")
    lines.append(f"narrowing order (counter-ranked): "
                 f"{', '.join(result.order) or '-'}")
    lines += ["", "## Pareto frontier", "",
              "```", frontier_table(result.frontier, result.winner), "```",
              ""]
    if result.winner:
        lines += ["## Winner", "",
                  f"    --numerics '{result.winner['plan']}'", "",
                  f"acc {result.winner['acc']:.4f} "
                  f"(delta {result.winner['acc_delta']:+.4f} vs anchor), "
                  f"cost {result.winner['cost']:.4g}", "",
                  "```",
                  plan_diff(space.anchor_plan(), result.winner["plan"],
                            paths=space.known_paths,
                            labels=("anchor", "winner")),
                  "```", ""]
    else:
        lines += ["## Winner", "", "none (no feasible frontier point"
                  + ("" if result.complete else "; search incomplete")
                  + ")", ""]
    lines += ["## Per-layer rationale", ""]
    lines += [f"- {ln}" for ln in _layer_rationale(result, space)]
    lines.append("")
    return "\n".join(lines)

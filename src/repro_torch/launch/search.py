"""Plan-autosearch launcher: ``python -m repro_torch.launch.search ...``

Runs the deterministic plan search (``repro_torch.search``) over the paper
MLP, each candidate trained on ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain versions, with the same codes), emitting:

* ``BENCH_plan_search.json`` — every evaluation as a row carrying its
  canonical plan string (frontier membership + winner marked), JSON with
  sorted keys and no wall-clock fields in the default mode, so a seeded
  run is byte-reproducible, on either device;
* a plain-text report (frontier table + per-layer rationale);
* the winning plan string as a one-line artifact users paste straight
  into ``launch/train.py --numerics '...'``.

Resume drill: the search journals every evaluation to ``--journal``;
kill the process mid-sweep and rerun the identical command — the journal
replays as an evaluation cache and the run completes to the *exact* same
frontier as an uninterrupted run (``--selfcheck-resume`` proves it
in-process by truncating a copy of the journal and re-searching).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..search import PlanSearch, SearchConfig, SearchSpace, render_report


def _bench_rows(result, space, config) -> list:
    rows = []
    win = result.winner["plan"] if result.winner else None
    for r in result.evals:
        row = {"op": "plan_search", "backend": "lns",
               "shape": f"mlp/{config.dataset}",
               "plan": r["plan"], "acc": r["acc"],
               "acc_delta": r["acc_delta"], "cost": r["cost"],
               "time_cost": r["time_cost"],
               "on_frontier": bool(r.get("on_frontier")),
               "winner": r["plan"] == win,
               "spec": str(space.anchor_plan().default)}
        if "ms_per_step" in r:
            row["ms_per_step"] = r["ms_per_step"]
        rows.append(row)
    return rows


def _frontier_signature(result) -> list:
    """The deterministic identity of a frontier (for resume checks)."""
    return [[r["plan"], round(r["acc"], 12), round(r["cost"], 6)]
            for r in result.frontier]


def _run_search(space, config, journal, max_evals=None, verbose=True,
                device="cuda"):
    search = PlanSearch(space, config, journal=journal, verbose=verbose,
                        device=device)
    try:
        return search.run(max_evals=max_evals)
    finally:
        search.close()


def _selfcheck_resume(space, config, journal, result,
                      device="cuda") -> None:
    """Prove kill-resumability: truncate a copy of the journal mid-sweep,
    resume from it, and require the identical frontier."""
    with open(journal) as f:
        lines = f.read().splitlines()
    evals = [ln for ln in lines[1:]
             if json.loads(ln).get("kind") == "eval"]
    if len(evals) < 2:
        print("[search] selfcheck-resume: too few evaluations to "
              "truncate; skipping")
        return
    keep = 1 + len(evals) // 2   # header + probe/evals prefix
    cut = journal + ".selfcheck"
    kept, n_eval = [lines[0]], 0
    for ln in lines[1:]:
        if json.loads(ln).get("kind") == "eval":
            if n_eval >= keep:
                break
            n_eval += 1
        kept.append(ln)
    with open(cut, "w") as f:
        f.write("\n".join(kept) + "\n")
    resumed = _run_search(space, config, cut, verbose=False,
                          device=device)
    os.remove(cut)
    a, b = _frontier_signature(result), _frontier_signature(resumed)
    if a != b:
        raise SystemExit(
            f"[search] selfcheck-resume FAILED: resumed frontier "
            f"differs from the uninterrupted run\n  full:    {a}\n"
            f"  resumed: {b}")
    print(f"[search] selfcheck-resume OK: truncated journal to "
          f"{n_eval}/{len(evals)} evals, resumed to the identical "
          f"frontier ({len(b)} points)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Search per-layer NumericsPlan space on the paper MLP")
    ap.add_argument("--base", default="lns16-train-emulate",
                    help="anchor plan/spec string candidates start from")
    ap.add_argument("--layers", nargs="+", default=None,
                    help="layer patterns to sweep (default: every known "
                    "layer path of the paper MLP)")
    ap.add_argument("--fmts", nargs="+", default=["lns16", "lns12"],
                    help="format lattice, wide -> narrow")
    ap.add_argument("--deltas", nargs="+", default=[],
                    help="delta engines to sweep (e.g. lut20 bitshift)")
    ap.add_argument("--interprets", nargs="+", default=[],
                    help="interpret lanes to sweep (e.g. auto off)")
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps-per-epoch", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-acc-drop", type=float, default=0.02)
    ap.add_argument("--refine-generations", type=int, default=2)
    ap.add_argument("--refine-population", type=int, default=3)
    ap.add_argument("--measure", action="store_true",
                    help="record measured train-step time per candidate "
                    "(autotuner best-of-reps) and rank the frontier by "
                    "it; wall clock => the JSON is no longer "
                    "byte-reproducible")
    ap.add_argument("--max-evals", type=int, default=None,
                    help="stop after this many fresh evaluations "
                    "(budget/kill drill; resume from --journal)")
    ap.add_argument("--journal", default="plan_search_journal.jsonl")
    ap.add_argument("--out", default="BENCH_plan_search.json")
    ap.add_argument("--report", default="plan_search_report.md")
    ap.add_argument("--winner-out", default="plan_search_winner.txt")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed-seed budget (CI): 2 layers x "
                    "{lns12,lns16}, a few steps per eval, no "
                    "measurement")
    ap.add_argument("--selfcheck-resume", action="store_true",
                    help="after the run, truncate a copy of the journal "
                    "mid-sweep, resume, and fail unless the frontier is "
                    "identical")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--device", default="cuda",
                    help="where candidates train: cuda (the kernels) or "
                    "cpu (their plain versions; the same codes)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.fmts = ["lns16", "lns12"]
        args.deltas, args.interprets = [], []
        args.epochs, args.steps_per_epoch = 1, 6
        args.refine_generations, args.refine_population = 1, 2
        args.measure = False

    space = SearchSpace.for_paper_mlp(
        args.base, layers=args.layers, fmts=args.fmts,
        deltas=args.deltas, interprets=args.interprets)
    config = SearchConfig(
        dataset=args.dataset, epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch, batch_size=args.batch_size,
        seed=args.seed, max_acc_drop=args.max_acc_drop,
        refine_generations=args.refine_generations,
        refine_population=args.refine_population, measure=args.measure,
        data_dir=args.data_dir)
    print(f"[search] anchor {space.base!r}, sweeping "
          f"{list(space.layers)} over fmts={list(space.fmts)}"
          + (f" deltas={list(space.deltas)}" if space.deltas else "")
          + (f" interprets={list(space.interprets)}"
             if space.interprets else ""))
    result = _run_search(space, config, args.journal,
                         max_evals=args.max_evals, device=args.device)

    rows = _bench_rows(result, space, config)
    with open(args.out, "w") as f:
        json.dump({"benchmark": "plan_search",
                   "space": space.descriptor(),
                   "config": dataclasses.asdict(config),
                   "complete": result.complete,
                   "rows": rows}, f, indent=1, sort_keys=True)
    report = render_report(result, space, config)
    with open(args.report, "w") as f:
        f.write(report)
    print(report)
    print(f"[search] wrote {len(rows)} rows to {args.out}, report to "
          f"{args.report}")
    if result.winner is not None:
        with open(args.winner_out, "w") as f:
            f.write(result.winner["plan"] + "\n")
        print(f"[search] winning plan ({args.winner_out}):\n"
              f"  --numerics '{result.winner['plan']}'")
    elif not result.complete:
        print(f"[search] budget exhausted after {len(result.evals)} "
              f"evaluations; rerun with the same --journal to resume")
    if args.selfcheck_resume:
        if not result.complete:
            raise SystemExit("[search] --selfcheck-resume needs a "
                             "complete run (drop --max-evals)")
        _selfcheck_resume(space, config, args.journal, result,
                          device=args.device)
    return result


if __name__ == "__main__":
    main()

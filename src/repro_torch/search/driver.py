"""The plan-search driver: greedy narrowing + evolutionary refinement.

Deterministic by construction and resumable by journal:

* **Deterministic** — the proposal sequence is a pure function of
  (space, config): the greedy phase walks layers in an order derived
  from the anchor's obs-counter probe (itself deterministic — telemetry
  is a pure read), the refinement phase draws from a seeded
  ``numpy.random.default_rng`` whose consumption does not depend on
  whether an evaluation came from the journal or ran live.  Candidate
  evaluation (``run_experiment`` at a fixed seed/budget on the offline
  deterministic datasets) and the cost model are deterministic too, so
  two runs of the same search produce identical frontiers.

* **Resumable** — every evaluation appends one JSONL row keyed by the
  candidate's canonical plan string.  On start the journal is replayed
  into the evaluation cache (after its header is checked against this
  search's identity — a journal from a *different* space/config must
  fail loudly, not silently corrupt determinism); the driver then runs
  the same deterministic sequence, serving the prefix from cache and
  evaluating only what the killed run never reached.  Resume therefore
  reproduces the exact frontier of an uninterrupted run.

Candidate evaluation reuses the existing surfaces verbatim — accuracy
via :func:`repro_torch.paper.training.run_experiment`, obs counters via
``train_step_metrics`` → :meth:`MetricsRegistry.merge_numerics_taps`,
and (opt-in, ``measure=True``) step time via the autotuner's
best-of-reps timer (:func:`repro_torch.kernels.autotune._measure_ms`:
CUDA events on the card) — the search never grows a private arithmetic
path.  Every evaluation runs on the ``device`` the search was given (the
card unless the caller asks for the CPU); the device is not part of the
search's identity, so a journal written on the card resumes on the CPU
lane and the other way round (the lanes give the same codes).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np

from ..core.plan import NumericsPlan
from .pareto import pareto_frontier, select_winner
from .space import SearchSpace

JOURNAL_VERSION = 1

#: Δ-LUT histogram buckets counted as "upper" for narrowing evidence:
#: the top two ``DHIST_EDGES`` buckets ([8, 10) and the beyond-``d_max``
#: overflow bucket).  A layer whose ⊞ arguments never land there is not
#: using the wide format's Δ range.
UPPER_DHIST_BUCKETS = 2


class SearchBudgetExhausted(Exception):
    """Raised internally when ``max_evals`` fresh evaluations ran."""


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Evaluation budget + acceptance policy of one search run.

    Everything here is part of the search's identity (journal header):
    resuming under a different config would splice incomparable
    evaluations together, so it is rejected.
    """

    dataset: str = "mnist"
    epochs: int = 1
    steps_per_epoch: int = 20     # short-horizon eval budget
    batch_size: int = 5
    seed: int = 0
    lr: float = 0.01
    weight_decay: float = 0.0
    momentum: float = 0.0
    max_acc_drop: float = 0.02    # feasibility: acc_delta >= -this
    refine_generations: int = 2
    refine_population: int = 3
    measure: bool = False         # opt-in measured step time (wall clock
                                  # → frontier no longer run-twice-
                                  # identical; off for smoke/CI)
    measure_reps: int = 3
    data_dir: str = "data"

    def descriptor(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SearchResult:
    anchor: dict
    evals: list                   # all evaluation rows, in eval order
    frontier: list                # non-dominated rows (sorted)
    winner: Optional[dict]
    evidence: dict                # layer path → probe counter summary
    order: list                   # greedy narrowing order (patterns)
    complete: bool = True


class PlanSearch:
    """One configured search over a :class:`SearchSpace`.

    ``evaluate_fn(plan_str) -> {"acc": float, ...}`` and
    ``probe_fn() -> {path: {...counts}}`` inject deterministic stubs in
    tests; the defaults run the real model surfaces on ``device``.
    """

    def __init__(self, space: SearchSpace, config: SearchConfig = None, *,
                 journal: Optional[str] = None,
                 evaluate_fn: Optional[Callable] = None,
                 probe_fn: Optional[Callable] = None,
                 verbose: bool = False, device="cuda"):
        self.space = space.validate()   # fail fast, before any measurement
        self.config = config or SearchConfig()
        self.verbose = verbose
        self.device = device
        self._evaluate_fn = evaluate_fn or self._real_evaluate
        self._probe_fn = probe_fn or self._real_probe
        self._cache: dict = {}          # plan string → eval row
        self._assigns: dict = {}        # plan string → assignment
        self._evals: list = []          # rows in evaluation order
        self._evidence: Optional[dict] = None
        self._fresh = 0                 # live (non-cache) evaluations
        self._max_evals: Optional[int] = None
        self._journal_path = journal
        self._journal_file = None
        if journal:
            self._open_journal(journal)

    # -- journal -----------------------------------------------------------
    def _header(self) -> dict:
        return {"kind": "header", "version": JOURNAL_VERSION,
                "space": self.space.descriptor(),
                "config": self.config.descriptor()}

    def _open_journal(self, path: str) -> None:
        header = self._header()
        if os.path.exists(path) and os.path.getsize(path):
            # Torn-tail-tolerant replay via the shared obs helper: a
            # killed-mid-write journal parses up to the torn line and
            # resumes from there (--selfcheck-resume pins the identical-
            # frontier property in CI).
            from ..obs.sink import read_jsonl_tolerant
            rows = read_jsonl_tolerant(path)
            if not rows:
                raise ValueError(
                    f"search journal {path} has no readable header; "
                    f"delete it to start fresh")
            if rows[0] != header:
                raise ValueError(
                    f"search journal {path} was written by a different "
                    f"search (space/config mismatch); resuming would "
                    f"splice incomparable evaluations — delete it or "
                    f"point --journal elsewhere")
            for row in rows[1:]:
                if row.get("kind") == "eval":
                    row = {k: v for k, v in row.items() if k != "kind"}
                    self._cache[row["plan"]] = row
                elif row.get("kind") == "probe":
                    self._evidence = row["evidence"]
            self._journal_file = open(path, "a")
        else:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._journal_file = open(path, "w")
            self._append(header)

    def _append(self, row: dict) -> None:
        if self._journal_file is not None:
            self._journal_file.write(json.dumps(row, sort_keys=True) + "\n")
            self._journal_file.flush()

    def close(self) -> None:
        if self._journal_file is not None:
            self._journal_file.close()
            self._journal_file = None

    # -- real evaluation surfaces ------------------------------------------
    def _real_evaluate(self, plan_str: str) -> dict:
        from ..paper.training import run_experiment
        c = self.config
        res = run_experiment(
            "lns", c.dataset, numerics=plan_str, epochs=c.epochs,
            batch_size=c.batch_size, lr=c.lr, weight_decay=c.weight_decay,
            momentum=c.momentum, seed=c.seed, data_dir=c.data_dir,
            max_steps_per_epoch=c.steps_per_epoch, device=self.device)
        out = {"acc": float(res.val_curve[-1]),
               "test_acc": float(res.test_acc)}
        if c.measure:
            out["ms_per_step"] = self._measure_step(plan_str)
        return out

    def _measure_step(self, plan_str: str) -> float:
        """Train-step time in ms, best-of-reps (the autotuner's timer: on
        the card the step's device time, its launches back to back)."""
        import torch
        from ..kernels.autotune import _measure_ms
        from ..paper.mlp import MLPConfig, make_mlp
        c = self.config
        cfg = MLPConfig(spec=plan_str)
        model = make_mlp("lns", cfg, self.device)
        params = model.init(torch.Generator().manual_seed(c.seed))
        rng = np.random.default_rng(c.seed)
        xb = rng.uniform(0, 1, size=(c.batch_size, cfg.n_in)) \
            .astype(np.float32)
        yb = rng.integers(0, cfg.n_out, size=(c.batch_size,))
        return _measure_ms(
            lambda: model.train_step(params, xb, yb)[0]["w1"].code,
            reps=c.measure_reps)

    def _real_probe(self) -> dict:
        """Anchor-plan obs-counter probe: per-layer narrowing evidence.

        Runs one ``train_step_metrics`` step of the anchor plan with
        every sweep pattern raised to ``metrics:full`` (the Δ-LUT
        ``dhist`` shadow pass) on the first real dataset batches, folds
        the taps through ``MetricsRegistry.merge_numerics_taps`` — the
        existing telemetry surface, never a private reading of the
        arithmetic — and summarizes per layer path: saturations,
        zero-flushes, total elements, and upper-Δ-LUT-bucket occupancy.
        Telemetry is a pure read, so the probe cannot perturb anything.
        """
        import torch
        from ..obs import MetricsRegistry, host_taps
        from ..paper import datasets
        from ..paper.mlp import MLPConfig, make_mlp
        c = self.config
        plan = self.space.anchor_plan()
        for pat in self.space.layers:
            plan = plan.with_rule(pat, metrics="full")
        x, yl, _, _, dspec = datasets.load(c.dataset, c.data_dir, c.seed)
        cfg = MLPConfig(n_out=dspec.n_classes, spec=plan, lr=c.lr,
                        weight_decay=c.weight_decay, momentum=c.momentum)
        model = make_mlp("lns", cfg, self.device)
        params = model.init(torch.Generator().manual_seed(c.seed))
        n = min(32, len(x))
        out, taps = model.train_step_metrics(params, x[:n], yl[:n])
        reg = MetricsRegistry()
        reg.merge_numerics_taps(host_taps(taps), lanes=model.lanes())
        evidence: dict = {}
        for row in reg.rows():
            layer = row.get("layer")
            if layer is None:
                continue
            ev = evidence.setdefault(
                layer, {"sat": 0, "zero": 0, "elems": 0, "upper_dhist": 0})
            if row["kind"] == "counter":
                name = row["name"]
                if name in ("numerics.sat", "numerics.q_sat",
                            "numerics.convert_sat"):
                    ev["sat"] += int(row["value"])
                elif name in ("numerics.zero", "numerics.q_flush",
                              "numerics.convert_flush"):
                    ev["zero"] += int(row["value"])
                elif name == "numerics.elems":
                    ev["elems"] += int(row["value"])
            elif row["kind"] == "bucketed_histogram" \
                    and row["name"] == "numerics.dhist":
                ev["upper_dhist"] += int(
                    sum(row["counts"][-UPPER_DHIST_BUCKETS:]))
        return evidence

    # -- evaluation with cache + journal ------------------------------------
    def _evaluate(self, assign: dict) -> dict:
        plan = self.space.build(assign)
        plan_str = str(plan)
        self._assigns.setdefault(plan_str, assign)
        row = self._cache.get(plan_str)
        if row is None:
            if self._max_evals is not None \
                    and self._fresh >= self._max_evals:
                raise SearchBudgetExhausted(
                    f"evaluation budget ({self._max_evals}) exhausted")
            measured = self._evaluate_fn(plan_str)
            row = {"plan": plan_str, "acc": float(measured["acc"]),
                   "cost": self.space.cost(plan)}
            for k, v in measured.items():
                if k != "acc":
                    row[k] = v
            self._fresh += 1
            self._cache[plan_str] = row
            self._append({"kind": "eval", **row})
            if self.verbose:
                print(f"[search] eval {plan_str}: acc={row['acc']:.4f} "
                      f"cost={row['cost']:.3g}")
        if plan_str not in [r["plan"] for r in self._evals]:
            self._evals.append(row)
        return row

    def _finalize_rows(self, anchor_acc: float) -> None:
        """Stamp the anchor-relative objectives on every row."""
        for row in self._evals:
            row["acc_delta"] = row["acc"] - anchor_acc
            row["time_cost"] = row["ms_per_step"] \
                if self.config.measure and "ms_per_step" in row \
                else row["cost"]

    # -- proposal order from counter evidence -------------------------------
    def _proposal_order(self, evidence: dict) -> list:
        """Sweep patterns ranked most-narrowable first.

        A pattern scores by the summed evidence of the known paths it
        matches: fewer saturations first (zero-sat layers have format
        headroom), then emptier upper Δ-LUT buckets, then name — the
        counter signals the obs subsystem exists to provide.
        """
        import fnmatch

        def score(pat):
            sat = upper = 0
            for p in self.space.known_paths:
                if fnmatch.fnmatchcase(p, pat):
                    ev = evidence.get(p, {})
                    sat += int(ev.get("sat", 0))
                    upper += int(ev.get("upper_dhist", 0))
            return (sat, upper, pat)

        return sorted(self.space.layers, key=score)

    # -- the search ---------------------------------------------------------
    def run(self, max_evals: Optional[int] = None) -> SearchResult:
        """Run (or resume) the search; returns the frontier + winner.

        ``max_evals`` caps *fresh* (non-journal) evaluations — the
        budget/kill knob: an exhausted run returns ``complete=False``
        with the journal holding everything evaluated so far, and a
        rerun over the same journal continues where it stopped.
        """
        self._max_evals = max_evals
        space, c = self.space, self.config
        try:
            if self._evidence is None:
                self._evidence = self._probe_fn()
                self._append({"kind": "probe", "evidence": self._evidence})
            order = self._proposal_order(self._evidence)
            anchor_row = self._evaluate({})
            incumbent: dict = {}
            # Phase 1: greedy narrowing, counter-ranked layer order.
            for pat in order:
                for fmt in space.narrower_fmts(
                        space.current(incumbent, pat, "fmt")):
                    cand = {**{p: dict(a) for p, a in incumbent.items()}}
                    cand.setdefault(pat, {})["fmt"] = fmt
                    row = self._evaluate(cand)
                    if row["acc"] - anchor_row["acc"] >= -c.max_acc_drop:
                        incumbent = cand
                    else:
                        break   # narrower will not recover accuracy
            # Phase 2: seeded evolutionary refinement over all axes.
            rng = np.random.default_rng(c.seed)
            for _ in range(c.refine_generations):
                pool = sorted(
                    self._evals,
                    key=lambda r: (
                        r["acc"] - anchor_row["acc"] < -c.max_acc_drop,
                        r["cost"], -r["acc"], r["plan"]))
                parents = pool[:c.refine_population]
                for parent in parents:
                    assign = self._assigns.get(parent["plan"])
                    if assign is None:
                        continue
                    muts = space.mutations(assign)
                    if not muts:
                        continue
                    # rng consumption is unconditional and identical
                    # under resume: the permutation is drawn whether or
                    # not the chosen mutation is already cached.
                    for i in rng.permutation(len(muts)):
                        cand = muts[int(i)]
                        if str(space.build(cand)) not in self._cache:
                            self._evaluate(cand)
                            break
            complete = True
        except SearchBudgetExhausted:
            complete = False
        anchor_acc = self._cache[str(space.anchor_plan())]["acc"] \
            if str(space.anchor_plan()) in self._cache else 0.0
        self._finalize_rows(anchor_acc)
        frontier = pareto_frontier(self._evals)
        for row in self._evals:
            row["on_frontier"] = row in frontier
        winner = select_winner(self._evals, max_acc_drop=c.max_acc_drop) \
            if complete else None
        if winner is not None:
            # The winning plan string must round-trip losslessly into
            # --numerics; assert rather than hope.
            assert str(NumericsPlan.parse(winner["plan"])) \
                == winner["plan"]
            winner = dict(winner, winner=True)
        return SearchResult(
            anchor=dict(self._cache.get(str(space.anchor_plan()), {})),
            evals=list(self._evals), frontier=frontier, winner=winner,
            evidence=dict(self._evidence or {}), order=order
            if self._evidence is not None else [], complete=complete)

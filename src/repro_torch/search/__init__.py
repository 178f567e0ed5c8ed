"""Plan autosearch: derive minimal-bitwidth NumericsPlans automatically.

A deterministic, journaled, resumable driver
(:class:`~repro_torch.search.driver.PlanSearch`) sweeps per-layer
``fmt``/``delta``/``interpret`` rules over
:class:`~repro_torch.core.plan.NumericsPlan` candidates
(:class:`~repro_torch.search.space.SearchSpace`), evaluates each by
short-horizon accuracy vs the anchor (the paper MLP trained on the card,
or on the CPU lane when asked), a deterministic datapath cost model (or
opt-in measured step time), and obs-counter narrowing evidence, and emits
the Pareto frontier (:mod:`~repro_torch.search.pareto`) plus a per-layer
rationale report (:mod:`~repro_torch.search.report`).  CLI:
``python -m repro_torch.launch.search``.
"""
from .driver import (PlanSearch, SearchBudgetExhausted, SearchConfig,
                     SearchResult)
from .pareto import dominates, pareto_frontier, select_winner
from .report import frontier_table, render_report
from .space import SWEEP_AXES, SearchSpace

__all__ = [
    "PlanSearch", "SearchBudgetExhausted", "SearchConfig", "SearchResult",
    "SearchSpace", "SWEEP_AXES", "dominates", "pareto_frontier",
    "select_winner", "frontier_table", "render_report",
]

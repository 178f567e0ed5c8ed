"""Candidate enumeration for the plan autosearch.

A :class:`SearchSpace` is the declarative half of the search: which layer
patterns may be overridden, along which spec axes (``fmt`` — ordered
wide → narrow, the *format lattice* greedy narrowing walks — ``delta``,
``interpret``), on top of which anchor plan, over which known layer
paths.  Candidates are **assignments**: ``{pattern: {axis: value}}``
mappings that :meth:`SearchSpace.build` turns into real
:class:`~repro_torch.core.plan.NumericsPlan` objects via ``with_rule`` — the
search composes plans exclusively through the existing plan machinery,
so it can never invent arithmetic the trained model would not also run
(``reduce.*`` rules are rejected by ``PlanRule`` itself; the axes here
are additionally restricted to the three sweepable ones).

Validation is eager and total (:meth:`validate`): the anchor plan parses,
every sweep pattern matches a known layer path (``validate_paths`` —
its error message lists the known paths, so a typo'd glob fails in
seconds, *before* any measurement), and every axis value round-trips
through the spec vocabulary.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

from ..core.plan import NumericsPlan

#: The spec axes a search may sweep per layer.  Deliberately closed:
#: quantize/compute_dtype change what is being trained, backend/blocks
#: are performance axes the autotuner already owns, reduce.* is a global
#: contract (and rejected in plan rules anyway).  ``interpret`` routes
#: nothing here (the operands' device picks the lane); it stays sweepable
#: so that the JAX package's spaces carry across, and two candidates that
#: differ only there train identically.
SWEEP_AXES = ("fmt", "delta", "interpret")

#: Relative per-MAC cost of each Δ-engine kind (the deterministic cost
#: model's Δ factor): exact evaluates log1p per ⊞, lut640 is a 64×
#: finer table than the paper default, bitshift replaces the table with
#: a shift.  Coarse by design — it ranks datapaths, it does not predict
#: wall time (pass ``measure=True`` to the driver for that).
DELTA_FACTORS = {"exact": 4.0, "lut640": 1.5, "lut20": 1.0,
                 "bitshift": 0.75, "none": 1.0}


def _delta_factor(name: str) -> float:
    return DELTA_FACTORS.get(name, 2.0)   # unknown/generic LUTs: mid-cost


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The plan-search candidate space (frozen, deterministic).

    ``base`` is the anchor plan string every candidate starts from;
    ``layers`` the sweep patterns (fnmatch globs over ``known_paths``,
    usually the literal paths); ``fmts`` the format lattice in
    wide → narrow order; ``deltas`` / ``interprets`` optional extra axes
    (empty = not swept).  ``layer_macs`` maps each known path to its
    per-sample MAC count — the deterministic cost model's weights.
    """

    base: str
    layers: Tuple[str, ...]
    known_paths: Tuple[str, ...]
    fmts: Tuple[str, ...] = ("lns16", "lns12")
    deltas: Tuple[str, ...] = ()
    interprets: Tuple[str, ...] = ()
    layer_macs: Tuple[Tuple[str, int], ...] = ()

    # -- construction helpers ----------------------------------------------
    @classmethod
    def for_paper_mlp(cls, base: str = "lns16-train-emulate", *,
                      layers=None, fmts=("lns16", "lns12"), deltas=(),
                      interprets=(), n_in: int = 784, n_hidden: int = 100,
                      n_out: int = 10) -> "SearchSpace":
        """The space over the paper MLP's two layer paths.

        ``layer_macs`` counts one forward matmul per layer per sample;
        backward roughly triples every layer uniformly, so forward MACs
        rank identically.
        """
        from ..paper.mlp import LAYER_PATHS
        return cls(base=base,
                   layers=tuple(layers) if layers else LAYER_PATHS,
                   known_paths=LAYER_PATHS,
                   fmts=tuple(fmts), deltas=tuple(deltas),
                   interprets=tuple(interprets),
                   layer_macs=(("hidden", n_in * n_hidden),
                               ("out", n_hidden * n_out)))

    # -- validation (satellite: fail in seconds, not after a sweep) --------
    def validate(self) -> "SearchSpace":
        """Raise before any measurement if the space is ill-formed.

        Checks, in order: the anchor plan parses and its own rules match
        known paths; every sweep pattern matches at least one known path
        (via ``NumericsPlan.validate_paths`` — the error lists the known
        layer paths); every axis value is valid spec vocabulary.
        """
        if not self.layers:
            raise ValueError("search space has no layer patterns to sweep")
        if not self.fmts:
            raise ValueError("search space has an empty format lattice")
        plan = NumericsPlan.parse(self.base)
        plan.validate_paths(self.known_paths)
        probe = plan
        for pat in self.layers:
            # One probe rule per pattern: with_rule validates the axis
            # values, validate_paths the patterns (its message lists the
            # known layer paths — the regression-tested guard).
            for fmt in self.fmts:
                probe = probe.with_rule(pat, fmt=fmt)
            for d in self.deltas:
                probe = probe.with_rule(pat, delta=d)
            for i in self.interprets:
                probe = probe.with_rule(pat, interpret=i)
        probe.validate_paths(self.known_paths)
        return self

    # -- plans from assignments --------------------------------------------
    def anchor_plan(self) -> NumericsPlan:
        return NumericsPlan.parse(self.base)

    def build(self, assign: Mapping[str, Mapping[str, str]]) -> NumericsPlan:
        """The candidate plan of one assignment.

        Rules are appended in the space's declared layer order with axes
        in ``SWEEP_AXES`` order, so equal assignments always serialize to
        the identical canonical plan string (the journal key).
        """
        plan = self.anchor_plan()
        for pat in self.layers:
            kv = assign.get(pat)
            if not kv:
                continue
            ordered = {ax: kv[ax] for ax in SWEEP_AXES if ax in kv}
            bad = set(kv) - set(SWEEP_AXES)
            if bad:
                raise ValueError(
                    f"assignment for {pat!r} sets non-sweepable axis "
                    f"{sorted(bad)}; sweepable axes: {SWEEP_AXES}")
            plan = plan.with_rule(pat, **ordered)
        return plan

    def current(self, assign: Mapping, pattern: str, axis: str) -> str:
        """The effective value of ``axis`` at ``pattern`` under
        ``assign`` (falling back to the anchor's resolved value at the
        pattern's first matching known path)."""
        kv = assign.get(pattern, {})
        if axis in kv:
            return kv[axis]
        import fnmatch
        for p in self.known_paths:
            if fnmatch.fnmatchcase(p, pattern):
                return self.anchor_plan().resolve(p)._flat()[axis]
        raise ValueError(f"pattern {pattern!r} matches no known path")

    def narrower_fmts(self, fmt: str) -> Tuple[str, ...]:
        """Formats strictly narrower than ``fmt`` on the lattice, in
        narrowing order (the greedy walk's steps).  A format not on the
        lattice has no narrowing steps."""
        if fmt not in self.fmts:
            return ()
        return self.fmts[self.fmts.index(fmt) + 1:]

    def mutations(self, assign: Mapping) -> list:
        """Every single-axis neighbor of ``assign``, deterministic order.

        One entry per (pattern, axis, value != current) over the declared
        axis vocabularies — the evolutionary refinement's move set.
        """
        out = []
        axes = [("fmt", self.fmts), ("delta", self.deltas),
                ("interpret", self.interprets)]
        for pat in self.layers:
            for axis, values in axes:
                cur = self.current(assign, pat, axis) if values else None
                for v in values:
                    if v == cur:
                        continue
                    kv = dict(assign.get(pat, {}))
                    kv[axis] = v
                    out.append({**{p: dict(a) for p, a in assign.items()},
                                pat: kv})
        return out

    # -- deterministic cost model ------------------------------------------
    def cost(self, plan: "NumericsPlan | str") -> float:
        """Datapath cost proxy of ``plan``: Σ layer MACs × format bits ×
        Δ factor, over the known paths with declared MAC counts.

        A pure function of the resolved plan — no clock, no measurement —
        so frontier dominance computed from it is run-twice-identical.
        """
        plan = NumericsPlan.parse(plan)
        total = 0.0
        for path, macs in self.layer_macs:
            spec = plan.resolve(path)
            fmt = spec.fmt
            bits = fmt.total_bits if fmt is not None else 32
            total += macs * bits * _delta_factor(spec._flat()["delta"])
        return total

    # -- journal identity ---------------------------------------------------
    def descriptor(self) -> dict:
        """The JSON-stable identity of this space (journal header)."""
        return {
            "base": str(self.anchor_plan()),
            "layers": list(self.layers),
            "known_paths": list(self.known_paths),
            "fmts": list(self.fmts),
            "deltas": list(self.deltas),
            "interprets": list(self.interprets),
            "layer_macs": [[p, int(m)] for p, m in self.layer_macs],
        }

"""Resilience: deterministic fault injection and guardrails.

``inject`` makes hardware-realistic faults (bit flips, Δ-table
corruption, stuck saturation lanes, dropped or duplicated data-parallel
segment partials) seed-keyed inputs via :class:`FaultPlan`, drawn with the
JAX package's generator (``prng``) so a faulted run equals the
reference's; ``guard`` wires the numerics taps to recovery (snapshot
rollback, per-layer format widening, recovery of lost segment partials).
With no plan active and the guardrails off, every step runs the ops of a
build without this package.
"""
from .inject import (FAULT_KINDS, FaultPlan, FaultRule, active_plan,
                     active_step, corrupt_engine, fault_plan, inject_codes,
                     inject_param_codes, inject_segment_partials, injecting,
                     serve_faults, suspended)
from .guard import (Alert, GuardConfig, GuardedTrainer, SnapshotRing,
                    detect, recover_segment_partials, shrink)

__all__ = [
    "FAULT_KINDS", "FaultPlan", "FaultRule", "fault_plan", "injecting",
    "suspended", "active_plan", "active_step", "inject_codes",
    "inject_param_codes", "inject_segment_partials", "corrupt_engine",
    "serve_faults",
    "Alert", "GuardConfig", "GuardedTrainer", "SnapshotRing", "detect",
    "recover_segment_partials", "shrink",
]

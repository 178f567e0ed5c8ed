"""Observability: numerics counters, step tracing, metric sinks.

This package imports nothing of ``repro_torch.core`` (core ops import it
for their taps): only torch, numpy and the standard library.
"""
from .metrics import (
    DHIST_EDGES,
    NumericsCollector,
    collecting,
    current_scope,
    dhist_edges_codes,
    enabled,
    host_taps,
    observe_codes,
    observe_convert,
    observe_float,
    observe_quantize,
    scope,
    scope_active,
    suspended,
    tap,
)
from .registry import MetricsRegistry
from .sink import JsonlSink, read_jsonl, read_jsonl_tolerant
from .trace import (
    StepTimer,
    TRACE_DIR_ENV,
    maybe_profile,
    phase_scope,
    profiler_session,
)

__all__ = [
    "DHIST_EDGES",
    "NumericsCollector",
    "collecting",
    "current_scope",
    "dhist_edges_codes",
    "enabled",
    "host_taps",
    "observe_codes",
    "observe_convert",
    "observe_float",
    "observe_quantize",
    "scope",
    "scope_active",
    "suspended",
    "tap",
    "MetricsRegistry",
    "JsonlSink",
    "read_jsonl",
    "read_jsonl_tolerant",
    "StepTimer",
    "TRACE_DIR_ENV",
    "maybe_profile",
    "phase_scope",
    "profiler_session",
]

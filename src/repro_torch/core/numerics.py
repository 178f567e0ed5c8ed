"""Numerics policy registry: a thin view over ``core.spec``.

``POLICIES`` maps alias → :class:`~repro_torch.core.spec.NumericsSpec`;
:func:`get_policy` resolves a name, spec string, spec or plan into the
cached :class:`~repro_torch.core.spec.LNSRuntime` every LM layer routes
its weight products through.  ``NumericsPolicy`` is the JAX package's
older name of the runtime type.
"""
from __future__ import annotations

from .plan import NumericsPlan, get_plan
from .spec import ALIASES, LNSRuntime, NumericsSpec, ReduceSpec

#: Alias registry: name → NumericsSpec.
POLICIES = ALIASES

#: The older name of the resolved-runtime type.
NumericsPolicy = LNSRuntime


def get_policy(name: "str | NumericsSpec | NumericsPlan") -> LNSRuntime:
    """Resolve an alias, spec string, spec or plan into its runtime (a
    plan: its default spec's; per-layer call sites use :func:`get_plan`
    and ``plan.runtime_for``).  Unknown names raise with the valid ones."""
    return NumericsPlan.parse(name).default.runtime()


__all__ = ["ALIASES", "LNSRuntime", "NumericsPlan", "NumericsPolicy",
           "NumericsSpec", "POLICIES", "ReduceSpec", "get_plan",
           "get_policy"]

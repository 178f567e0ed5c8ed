"""Per-layer numerics: ``NumericsPlan`` — glob patterns → spec overrides.

Serialized form (``parse``/``str`` round-trip losslessly)::

    lns16-train-pallas;hidden=fmt:lns12,delta:lut20;out=delta:bitshift
    └─ default spec ──┘└─ rule 1 ────────────────┘└─ rule 2 ──────────┘

The first ``;``-separated segment is any :class:`NumericsSpec` string;
each rule is ``<pattern>=<key>:<value>[,<key>:<value>...]`` with the
spec-string vocabulary.  Patterns are ``fnmatch`` globs over layer paths
(the paper MLP has ``hidden`` and ``out``).  :meth:`NumericsPlan.resolve`
applies every matching rule on top of the default, in declaration order.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import Tuple

from .spec import NumericsSpec, apply_kv_overrides

_PATTERN_FORBIDDEN = set(";=,:")


@dataclasses.dataclass(frozen=True)
class PlanRule:
    """One ``pattern=key:value,...`` rule; ``overrides`` are canonical
    ``(key, value)`` string pairs sorted by key."""

    pattern: str
    overrides: Tuple[Tuple[str, str], ...]

    def __post_init__(self):
        if not self.pattern:
            raise ValueError("empty layer pattern in numerics plan rule")
        bad = _PATTERN_FORBIDDEN & set(self.pattern)
        if bad:
            raise ValueError(
                f"layer pattern {self.pattern!r} contains reserved "
                f"character(s) {''.join(sorted(bad))!r}")
        if not self.overrides:
            raise ValueError(f"rule {self.pattern!r} has no overrides; "
                             f"expected '{self.pattern}=key:value[,...]'")
        bad_reduce = sorted(k for k, _ in self.overrides
                            if k.startswith("reduce."))
        if bad_reduce:
            raise ValueError(
                f"rule {self.pattern!r} sets {', '.join(bad_reduce)}: the "
                f"gradient reduce is one global contract (one canonical "
                f"segmentation of the global batch), not a per-layer "
                f"property; set reduce.* on the plan's default spec "
                f"(e.g. 'lns16-train-pallas,reduce.grad_segments=4;...')")

    def matches(self, path: str) -> bool:
        return fnmatch.fnmatchcase(path, self.pattern)

    def __str__(self) -> str:
        return self.pattern + "=" + ",".join(
            f"{k}:{v}" for k, v in self.overrides)


@dataclasses.dataclass(frozen=True)
class NumericsPlan:
    """A default :class:`NumericsSpec` plus per-layer glob overrides."""

    default: NumericsSpec
    rules: Tuple[PlanRule, ...] = ()

    def __post_init__(self):
        for rule in self.rules:
            apply_kv_overrides(self.default, rule.overrides)

    @staticmethod
    def parse(text: "str | NumericsSpec | NumericsPlan") -> "NumericsPlan":
        """Parse a plan string, spec string, spec, or plan (pass-through)."""
        if isinstance(text, NumericsPlan):
            return text
        if isinstance(text, NumericsSpec):
            return NumericsPlan(default=text)
        return _parse_plan_cached(str(text))

    def __str__(self) -> str:
        return ";".join([str(self.default)] + [str(r) for r in self.rules])

    def resolve(self, path: str) -> NumericsSpec:
        """The spec layer ``path`` runs under (default + matching rules)."""
        return _resolve_cached(self, path)

    def validate_paths(self, paths) -> "NumericsPlan":
        """Raise if any rule pattern matches none of ``paths`` (a typo'd
        pattern would otherwise train a layer under the wrong format)."""
        paths = tuple(paths)
        dead = [str(r) for r in self.rules
                if not any(r.matches(p) for p in paths)]
        if dead:
            raise ValueError(f"numerics plan rule(s) {dead} match no layer "
                             f"path; known layer paths: {', '.join(paths)}")
        return self

    def with_(self, **kw) -> "NumericsPlan":
        """Typed overrides applied to the default spec (rules kept)."""
        return dataclasses.replace(self, default=self.default.with_(**kw))

    @property
    def fmt(self):
        return self.default.fmt

    @property
    def delta_spec(self):
        return self.default.delta_spec

    @property
    def backend(self) -> str:
        return self.default.backend

    @property
    def reduce(self):
        return self.default.reduce


def _canonical_rule(default: NumericsSpec, pattern: str, kv) -> PlanRule:
    """A rule with validated override values, re-serialized from the
    resolved spec so that equal rules compare equal and print alike."""
    keys = [k for k, _ in kv]
    if len(keys) != len(set(keys)):
        dup = sorted(k for k in set(keys) if keys.count(k) > 1)
        raise ValueError(
            f"rule {pattern!r} sets {', '.join(dup)} more than once")
    flat = apply_kv_overrides(default, kv)._flat()
    return PlanRule(pattern=pattern,
                    overrides=tuple((k, flat[k]) for k in sorted(keys)))


@functools.lru_cache(maxsize=None)
def _parse_plan_cached(text: str) -> NumericsPlan:
    segments = [s.strip() for s in text.split(";")]
    if not segments[0]:
        raise ValueError("empty numerics plan; expected '<default spec>"
                         "[;<pattern>=<key>:<value>,...]...'")
    default = NumericsSpec.parse(segments[0])
    rules = []
    for seg in segments[1:]:
        if not seg:
            continue
        if "=" not in seg:
            raise ValueError(f"plan rule {seg!r} has no '='; expected "
                             f"'<pattern>=<key>:<value>[,<key>:<value>...]'")
        pattern, body = (p.strip() for p in seg.split("=", 1))
        kv = []
        for tok in body.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if ":" not in tok:
                raise ValueError(f"plan override {tok!r} in rule "
                                 f"{pattern!r} has no ':'")
            kv.append(tuple(p.strip() for p in tok.split(":", 1)))
        rules.append(_canonical_rule(default, pattern, kv))
    return NumericsPlan(default=default, rules=tuple(rules))


@functools.lru_cache(maxsize=None)
def _resolve_cached(plan: NumericsPlan, path: str) -> NumericsSpec:
    spec = plan.default
    for rule in plan.rules:
        if rule.matches(path):
            spec = apply_kv_overrides(spec, rule.overrides)
    return spec

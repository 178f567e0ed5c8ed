"""Per-layer numerics: ``NumericsPlan`` — glob patterns → spec overrides.

Serialized form (``parse``/``str`` round-trip losslessly)::

    lns16-train-pallas;hidden=fmt:lns12,delta:lut20;out=delta:bitshift
    └─ default spec ──┘└─ rule 1 ────────────────┘└─ rule 2 ──────────┘

The first ``;``-separated segment is any :class:`NumericsSpec` string;
each rule is ``<pattern>=<key>:<value>[,<key>:<value>...]`` with the
spec-string vocabulary.  Patterns are ``fnmatch`` globs over layer paths
(the paper MLP has ``hidden`` and ``out``).  :meth:`NumericsPlan.resolve`
applies every matching rule on top of the default, in declaration order.
A plan with no rules reads through to its default spec, so it can stand
wherever a spec does.  :meth:`NumericsPlan.runtime_for` gives a layer's
resolved :class:`~repro_torch.core.spec.LNSRuntime`; layers whose specs are
equal share one cached runtime.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import Tuple

from .spec import LNSRuntime, NumericsSpec, apply_kv_overrides

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
        keys = [k for k, _ in self.overrides]
        if len(keys) != len(set(keys)):
            dup = sorted(k for k in set(keys) if keys.count(k) > 1)
            raise ValueError(
                f"rule {self.pattern!r} sets {', '.join(dup)} more than once")
        bad_reduce = sorted(k for k in keys if k.startswith("reduce."))
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

    def runtime_for(self, path: str, block_m: int = 128, block_n: int = 128,
                    block_k: int = 128) -> LNSRuntime:
        """The resolved runtime of layer ``path``; layers whose resolved
        specs are equal share one cached runtime."""
        return self.resolve(path).runtime(block_m=block_m, block_n=block_n,
                                          block_k=block_k)

    def runtime(self, block_m: int = 128, block_n: int = 128,
                block_k: int = 128) -> LNSRuntime:
        """The default spec's runtime (what un-planned call sites use)."""
        return self.default.runtime(block_m=block_m, block_n=block_n,
                                    block_k=block_k)

    def resolve_layers(self, paths) -> dict:
        """``{path: resolved spec}`` for every path, after validation."""
        self.validate_paths(paths)
        return {p: self.resolve(p) for p in paths}

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

    def diff(self, other, paths=None) -> dict:
        """Which spec keys differ from ``other``, and where:
        ``{where: {key: (mine, theirs)}}`` over serialized values.

        ``"<default>"`` compares the default specs.  With ``paths`` each
        layer path compares its resolved spec; without, the rules compare
        pattern by pattern, each pattern's last value of a key counting
        (``None`` where only one side sets it)."""
        other = NumericsPlan.parse(other)
        out: dict = {}
        mine_d, theirs_d = self.default._flat(), other.default._flat()
        d = {k: (mine_d[k], theirs_d[k]) for k in mine_d
             if mine_d[k] != theirs_d[k]}
        if d:
            out["<default>"] = d
        if paths is not None:
            for p in paths:
                a, b = self.resolve(p)._flat(), other.resolve(p)._flat()
                dd = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
                if dd:
                    out[p] = dd
            return out

        def effective(plan):
            eff: dict = {}
            for r in plan.rules:
                eff.setdefault(r.pattern, {}).update(dict(r.overrides))
            return eff
        mine, theirs = effective(self), effective(other)
        for pat in dict.fromkeys(r.pattern for plan in (self, other)
                                 for r in plan.rules):
            a_kv, b_kv = mine.get(pat, {}), theirs.get(pat, {})
            dd = {k: (a_kv.get(k), b_kv.get(k))
                  for k in sorted(set(a_kv) | set(b_kv))
                  if a_kv.get(k) != b_kv.get(k)}
            if dd:
                out[pat] = dd
        return out

    def with_(self, **kw) -> "NumericsPlan":
        """Typed overrides applied to the default spec (rules kept)."""
        return dataclasses.replace(self, default=self.default.with_(**kw))

    def with_rule(self, pattern: str, **kv) -> "NumericsPlan":
        """Append one rule from serialized ``key=value`` strings."""
        rule = _canonical_rule(self.default, pattern,
                               [(k, str(v)) for k, v in kv.items()])
        return dataclasses.replace(self, rules=self.rules + (rule,))

    @property
    def is_uniform(self) -> bool:
        """True when every layer resolves to the default spec."""
        return not self.rules

    # -- read-through views of the default spec --------------------------
    @property
    def fmt(self):
        return self.default.fmt

    @property
    def delta_spec(self):
        return self.default.delta_spec

    @property
    def quantize(self) -> str:
        return self.default.quantize

    @property
    def compute_dtype(self) -> str:
        return self.default.compute_dtype

    @property
    def backend(self) -> str:
        return self.default.backend

    @property
    def interpret(self) -> str:
        return self.default.interpret

    @property
    def reduce(self):
        return self.default.reduce

    @property
    def quantize_params(self) -> bool:
        return self.default.quantize_params

    @property
    def quantize_acts(self) -> bool:
        return self.default.quantize_acts

    @property
    def quantize_grads(self) -> bool:
        return self.default.quantize_grads

    @property
    def lns_grad(self) -> bool:
        return self.default.quantize_grads


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


def get_plan(name: "str | NumericsSpec | NumericsPlan") -> NumericsPlan:
    """Resolve any numerics descriptor (alias / spec / plan) to a plan."""
    return NumericsPlan.parse(name)


def plan_diff(a, b, paths=None, labels=("a", "b")) -> str:
    """:meth:`NumericsPlan.diff` for people: a header naming ``labels``,
    then one ``<where>: <key> <a-value> -> <b-value>`` line per place
    (``-`` where a side sets nothing), or ``(no differences)``."""
    a, b = NumericsPlan.parse(a), NumericsPlan.parse(b)
    delta = a.diff(b, paths=paths)
    head = f"numerics diff ({labels[0]} vs {labels[1]}):"
    if not delta:
        return f"{head} (no differences)"
    lines = [head]
    order = ["<default>"] + [w for w in delta if w != "<default>"]
    for where in order:
        if where not in delta:
            continue
        changes = ", ".join(
            f"{k} {'-' if av is None else av} -> {'-' if bv is None else bv}"
            for k, (av, bv) in sorted(delta[where].items()))
        lines.append(f"  {where}: {changes}")
    return "\n".join(lines)

"""Deterministic fault injection: ``FaultPlan`` — glob rules → faults.

Training on edge hardware with fixed-point log-domain arithmetic is the
regime where bit flips, Δ-table corruption and lost devices are real
events.  This module makes them *reproducible inputs*: a
:class:`FaultPlan` is a seed-keyed, serializable description of which
faults hit which layers at which steps, with the shape of
:class:`~repro_torch.core.plan.NumericsPlan` (glob rules, a lossless
``parse`` / ``str`` round trip, the ``validate_paths`` typo guard).  Plan
strings are the JAX package's, and mean the same faults bit for bit.

Serialized form::

    seed=42,start=3,stop=4;hidden=flip_w:0.001,sat_lanes:2;serve=hang_step:3
    └─ head: plan keys ──┘ └─ rule 1 ─────────────────────┘└─ rule 2 ────┘

* segments are ``;``-separated; the first (always present, ``seed`` is
  always printed) holds the plan keys: ``seed`` (the root of every
  stochastic fault), ``start`` / ``stop`` (the half-open step window
  ``[start, stop)`` of the per-step faults; ``stop=-1`` = no end);
* each rule is ``<pattern>=<kind>:<value>[,...]``: an fnmatch glob over
  layer paths (or the pseudo-path ``serve``) and kinds of
  :data:`FAULT_KINDS`.

The contract mirrors the telemetry's (``obs/metrics.py``):

* **No plan ⇒ no op.**  Every helper returns its input *object*
  unchanged when no plan is active or no rule matches, so the step runs
  exactly the ops of a fault-free build.
* **Deterministic.**  Every stochastic choice derives from
  ``fold_in(PRNGKey(plan.seed), crc32(site))`` (and the step, for
  per-step faults) on the JAX package's threefry generator
  (``resil/prng.py``), so the same plan draws the same faults as the
  reference, on the card and on the CPU alike: the sites sit *between*
  ops, on the code tensors both lanes share.
* **Ambient activation.**  A plan is activated with ``with
  injecting(plan, step):`` around a step; library code consults
  :func:`active_plan` and never threads plans through signatures.
  ``suspended()`` masks it over a region (the data-parallel step's
  per-segment backward, gather and combine).

The step is data: a Python int or an integer tensor (a tensor on the card
keeps the window test and the keys on the card, with no host sync).

This module imports nothing of ``repro_torch.core``: the fault surface is
duck-typed — an LNS format is anything with ``qi`` / ``qf`` / ``code_max``
/ ``zero_code``, an LNS tensor anything with ``.code`` / ``.sign``
rebuilt by ``type(a)(code, sign)``, and a Δ engine is copied with other
tables by its ``with_tables``.  ``serve_faults`` hands the serve
engine (``serve/engine.py``) its faults.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import functools
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from . import prng

#: Characters that would collide with the plan/rule/value separators.
_PATTERN_FORBIDDEN = set(";=,:")


def _parse_rate(kind, v):
    r = float(v)
    if not (0.0 < r <= 1.0):
        raise ValueError(f"fault {kind}:{v} — rate must be in (0, 1]")
    return r


def _parse_count(kind, v, lo=1):
    n = int(v)
    if n < lo:
        raise ValueError(f"fault {kind}:{v} — expected an integer >= {lo}")
    return n


#: kind → (parse+validate, canonical-serialize).  The closed vocabulary of
#: injectable faults; extend only by appending (drill baselines key on it).
FAULT_KINDS = {
    # per-step (keyed by plan.seed × site × step):
    "flip_w":    (lambda v: _parse_rate("flip_w", v), repr),      # weight-code bit-flip rate
    "flip_act":  (lambda v: _parse_rate("flip_act", v), repr),    # activation-code bit-flip rate
    "sat_lanes": (lambda v: _parse_count("sat_lanes", v), str),   # stuck-at-code_max output lanes
    # host-static (applied when the model is built):
    "lut":       (lambda v: _parse_count("lut", v), str),         # corrupted Δ-LUT entries per table
    # DP segment-partial faults (deterministic, no randomness):
    "drop_seg":  (lambda v: _parse_count("drop_seg", v, 0), str),  # global segment index zeroed
    "dup_seg":   (lambda v: _parse_count("dup_seg", v, 0), str),   # global segment index cloned into +1
    # serve-engine faults (host-side, pattern 'serve'):
    "hang_step": (lambda v: _parse_count("hang_step", v, 0), str),  # engine step that "hangs"
    "slow_req":  (lambda v: _parse_count("slow_req", v), str),      # rid % v == 0 decodes at half speed
}


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One ``pattern=kind:value,...`` rule of a :class:`FaultPlan`.

    ``faults`` holds canonicalized ``(kind, value-string)`` pairs sorted
    by kind, so equal-meaning rules compare/hash equal and the plan's
    ``str`` round-trips losslessly.
    """

    pattern: str
    faults: Tuple[Tuple[str, str], ...]

    def __post_init__(self):
        if not self.pattern:
            raise ValueError("empty layer pattern in fault plan rule")
        bad = _PATTERN_FORBIDDEN & set(self.pattern)
        if bad:
            raise ValueError(
                f"fault pattern {self.pattern!r} contains reserved "
                f"character(s) {''.join(sorted(bad))!r}; patterns are "
                f"fnmatch globs over layer paths (e.g. 'hidden', "
                f"'layers.*') or the pseudo-path 'serve'")
        if not self.faults:
            raise ValueError(
                f"rule {self.pattern!r} has no faults; expected "
                f"'{self.pattern}=kind:value[,kind:value...]'")
        kinds = [k for k, _ in self.faults]
        if len(kinds) != len(set(kinds)):
            dup = sorted(k for k in set(kinds) if kinds.count(k) > 1)
            raise ValueError(
                f"rule {self.pattern!r} sets {', '.join(dup)} more than "
                f"once")
        for k, _ in self.faults:
            if k not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {k!r} in rule {self.pattern!r}; "
                    f"valid kinds: {', '.join(sorted(FAULT_KINDS))}")

    def matches(self, path: str) -> bool:
        return fnmatch.fnmatchcase(path, self.pattern)

    def __str__(self) -> str:
        return self.pattern + "=" + ",".join(
            f"{k}:{v}" for k, v in self.faults)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed-keyed schedule of injected faults over layer-path globs.

    Frozen and hashable, like :class:`NumericsPlan`; the plan rides on
    the model's config.  Rules apply in declaration order; a later
    matching rule overrides an earlier one kind by kind.
    """

    seed: int = 0
    start: int = 0         # first step per-step faults fire (inclusive)
    stop: int = -1         # first step they stop (-1 = never)
    rules: Tuple[FaultRule, ...] = ()

    def __post_init__(self):
        if self.start < 0:
            raise ValueError(f"start must be >= 0, got {self.start}")
        if self.stop != -1 and self.stop <= self.start:
            raise ValueError(
                f"stop={self.stop} must be -1 (open) or > start="
                f"{self.start}")

    # -- parse / serialize ------------------------------------------------
    @staticmethod
    def parse(text: "str | FaultPlan | None") -> "Optional[FaultPlan]":
        """Parse a fault-plan string (``None``/``''`` pass through as
        ``None`` — no plan, true no-op)."""
        if text is None or isinstance(text, FaultPlan):
            return text
        text = str(text).strip()
        if not text:
            return None
        return _parse_fault_plan_cached(text)

    def __str__(self) -> str:
        head = [f"seed={self.seed}"]
        if self.start:
            head.append(f"start={self.start}")
        if self.stop != -1:
            head.append(f"stop={self.stop}")
        return ";".join([",".join(head)] + [str(r) for r in self.rules])

    # -- resolution -------------------------------------------------------
    def resolve(self, path: str) -> dict:
        """``{kind: typed value}`` hitting layer ``path`` (later rules
        override earlier ones per kind — the NumericsPlan precedence
        contract)."""
        return _resolve_faults_cached(self, path)

    def validate_paths(self, paths) -> "FaultPlan":
        """Raise if any rule pattern matches none of ``paths`` — a typo'd
        pattern must not silently inject nothing."""
        paths = tuple(paths)
        dead = [str(r) for r in self.rules
                if not any(r.matches(p) for p in paths)]
        if dead:
            raise ValueError(
                f"fault plan rule(s) {dead} match no layer path; "
                f"known layer paths: {', '.join(paths)}")
        return self


@functools.lru_cache(maxsize=None)
def _parse_fault_plan_cached(text: str) -> FaultPlan:
    segments = [s.strip() for s in text.split(";")]
    head, keys = segments[0], {}
    for tok in head.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok or ":" in tok:
            raise ValueError(
                f"fault plan head token {tok!r}; the first segment is "
                f"'seed=N[,start=A][,stop=B]' (rules come after the "
                f"first ';')")
        k, v = (p.strip() for p in tok.split("=", 1))
        if k not in ("seed", "start", "stop"):
            raise ValueError(
                f"unknown fault plan key {k!r}; valid keys: seed, "
                f"start, stop")
        if k in keys:
            raise ValueError(f"fault plan sets {k} more than once")
        keys[k] = int(v)
    rules = []
    for seg in segments[1:]:
        if not seg:
            continue
        if "=" not in seg:
            raise ValueError(
                f"fault rule {seg!r} has no '='; expected "
                f"'<pattern>=<kind>:<value>[,<kind>:<value>...]'")
        pattern, body = (p.strip() for p in seg.split("=", 1))
        kv = []
        for tok in body.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if ":" not in tok:
                raise ValueError(
                    f"fault {tok!r} in rule {pattern!r} has no ':'; "
                    f"expected '<kind>:<value>'")
            kv.append(tuple(p.strip() for p in tok.split(":", 1)))
        rules.append(_canonical_fault_rule(pattern, kv))
    return FaultPlan(rules=tuple(rules), **keys)


def _canonical_fault_rule(pattern: str, kv) -> FaultRule:
    """Validate values through :data:`FAULT_KINDS` and re-serialize them
    canonically (``flip_w:1e-3`` stores as ``0.001``) so ``parse``/``str``
    round-trips losslessly and rule equality is semantic."""
    out = []
    for kind, v in kv:
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in rule {pattern!r}; "
                f"valid kinds: {', '.join(sorted(FAULT_KINDS))}")
        parse, serialize = FAULT_KINDS[kind]
        out.append((kind, serialize(parse(v))))
    return FaultRule(pattern=pattern,
                     faults=tuple(sorted(out)))


@functools.lru_cache(maxsize=None)
def _resolve_faults_cached(plan: FaultPlan, path: str) -> dict:
    faults = {}
    for rule in plan.rules:
        if rule.matches(path):
            for kind, v in rule.faults:
                faults[kind] = FAULT_KINDS[kind][0](v)
    return faults


def fault_plan(pattern_faults: dict = None, *, seed: int = 0,
               start: int = 0, stop: int = -1) -> FaultPlan:
    """Convenience constructor: ``fault_plan({"hidden": "flip_w:0.01"})``."""
    rules = []
    for pattern, body in (pattern_faults or {}).items():
        kv = [tuple(p.strip() for p in tok.split(":", 1))
              for tok in body.split(",") if tok.strip()]
        rules.append(_canonical_fault_rule(pattern, kv))
    return FaultPlan(seed=seed, start=start, stop=stop, rules=tuple(rules))


# -- ambient activation (the obs collector-stack pattern) -----------------
_ACTIVE: list = []   # (plan | None, step | None) — top of stack wins


@contextlib.contextmanager
def injecting(plan: Optional[FaultPlan], step=None):
    """Activate ``plan`` (with ``step``, an int or an integer tensor, for
    windowed faults) for the enclosed step.  ``injecting(None)`` is a true
    no-op: every helper sees no plan."""
    _ACTIVE.append((plan, step))
    try:
        yield
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def suspended():
    """Mask any active plan over a region."""
    _ACTIVE.append((None, None))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE[-1][0] if _ACTIVE else None


def active_step():
    return _ACTIVE[-1][1] if _ACTIVE else None


# -- keying + windowing ---------------------------------------------------
def _step_on(step, device):
    """The step as a Python int, or as a tensor on ``device``."""
    if isinstance(step, torch.Tensor):
        return step.to(device)
    return step


def _site_key(plan: FaultPlan, site: str, step=None) -> tuple:
    """Per-site threefry key: root seed × crc32(site) × step."""
    key = prng.fold_in(prng.prng_key(plan.seed),
                       zlib.crc32(site.encode()) & 0x7FFFFFFF)
    if step is not None:
        key = prng.fold_in(key, step)
    return key


def _window(plan: FaultPlan, step):
    """Is ``step`` inside ``[start, stop)``?  A bool tensor for a tensor
    step, a bool for an int; ``None`` (no step) means statically open."""
    if step is None:
        return None
    m = step >= plan.start
    if plan.stop != -1:
        m = m & (step < plan.stop)
    return m


def _masked(hit, window):
    return hit if window is None else hit & window


# -- injection helpers ----------------------------------------------------
def _flip_bits(code: torch.Tensor, rate: float, nbits: int, key, window):
    """Flip one uniformly chosen low bit of ``code`` per hit element.

    Codes live in ``[-(2^n), 2^n - 1]`` with ``n = qi + qf``; xor-ing any
    bit ``b < n`` keeps the result in range (a flip *can* land on the
    ``zero_code`` sentinel: a flush to zero, as such a flip is in
    hardware).
    """
    kh, kb = prng.split(key)
    hit = _masked(prng.uniform(kh, code.shape, code.device) < rate, window)
    bit = prng.randint(kb, code.shape, 0, nbits, code.device)
    return torch.where(hit, code ^ (torch.ones_like(code) << bit), code)


@functools.lru_cache(maxsize=None)
def _stuck_lanes(seed: int, site: str, ncols: int, lanes: int,
                 device: torch.device) -> torch.Tensor:
    """The host-static choice of stuck last-axis lanes (a broken MAC
    column), as a bool mask on ``device``: made once, so a step copies
    nothing to the card."""
    rng = np.random.default_rng(seed ^ zlib.crc32(site.encode()))
    pick = np.zeros((ncols,), bool)
    pick[rng.permutation(ncols)[:min(lanes, ncols)]] = True
    return torch.as_tensor(pick, device=device)


def inject_codes(a, fmt, *, layer: str, site: str = "act"):
    """Inject activation-plane faults (``flip_act``, ``sat_lanes``) into
    the LNS tensor ``a``; returns ``a`` itself when nothing applies."""
    plan = active_plan()
    if plan is None:
        return a
    faults = plan.resolve(layer)
    rate, lanes = faults.get("flip_act"), faults.get("sat_lanes")
    if rate is None and lanes is None:
        return a
    code, sign = a.code, a.sign
    step = _step_on(active_step(), code.device)
    window = _window(plan, step)
    if rate is not None:
        key = _site_key(plan, f"{layer}/{site}/flip_act", step)
        code = _flip_bits(code, rate, fmt.qi + fmt.qf, key, window)
    if lanes is not None:
        # Stuck-at-saturation output lanes pin to +code_max inside the
        # step window.
        mask = _masked(_stuck_lanes(plan.seed, f"{layer}/{site}/sat_lanes",
                                    code.shape[-1], lanes, code.device),
                       window)
        code = torch.where(mask, fmt.code_max, code)
        sign = torch.where(mask, torch.zeros_like(sign), sign)
    return type(a)(code, sign)


def inject_param_codes(params: dict, *, param_fmts: dict,
                       param_layer: dict):
    """Inject ``flip_w`` weight-code bit flips into a parameter dict;
    returns the *same dict object* when no parameter is hit."""
    plan = active_plan()
    if plan is None:
        return params
    out, changed = {}, False
    for k, w in params.items():
        rate = plan.resolve(param_layer[k]).get("flip_w")
        if rate is None:
            out[k] = w
            continue
        fmt = param_fmts[k]
        step = _step_on(active_step(), w.code.device)
        key = _site_key(plan, f"{param_layer[k]}/w.{k}/flip_w", step)
        code = _flip_bits(w.code, rate, fmt.qi + fmt.qf, key,
                          _window(plan, step))
        out[k] = type(w)(code, w.sign)
        changed = True
    return out if changed else params


def inject_segment_partials(grads: dict, *, param_fmts: dict,
                            param_layer: dict, segs_local: int,
                            rank: int = 0, plan: FaultPlan = None):
    """Inject data-parallel segment-partial faults (``drop_seg`` /
    ``dup_seg``).

    Operates on per-segment gradient partials with a leading local
    segment axis (``segs_local`` slots of rank ``rank``: global slots
    ``rank × segs_local`` on).  ``drop_seg:s`` zeroes global segment
    ``s``'s partial (a lost device, a dropped message); ``dup_seg:s``
    overwrites slot ``s+1`` with a copy of slot ``s`` (a duplicated
    message), only where both slots live on this rank, as a retransmit
    fault shows.  Pass ``plan`` explicitly where the ambient plan is
    suspended (the data-parallel step's per-segment region).  Segment
    faults are not step-windowed: they model a persistent transport
    fault, active for as long as the plan is.

    Returns the same dict object when no segment fault is configured.
    """
    if plan is None:
        plan = active_plan()
    if plan is None:
        return grads
    out, changed = {}, False
    for k, g in grads.items():
        faults = plan.resolve(param_layer[k])
        drop, dup = faults.get("drop_seg"), faults.get("dup_seg")
        if drop is None and dup is None:
            out[k] = g
            continue
        fmt = param_fmts[k]
        code, sign = g.code, g.sign
        slot = torch.arange(segs_local, device=code.device)
        glob = slot + rank * segs_local
        shape1 = (segs_local,) + (1,) * (code.ndim - 1)
        if drop is not None:
            m = (glob == drop).reshape(shape1)
            code = torch.where(m, fmt.zero_code, code)
            sign = torch.where(m, torch.zeros_like(sign), sign)
        if dup is not None:
            # slot s+1 := slot s, when both live on this rank
            m = ((glob == dup + 1) & (slot > 0)).reshape(shape1)
            code = torch.where(m, torch.roll(code, 1, 0), code)
            sign = torch.where(m, torch.roll(sign, 1, 0), sign)
        out[k] = type(g)(code, sign)
        changed = True
    return out if changed else grads


# -- host-side (build-time) injection -------------------------------------
def corrupt_engine(eng, plan: Optional[FaultPlan], layer: str):
    """Return a copy of Δ engine ``eng`` with ``lut`` faults applied: n
    entries of each table get one low bit flipped (clipped back into the
    table's live range, so the arithmetic stays in format — the entry is
    *wrong*, not out of domain).  Returns ``eng`` itself when no ``lut``
    fault targets ``layer``, or when the engine has no tables
    (``exact`` / ``bitshift`` compute Δ; only ``lut`` engines model a
    corruptible ROM).

    Engines are cached and shared, so the copy is made with
    ``eng.with_tables``: new tables and a device-table cache of its own.
    It feeds the ⊞ sites that read the model's engine (the bias-gradient
    ⊞-fold, the unfused update, the tree combine, the dhist replay); the
    kernels and their plain versions build their tables from the format
    and Δ spec, and stay clean, as the JAX package's Pallas kernels do.
    """
    if plan is None:
        return eng
    n = plan.resolve(layer).get("lut")
    if not n or getattr(eng, "spec", None) is None \
            or eng.spec.kind != "lut":
        return eng
    rng = np.random.default_rng(
        plan.seed ^ zlib.crc32(f"{layer}/lut".encode()))
    tables = {}
    for name in ("_tab_plus", "_tab_minus"):
        tab = np.array(getattr(eng, name))
        lo = 1 if name == "_tab_minus" else 0  # keep the flush sentinel
        live = tab[lo:]
        if live.size:
            k = min(n, live.size)
            idx = lo + rng.permutation(live.size)[:k]
            bits = rng.integers(0, 3, size=k)
            tab[idx] = np.clip(tab[idx] ^ (1 << bits).astype(np.int32),
                               int(live.min()), int(live.max()))
        tables[name] = tab
    return eng.with_tables(tables["_tab_plus"], tables["_tab_minus"])


# -- serve-side fault queries (host Python) --------------------------------
def serve_faults(plan: Optional[FaultPlan]) -> dict:
    """The faults targeting the serve engine (pseudo-path ``'serve'``):
    ``hang_step`` and ``slow_req``, read by ``ServingEngine.step``."""
    if plan is None:
        return {}
    return plan.resolve("serve")

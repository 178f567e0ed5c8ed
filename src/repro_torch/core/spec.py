"""``NumericsSpec`` → ``LNSRuntime``: the serializable descriptor of the
LNS arithmetic, and the spec resolved once.

:class:`NumericsSpec` holds format, Δ approximation, which tensors are
quantized, compute dtype, backend, interpret mode, kernel blocks,
telemetry and the data-parallel gradient reduce (:class:`ReduceSpec`).
``parse`` accepts a registry alias (``"lns16-train-pallas"``), a
``key=value`` list, or an alias plus overrides
(``"lns16-train-pallas,delta=bitshift"``); ``str`` gives the same
canonical text as the JAX package does.

:class:`LNSRuntime` is what the LM layers call: ``q_param`` / ``q_act`` /
``linear`` dispatch each weight product to the ⊞-MAC path the spec names,
with the shared ⊞-MAC backend and Δ engine.

Two keys are parsed, validated and printed so that reference strings
load unchanged, but route no lane here: ``backend`` and ``interpret``.
The device of the operands chooses the lane (see
:class:`~repro_torch.core.lns.LNSMatmulBackend`).  ``backend`` still picks
the *arithmetic* of a forward-only product, as in the JAX package:
``emulate`` is the pairwise tree of ``lns_dot_exact``, ``pallas`` the
sequential ⊞-MAC of ``lns_dot_dispatch`` (see :meth:`LNSRuntime.linear`).

``blocks`` sets the one launch parameter the CUDA kernels read, the tiled
⊞-MAC's output rows per block (see :data:`BLOCK_MODES`); it changes no
result.

``metrics`` sets a layer's telemetry as in the JAX package: ``off``,
``counters``, or ``full`` (the counters and the Δ-table occupancy
histogram), read by the metrics entry points of ``paper/mlp.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import torch

from .delta import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_EXACT, DELTA_SOFTMAX,
                    DeltaSpec)
from .formats import FORMATS, LNS12, LNS16, LNSFormat
from .lns import LNSMatmulBackend

MATMUL_BACKENDS = ("emulate", "pallas")
QUANTIZE_AXES = ("params", "acts", "grads")
COMPUTE_DTYPES = ("float32", "bfloat16", "float16")
REDUCE_MODES = ("boxplus", "float-psum")
REDUCE_SCHEDULES = ("sequential", "tree")
INTERPRET_MODES = ("auto", "on", "off")
#: Telemetry eligibility per spec: "counters", "full" (also the Δ-LUT
#: occupancy histogram) or "off".
METRICS_MODES = ("off", "counters", "full")
#: Kernel tiling: "default", "auto" (the autotuner) or an explicit
#: "MxNxK" (block_m × block_n × block_k).  On the card these set the tiled
#: ⊞-MAC's output rows per block, the one launch parameter it reads:
#: "default" 4, "auto" the autotuner's measured choice of 1, 2, 4 or 8 per
#: op and shape (``kernels/autotune.py``), "MxNxK" the largest of 1, 2, 4,
#: 8 that is at most M; N and K are read by nothing.  The short form, the
#: ⊞-SGD and the ⊞-reduce have one fixed launch shape.
BLOCK_MODES = ("default", "auto", "<M>x<N>x<K>")


def parse_blocks(text: str):
    """Decode an explicit ``MxNxK`` blocks value → (block_m, block_n,
    block_k); raises with the valid forms for anything else."""
    parts = text.split("x")
    if len(parts) == 3:
        try:
            bm, bn, bk = (int(p) for p in parts)
            if bm > 0 and bn > 0 and bk > 0:
                return bm, bn, bk
        except ValueError:
            pass
    raise _bad_value("blocks", text, BLOCK_MODES)


def resolve_blocks_arg(blocks: str, block_m: int, block_n: int,
                       block_k: int):
    """Fold a spec's ``blocks`` axis onto caller-supplied tile sizes:
    ``(block_m, block_n, block_k, mode)``, ``mode`` "auto" or "default";
    an explicit ``MxNxK`` overrides the caller's sizes."""
    if blocks == "auto":
        return block_m, block_n, block_k, "auto"
    if blocks != "default":
        bm, bn, bk = parse_blocks(blocks)
        return bm, bn, bk, "default"
    return block_m, block_n, block_k, "default"


#: Named Δ specs; other LUTs round-trip as ``lut:<d_max>:<r>``.
DELTA_NAMES = {
    "lut20": DELTA_DEFAULT,        # paper default: d_max=10, r=1/2
    "lut640": DELTA_SOFTMAX,       # softmax-grade: d_max=10, r=1/64
    "bitshift": DELTA_BITSHIFT,
    "exact": DELTA_EXACT,
}
_DELTA_REVERSE = {v: k for k, v in DELTA_NAMES.items()}

#: The formats a spec may name: the linear fixed-point ones are refused.
_LNS_FORMATS = {n: f for n, f in FORMATS.items() if isinstance(f, LNSFormat)}


def _bad_value(key, got, valid):
    return ValueError(
        f"invalid {key}={got!r}; valid values: {', '.join(map(str, valid))}")


@dataclasses.dataclass(frozen=True)
class ReduceSpec:
    """Data-parallel gradient-reduction semantics (the ⊞ contract).

    ``mode="boxplus"`` cuts the global batch into ``grad_segments``
    contiguous equal segments and ⊞-combines their partials on a fixed
    ``schedule`` that depends on the segment count alone;
    ``mode="float-psum"`` decodes, sums in float across ranks and
    re-encodes (not bit-stable across rank counts).  ``grad_segments=0``
    resolves to the rank count at run time.
    """

    mode: str = "boxplus"
    grad_segments: int = 0
    schedule: str = "sequential"

    def __post_init__(self):
        if self.mode not in REDUCE_MODES:
            raise _bad_value("reduce.mode", self.mode, REDUCE_MODES)
        if self.schedule not in REDUCE_SCHEDULES:
            raise _bad_value("reduce.schedule", self.schedule,
                             REDUCE_SCHEDULES)
        if self.grad_segments < 0:
            raise _bad_value("reduce.grad_segments", self.grad_segments,
                             ("any integer >= 0",))

    def with_(self, **kw) -> "ReduceSpec":
        return dataclasses.replace(self, **kw)


_REDUCE_FIELDS = ("mode", "grad_segments", "schedule")


@dataclasses.dataclass(frozen=True)
class NumericsSpec:
    """One frozen descriptor of the approximate arithmetic.

    ======================  ==========  ===================================
    field                   key         values
    ======================  ==========  ===================================
    ``fmt``                 fmt         none | lns16 | lns12 | lns21
    ``delta_spec``          delta       none | lut20 | lut640 | bitshift |
                                        exact | ``lut:<d_max>:<r>``
    ``quantize``            quantize    none or ``+``-joined subset of
                                        params/acts/grads
    ``compute_dtype``       compute_dtype  float32 | bfloat16 | float16
    ``backend``             backend     emulate | pallas (printed only)
    ``interpret``           interpret   auto | on | off (printed only)
    ``blocks``              blocks      default | auto | ``<M>x<N>x<K>``
                                        (printed only)
    ``metrics``             metrics     off | counters | full
    ``reduce.mode``         reduce.mode  boxplus | float-psum
    ``reduce.grad_segments``  reduce.grad_segments  int >= 0
    ``reduce.schedule``     reduce.schedule  sequential | tree
    ======================  ==========  ===================================
    """

    fmt: Optional[LNSFormat] = None
    delta_spec: Optional[DeltaSpec] = None
    quantize: str = ""
    compute_dtype: str = "bfloat16"
    backend: str = "emulate"
    interpret: str = "auto"
    blocks: str = "default"
    metrics: str = "counters"
    reduce: ReduceSpec = ReduceSpec()

    def __post_init__(self):
        if self.backend not in MATMUL_BACKENDS:
            raise _bad_value("backend", self.backend, MATMUL_BACKENDS)
        if self.interpret not in INTERPRET_MODES:
            raise _bad_value("interpret", self.interpret, INTERPRET_MODES)
        if self.blocks not in ("default", "auto"):
            parse_blocks(self.blocks)
        if self.metrics not in METRICS_MODES:
            raise _bad_value("metrics", self.metrics, METRICS_MODES)
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise _bad_value("compute_dtype", self.compute_dtype,
                             COMPUTE_DTYPES)
        toks = [t for t in self.quantize.split("+") if t]
        for t in toks:
            if t not in QUANTIZE_AXES:
                raise _bad_value("quantize", self.quantize,
                                 ("none",) + QUANTIZE_AXES)
        object.__setattr__(self, "quantize",
                           "+".join(a for a in QUANTIZE_AXES if a in toks))
        if self.quantize and self.fmt is None:
            raise ValueError(f"quantize={self.quantize!r} requires an LNS "
                             f"fmt; valid fmt values: "
                             f"{', '.join(sorted(_LNS_FORMATS))}")
        if self.quantize_grads and self.delta_spec is None:
            raise ValueError("quantize='...+grads' requires a delta spec")
        if self.delta_spec is not None and self.fmt is None:
            raise ValueError("a delta spec requires an LNS fmt")

    @property
    def quantize_params(self) -> bool:
        return "params" in self.quantize.split("+")

    @property
    def quantize_acts(self) -> bool:
        return "acts" in self.quantize.split("+")

    @property
    def quantize_grads(self) -> bool:
        """End-to-end log-domain gradients (the ⊞-MAC backward path)."""
        return "grads" in self.quantize.split("+")

    # The JAX package's pre-spec field names.
    @property
    def lns_grad(self) -> bool:
        return self.quantize_grads

    @property
    def exact_spec(self) -> Optional[DeltaSpec]:
        return self.delta_spec

    @property
    def interpret_flag(self) -> Optional[bool]:
        """The tri-state as the JAX package's kernels take it."""
        return {"auto": None, "on": True, "off": False}[self.interpret]

    def with_(self, **kw) -> "NumericsSpec":
        """Validated copy with field overrides; dotted ``reduce.*`` keys
        update the nested :class:`ReduceSpec`.  Unknown keys raise with
        the valid ones."""
        names = {f.name for f in dataclasses.fields(self)}
        reduce_keys = tuple(f"reduce.{f}" for f in _REDUCE_FIELDS)
        flat, reduce_kw = {}, {}
        for k, v in kw.items():
            if k in reduce_keys:
                reduce_kw[k.split(".", 1)[1]] = v
            elif k in names:
                flat[k] = v
            else:
                raise _bad_value("override key", k,
                                 tuple(sorted(names)) + reduce_keys)
        if reduce_kw:
            flat["reduce"] = flat.get("reduce", self.reduce).with_(
                **reduce_kw)
        return dataclasses.replace(self, **flat)

    def runtime(self, block_m: int = 128, block_n: int = 128,
                block_k: int = 128) -> "LNSRuntime":
        """This spec resolved once into a cached :class:`LNSRuntime`."""
        return _cached_runtime(self, block_m, block_n, block_k)

    def _flat(self) -> dict:
        """Serialized ``key → value-string`` view (parse's inverse)."""
        return {
            "fmt": self.fmt.name if self.fmt is not None else "none",
            "delta": _delta_to_str(self.delta_spec),
            "quantize": self.quantize or "none",
            "compute_dtype": self.compute_dtype,
            "backend": self.backend,
            "interpret": self.interpret,
            "blocks": self.blocks,
            "metrics": self.metrics,
            "reduce.mode": self.reduce.mode,
            "reduce.grad_segments": str(self.reduce.grad_segments),
            "reduce.schedule": self.reduce.schedule,
        }

    def __str__(self) -> str:
        # The registry alias that differs in the fewest keys, then the
        # differing keys sorted (ties go to registry order).
        mine = self._flat()
        best_name, best_diff = None, None
        for name, spec in ALIASES.items():
            theirs = spec._flat()
            diff = {k: v for k, v in mine.items() if theirs[k] != v}
            if best_diff is None or len(diff) < len(best_diff):
                best_name, best_diff = name, diff
        return best_name + "".join(
            f",{k}={best_diff[k]}" for k in sorted(best_diff))

    @staticmethod
    def explicit_keys(text: "str | NumericsSpec") -> frozenset:
        """The ``key=value`` keys a spec string mentions (a spec object:
        those its ``str()`` carries)."""
        if isinstance(text, NumericsSpec):
            text = str(text)
        return frozenset(tok.split("=", 1)[0].strip()
                         for tok in str(text).split(",") if "=" in tok)

    @staticmethod
    def parse(text: "str | NumericsSpec") -> "NumericsSpec":
        """Parse an alias, a ``key=value`` list, or alias + overrides."""
        if isinstance(text, NumericsSpec):
            return text
        return _parse_cached(str(text))


def _delta_to_str(d: Optional[DeltaSpec]) -> str:
    if d is None:
        return "none"
    named = _DELTA_REVERSE.get(d)
    if named is not None:
        return named
    return f"lut:{d.d_max!r}:{d.r!r}"


def _delta_from_str(s: str) -> Optional[DeltaSpec]:
    if s == "none":
        return None
    if s in DELTA_NAMES:
        return DELTA_NAMES[s]
    if s.startswith("lut:"):
        try:
            _, d_max, r = s.split(":")
            return DeltaSpec(kind="lut", d_max=float(d_max), r=float(r))
        except ValueError:
            pass
    raise _bad_value("delta", s, ("none",) + tuple(sorted(DELTA_NAMES))
                     + ("lut:<d_max>:<r>",))


_PARSE_KEYS = ("fmt", "delta", "quantize", "compute_dtype", "backend",
               "interpret", "blocks", "metrics", "reduce.mode",
               "reduce.grad_segments", "reduce.schedule")


def override_from_kv(key: str, value: str):
    """Map one serialized ``key``/``value`` pair to a ``with_`` override.
    Shared by the spec parser and the plan's rule parser."""
    if key not in _PARSE_KEYS:
        raise _bad_value("spec key", key, _PARSE_KEYS)
    if key == "fmt":
        if value == "none":
            return "fmt", None
        if value not in _LNS_FORMATS:
            raise _bad_value("fmt", value,
                             ("none",) + tuple(sorted(_LNS_FORMATS)))
        return "fmt", _LNS_FORMATS[value]
    if key == "delta":
        return "delta_spec", _delta_from_str(value)
    if key == "quantize":
        return "quantize", "" if value == "none" else value
    if key == "reduce.grad_segments":
        try:
            return key, int(value)
        except ValueError:
            raise _bad_value(key, value, ("any integer >= 0",)) from None
    return key, value


def apply_kv_overrides(spec: NumericsSpec, items) -> NumericsSpec:
    """Apply serialized ``(key, value)`` string pairs onto ``spec``."""
    overrides = dict(override_from_kv(k, v) for k, v in items)
    return spec.with_(**overrides) if overrides else spec


@functools.lru_cache(maxsize=None)
def _parse_cached(text: str) -> NumericsSpec:
    tokens = [t.strip() for t in text.split(",") if t.strip()]
    if not tokens:
        raise ValueError(f"empty numerics spec; pass an alias "
                         f"({', '.join(ALIASES)}) or key=value pairs")
    if "=" in tokens[0]:
        spec = NumericsSpec()
    else:
        alias = tokens.pop(0)
        if alias not in ALIASES:
            raise ValueError(f"unknown numerics alias {alias!r}; the port "
                             f"has {sorted(ALIASES)}")
        spec = ALIASES[alias]
    kv = []
    for tok in tokens:
        if "=" not in tok:
            raise ValueError(f"expected key=value after the alias, got "
                             f"{tok!r}; valid keys: {', '.join(_PARSE_KEYS)}")
        kv.append(tuple(p.strip() for p in tok.split("=", 1)))
    return apply_kv_overrides(spec, kv)


#: The JAX package's nine aliases, in its order, so that ``str()``
#: canonicalizes onto the same nearest alias in both packages.  The QAT and
#: float ones parse and print; the paper MLP completes a spec without a
#: fmt or Δ from its ``bits`` / ``approx``.  The two training aliases run
#: the same arithmetic here.
ALIASES = {
    "fp32": NumericsSpec(compute_dtype="float32"),
    "bf16": NumericsSpec(compute_dtype="bfloat16"),
    "lns16-qat": NumericsSpec(fmt=LNS16, quantize="params+acts"),
    "lns12-qat": NumericsSpec(fmt=LNS12, quantize="params+acts"),
    "lns16-w-only": NumericsSpec(fmt=LNS16, quantize="params"),
    "lns16-exact": NumericsSpec(
        fmt=LNS16, quantize="params+acts", delta_spec=DELTA_DEFAULT,
        compute_dtype="float32"),
    "lns16-exact-pallas": NumericsSpec(
        fmt=LNS16, quantize="params+acts", delta_spec=DELTA_DEFAULT,
        compute_dtype="float32", backend="pallas"),
    "lns16-train-emulate": NumericsSpec(
        fmt=LNS16, quantize="params+acts+grads", delta_spec=DELTA_DEFAULT,
        compute_dtype="float32", backend="emulate"),
    "lns16-train-pallas": NumericsSpec(
        fmt=LNS16, quantize="params+acts+grads", delta_spec=DELTA_DEFAULT,
        compute_dtype="float32", backend="pallas"),
}


def resolve_kernel_args(numerics, *, fmt=None, spec=None, backend=None,
                        interpret=None, blocks=None, op: str = "kernel",
                        layer: "str | None" = None):
    """Fill a kernel entry point's config pieces from a spec or plan.

    Explicit arguments win over the spec; a missing fmt or Δ raises naming
    ``op``.  ``numerics`` may be a :class:`NumericsSpec`, a
    :class:`~repro_torch.core.plan.NumericsPlan` or their string; with a
    plan, ``layer`` picks the layer path whose resolved spec applies
    (default: the plan's default spec).  Returns ``(fmt, spec, backend,
    interpret, blocks)``, ``blocks`` the spec's tiling string.
    """
    if numerics is not None:
        from .plan import NumericsPlan  # plan.py imports this module
        pl = NumericsPlan.parse(numerics)
        ns = pl.resolve(layer) if layer is not None else pl.default
        fmt = fmt if fmt is not None else ns.fmt
        spec = spec if spec is not None else ns.delta_spec
        backend = backend if backend is not None else ns.backend
        interpret = interpret if interpret is not None else ns.interpret_flag
        blocks = blocks if blocks is not None else ns.blocks
    if fmt is None or spec is None:
        raise ValueError(
            f"{op} needs fmt + spec (pass them explicitly or via "
            f"numerics=<NumericsSpec/spec string> with fmt and delta set)")
    return fmt, spec, backend, interpret, \
        (blocks if blocks is not None else "default")


#: The compute dtypes as torch dtypes.
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LNSRuntime:
    """A :class:`NumericsSpec` resolved into live execution objects.

    * :attr:`matmul` — the :class:`~repro_torch.core.lns.LNSMatmulBackend`
      of the spec's format and Δ: the forward and backward ⊞-MAC products,
      kernel on the card, plain version on the CPU;
    * :attr:`delta_engine` — the shared Δ engine of (Δ spec, fmt);
    * :meth:`q_param` / :meth:`q_act` / :meth:`linear` — what the LM layers
      call;
    * :meth:`dp_config` — the data-parallel reduce plan of ``spec.reduce``.

    The block sizes are kept so that the JAX package's calls carry across;
    the spec's ``blocks`` is what sets the kernels' rows per block (see
    :data:`BLOCK_MODES`).  The JAX package's ``NumericsPolicy`` attribute
    names (``param_lns``, ``exact_spec``, ``lns_grad``, ``matmul_backend``
    ...) read through to the spec.
    """

    spec: NumericsSpec
    block_m: int = 128
    block_n: int = 128
    block_k: int = 128

    @functools.cached_property
    def matmul(self) -> LNSMatmulBackend:
        s = self.spec
        if s.fmt is None or s.delta_spec is None:
            raise ValueError(
                f"spec {str(s)!r} has no ⊞-MAC path (needs fmt + delta); "
                f"set e.g. fmt=lns16,delta=lut20")
        # The spec's blocks axis wins over this runtime's tile sizes; the
        # backend keeps the axis itself, which sets the rows per block.
        bm, bn, bk, _ = resolve_blocks_arg(
            s.blocks, self.block_m, self.block_n, self.block_k)
        return LNSMatmulBackend(fmt=s.fmt, spec=s.delta_spec, block_m=bm,
                                block_n=bn, block_k=bk, blocks=s.blocks)

    @functools.cached_property
    def delta_engine(self):
        s = self.spec
        if s.fmt is None or s.delta_spec is None:
            raise ValueError(
                f"spec {str(s)!r} has no Δ engine (needs fmt + delta)")
        from .delta import cached_engine
        return cached_engine(s.delta_spec, s.fmt)

    def dp_config(self, num_devices: int = 1, **kw):
        """The data-parallel reduce plan: a ``DPConfig`` from this spec."""
        from ..distributed.lns_dp import DPConfig
        return DPConfig(num_devices=num_devices, reduce=self.spec.reduce,
                        **kw)

    @property
    def name(self) -> str:
        return str(self.spec)

    def lane_on(self, device) -> str:
        """The lane of this runtime's products on ``device``, for metrics
        rows: ``"cuda"`` (the kernels on a card) or ``"cpu"`` (their plain
        versions), or ``"float-<dtype>"`` off the ⊞-MAC path."""
        s = self.spec
        if s.delta_spec is None or s.fmt is None:
            return f"float-{s.compute_dtype}"
        return torch.device(device).type

    @property
    def lane(self) -> str:
        """:meth:`lane_on` the entry points' default device: the card where
        there is one, else the CPU."""
        return self.lane_on("cuda" if torch.cuda.is_available() else "cpu")

    @property
    def dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.spec.compute_dtype]

    def q_param(self, w):
        if self.spec.quantize_params:
            from .qat import lns_quantize_ste
            w = lns_quantize_ste(w, self.spec.fmt)
        return w.to(self.dtype)

    def q_act(self, x):
        if self.spec.quantize_acts:
            from .qat import lns_quantize_ste
            x = lns_quantize_ste(x, self.spec.fmt)
        return x.to(self.dtype)

    def linear(self, x, w):
        """Contract x's last axis against w's first under this spec.

        A Δ spec runs the ⊞-MAC path: end-to-end log-domain gradients
        (``lns_matmul_trainable``) when ``quantize`` holds ``grads``, else
        a forward-only ⊞-MAC with straight-through gradients, sequential
        (``lns_dot_dispatch``, ``backend=pallas``) or the pairwise tree
        (``lns_dot_exact``, ``backend=emulate``).  Without a Δ spec the
        product is a float matmul of the STE-quantized operands in the
        compute dtype.
        """
        with self._tapping(op="linear") as observe:
            s = self.spec
            if s.delta_spec is not None:
                if s.quantize_grads:
                    from ..kernels.lns_matmul import lns_matmul_trainable
                    out = lns_matmul_trainable(
                        x, w, numerics=s, block_m=self.block_m,
                        block_n=self.block_n, block_k=self.block_k)
                elif s.backend != "emulate":
                    from .qat import lns_dot_dispatch
                    out = lns_dot_dispatch(x, w, self.matmul)
                else:
                    from .qat import lns_dot_exact
                    out = lns_dot_exact(x, w, s.fmt, s.delta_spec)
            else:
                out = torch.matmul(self.q_act(x), self.q_param(w))
        observe(out)
        return out

    def linear_infer(self, x, w):
        """Forward-only :meth:`linear` for serving (decode / prefill).

        Bit-identical to :meth:`linear`'s forward on every spec, but a Δ
        spec with a kernel path (``quantize`` holding ``grads``, or
        ``backend=pallas``) runs the *fused* forward ⊞-MAC
        (:meth:`~repro_torch.core.lns.LNSMatmulBackend.matmul_fused` with
        no epilogue, kernel row 1) under ``torch.no_grad``, with no
        autograd Function.  The emulate-backend exact mode keeps
        :meth:`linear`'s pairwise-tree ``lns_dot_exact``.  No gradient:
        training uses :meth:`linear`.
        """
        s = self.spec
        if s.delta_spec is not None and (s.quantize_grads
                                         or s.backend != "emulate"):
            with self._tapping(op="linear_infer") as observe:
                from .qat import lns_dot_fused
                out = lns_dot_fused(x, w, self.matmul)
            observe(out)
            return out
        if s.delta_spec is None:
            with self._tapping(op="linear_infer") as observe:
                out = torch.matmul(self.q_act(x), self.q_param(w))
            observe(out)
            return out
        return self.linear(x, w)  # observed under op="linear"

    @contextlib.contextmanager
    def _tapping(self, *, op: str):
        """Yields ``observe(out)``, the float-view health tap of a linear
        output, and suspends collection inside the product.  It records
        only when this spec opted in (``metrics != "off"``), a collector is
        live and an ambient ``obs.scope`` names the layer.  Pure reads."""
        from ..obs import metrics as _obs
        if self.spec.metrics == "off" or not _obs.scope_active():
            yield lambda out: None
            return
        with _obs.suspended():
            yield lambda out: _obs.observe_float(out, self.spec.fmt, op=op)

    @property
    def matmul_path(self) -> str:
        """What :meth:`linear` runs, in words."""
        s = self.spec
        if s.delta_spec is None:
            return f"float torch.matmul ({s.compute_dtype})"
        if s.quantize_grads or s.backend != "emulate":
            return "LNS ⊞-MAC via LNSMatmulBackend (lane by device)"
        return "LNS ⊞-MAC via lns_dot_exact (pairwise-tree order)"

    @property
    def infer_path(self) -> str:
        """What :meth:`linear_infer` runs (serving), in the JAX package's
        words: the same text for the same spec."""
        s = self.spec
        if s.delta_spec is None:
            return f"float XLA matmul ({s.compute_dtype})"
        if s.quantize_grads or s.backend != "emulate":
            return (f"LNS ⊞-MAC via matmul_fused "
                    f"(fused forward-epilogue surface, "
                    f"backend='{s.backend}')")
        return "LNS ⊞-MAC via lns_dot_exact (emulated, pairwise-tree order)"

    # -- the JAX package's NumericsPolicy names ----------------------------
    @property
    def compute_dtype(self) -> str:
        return self.spec.compute_dtype

    @property
    def param_lns(self) -> Optional[LNSFormat]:
        return self.spec.fmt if self.spec.quantize_params else None

    @property
    def act_lns(self) -> Optional[LNSFormat]:
        return self.spec.fmt if self.spec.quantize_acts else None

    @property
    def exact_spec(self) -> Optional[DeltaSpec]:
        return self.spec.delta_spec

    @property
    def lns_grad(self) -> bool:
        return self.spec.quantize_grads

    @property
    def matmul_backend(self) -> str:
        return self.spec.backend


_RUNTIME_CACHE: dict = {}


def _cached_runtime(spec: NumericsSpec, block_m: int, block_n: int,
                    block_k: int) -> LNSRuntime:
    key = (spec, block_m, block_n, block_k)
    if key not in _RUNTIME_CACHE:
        _RUNTIME_CACHE[key] = LNSRuntime(spec, block_m, block_n, block_k)
    return _RUNTIME_CACHE[key]

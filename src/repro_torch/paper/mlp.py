"""The paper's MLP (784–100–K) in its three arithmetic backends (Sec. 4/5).

* ``float`` — float32 linear-domain reference (:class:`FloatMLP`);
* ``fxp``   — linear-domain fixed point, 12 or 16 bits, hand backprop,
              optionally with stochastic rounding of the update
              (:class:`FxpMLP`);
* ``lns``   — end-to-end log-domain fixed point (:class:`LNSMLP`), the
              paper's contribution, with the hand-written CUDA kernels.

The LNS backprop follows eq. (10)-(14): δ2 = P ⊟ Y, gW2 = a1ᵀ ⊡⊞ δ2,
δ1 = (δ2 ⊡⊞ W2ᵀ) ⊡ llReLU'(z1), gW1 = xᵀ ⊡⊞ δ1, ⊞-SGD per core/sgd.py.
Every forward / backward / update quantity is an LNS code; the CE loss is
a monitoring readout only.

With ``MLPConfig.fused`` (the default) the forward ⊞-MACs fold bias ⊞ /
llReLU / format conversion into their flush, each dW ⊞-MAC applies the
⊞-SGD update at its flush (the weight gradient is never stored), and the
bias gradients (pairwise ⊞-folds) go through the elementwise update
kernel: one step launches the fused forward kernel twice, the dX kernel
once, the dW-update kernel twice and the update kernel twice.  The unfused
step (``fused=False``, and the fallback when ``lr <= 0``) runs each piece
as its own pass: the plain forward and dW kernels, and the ⊞-SGD as
elementwise tensor ops (``core/sgd.py: apply_update``).  Both give the
same codes.  A spec with ``reduce.grad_segments`` (or
``data_parallel > 1``) routes ``make_mlp`` to the data-parallel model
(``distributed/lns_dp.py``), which emits per-segment partials.

Arithmetic is per layer: ``MLPConfig.spec`` is a
:class:`~repro_torch.core.plan.NumericsPlan` over the layer paths
``"hidden"`` (w1/b1) and ``"out"`` (w2/b2); ``"lns16-train-pallas;hidden=
fmt:lns12"`` trains the hidden layer in lns12 with exact integer shifts at
the format boundary.  Where a step runs follows the model's ``device``:
the CUDA kernels on a card, their plain PyTorch versions on the CPU,
bit-exact to each other and to the JAX package.  The float and fixed-point
baselines reach no TPU kernel in the JAX package and none here: their
products are ``torch.matmul`` in float32 (never TF32) and a broadcast
int32 product-and-sum.

Telemetry and faults ride on the LNS models' other entry points:
``train_step_metrics`` returns the step's outputs and its numerics taps
(``obs/``), ``train_step_faults`` runs the step with the config's
:class:`~repro_torch.resil.inject.FaultPlan` armed at a given step, and
``train_step_faults_metrics`` does both.  Each returns exactly what
``train_step`` returns where no fault is planned: the taps are reads of
the step's tensors, the fault sites return their inputs untouched.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from ..core import f32
from ..core.activations import beta_code, llrelu, llrelu_grad_from_sign
from ..core.arithmetic import boxdot, boxsum, matmul_dhist
from ..core.delta import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_EXACT,
                          DELTA_SOFTMAX, DeltaEngine, DeltaSpec, cached_engine)
from ..core.formats import FXP12, FXP16, LNS12, LNS16
from ..core.initializers import he_sigma, linear_normal_init, log_normal_init
from ..core.linear_fixed import (fxp_affine, fxp_decode, fxp_encode,
                                 fxp_leaky_relu, fxp_leaky_relu_grad,
                                 fxp_matmul, fxp_mul, fxp_sat)
from ..core.lns import (LNSArray, LNSMatmulBackend, convert_format, encode,
                        zeros)
from ..core.plan import NumericsPlan
from ..core.sgd import LogSGDConfig, UpdateEpilogue, apply_update
from ..core.softmax import ce_grad_init, ce_loss_readout, log_softmax_lns
from ..core.spec import NumericsSpec
from ..devices import resolve_device as _device
from ..obs import metrics as _obs
from ..obs.trace import phase_scope
from ..resil import inject as _inj

HIDDEN = 100
ALPHA = 0.01  # leaky-ReLU slope

#: The paper MLP's layer paths: what NumericsPlan glob patterns match.
LAYER_PATHS = ("hidden", "out")
#: Parameter → owning layer path (the unit of per-layer arithmetic).
PARAM_LAYER = {"w1": "hidden", "b1": "hidden", "w2": "out", "b2": "out"}

_APPROX_DELTA = {"lut": DELTA_DEFAULT, "bitshift": DELTA_BITSHIFT,
                 "exact": DELTA_EXACT}


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    n_in: int = 784
    n_hidden: int = HIDDEN
    n_out: int = 10
    lr: float = 0.01
    weight_decay: float = 0.0
    momentum: float = 0.0           # lns only: ⊞-momentum
    bits: int = 16                  # 12 or 16
    approx: str = "lut"             # 'lut' | 'bitshift' | 'exact' (lns)
    stochastic_round: bool = False  # fxp only: SR on the weight update
    spec: Any = None                # NumericsPlan | NumericsSpec | string |
                                    # None (→ from bits/approx); normalized
                                    # to a NumericsPlan
    matmul_block: int = 32          # carried for the JAX package's
                                    # signature; routes nothing: the
                                    # spec's blocks axis sets the kernels'
                                    # rows per block
    fused: bool = True              # lns only: flush-time kernel
                                    # epilogues; False = the separate-pass
                                    # step, same codes
    data_parallel: int = 1          # lns only: ranks of the DP step
    faults: Any = None              # lns only: FaultPlan | plan string |
                                    # None (no injection); normalized to a
                                    # FaultPlan
    # -- the JAX package's loose knobs, deprecated: fold into ``spec`` ----
    matmul_backend: dataclasses.InitVar[Any] = None   # → spec.backend
    reduce_mode: dataclasses.InitVar[Any] = None      # → spec.reduce.mode
    grad_segments: dataclasses.InitVar[Any] = None    # → spec.reduce
                                                      #   .grad_segments

    def __post_init__(self, matmul_backend, reduce_mode, grad_segments):
        if self.spec is not None:
            spec = NumericsPlan.parse(self.spec)
        else:
            spec = NumericsPlan(NumericsSpec(
                fmt=self.lns_fmt, delta_spec=_APPROX_DELTA[self.approx],
                quantize="params+acts+grads", compute_dtype="float32"))
        # A legacy value equal to what the spec already says stays silent:
        # dataclasses.replace() passes the read-back values of these names.
        current = {"backend": spec.backend, "reduce.mode": spec.reduce.mode,
                   "reduce.grad_segments": spec.reduce.grad_segments}
        legacy = {k: v for k, v in (("backend", matmul_backend),
                                    ("reduce.mode", reduce_mode),
                                    ("reduce.grad_segments", grad_segments))
                  if v is not None and v != current[k]}
        if legacy:
            spec = spec.with_(**legacy)
            warnings.warn(
                f"MLPConfig(matmul_backend=/reduce_mode=/grad_segments=) "
                f"are deprecated; pass the unified descriptor instead: "
                f"MLPConfig(spec={str(spec)!r})",
                DeprecationWarning, stacklevel=3)
        object.__setattr__(self, "spec", spec)
        object.__setattr__(self, "faults", _inj.FaultPlan.parse(self.faults))

    @property
    def lns_fmt(self):
        if isinstance(self.spec, NumericsPlan) and self.spec.fmt is not None:
            return self.spec.fmt
        return LNS16 if self.bits == 16 else LNS12

    @property
    def fxp_fmt(self):
        return FXP16 if self.bits == 16 else FXP12

    @property
    def delta_spec(self) -> DeltaSpec:
        if (isinstance(self.spec, NumericsPlan)
                and self.spec.delta_spec is not None):
            return self.spec.delta_spec
        return _APPROX_DELTA[self.approx]

    @property
    def softmax_spec(self) -> DeltaSpec:
        """The softmax's Δ: the r = 1/64 table, also under bit-shifts
        (the paper's approximation-sensitive block), or exact."""
        return DELTA_EXACT if self.delta_spec.kind == "exact" \
            else DELTA_SOFTMAX

    def plan(self) -> NumericsPlan:
        """The plan with its default completed from ``bits`` / ``approx``
        where the spec names no fmt or Δ."""
        plan = self.spec
        if plan.fmt is None or plan.delta_spec is None:
            plan = plan.with_(fmt=self.lns_fmt, delta_spec=self.delta_spec)
        return plan

    def layer_runtime(self, path: str):
        """The resolved :class:`~repro_torch.core.spec.LNSRuntime` of layer
        ``path`` (``matmul_block`` is carried; it routes nothing)."""
        return self.plan().runtime_for(path, block_m=self.matmul_block,
                                       block_n=self.matmul_block,
                                       block_k=self.matmul_block)

    def runtime(self):
        """The default resolved runtime, shared by every layer no plan rule
        overrides; per-layer consumers use :meth:`layer_runtime`."""
        return self.plan().runtime(block_m=self.matmul_block,
                                   block_n=self.matmul_block,
                                   block_k=self.matmul_block)


# Read-back of the deprecated keywords, as views of the spec.  The names
# double as InitVars above, so the properties are attached after the class.
MLPConfig.matmul_backend = property(lambda self: self.spec.backend)
MLPConfig.reduce_mode = property(lambda self: self.spec.reduce.mode)
MLPConfig.grad_segments = property(
    lambda self: self.spec.reduce.grad_segments)


class _PaperMLP:
    """What the three backends share: the config, the device and the
    batch's move onto it."""

    def __init__(self, cfg: MLPConfig, device="cuda"):
        self.cfg = cfg
        self.device = _device(device)

    def _inputs(self, xb, yb=None):
        x = torch.as_tensor(xb, dtype=torch.float32, device=self.device)
        if yb is None:
            return x
        return x, torch.as_tensor(yb, device=self.device).long()


def _leaky(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z > 0, z, ALPHA * z)


# ---------------------------------------------------------------- float --
class FloatMLP(_PaperMLP):
    """float32 linear-domain reference: autograd of the batch's summed NLL
    (no 1/B, as the MAC array accumulates per-sample outer products), plain
    SGD with weight decay.  On a card its products must run in float32,
    not TF32."""

    def __init__(self, cfg: MLPConfig, device="cuda"):
        super().__init__(cfg, device)
        if self.device.type == "cuda" and (
                torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError(
                "FloatMLP is the float32 baseline: set "
                "torch.backends.cuda.matmul.allow_tf32 = False and "
                "torch.set_float32_matmul_precision('highest')")

    def init(self, gen: torch.Generator):
        """He-normal weights drawn from ``gen``, then moved to the device."""
        c = self.cfg
        params = dict(
            w1=linear_normal_init(gen, (c.n_in, c.n_hidden), he_sigma(c.n_in)),
            b1=torch.zeros(c.n_hidden),
            w2=linear_normal_init(gen, (c.n_hidden, c.n_out),
                                  he_sigma(c.n_hidden)),
            b2=torch.zeros(c.n_out))
        return {k: v.to(self.device) for k, v in params.items()}

    @staticmethod
    def _logits(p, x):
        return _leaky(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    def train_step(self, params, xb, yb):
        """One step; returns (params, summed NLL)."""
        c = self.cfg
        x, y = self._inputs(xb, yb)
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        nll = -torch.log_softmax(self._logits(p, x), dim=-1).gather(
            1, y[:, None]).sum()
        grads = torch.autograd.grad(nll, list(p.values()))
        new = {k: (w - c.lr * (g + c.weight_decay * w)).detach()
               for (k, w), g in zip(params.items(), grads)}
        return new, nll.detach()

    @torch.no_grad()
    def predict(self, params, xb) -> torch.Tensor:
        return torch.argmax(self._logits(params, self._inputs(xb)), dim=-1)


# ------------------------------------------------------------------ fxp --
def sr_update(w: torch.Tensor, g: torch.Tensor, lr_code: int,
              r: torch.Tensor, fmt) -> torch.Tensor:
    """w - lr·g with stochastic rounding (Gupta et al. 2015): the raw
    product carries 2·bf fraction bits, and its low bf bits round the step
    up where they exceed the rounding bits ``r`` (uniform on [0, 2^bf)),
    so sub-resolution updates survive in expectation."""
    raw = lr_code * g
    step = (raw >> fmt.bf) + ((raw & (fmt.scale - 1)) > r).to(torch.int32)
    return fxp_sat(w - step, fmt)


class FxpMLP(_PaperMLP):
    """Linear-domain fixed point, the paper's Table 1 baseline; int32 codes
    throughout.  The softmax / CE gradient is float on the decoded logits
    and re-encoded (a fine exp table in hardware)."""

    def __init__(self, cfg: MLPConfig, device="cuda"):
        super().__init__(cfg, device)
        self.fmt = f = cfg.fxp_fmt
        self.alpha = int(fxp_encode(ALPHA, f))
        self.lr_code = int(fxp_encode(cfg.lr, f))

    def init(self, gen: torch.Generator):
        """He-normal weights drawn from ``gen`` and encoded, then moved to
        the device."""
        c, f = self.cfg, self.fmt
        params = dict(
            w1=fxp_encode(linear_normal_init(
                gen, (c.n_in, c.n_hidden), he_sigma(c.n_in)), f),
            b1=torch.zeros(c.n_hidden, dtype=torch.int32),
            w2=fxp_encode(linear_normal_init(
                gen, (c.n_hidden, c.n_out), he_sigma(c.n_hidden)), f),
            b2=torch.zeros(c.n_out, dtype=torch.int32))
        return {k: v.to(self.device) for k, v in params.items()}

    def _forward(self, params, x):
        f = self.fmt
        x = fxp_encode(x, f)
        z1 = fxp_affine(x, params["w1"], params["b1"], f)
        a1 = fxp_leaky_relu(z1, self.alpha, f)
        return x, z1, a1, fxp_affine(a1, params["w2"], params["b2"], f)

    def rounding_bits(self, params, gen: torch.Generator) -> dict:
        """The stochastic rounding's bits, uniform int32 on [0, 2^bf), one
        per weight, drawn from the CPU generator ``gen`` in the order w1,
        b1, w2, b2 and moved to the device: every device sees the same."""
        return {k: torch.randint(0, self.fmt.scale, params[k].shape,
                                 generator=gen, dtype=torch.int32
                                 ).to(self.device)
                for k in ("w1", "b1", "w2", "b2")}

    def gradients(self, params, xb, yb):
        """The int32 gradient of every weight, and the mean NLL readout."""
        c, f = self.cfg, self.fmt
        xf, y = self._inputs(xb, yb)
        x, z1, a1, z2 = self._forward(params, xf)
        logits = fxp_decode(z2, f)
        onehot = torch.nn.functional.one_hot(y, c.n_out).to(torch.float32)
        d2 = fxp_encode(f32.softmax(logits) - onehot, f)
        bp = fxp_matmul(d2, params["w2"].T, f)
        d1 = fxp_mul(bp, fxp_leaky_relu_grad(z1, self.alpha, f), f)
        grads = dict(
            w1=fxp_matmul(x.T, d1, f),
            b1=fxp_sat(torch.sum(d1, dim=0, dtype=torch.int32), f),
            w2=fxp_matmul(a1.T, d2, f),
            b2=fxp_sat(torch.sum(d2, dim=0, dtype=torch.int32), f))
        nll = -torch.log_softmax(logits, dim=-1).gather(1, y[:, None]).mean()
        return grads, nll

    def update(self, params, grads, r=None):
        """w - lr·g for every weight: rounded to nearest, or stochastically
        with the rounding bits ``r`` (:meth:`rounding_bits`)."""
        f = self.fmt
        if r is None:
            return {k: fxp_sat(w - fxp_mul(self.lr_code, grads[k], f), f)
                    for k, w in params.items()}
        return {k: sr_update(w, grads[k], self.lr_code, r[k], f)
                for k, w in params.items()}

    def train_step(self, params, xb, yb, gen: torch.Generator = None):
        """One step; returns (params, mean NLL readout).  With
        ``cfg.stochastic_round`` and a CPU generator the update rounds
        stochastically with bits drawn from it, else to nearest."""
        grads, nll = self.gradients(params, xb, yb)
        r = (self.rounding_bits(params, gen)
             if self.cfg.stochastic_round and gen is not None else None)
        return self.update(params, grads, r), nll

    def predict(self, params, xb) -> torch.Tensor:
        return torch.argmax(self._forward(params, self._inputs(xb))[3],
                            dim=-1)

    def apply_decay(self, params, every: int):
        """Periodic weight decay: the per-step constant lr·λ underflows
        narrow fixed point (code 0 at bf = 7), so the decay runs every
        ``every`` steps with the representable every·lr·λ; the 12-bit runs
        need it (the paper's larger regularization, Sec. 5)."""
        f, c = self.fmt, self.cfg
        wd = int(fxp_encode(every * c.lr * c.weight_decay, f))
        return {k: fxp_sat(w - fxp_mul(wd, w, f), f)
                for k, w in params.items()}


# ------------------------------------------------------------------ lns --
def segmented_boxsum(d: LNSArray, num_segments: int, eng) -> LNSArray:
    """Per-segment sequential ⊞-fold over the batch axis: (B, K) → (S, K);
    slot s folds segment s's rows only (the bias side of the
    data-parallel reduce)."""
    b, tail = d.shape[0], tuple(d.shape[1:])
    shape = (num_segments, b // num_segments) + tail
    return boxsum(LNSArray(d.code.reshape(shape), d.sign.reshape(shape)), 1,
                  eng, order="sequential")


class LNSMLP(_PaperMLP):
    """End-to-end log-domain training (the paper's contribution) on
    ``device``; parameters are dicts of :class:`LNSArray` on that device.

    Its lane is the device's: :meth:`lanes` names it ``"cuda"`` (the
    kernels launch) or ``"cpu"`` (their plain versions run) in metrics
    rows.
    """

    def __init__(self, cfg: MLPConfig, device="cuda"):
        super().__init__(cfg, device)
        self.plan = cfg.plan().validate_paths(LAYER_PATHS)
        specs = {p: self.plan.resolve(p) for p in LAYER_PATHS}
        self.fmts = {p: specs[p].fmt for p in LAYER_PATHS}
        self.engs = {p: cached_engine(specs[p].delta_spec, self.fmts[p])
                     for p in LAYER_PATHS}
        # Δ-table corruption is a build-time fault, applied to copies (the
        # cached engines are shared by every model).  The copies feed the
        # ⊞ sites that read the model's engines: the bias-gradient ⊞-fold,
        # the unfused update, the tree combine and the dhist replay; the
        # kernels build their tables from the format and Δ spec and stay
        # clean, as the JAX package's Pallas kernels do.
        self.fault_plan = cfg.faults
        if self.fault_plan is not None:
            self.fault_plan.validate_paths(LAYER_PATHS + ("serve",))
            self.engs = {p: _inj.corrupt_engine(self.engs[p],
                                                self.fault_plan, p)
                         for p in LAYER_PATHS}
        self.mms = {p: LNSMatmulBackend(fmt=self.fmts[p],
                                        spec=specs[p].delta_spec,
                                        blocks=specs[p].blocks)
                    for p in LAYER_PATHS}
        # Softmax sits in the output layer: its approximation-sensitive
        # r = 1/64 table lives in the output format.
        out_kind = specs["out"].delta_spec.kind
        self.eng_sm = DeltaEngine(
            DELTA_EXACT if out_kind == "exact" else DELTA_SOFTMAX,
            self.fmts["out"])
        self.beta = beta_code(ALPHA, self.fmts["hidden"])
        self.sgd = LogSGDConfig(lr=cfg.lr, weight_decay=cfg.weight_decay,
                                momentum=cfg.momentum)
        # The ⊞-SGD as static scalar codes, one per layer format: what the
        # fused kernels apply at flush.  lr <= 0 has no scalar code: the
        # step then falls back to the unfused update.
        self.update_eps = (
            {p: UpdateEpilogue.from_sgd(self.sgd, self.fmts[p])
             for p in LAYER_PATHS} if cfg.lr > 0 else None)
        # Per-parameter views (the unit the data-parallel reduce keys on).
        self.param_fmts = {k: self.fmts[l] for k, l in PARAM_LAYER.items()}
        self.param_engines = {k: self.engs[l] for k, l in PARAM_LAYER.items()}
        # Telemetry per layer (the plan's `metrics` axis); the switch is
        # which entry point runs (train_step or train_step_metrics).
        self.metrics_levels = {p: specs[p].metrics for p in LAYER_PATHS}

    def lanes(self) -> dict:
        """Layer path → the lane that runs it, for metrics rows: ``"cuda"``
        (the kernels) or ``"cpu"`` (their plain versions)."""
        return {p: self.device.type for p in LAYER_PATHS}

    # -- telemetry gates (no-ops unless a collector is active) -------------
    def _collect(self, layer: str, level: str = "counters") -> bool:
        """Should this layer tap at ``level`` right now?"""
        if not _obs.enabled():
            return False
        mode = self.metrics_levels[layer]
        if mode == "off":
            return False
        return mode == "full" if level == "full" else True

    def _scope(self, layer: str, op: str):
        """Ambient tap scope for ``layer``: a null context unless a
        collector is live and the layer's spec opted in."""
        if self._collect(layer):
            return _obs.scope(layer, op)
        return contextlib.nullcontext()

    def init(self, gen: torch.Generator):
        """Log-normal He init (eq. 12) drawn from ``gen``, then moved to
        the model's device: a CPU generator gives the same weights on
        every device."""
        c = self.cfg
        fh, fo = self.fmts["hidden"], self.fmts["out"]
        params = dict(
            w1=log_normal_init(gen, (c.n_in, c.n_hidden), he_sigma(c.n_in),
                               fh),
            b1=zeros((c.n_hidden,), fh),
            w2=log_normal_init(gen, (c.n_hidden, c.n_out),
                               he_sigma(c.n_hidden), fo),
            b2=zeros((c.n_out,), fo))
        return {k: v.to(self.device) for k, v in params.items()}

    def init_momentum(self, params):
        """Zero ⊞-momentum state, one slot per parameter in its layer's
        format (``None`` when momentum is off)."""
        if self.sgd.momentum == 0.0:
            return None
        return {k: zeros(params[k].shape, self.param_fmts[k], self.device)
                for k in params}

    def _forward(self, params, x: LNSArray):
        """Returns (z1_sign, a1 [out fmt], z2); ``z1_sign`` is the post-bias
        pre-activation sign plane, the only piece of z1 backward needs.
        Fused, bias ⊞ / llReLU / conversion run in the forward kernels'
        flush; unfused, each is a pass of its own."""
        mm_h, mm_o = self.mms["hidden"], self.mms["out"]
        fh, fo = self.fmts["hidden"], self.fmts["out"]
        if self.cfg.fused:
            with self._scope("hidden", "fwd"):  # the epi_fwd tap
                a1, z1_sign = mm_h.matmul_fused(
                    x, params["w1"], bias=params["b1"],
                    llrelu_beta=self.beta, out_fmt=fo, emit_z_sign=True)
            with self._scope("out", "fwd"):
                z2 = mm_o.matmul_fused(a1, params["w2"], bias=params["b2"])
        else:
            with self._scope("hidden", "fwd"):  # the convert_* taps
                z1 = mm_h.affine(x, params["w1"], params["b1"])
                a1 = convert_format(llrelu(z1, self.beta, fh), fh, fo)
            with self._scope("out", "fwd"):
                z2 = mm_o.affine(a1, params["w2"], params["b2"])
            z1_sign = z1.sign
        # Fault sites (no-ops without an active FaultPlan): activation bit
        # flips and stuck lanes land after the layer's compute and before
        # its taps, so the detectors see what the next layer sees.
        a1 = _inj.inject_codes(a1, fo, layer="hidden", site="act")
        z2 = _inj.inject_codes(z2, fo, layer="out", site="act")
        if self._collect("hidden"):
            _obs.observe_codes(a1, fo, layer="hidden", op="act")
        if self._collect("out"):
            _obs.observe_codes(z2, fo, layer="out", op="logits")
        return z1_sign, a1, z2

    def _bwd_core(self, params, xb, yb):
        """Forward + error backprop; returns ``(x, a1, d1, d2, loss)``."""
        fh, fo = self.fmts["hidden"], self.fmts["out"]
        with self._scope("hidden", "encode"):  # the q_* taps
            x = encode(xb, fh)
        with phase_scope("fwd"):
            z1_sign, a1, z2 = self._forward(params, x)
            p = log_softmax_lns(z2, self.eng_sm)
        # Δ-table occupancy (metrics=full): a shadow replay of each forward
        # product's sequential order; what flows on is the product above.
        if self._collect("hidden", "full"):
            _obs.tap("dhist", matmul_dhist(x, params["w1"],
                                           self.engs["hidden"]),
                     layer="hidden", op="fwd")
        if self._collect("out", "full"):
            _obs.tap("dhist", matmul_dhist(a1, params["w2"],
                                           self.engs["out"]),
                     layer="out", op="fwd")
        d2 = ce_grad_init(p, yb, fo, self.eng_sm)            # (B, K), out fmt
        if self._collect("out"):
            _obs.observe_codes(d2, fo, layer="out", op="dgrad")
        with phase_scope("dx"):
            bp = self.mms["out"].matmul_dx(d2, params["w2"])  # (B, H), out
            with self._scope("hidden", "dx"):  # the convert_* taps
                bp = convert_format(bp, fo, fh)
            d1 = boxdot(bp, llrelu_grad_from_sign(z1_sign, self.beta), fh)
        if self._collect("hidden"):
            _obs.observe_codes(d1, fh, layer="hidden", op="dgrad")
        return x, a1, d1, d2, ce_loss_readout(p, yb, fo)

    def _backward(self, params, xb, yb, num_segments=None):
        """Gradients of every parameter, each in its own layer's format.

        ``num_segments=None`` gives fully ⊞-reduced gradients (the
        sequential MAC over the batch for dW, the pairwise ⊞-fold for the
        biases); an integer gives per-segment partials with a leading
        segment axis, what the data-parallel reduce combines."""
        mm_h, mm_o = self.mms["hidden"], self.mms["out"]
        eng_h, eng_o = self.engs["hidden"], self.engs["out"]
        x, a1, d1, d2, loss = self._bwd_core(params, xb, yb)
        if num_segments is None:
            grads = dict(w1=mm_h.matmul_dw(x, d1), b1=boxsum(d1, 0, eng_h),
                         w2=mm_o.matmul_dw(a1, d2), b2=boxsum(d2, 0, eng_o))
        else:
            grads = dict(
                w1=mm_h.matmul_dw_partials(x, d1, num_segments),
                b1=segmented_boxsum(d1, num_segments, eng_h),
                w2=mm_o.matmul_dw_partials(a1, d2, num_segments),
                b2=segmented_boxsum(d2, num_segments, eng_o))
        return grads, loss

    def per_segment_grads(self, params, xb, yb, num_segments: int):
        """Per-segment gradient partials (leading segment axis) + loss."""
        return self._backward(params, xb, yb, num_segments)

    def apply_updates(self, params, grads, momentum=None):
        """⊞-SGD of every parameter under its own layer's Δ engine: the
        elementwise update kernel when fused (and lr > 0), else
        ``core/sgd.py: apply_update``.  The two give the same codes."""
        if self.cfg.fused and self.update_eps is not None:
            # cfg.momentum == 0 with a momentum dict passed: the state
            # passes through untouched, as in the unfused update.
            has_mom = self.sgd.momentum != 0.0 and momentum is not None
            new_p = {}
            new_m = dict(momentum) if momentum is not None else None
            for k in params:
                layer = PARAM_LAYER[k]
                with self._scope(layer, f"update.{k}"):  # epi_update tap
                    new_p[k], m = self.mms[layer].fused_update(
                        params[k], grads[k],
                        momentum[k] if has_mom else None,
                        self.update_eps[layer])
                if has_mom:
                    new_m[k] = m
            return new_p, new_m
        new_p, new_m = {}, ({} if momentum is not None else None)
        for layer in LAYER_PATHS:
            keys = [k for k, l in PARAM_LAYER.items() if l == layer]
            p2, m2 = apply_update(
                {k: params[k] for k in keys}, {k: grads[k] for k in keys},
                None if momentum is None else {k: momentum[k] for k in keys},
                self.sgd, self.engs[layer])
            if self._collect(layer):
                for k in keys:
                    _obs.observe_codes(p2[k], self.fmts[layer], layer=layer,
                                       op=f"update.{k}")
            new_p.update(p2)
            if momentum is not None:
                new_m.update(m2)
        return new_p, new_m

    def _step_impl(self, params, xb, yb, momentum=None):
        """The step's body, shared by every entry point, so telemetry and
        faults can never fork its arithmetic."""
        # Weight-code bit flips (a fault site; the same object back with
        # no active plan): the step trains on, and updates, the flipped
        # codes.
        params = _inj.inject_param_codes(params, param_fmts=self.param_fmts,
                                         param_layer=PARAM_LAYER)
        if not self.cfg.fused or self.update_eps is None:
            grads, loss = self._backward(params, xb, yb)
            with phase_scope("update"):
                params, momentum = self.apply_updates(params, grads,
                                                      momentum)
            if momentum is None:
                return params, loss
            return params, momentum, loss
        x, a1, d1, d2, loss = self._bwd_core(params, xb, yb)
        # cfg.momentum == 0 with a momentum dict passed: the state passes
        # through untouched.
        has_mom = self.sgd.momentum != 0.0 and momentum is not None
        new_p = {}
        new_m = dict(momentum) if momentum is not None else None
        for wk, bk, layer, act, d in (("w1", "b1", "hidden", x, d1),
                                      ("w2", "b2", "out", a1, d2)):
            mm, ep = self.mms[layer], self.update_eps[layer]
            with phase_scope("dw"), self._scope(layer, f"update.{wk}"):
                new_p[wk], mw = mm.matmul_dw_update(
                    act, d, params[wk], momentum[wk] if has_mom else None,
                    ep)
            gb = boxsum(d, 0, self.engs[layer])
            with phase_scope("update"), self._scope(layer, f"update.{bk}"):
                new_p[bk], mb = mm.fused_update(
                    params[bk], gb, momentum[bk] if has_mom else None, ep)
            if has_mom:
                new_m[wk], new_m[bk] = mw, mb
        if momentum is None:
            return new_p, loss
        return new_p, new_m, loss

    def train_step(self, params, xb, yb, momentum=None):
        """One step on a batch (numpy or tensors); returns (params, loss),
        or (params, momentum, loss) when a momentum dict is passed."""
        x, y = self._inputs(xb, yb)
        return self._step_impl(params, x, y, momentum)

    def train_step_metrics(self, params, xb, yb, momentum=None):
        """:meth:`train_step` with numerics telemetry: returns
        ``(step_outputs, taps)``, ``step_outputs`` exactly what
        ``train_step`` returns and ``taps`` a ``"layer/op/counter"`` →
        int32 tensor dict on the model's device (read it to the host once:
        ``obs.metrics.host_taps``; fold it into a ``MetricsRegistry`` with
        :meth:`lanes`).  Layers whose spec says ``metrics=off`` stay
        silent; ``metrics=full`` adds the Δ-table ``dhist`` replay."""
        x, y = self._inputs(xb, yb)
        with _obs.collecting() as col:
            out = self._step_impl(params, x, y, momentum)
        return out, col.taps()

    def train_step_faults(self, params, xb, yb, step, momentum=None):
        """:meth:`train_step` with the config's :class:`FaultPlan` armed.
        ``step`` (an int, or an integer tensor on the model's device) keys
        the per-step faults and the plan's ``[start, stop)`` window.  With
        ``cfg.faults=None`` this is the plain step."""
        x, y = self._inputs(xb, yb)
        with _inj.injecting(self.fault_plan, step):
            return self._step_impl(params, x, y, momentum)

    def train_step_faults_metrics(self, params, xb, yb, step,
                                  momentum=None):
        """:meth:`train_step_faults` and its taps, taken after injection
        (the guardrails' entry point)."""
        x, y = self._inputs(xb, yb)
        with _inj.injecting(self.fault_plan, step):
            with _obs.collecting() as col:
                out = self._step_impl(params, x, y, momentum)
        return out, col.taps()

    def predict(self, params, xb) -> torch.Tensor:
        """Class indices: signed argmax of the LNS logits (no decode)."""
        _, _, z2 = self._forward(params, encode(self._inputs(xb),
                                                self.fmts["hidden"]))
        key = torch.where(z2.sign == 0, z2.code + (1 << 30),
                          -z2.code - (1 << 30))
        return torch.argmax(key, dim=-1)


def params_from_numpy(d: dict, device="cuda") -> dict:
    """Parameters as numpy (e.g. ``np.asarray`` of the JAX package's) onto
    ``device``: an LNS parameter is a ``(code int32, sign int8)`` pair and
    becomes an :class:`LNSArray`; a float or fixed-point one is a plain
    array and keeps its dtype.  Momentum state has the LNS form."""
    device = _device(device)
    out = {}
    for k, v in d.items():
        if isinstance(v, (tuple, list)):
            c, s = v
            out[k] = LNSArray(
                torch.as_tensor(np.array(c, np.int32), device=device),
                torch.as_tensor(np.array(s, np.int8), device=device))
        else:
            out[k] = torch.as_tensor(np.array(v), device=device)
    return out


def params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`params_from_numpy`."""
    return {k: ((v.code.cpu().numpy(), v.sign.cpu().numpy())
                if isinstance(v, LNSArray) else v.cpu().numpy())
            for k, v in params.items()}


BACKENDS = {"float": FloatMLP, "fxp": FxpMLP, "lns": LNSMLP}


def make_mlp(backend: str, cfg: MLPConfig, device="cuda"):
    """The paper MLP of ``backend`` (``BACKENDS``) on ``device``.  An LNS
    config with ``data_parallel > 1`` or a spec that sets
    ``reduce.grad_segments`` gives the data-parallel model
    (:class:`~repro_torch.distributed.lns_dp.LNSDataParallelMLP`), so that
    one- and many-rank runs sharing a segmentation give the same codes."""
    if cfg.data_parallel > 1 and backend != "lns":
        raise ValueError(
            f"data_parallel={cfg.data_parallel} is the LNS data-parallel "
            f"step (distributed/lns_dp); the {backend!r} backend has no "
            f"deterministic-reduce train step")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid values: "
                         f"{', '.join(BACKENDS)}")
    if backend == "lns" and (cfg.data_parallel > 1
                             or cfg.spec.reduce.grad_segments):
        from ..distributed.lns_dp import DPConfig, LNSDataParallelMLP
        return LNSDataParallelMLP(
            cfg, DPConfig(num_devices=cfg.data_parallel,
                          reduce=cfg.spec.reduce), device)
    return BACKENDS[backend](cfg, device)

"""The paper's MLP (784–100–K) trained end to end in the log domain.

Backprop follows eq. (10)-(14): δ2 = P ⊟ Y, gW2 = a1ᵀ ⊡⊞ δ2,
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
the format boundary.  Where the step runs follows the model's ``device``:
the CUDA kernels on a card, their plain PyTorch versions on the CPU,
bit-exact to each other and to the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.activations import beta_code, llrelu, llrelu_grad_from_sign
from ..core.arithmetic import boxdot, boxsum
from ..core.delta import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_EXACT,
                          DELTA_SOFTMAX, DeltaEngine, DeltaSpec, cached_engine)
from ..core.formats import LNS12, LNS16
from ..core.initializers import he_sigma, log_normal_init
from ..core.lns import (LNSArray, LNSMatmulBackend, convert_format, encode,
                        zeros)
from ..core.plan import NumericsPlan
from ..core.sgd import LogSGDConfig, UpdateEpilogue, apply_update
from ..core.softmax import ce_grad_init, ce_loss_readout, log_softmax_lns
from ..core.spec import NumericsSpec

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
    momentum: float = 0.0
    bits: int = 16                  # 12 or 16
    approx: str = "lut"             # 'lut' | 'bitshift' | 'exact'
    spec: Any = None                # NumericsPlan | NumericsSpec | string |
                                    # None (→ from bits/approx); normalized
                                    # to a NumericsPlan
    fused: bool = True              # flush-time kernel epilogues; False =
                                    # the separate-pass step, same codes
    data_parallel: int = 1          # ranks of the data-parallel step
    faults: Any = None              # fault injection (not ported)

    def __post_init__(self):
        if self.faults is not None:
            raise NotImplementedError(
                "fault injection (resil/) is not ported yet: ROADMAP queue 1")
        if self.spec is not None:
            spec = NumericsPlan.parse(self.spec)
        else:
            spec = NumericsPlan(NumericsSpec(
                fmt=self.lns_fmt, delta_spec=_APPROX_DELTA[self.approx],
                quantize="params+acts+grads", compute_dtype="float32"))
        object.__setattr__(self, "spec", spec)

    @property
    def lns_fmt(self):
        if isinstance(self.spec, NumericsPlan) and self.spec.fmt is not None:
            return self.spec.fmt
        return LNS16 if self.bits == 16 else LNS12

    @property
    def delta_spec(self) -> DeltaSpec:
        if (isinstance(self.spec, NumericsPlan)
                and self.spec.delta_spec is not None):
            return self.spec.delta_spec
        return _APPROX_DELTA[self.approx]

    def plan(self) -> NumericsPlan:
        """The plan with its default completed from ``bits`` / ``approx``
        where the spec names no fmt or Δ."""
        plan = self.spec
        if plan.fmt is None or plan.delta_spec is None:
            plan = plan.with_(fmt=self.lns_fmt, delta_spec=self.delta_spec)
        return plan


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card and none is "
            f"available; pass device='cpu' for the plain PyTorch lane")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def segmented_boxsum(d: LNSArray, num_segments: int, eng) -> LNSArray:
    """Per-segment sequential ⊞-fold over the batch axis: (B, K) → (S, K);
    slot s folds segment s's rows only (the bias side of the
    data-parallel reduce)."""
    b, tail = d.shape[0], tuple(d.shape[1:])
    shape = (num_segments, b // num_segments) + tail
    return boxsum(LNSArray(d.code.reshape(shape), d.sign.reshape(shape)), 1,
                  eng, order="sequential")


class LNSMLP:
    """End-to-end log-domain training (the paper's contribution) on
    ``device``; parameters are dicts of :class:`LNSArray` on that device.
    """

    def __init__(self, cfg: MLPConfig, device="cuda"):
        self.cfg = cfg
        self.device = _device(device)
        self.plan = cfg.plan().validate_paths(LAYER_PATHS)
        specs = {p: self.plan.resolve(p) for p in LAYER_PATHS}
        self.fmts = {p: specs[p].fmt for p in LAYER_PATHS}
        self.engs = {p: cached_engine(specs[p].delta_spec, self.fmts[p])
                     for p in LAYER_PATHS}
        self.mms = {p: LNSMatmulBackend(fmt=self.fmts[p],
                                        spec=specs[p].delta_spec)
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
            a1, z1_sign = mm_h.matmul_fused(
                x, params["w1"], bias=params["b1"], llrelu_beta=self.beta,
                out_fmt=fo, emit_z_sign=True)
            z2 = mm_o.matmul_fused(a1, params["w2"], bias=params["b2"])
            return z1_sign, a1, z2
        z1 = mm_h.affine(x, params["w1"], params["b1"])
        a1 = convert_format(llrelu(z1, self.beta, fh), fh, fo)
        z2 = mm_o.affine(a1, params["w2"], params["b2"])
        return z1.sign, a1, z2

    def _bwd_core(self, params, xb, yb):
        """Forward + error backprop; returns ``(x, a1, d1, d2, loss)``."""
        fh, fo = self.fmts["hidden"], self.fmts["out"]
        x = encode(xb, fh)
        z1_sign, a1, z2 = self._forward(params, x)
        p = log_softmax_lns(z2, self.eng_sm)
        d2 = ce_grad_init(p, yb, fo, self.eng_sm)            # (B, K), out fmt
        bp = self.mms["out"].matmul_dx(d2, params["w2"])    # (B, H), out fmt
        bp = convert_format(bp, fo, fh)
        d1 = boxdot(bp, llrelu_grad_from_sign(z1_sign, self.beta), fh)
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
                new_p[k], m = self.mms[layer].fused_update(
                    params[k], grads[k], momentum[k] if has_mom else None,
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
            new_p.update(p2)
            if momentum is not None:
                new_m.update(m2)
        return new_p, new_m

    def _step_impl(self, params, xb, yb, momentum=None):
        if not self.cfg.fused or self.update_eps is None:
            grads, loss = self._backward(params, xb, yb)
            params, momentum = self.apply_updates(params, grads, momentum)
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
            new_p[wk], mw = mm.matmul_dw_update(
                act, d, params[wk], momentum[wk] if has_mom else None, ep)
            gb = boxsum(d, 0, self.engs[layer])
            new_p[bk], mb = mm.fused_update(
                params[bk], gb, momentum[bk] if has_mom else None, ep)
            if has_mom:
                new_m[wk], new_m[bk] = mw, mb
        if momentum is None:
            return new_p, loss
        return new_p, new_m, loss

    def _inputs(self, xb, yb=None):
        x = torch.as_tensor(xb, dtype=torch.float32, device=self.device)
        if yb is None:
            return x
        return x, torch.as_tensor(yb, device=self.device).long()

    def train_step(self, params, xb, yb, momentum=None):
        """One step on a batch (numpy or tensors); returns (params, loss),
        or (params, momentum, loss) when a momentum dict is passed."""
        x, y = self._inputs(xb, yb)
        return self._step_impl(params, x, y, momentum)

    def predict(self, params, xb) -> torch.Tensor:
        """Class indices: signed argmax of the LNS logits (no decode)."""
        _, _, z2 = self._forward(params, encode(self._inputs(xb),
                                                self.fmts["hidden"]))
        key = torch.where(z2.sign == 0, z2.code + (1 << 30),
                          -z2.code - (1 << 30))
        return torch.argmax(key, dim=-1)


def params_from_numpy(d: dict, device="cuda") -> dict:
    """``{"w1","b1","w2","b2"}`` → ``(code int32, sign int8)`` numpy pairs
    (e.g. ``np.asarray`` of the JAX package's parameters) as LNSArrays on
    ``device``.  Momentum state has the same form."""
    device = _device(device)
    return {k: LNSArray(torch.as_tensor(np.array(c, np.int32),
                                        device=device),
                        torch.as_tensor(np.array(s, np.int8), device=device))
            for k, (c, s) in d.items()}


def params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`params_from_numpy`."""
    return {k: (v.code.cpu().numpy(), v.sign.cpu().numpy())
            for k, v in params.items()}


def make_mlp(backend: str, cfg: MLPConfig, device="cuda"):
    """The paper MLP of ``backend`` on ``device``.  With
    ``cfg.data_parallel > 1`` or a spec that sets
    ``reduce.grad_segments``, the data-parallel model
    (:class:`~repro_torch.distributed.lns_dp.LNSDataParallelMLP`), so that
    one- and many-rank runs sharing a segmentation give the same codes."""
    if cfg.data_parallel > 1 and backend != "lns":
        raise ValueError(
            f"data_parallel={cfg.data_parallel} is the LNS data-parallel "
            f"step (distributed/lns_dp); the {backend!r} backend has no "
            f"deterministic-reduce train step")
    if backend != "lns":
        raise NotImplementedError(
            f"the {backend!r} MLP (FloatMLP / FxpMLP) is not ported yet: "
            f"ROADMAP queue 1")
    if cfg.data_parallel > 1 or cfg.spec.reduce.grad_segments:
        from ..distributed.lns_dp import DPConfig, LNSDataParallelMLP
        return LNSDataParallelMLP(
            cfg, DPConfig(num_devices=cfg.data_parallel,
                          reduce=cfg.spec.reduce), device)
    return LNSMLP(cfg, device)

"""Log-domain SGD with weight decay and optional momentum (paper Sec. 5).

Update rule (linear domain):  w ← w − lr·g − lr·λ·w
Log domain:                   W ← W ⊟ (LR ⊡ G) ⊟ (LRλ ⊡ W)
With momentum μ:              M ← (μ ⊡ M) ⊞ G ;  W ← W ⊟ (LR ⊡ M)

:class:`UpdateEpilogue` pins the update down to integer scalar codes on one
format's grid: what the fused kernels apply at accumulator flush and what
:func:`apply_update_codes` evaluates elementwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .arithmetic import boxdot, boxminus, boxplus
from .delta import DeltaEngine
from .lns import LNSArray, scalar, zeros


@dataclasses.dataclass(frozen=True)
class LogSGDConfig:
    lr: float = 0.01
    weight_decay: float = 0.0
    momentum: float = 0.0


@dataclasses.dataclass(frozen=True)
class UpdateEpilogue:
    """The ⊞-SGD update as static integer scalar codes (one format's grid).

    ``lr_code`` is the LNS code of the learning rate; ``momentum_code`` /
    ``weight_decay_code`` are the codes of μ and lr·λ, or ``None`` when the
    term is off.  All three scalars are positive.
    """

    lr_code: int
    momentum_code: Optional[int] = None
    weight_decay_code: Optional[int] = None

    @classmethod
    def from_sgd(cls, cfg: LogSGDConfig, fmt) -> "UpdateEpilogue":
        """Quantize a :class:`LogSGDConfig` onto ``fmt``'s code grid."""
        if cfg.lr <= 0:
            raise ValueError(f"fused ⊞-SGD needs lr > 0, got {cfg.lr}")
        if cfg.momentum < 0 or cfg.weight_decay < 0:
            raise ValueError(
                f"momentum/weight_decay must be >= 0, got "
                f"{cfg.momentum}/{cfg.weight_decay}")
        return cls(
            lr_code=int(scalar(cfg.lr, fmt).code),
            momentum_code=(int(scalar(cfg.momentum, fmt).code)
                           if cfg.momentum != 0.0 else None),
            weight_decay_code=(
                int(scalar(cfg.lr * cfg.weight_decay, fmt).code)
                if cfg.weight_decay != 0.0 else None))

    @property
    def has_momentum(self) -> bool:
        return self.momentum_code is not None


def apply_update_codes(w: LNSArray, g: LNSArray, m: Optional[LNSArray],
                       ep: UpdateEpilogue, eng: DeltaEngine):
    """One-leaf ⊞-SGD update from an :class:`UpdateEpilogue`'s codes.
    Returns ``(w_new, m_new)`` (``m_new is None`` when momentum is off)."""
    fmt = eng.fmt

    def sdot(code: int, t: LNSArray) -> LNSArray:
        s = LNSArray(torch.tensor(code, dtype=torch.int32, device=t.device),
                     torch.tensor(0, dtype=torch.int8, device=t.device))
        return boxdot(s, t, fmt)

    if ep.momentum_code is not None:
        if m is None:
            raise ValueError("UpdateEpilogue has momentum but no momentum "
                             "state was passed")
        m = boxplus(sdot(ep.momentum_code, m), g, eng)
        g = m
    else:
        m = None
    w = boxminus(w, sdot(ep.lr_code, g), eng)
    if ep.weight_decay_code is not None:
        w = boxminus(w, sdot(ep.weight_decay_code, w), eng)
    return w, m


def init_momentum(params: dict, cfg: LogSGDConfig, fmt) -> Optional[dict]:
    """Zero ⊞-momentum state for a dict of parameters (``None`` when
    momentum is off)."""
    if cfg.momentum == 0.0:
        return None
    return {k: zeros(p.shape, fmt, p.device) for k, p in params.items()}


def apply_update(params: dict, grads: dict, momentum: Optional[dict],
                 cfg: LogSGDConfig, eng: DeltaEngine):
    """The unfused pure-LNS update of a dict of parameters, each term a
    separate elementwise pass; returns ``(params, momentum)``."""
    fmt = eng.fmt

    def const(v: float, like: LNSArray) -> LNSArray:
        return scalar(v, fmt, like.device)

    def upd(w: LNSArray, g: LNSArray, m: Optional[LNSArray]):
        if cfg.momentum != 0.0:
            m = boxplus(boxdot(const(cfg.momentum, w), m, fmt), g, eng)
            g = m
        w = boxminus(w, boxdot(const(cfg.lr, w), g, fmt), eng)
        if cfg.weight_decay != 0.0:
            wd = const(cfg.lr * cfg.weight_decay, w)
            w = boxminus(w, boxdot(wd, w, fmt), eng)
        return w, m

    new_p = {}
    new_m = None if momentum is None else {}
    for k, w in params.items():
        new_p[k], m = upd(w, grads[k],
                          None if momentum is None else momentum[k])
        if momentum is not None:
            new_m[k] = m
    return new_p, new_m

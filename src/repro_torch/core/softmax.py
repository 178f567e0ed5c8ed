"""Log-domain soft-max and cross-entropy gradient initialization (eq. 14).

    log2 p_ij = (a_ij · log2 e) − ⊞_j (a_ij · log2 e, +)
    δ_ij      = P_ij ⊟ Y_ij

Logits are recentred at their max before the log→linear conversion, so
large logits cannot saturate the qi=4 code range.
"""
from __future__ import annotations

import math

import torch

from .arithmetic import boxabs_max, boxdot, boxminus, boxsum
from .conversions import lns_value_to_code
from .delta import DeltaEngine
from .formats import LNSFormat
from .lns import LNSArray, scalar

LOG2E = math.log2(math.e)


def log_softmax_lns(a: LNSArray, eng: DeltaEngine) -> LNSArray:
    """P = softmax probabilities as LNS numbers, along the last axis."""
    fmt = eng.fmt
    m = boxabs_max(a, axis=a.ndim - 1, keepdims=True)
    a = boxminus(a, LNSArray(m.code.expand(a.shape), m.sign.expand(a.shape)),
                 eng)
    t = boxdot(a, scalar(LOG2E, fmt, a.device), fmt)   # LNS rep of a·log2(e)
    e_code = torch.clamp(lns_value_to_code(t, fmt),    # log2-mag of e^a
                         min=fmt.min_nonzero_code)
    exps = LNSArray(e_code, torch.zeros_like(e_code, dtype=torch.int8))
    z = boxsum(exps, axis=exps.ndim - 1, eng=eng)      # ⊞_j e^{a_j}
    logp = torch.clamp(e_code - z.code[..., None], fmt.min_nonzero_code, 0)
    return LNSArray(logp, torch.zeros_like(logp, dtype=torch.int8))


def ce_grad_init(p: LNSArray, labels: torch.Tensor, fmt: LNSFormat,
                 eng: DeltaEngine) -> LNSArray:
    """δ = p − onehot(y) in the log domain (eq. 13b/14b)."""
    n = p.shape[-1]
    onehot = labels[..., None] == torch.arange(n, device=labels.device)
    y = LNSArray(torch.where(onehot, 0, fmt.zero_code).to(torch.int32),
                 torch.zeros(p.shape, dtype=torch.int8, device=p.device))
    return boxminus(p, y, eng)


def ce_loss_readout(p: LNSArray, labels: torch.Tensor,
                    fmt: LNSFormat) -> torch.Tensor:
    """Scalar cross-entropy (nats) for reporting: −mean log_e p[label].
    A monitoring readout, not part of the training arithmetic."""
    logp_code = torch.take_along_dim(p.code, labels[..., None].long(),
                                     dim=-1)[..., 0]
    logp = logp_code.to(torch.float32) / fmt.scale
    return -torch.mean(logp) * math.log(2.0)

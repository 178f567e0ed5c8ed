"""Log-domain weight initialization (paper eq. 12).

For a symmetric linear-domain density f_w, the log-magnitude W = log2|w| has

    f_W(y) = 2^{y+1} · ln(2) · f_w(2^y)

and the sign is Bernoulli(1/2).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import f32
from .formats import LNSFormat
from .lns import LNSArray, encode


def he_sigma(fan_in: int) -> float:
    """He-normal std for (leaky-)ReLU layers."""
    return math.sqrt(2.0 / fan_in)


def log_normal_init(gen: torch.Generator, shape, sigma: float,
                    fmt: LNSFormat) -> LNSArray:
    """LNS weights equal in law to w ~ N(0, sigma^2), drawn from ``gen``
    on its device: sign ~ Bernoulli(1/2), Y = log2(sigma) + log2|n| with
    n ~ N(0, 1)."""
    n = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    y = f32.log2(torch.clamp(torch.abs(n), min=1e-30)) + math.log2(sigma)
    code = torch.clamp(torch.round(y * fmt.scale).to(torch.int32),
                       fmt.min_nonzero_code, fmt.code_max)
    sign = (torch.rand(shape, generator=gen, device=gen.device) < 0.5
            ).to(torch.int8)
    return LNSArray(code, sign)


def log_density_normal(y, sigma: float):
    """f_W(y) for w ~ N(0, sigma^2) per eq. (12)."""
    y = np.asarray(y, np.float64)
    x = np.exp2(y)
    f_w = np.exp(-x * x / (2 * sigma * sigma)) / (
        math.sqrt(2 * math.pi) * sigma)
    return np.exp2(y + 1) * math.log(2.0) * f_w


def linear_normal_init(gen: torch.Generator, shape, sigma: float
                       ) -> torch.Tensor:
    """float32 weights w ~ N(0, sigma^2) drawn from ``gen`` on its device."""
    return sigma * torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=gen.device)


def encode_init(gen: torch.Generator, shape, sigma: float,
                fmt: LNSFormat) -> LNSArray:
    """Reference path: sample in the linear domain, then encode (the same
    law as :func:`log_normal_init`)."""
    return encode(linear_normal_init(gen, shape, sigma), fmt)

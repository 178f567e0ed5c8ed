"""Log-domain → linear-domain fixed point conversion.

The log-domain softmax (eq. 14) treats ``a·log2(e)`` — a linear value — as
the new log-magnitude of ``e^a``; this is that log→linear conversion.
"""
from __future__ import annotations

import torch

from . import f32
from .formats import LNSFormat
from .lns import LNSArray


def lns_value_to_code(a: LNSArray, fmt: LNSFormat) -> torch.Tensor:
    """The *signed fixed-point value* of each LNS number on the qf grid.

    value = ±2^(code/2^qf); output = round(value · 2^qf) as int32 (float32
    exp2 of ``core.f32``, round-half-even), saturated to the format's
    code range.
    """
    mag = f32.exp2(a.code.to(torch.float32) / fmt.scale + fmt.qf)
    v = torch.clamp(torch.round(mag).to(torch.int32), max=fmt.code_max)
    v = torch.where(a.code == fmt.zero_code, 0, v)
    return torch.where(a.sign == 1, -v, v)

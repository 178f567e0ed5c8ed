"""Log-domain <-> linear-domain fixed point conversion.

The log-domain softmax (eq. 14) treats ``a·log2(e)`` — a linear value — as
the new log-magnitude of ``e^a``; this is that log→linear conversion.  In
hardware these are a barrel shifter plus either a small 2^frac /
log2(1+m) table (``exact``) or the Mitchell approximation ``2^f ≈ 1+f``,
``log2(1+m) ≈ m`` (``mitchell``, pure shifts).
"""
from __future__ import annotations

import torch

from . import f32
from .formats import LNSFormat
from .lns import LNSArray


def lns_value_to_code(a: LNSArray, fmt: LNSFormat,
                      mode: str = "exact") -> torch.Tensor:
    """The *signed fixed-point value* of each LNS number on the qf grid.

    value = ±2^(code/2^qf); output = round(value · 2^qf) as int32,
    saturated to the format's code range.  ``exact`` takes the float32
    exp2 of ``core.f32`` and rounds half to even; ``mitchell`` is integer
    shifts of the mantissa 2^qf + frac.
    """
    qf = fmt.qf
    if mode == "exact":
        mag = f32.exp2(a.code.to(torch.float32) / fmt.scale + qf)
        v = torch.clamp(torch.round(mag).to(torch.int32), max=fmt.code_max)
    elif mode == "mitchell":
        # u = code + qf << qf is log2 of the scaled magnitude, in code units.
        u = a.code + (qf << qf)
        n = u >> qf                      # floor(log2 .)
        mant = (1 << qf) + (u - (n << qf))
        v = torch.where(n >= qf, mant << torch.clamp(n - qf, 0, 31),
                        mant >> torch.clamp(qf - n, 0, 31))
        # Magnitudes too small to represent round to 0.
        v = torch.clamp(torch.where(n < -1, 0, v), max=fmt.code_max)
    else:
        raise ValueError(f"unknown conversion mode {mode!r}; expected "
                         f"'exact' or 'mitchell'")
    v = torch.where(a.code == fmt.zero_code, 0, v)
    return torch.where(a.sign == 1, -v, v)


def code_to_lns(value_code: torch.Tensor, fmt: LNSFormat,
                mode: str = "exact") -> LNSArray:
    """Inverse: a signed fixed-point value (qf fraction bits) as a real,
    encoded in LNS (linear → log conversion).  Both modes take log2 through
    ``core.f32``, so the result does not depend on the device."""
    qf = fmt.qf
    mag = torch.abs(value_code)
    safe = torch.clamp(mag, min=1)
    if mode == "exact":
        x = f32.log2(safe.to(torch.float32)) - qf
        code = torch.round(x * fmt.scale).to(torch.int32)
    elif mode == "mitchell":
        # n = position of the MSB; log2(mag) ≈ n + (mag / 2^n - 1).
        n = torch.floor(f32.log2(safe.to(torch.float32))).to(torch.int32)
        scaled = torch.where(n >= qf, safe >> torch.clamp(n - qf, 0, 31),
                             safe << torch.clamp(qf - n, 0, 31))
        code = ((n - qf) << qf) + scaled - (1 << qf)
    else:
        raise ValueError(f"unknown conversion mode {mode!r}; expected "
                         f"'exact' or 'mitchell'")
    code = torch.clamp(code, fmt.min_nonzero_code, fmt.code_max)
    zero = mag == 0
    return LNSArray(torch.where(zero, fmt.zero_code, code).to(torch.int32),
                    torch.where(zero, 0, (value_code < 0).to(torch.int8)
                                ).to(torch.int8))

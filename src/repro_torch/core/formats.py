"""Fixed-point formats of the LNS log-magnitude code and of the linear
fixed-point baseline.

The paper (Sec. 2/4) represents a real ``v`` as ``(X = log2|v|, s_v)`` where
``X`` is a two's-complement fixed-point number with ``qi`` integer and ``qf``
fraction bits.  Total width ``W_log = 2 + qi + qf``.  Codes are carried as
int32 and the narrow width is enforced by explicit saturation.  Linear
fixed point (the paper's baseline) has 1 sign bit plus ``bi``/``bf``
integer/fraction bits: ``W_lin = 1 + bi + bf``.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LNSFormat:
    """Fixed-point format of the log-magnitude code ``X``.

    code = round(X * 2**qf), saturated to [code_min + 1, code_max].
    ``code_min`` is reserved as the exact-zero sentinel (log2(0) = -inf).
    """

    qi: int
    qf: int
    name: str = ""

    @property
    def total_bits(self) -> int:
        return 2 + self.qi + self.qf

    @property
    def scale(self) -> int:
        """Integer scale factor 2**qf."""
        return 1 << self.qf

    @property
    def code_max(self) -> int:
        return (1 << (self.qi + self.qf)) - 1

    @property
    def code_min(self) -> int:
        """Most negative *magnitude* code (reserved for zero)."""
        return -(1 << (self.qi + self.qf))

    @property
    def zero_code(self) -> int:
        return self.code_min

    @property
    def min_nonzero_code(self) -> int:
        return self.code_min + 1

    def to_code(self, x: float) -> int:
        """Host-side quantization of a log2-magnitude to an integer code."""
        c = int(round(x * self.scale))
        return max(self.min_nonzero_code, min(self.code_max, c))


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """Linear-domain two's-complement fixed point: 1 sign + bi + bf bits."""

    bi: int
    bf: int
    name: str = ""

    @property
    def total_bits(self) -> int:
        return 1 + self.bi + self.bf

    @property
    def scale(self) -> int:
        return 1 << self.bf

    @property
    def code_max(self) -> int:
        return (1 << (self.bi + self.bf)) - 1

    @property
    def code_min(self) -> int:
        return -(1 << (self.bi + self.bf))

    @property
    def max_value(self) -> float:
        return self.code_max / self.scale

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale


def required_log_width(lin: FixedPointFormat) -> int:
    """Paper eq. (15): the W_log lower bound for matching a linear format,
    W_log >= 1 + max(ceil(log2(b_i + 1)), ceil(log2(b_f))) + W_lin."""
    return (1 + max(math.ceil(math.log2(lin.bi + 1)),
                    math.ceil(math.log2(lin.bf)))
            + lin.total_bits)


# 16-bit LNS: W_log = 2 + 4 + 10; 12-bit LNS: W_log = 2 + 4 + 6 (paper Sec. 5).
LNS16 = LNSFormat(qi=4, qf=10, name="lns16")
LNS12 = LNSFormat(qi=4, qf=6, name="lns12")
LNS21 = LNSFormat(qi=8, qf=11, name="lns21")  # eq. (15) bound for FXP16

# Linear fixed-point baselines: 16-bit (bi=4, bf=11), 12-bit (bi=4, bf=7).
FXP16 = FixedPointFormat(bi=4, bf=11, name="fxp16")
FXP12 = FixedPointFormat(bi=4, bf=7, name="fxp12")

FORMATS = {f.name: f for f in (LNS16, LNS12, LNS21, FXP16, FXP12)}

"""Fixed-point formats of the LNS log-magnitude code.

The paper (Sec. 2/4) represents a real ``v`` as ``(X = log2|v|, s_v)`` where
``X`` is a two's-complement fixed-point number with ``qi`` integer and ``qf``
fraction bits.  Total width ``W_log = 2 + qi + qf``.  Codes are carried as
int32 and the narrow width is enforced by explicit saturation.
"""
from __future__ import annotations

import dataclasses


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


# 16-bit LNS: W_log = 2 + 4 + 10; 12-bit LNS: W_log = 2 + 4 + 6 (paper Sec. 5).
LNS16 = LNSFormat(qi=4, qf=10, name="lns16")
LNS12 = LNSFormat(qi=4, qf=6, name="lns12")
LNS21 = LNSFormat(qi=8, qf=11, name="lns21")

FORMATS = {f.name: f for f in (LNS16, LNS12, LNS21)}

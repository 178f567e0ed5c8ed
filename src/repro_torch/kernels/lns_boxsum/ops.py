"""``LNSArray``-level entry point of the ⊞-reduce kernel."""
from __future__ import annotations

from ...core.delta import DeltaSpec
from ...core.formats import LNSFormat
from ...core.lns import LNSArray
from .lns_boxsum import lns_boxsum


def lns_boxsum_kernel(x: LNSArray, *, fmt: LNSFormat,
                      spec: DeltaSpec) -> LNSArray:
    """⊞-reduce an (M, K) LNSArray over axis 1, sequentially → (M,); the
    kernel on the card, the plain version on the CPU."""
    return LNSArray(*lns_boxsum(x.code, x.sign, fmt=fmt, spec=spec))

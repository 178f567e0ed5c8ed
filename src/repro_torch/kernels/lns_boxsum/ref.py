"""Oracle of the ⊞-reduce kernel: the sequential ``core.arithmetic.boxsum``
over axis 1; comparisons against the kernel are bit-exact."""
from __future__ import annotations

from ...core.arithmetic import boxsum
from ...core.delta import DeltaSpec, cached_engine
from ...core.formats import LNSFormat
from ...core.lns import LNSArray


def lns_boxsum_ref(x: LNSArray, *, fmt: LNSFormat,
                   spec: DeltaSpec) -> LNSArray:
    return boxsum(x, 1, cached_engine(spec, fmt), order="sequential")

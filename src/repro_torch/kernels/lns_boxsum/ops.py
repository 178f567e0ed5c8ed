"""``LNSArray``-level entry point of the ⊞-reduce kernel, and the geometry
the data-parallel combine's ⊞-reduce launch reports."""
from __future__ import annotations

from ...core.delta import DeltaEngine, DeltaSpec
from ...core.formats import LNSFormat
from ...core.lns import LNSArray
from .lns_boxsum import lns_boxsum


def lns_boxsum_kernel(x: LNSArray, *, fmt: LNSFormat,
                      spec: DeltaSpec) -> LNSArray:
    """⊞-reduce an (M, K) LNSArray over axis 1, sequentially → (M,); the
    kernel on the card, the plain version on the CPU."""
    return LNSArray(*lns_boxsum(x.code, x.sign, fmt=fmt, spec=spec))


def dp_combine_blocks(n_elements: int, segments: int, eng: DeltaEngine, *,
                      blocks: str = "default", interpret: bool = True):
    """The ``(block_m, block_k)`` the data-parallel combine's fold of
    ``n_elements`` rows of ``segments`` steps reports, resolved as the JAX
    package resolves its tiles: ``"default"`` gives ``(min(256, n), S)``,
    an explicit ``MxNxK`` its M and K.  Neither routes anything: the
    ⊞-reduce kernel has one geometry (one row a thread).  ``"auto"``
    returns that geometry from ``autotune.lookup("boxsum", ...)``, which
    measures nothing for it.  An introspection hook; no choice changes the
    combined codes."""
    if blocks == "auto":
        from .. import autotune
        bm, _, bk = autotune.lookup(
            "boxsum", (n_elements, 1, segments), fmt=eng.fmt,
            spec=eng.spec, interpret=interpret)
        return bm, bk
    from ...core.spec import resolve_blocks_arg
    bm, _, bk, _ = resolve_blocks_arg(
        blocks, min(256, n_elements), 1, segments)
    return bm, bk

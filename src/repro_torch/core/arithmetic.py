"""Signed LNS arithmetic: ⊡ (mul), ⊞ (add), ⊟ (sub), reductions.

Paper eqs. (2)-(5).  All ops are elementwise over broadcast-compatible
:class:`LNSArray` operands, carried on int32 codes with explicit saturation
to the format width.  Sign convention: 1 = negative.
"""
from __future__ import annotations

import torch

from .delta import DeltaEngine
from .formats import LNSFormat
from .lns import LNSArray


def _sat(code, fmt: LNSFormat):
    """Saturate into the non-zero range, flushing underflow to zero."""
    over = torch.clamp(code, max=fmt.code_max)
    return torch.where(over < fmt.min_nonzero_code, fmt.zero_code, over)


def boxdot(a: LNSArray, b: LNSArray, fmt: LNSFormat) -> LNSArray:
    """⊡: linear-domain multiply = log-domain add (eq. 2)."""
    zero = (a.code == fmt.zero_code) | (b.code == fmt.zero_code)
    code = torch.where(zero, fmt.zero_code, _sat(a.code + b.code, fmt))
    sign = torch.where(zero, 0, a.sign ^ b.sign).to(torch.int8)
    return LNSArray(code, sign)


def boxneg(a: LNSArray) -> LNSArray:
    return LNSArray(a.code, a.sign ^ 1)


def boxplus(a: LNSArray, b: LNSArray, eng: DeltaEngine) -> LNSArray:
    """⊞: linear-domain add = max + Δ±(|X-Y|) (eq. 3)."""
    fmt = eng.fmt
    za = a.code == fmt.zero_code
    zb = b.code == fmt.zero_code
    d = torch.abs(a.code - b.code)
    same = a.sign == b.sign
    delta = torch.where(same, eng.plus(d), eng.minus(d))
    code = _sat(torch.maximum(a.code, b.code) + delta, fmt)
    # Opposite signs with equal magnitudes cancel exactly.
    code = torch.where(~same & (d == 0), fmt.zero_code, code)
    # Sign of the larger-magnitude operand (eq. 3c).
    sign = torch.where(same | (a.code > b.code), a.sign, b.sign)
    # x ⊞ 0 = x.
    code = torch.where(za, b.code, torch.where(zb, a.code, code))
    sign = torch.where(za, b.sign, torch.where(zb, a.sign, sign))
    return LNSArray(code, torch.where(code == fmt.zero_code, 0, sign
                                      ).to(torch.int8))


def boxminus(a: LNSArray, b: LNSArray, eng: DeltaEngine) -> LNSArray:
    """⊟: a - b = a ⊞ (-b) (eq. 5)."""
    return boxplus(a, boxneg(b), eng)


def boxdiv(a: LNSArray, b: LNSArray, fmt: LNSFormat) -> LNSArray:
    """Linear-domain divide = log-domain subtract of codes."""
    zero = a.code == fmt.zero_code
    code = torch.where(zero, fmt.zero_code, _sat(a.code - b.code, fmt))
    sign = torch.where(zero, 0, a.sign ^ b.sign).to(torch.int8)
    return LNSArray(code, sign)


def boxabs_max(a: LNSArray, axis: int, keepdims: bool = False) -> LNSArray:
    """Signed max over ``axis`` (value order, not magnitude order)."""
    key = torch.where(a.sign == 0, a.code + (1 << 30), -a.code - (1 << 30))
    idx = torch.argmax(key, dim=axis, keepdim=True)
    code = torch.take_along_dim(a.code, idx, dim=axis)
    sign = torch.take_along_dim(a.sign, idx, dim=axis)
    if not keepdims:
        code, sign = code.squeeze(axis), sign.squeeze(axis)
    return LNSArray(code, sign)


def boxsum(a: LNSArray, axis: int, eng: DeltaEngine,
           order: str = "pairwise") -> LNSArray:
    """⊞-reduction along ``axis``.

    ``pairwise``   — balanced tree over the axis zero-padded to a power of
                     two; what the train step uses for bias gradients and
                     the softmax denominator.
    ``sequential`` — left fold, matching a scalar MAC pipeline.
    ⊞ is only approximately associative, so the order is part of the
    result.
    """
    fmt = eng.fmt
    code = torch.movedim(a.code, axis, 0)
    sign = torch.movedim(a.sign, axis, 0)
    k = code.shape[0]
    if order == "sequential":
        acc = LNSArray(torch.full_like(code[0], fmt.zero_code),
                       torch.zeros_like(sign[0]))
        for i in range(k):
            acc = boxplus(acc, LNSArray(code[i], sign[i]), eng)
        return acc
    if order != "pairwise":
        raise ValueError(f"unknown ⊞ order {order!r}; expected 'pairwise' "
                         "or 'sequential'")
    n = 1
    while n < k:
        n *= 2
    if n != k:
        pad = (n - k,) + code.shape[1:]
        code = torch.cat([code, code.new_full(pad, fmt.zero_code)])
        sign = torch.cat([sign, sign.new_zeros(pad)])
    cur = LNSArray(code, sign)
    while cur.code.shape[0] > 1:
        h = cur.code.shape[0] // 2
        cur = boxplus(cur[:h], cur[h:], eng)
    return cur[0]


def boxsum_partials(parts: LNSArray, eng: DeltaEngine,
                    schedule: str = "sequential") -> LNSArray:
    """⊞-combine stacked partial sums along axis 0 on a fixed schedule.

    The reduction contract of data-parallel training
    (``distributed/lns_reduce.py``): ``parts`` holds S partials in
    canonical segment order, and the combine order depends on S alone,
    never on the rank count.  ``sequential`` is the left fold
    ``((p0 ⊞ p1) ⊞ p2) ⊞ …``; ``tree`` the balanced pairwise tree over
    the S slots zero-padded to a power of two.  The two differ in general.
    """
    if schedule not in ("sequential", "tree"):
        raise ValueError(f"unknown ⊞ combine schedule {schedule!r}; "
                         "expected 'sequential' or 'tree'")
    order = "sequential" if schedule == "sequential" else "pairwise"
    return boxsum(parts, 0, eng, order=order)


def lns_matmul(x: LNSArray, w: LNSArray, eng: DeltaEngine,
               order: str = "pairwise") -> LNSArray:
    """Z[..., m, n] = ⊞_k (X[..., m, k] ⊡ W[k, n]) (eq. 10).

    ``x``: (..., M, K), ``w``: (K, N).  The (..., M, K, N) ⊡ product is
    ⊞-summed over K in ``order`` (:func:`boxsum`): the balanced tree by
    default, as in the JAX package; ``order="sequential"`` is the
    ascending fold the MAC kernels keep, and their oracles ask for it.
    """
    prod = boxdot(LNSArray(x.code[..., :, :, None], x.sign[..., :, :, None]),
                  w, eng.fmt)
    return boxsum(prod, prod.ndim - 2, eng, order=order)


def matmul_dhist(x: LNSArray, w: LNSArray, eng: DeltaEngine,
                 edges_log2=None) -> torch.Tensor:
    """Δ-table occupancy of a sequential ⊞-MAC product: an int32 histogram
    of the ``|d| = |X - Y|`` entering the Δ engine.

    Replays ``lns_matmul(x, w, eng, order="sequential")``'s ascending MAC
    order (the order the kernels keep) and, at each accumulate, buckets
    ``|acc.code - prod.code|`` by the log2-magnitude ``edges_log2``
    (default :data:`repro_torch.obs.metrics.DHIST_EDGES`) put on the
    format's code grid.  Accumulates with a zero operand are not counted:
    ``x ⊞ 0`` bypasses the Δ engine.  Returns shape ``(len(edges) + 1,)``;
    the last bucket is beyond the table's ``d_max``.

    Telemetry only, taken at ``metrics=full``: a shadow pass in plain
    tensor ops beside the real product, whose result it never touches.
    """
    from ..obs.metrics import DHIST_EDGES, dhist_edges_codes
    fmt = eng.fmt
    edges = dhist_edges_codes(fmt, x.code.device,
                              DHIST_EDGES if edges_log2 is None
                              else edges_log2)
    prod = boxdot(LNSArray(x.code[..., :, :, None], x.sign[..., :, :, None]),
                  w, fmt)
    code = torch.movedim(prod.code, prod.ndim - 2, 0)
    sign = torch.movedim(prod.sign, prod.ndim - 2, 0)
    acc = LNSArray(torch.full_like(code[0], fmt.zero_code),
                   torch.zeros_like(sign[0]))
    d = torch.empty_like(code)
    live = torch.empty(code.shape, dtype=torch.bool, device=code.device)
    for i in range(code.shape[0]):
        live[i] = (acc.code != fmt.zero_code) & (code[i] != fmt.zero_code)
        d[i] = torch.abs(acc.code - code[i])
        acc = boxplus(acc, LNSArray(code[i], sign[i]), eng)
    bucket = torch.searchsorted(edges, d.reshape(-1), right=True)
    hist = torch.zeros(len(edges) + 1, dtype=torch.int64,
                       device=code.device)
    hist.scatter_add_(0, bucket, live.reshape(-1).to(torch.int64))
    return hist.to(torch.int32)


def bias_add(z: LNSArray, b: LNSArray, eng: DeltaEngine) -> LNSArray:
    """z ⊞ b with the bias broadcast over z's leading axes."""
    return boxplus(z, LNSArray(b.code.expand(z.shape), b.sign.expand(z.shape)),
                   eng)


def lns_affine(x: LNSArray, w: LNSArray, b: LNSArray, eng: DeltaEngine,
               order: str = "pairwise") -> LNSArray:
    """z = W x + b in the log domain (eq. 10 with bias)."""
    return bias_add(lns_matmul(x, w, eng, order=order), b, eng)

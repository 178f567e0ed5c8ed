"""Plain oracles for the ⊞-MAC kernels: the *unfused compositions* of
``core`` ops that each fused kernel folds into one pass.

Every oracle is ``core.arithmetic.lns_matmul(..., order="sequential")``
on suitably transposed operands, followed by the separate epilogue ops;
comparisons against the kernels are bit-exact.
"""
from __future__ import annotations

import torch

from ...core.activations import llrelu
from ...core.arithmetic import bias_add, lns_matmul
from ...core.delta import DeltaSpec, cached_engine
from ...core.formats import LNSFormat
from ...core.lns import LNSArray, convert_format
from ...core.sgd import UpdateEpilogue, apply_update_codes


def lns_matmul_ref(x: LNSArray, w: LNSArray, *, fmt: LNSFormat,
                   spec: DeltaSpec) -> LNSArray:
    """Z = X ⊞-MAC W, sequential over K."""
    return lns_matmul(x, w, cached_engine(spec, fmt), order="sequential")


def lns_matmul_fused_ref(x: LNSArray, w: LNSArray, *, fmt: LNSFormat,
                         spec: DeltaSpec, epilogue,
                         bias: "LNSArray | None" = None):
    """Sequential ⊞-MAC, then ``bias_add``, ``llrelu`` and
    ``convert_format`` per the :class:`FwdEpilogue`.  Returns ``(z,
    z_sign)`` with ``z_sign`` the post-bias pre-activation sign plane."""
    eng = cached_engine(spec, fmt)
    z = lns_matmul(x, w, eng, order="sequential")
    if epilogue.bias:
        z = bias_add(z, bias, eng)
    z_sign = z.sign
    if epilogue.llrelu_beta is not None:
        z = llrelu(z, epilogue.llrelu_beta, fmt)
    if epilogue.dst_fmt is not None:
        z = convert_format(z, fmt, epilogue.dst_fmt)
    return z, z_sign


def lns_matmul_dx_ref(dy: LNSArray, w: LNSArray, *, fmt: LNSFormat,
                      spec: DeltaSpec) -> LNSArray:
    """dX = dY ⊞-MAC Wᵀ, sequential over N."""
    return lns_matmul(dy, w.T, cached_engine(spec, fmt),
                      order="sequential")


def lns_matmul_dw_ref(x: LNSArray, dy: LNSArray, *, fmt: LNSFormat,
                      spec: DeltaSpec) -> LNSArray:
    """dW = Xᵀ ⊞-MAC dY, sequential over M."""
    return lns_matmul(x.T, dy, cached_engine(spec, fmt),
                      order="sequential")


def lns_matmul_dw_partials_ref(x: LNSArray, dy: LNSArray, *,
                               num_segments: int, fmt: LNSFormat,
                               spec: DeltaSpec) -> LNSArray:
    """out[s] = X[seg s]ᵀ ⊞-MAC dY[seg s] over ``num_segments`` equal
    contiguous segments of the batch, each sequential over its rows."""
    m = x.shape[0]
    if num_segments < 1 or m % num_segments:
        raise ValueError(f"batch {m} not divisible into {num_segments} "
                         f"equal segments")
    seg = m // num_segments
    outs = [lns_matmul_dw_ref(x[s * seg:(s + 1) * seg],
                              dy[s * seg:(s + 1) * seg], fmt=fmt, spec=spec)
            for s in range(num_segments)]
    return LNSArray(torch.stack([o.code for o in outs]),
                    torch.stack([o.sign for o in outs]))


def lns_matmul_dw_update_ref(x: LNSArray, dy: LNSArray, *, w: LNSArray,
                             epilogue: UpdateEpilogue, fmt: LNSFormat,
                             spec: DeltaSpec, m: "LNSArray | None" = None):
    """dW = Xᵀ ⊞-MAC dY (sequential over M), then the unfused ⊞-SGD.
    Returns ``(w_new, m_new)``."""
    eng = cached_engine(spec, fmt)
    return apply_update_codes(w, lns_matmul(x.T, dy, eng, order="sequential"),
                              m, epilogue, eng)


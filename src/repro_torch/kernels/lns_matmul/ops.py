"""``LNSArray``-level entry points of the ⊞-MAC and ⊞-SGD kernels, and
the differentiable ``lns_matmul_trainable``.

Each takes and returns :class:`~repro_torch.core.lns.LNSArray`\\ s and
routes by device like the wrappers it calls: the CUDA kernel for tensors
on the card, the plain PyTorch version for tensors on the CPU.  The ⊞-MAC
entry points pass ``block_rows``, the tiled form's output rows per block
(4 by default), to their wrapper.
"""
from __future__ import annotations

import torch

from ...core.delta import DeltaSpec
from ...core.formats import LNSFormat
from ...core.lns import LNSArray, LNSMatmulBackend, decode, encode
from ...core.sgd import UpdateEpilogue
from .lns_matmul import (FwdEpilogue, lns_matmul, lns_matmul_dw,
                         lns_matmul_dw_partials, lns_matmul_dw_update,
                         lns_matmul_dx, lns_matmul_fused)
from .update import lns_fused_update


def _check_momentum(epilogue: UpdateEpilogue, m) -> None:
    if epilogue.has_momentum != (m is not None):
        raise ValueError(
            f"epilogue momentum={epilogue.momentum_code} but momentum "
            f"state {'was' if m is not None else 'was not'} passed")


def lns_matmul_kernel(x: LNSArray, w: LNSArray, *, fmt: LNSFormat,
                      spec: DeltaSpec, block_rows: int = 4) -> LNSArray:
    """Forward ⊞-MAC: X (M, K) ⊞-MAC W (K, N) → (M, N), no epilogue."""
    return LNSArray(*lns_matmul(x.code, x.sign, w.code, w.sign, fmt=fmt,
                                spec=spec, block_rows=block_rows))


def lns_matmul_fused_kernel(x: LNSArray, w: LNSArray, *,
                            epilogue: FwdEpilogue,
                            bias: "LNSArray | None" = None,
                            fmt: LNSFormat, spec: DeltaSpec,
                            block_rows: int = 4):
    """Forward ⊞-MAC with the flush-time epilogue, one launch.  Returns
    the epilogued product, or ``(z, z_sign)`` when
    ``epilogue.emit_z_sign``."""
    if epilogue.bias != (bias is not None):
        raise ValueError(
            f"epilogue.bias={epilogue.bias} but bias "
            f"{'was' if bias is not None else 'was not'} passed")
    outs = lns_matmul_fused(
        x.code, x.sign, w.code, w.sign, fmt=fmt, spec=spec,
        epilogue=epilogue, bias_code=None if bias is None else bias.code,
        bias_sign=None if bias is None else bias.sign, block_rows=block_rows)
    z = LNSArray(outs[0], outs[1])
    return (z, outs[2]) if epilogue.emit_z_sign else z


def lns_matmul_dx_kernel(dy: LNSArray, w: LNSArray, *, fmt: LNSFormat,
                         spec: DeltaSpec, block_rows: int = 4) -> LNSArray:
    """Backward-activation ⊞-MAC: dY (M, N) ⊞-MAC Wᵀ → dX (M, K)."""
    return LNSArray(*lns_matmul_dx(dy.code, dy.sign, w.code, w.sign,
                                   fmt=fmt, spec=spec,
                                   block_rows=block_rows))


def lns_matmul_dw_kernel(x: LNSArray, dy: LNSArray, *, fmt: LNSFormat,
                         spec: DeltaSpec, block_rows: int = 4) -> LNSArray:
    """Backward-weight ⊞-MAC: Xᵀ ⊞-MAC dY (M, N) → dW (K, N)."""
    return LNSArray(*lns_matmul_dw(x.code, x.sign, dy.code, dy.sign,
                                   fmt=fmt, spec=spec,
                                   block_rows=block_rows))


def lns_matmul_dw_partials_kernel(x: LNSArray, dy: LNSArray, *,
                                  num_segments: int, fmt: LNSFormat,
                                  spec: DeltaSpec,
                                  block_rows: int = 4) -> LNSArray:
    """Segmented backward-weight ⊞-MAC: (S, K, N) per-segment dW partials
    over ``num_segments`` equal contiguous segments of the batch; raises
    ``ValueError`` when the batch does not divide."""
    return LNSArray(*lns_matmul_dw_partials(
        x.code, x.sign, dy.code, dy.sign, num_segments=num_segments,
        fmt=fmt, spec=spec, block_rows=block_rows))


def lns_matmul_dw_update_kernel(x: LNSArray, dy: LNSArray, *, w: LNSArray,
                                epilogue: UpdateEpilogue, fmt: LNSFormat,
                                spec: DeltaSpec,
                                m: "LNSArray | None" = None,
                                block_rows: int = 4):
    """Backward-weight ⊞-MAC with the ⊞-SGD update at flush; the weight
    gradient is never stored.  Returns ``(w_new, m_new)`` (``m_new is
    None`` without momentum)."""
    _check_momentum(epilogue, m)
    outs = lns_matmul_dw_update(
        x.code, x.sign, dy.code, dy.sign, w_code=w.code, w_sign=w.sign,
        epilogue=epilogue, fmt=fmt, spec=spec,
        m_code=None if m is None else m.code,
        m_sign=None if m is None else m.sign, block_rows=block_rows)
    m_new = LNSArray(outs[2], outs[3]) if epilogue.has_momentum else None
    return LNSArray(outs[0], outs[1]), m_new


def lns_fused_update_kernel(w: LNSArray, g: LNSArray, *,
                            epilogue: UpdateEpilogue, fmt: LNSFormat,
                            spec: DeltaSpec, m: "LNSArray | None" = None):
    """One-pass elementwise ⊞-SGD.  Returns ``(w_new, m_new)``."""
    _check_momentum(epilogue, m)
    outs = lns_fused_update(
        w.code, w.sign, g.code, g.sign, epilogue=epilogue, fmt=fmt,
        spec=spec, m_code=None if m is None else m.code,
        m_sign=None if m is None else m.sign)
    m_new = LNSArray(outs[2], outs[3]) if epilogue.has_momentum else None
    return LNSArray(outs[0], outs[1]), m_new


# ------------------------------------------------------------------------
# Differentiable op: the ⊞-MAC forward and backward under autograd
# ------------------------------------------------------------------------
class _Trainable(torch.autograd.Function):
    """Forward: encode both operands, ⊞-MAC (``lns_matmul``, kernel row 5),
    decode.  Saves the encoded operands, not the floats.  Backward: encode
    the cotangent, dX = dY ⊞ Wᵀ (``lns_matmul_dx``, row 2) and dW = Xᵀ ⊞ dY
    (``lns_matmul_dw``, row 6), each reading its transposed operand
    through the kernel's strides, and decode.  Each launch takes the rows
    per block that the backend's ``blocks`` give its shape."""

    @staticmethod
    def forward(ctx, x, w, be: LNSMatmulBackend):
        f = be.fmt
        xq, wq = encode(x, f), encode(w, f)
        # A transposed view (the tied embedding's head) encodes to
        # transposed planes; the kernels take row-major operands.
        wq = LNSArray(wq.code.contiguous(), wq.sign.contiguous())
        ctx.be = be
        ctx.save_for_backward(xq.code, xq.sign, wq.code, wq.sign)
        return decode(be.matmul(xq, wq), f)

    @staticmethod
    def backward(ctx, g):
        be = ctx.be
        xc, xs, wc, ws = ctx.saved_tensors
        dy = encode(g, be.fmt)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = decode(be.matmul_dx(dy, LNSArray(wc, ws)), be.fmt)
        if ctx.needs_input_grad[1]:
            dw = decode(be.matmul_dw(LNSArray(xc, xs), dy), be.fmt)
        return dx, dw, None


def lns_matmul_trainable(x, w, *, fmt: "LNSFormat | None" = None,
                         spec: "DeltaSpec | None" = None,
                         backend: "str | None" = None,
                         block_m: int = 128, block_n: int = 128,
                         block_k: int = 128,
                         interpret: "bool | None" = None,
                         numerics=None, layer: "str | None" = None):
    """Differentiable float-view matmul on the log-domain ⊞-MAC path.

    ``x``: (..., K) float, ``w``: (K, N) float.  The forward encodes both
    operands, runs the ⊞-MAC and decodes; the backward encodes the
    cotangent and runs the transposed ⊞-MACs (dX = dY ⊞ Wᵀ, dW = Xᵀ ⊞ dY):
    no float matmul in either direction.  The lane follows the device of
    the operands: the kernels on the card, their plain versions on the CPU.

    The arithmetic comes from explicit ``fmt`` / ``spec`` or from one
    ``numerics`` (a spec, a per-layer plan or their string; with a plan,
    ``layer`` picks the layer path); explicit pieces win.  The spec's
    ``blocks`` reaches the forward, dX and dW launches (``auto``: the
    autotuner's rows per block for each shape; ``MxNxK``: rows from M; see
    :class:`~repro_torch.core.lns.LNSMatmulBackend`).  ``backend``,
    ``interpret`` and the keyword block sizes are taken so that the JAX
    package's calls carry across; they route nothing.
    """
    from ...core.spec import resolve_blocks_arg, resolve_kernel_args
    fmt, spec, _, _, blocks = resolve_kernel_args(
        numerics, fmt=fmt, spec=spec, backend=backend, interpret=interpret,
        op="lns_matmul_trainable", layer=layer)
    bm, bn, bk, _ = resolve_blocks_arg(blocks, block_m, block_n, block_k)
    be = LNSMatmulBackend(fmt=fmt, spec=spec, block_m=bm, block_n=bn,
                          block_k=bk, blocks=blocks)
    lead = x.shape[:-1]
    z = _Trainable.apply(x.reshape(-1, x.shape[-1]), w, be)
    return z.reshape(lead + (w.shape[-1],))

"""LNS quantization-aware ops of the LM stack, as autograd Functions.

* :func:`lns_quantize_ste` — snap a float tensor to the LNS grid
  (encode → decode) with a straight-through gradient: the ``lns-qat``
  mode, whose products then run as float matmuls.
* :func:`lns_dot_exact` — forward through the ⊞-MAC in the pairwise-tree
  order of ``core.arithmetic.lns_matmul`` (plain tensor ops on every
  device, as the JAX package computes it in jnp); backward straight
  through, float products at the quantized operands.
* :func:`lns_dot_dispatch` — the same with the forward on the ⊞-MAC
  backend, sequential over the contraction: the kernel on the card, its
  plain version on the CPU.
* :func:`lns_dot_fused` — the serving forward: the fused ⊞-MAC with no
  epilogue (kernel row 1), no gradient.

For log-domain *gradients* use ``kernels.lns_matmul.lns_matmul_trainable``.
"""
from __future__ import annotations

import torch

from .arithmetic import lns_matmul
from .delta import DeltaSpec, cached_engine
from .formats import LNSFormat
from .lns import LNSMatmulBackend, decode, encode


def _quantize(x, fmt: LNSFormat):
    return decode(encode(x, fmt), fmt)


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        # dtype-preserving, so the straight-through cotangent matches.
        return _quantize(x, fmt).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def lns_quantize_ste(x, fmt: LNSFormat):
    """x snapped to ``fmt``'s grid, in x's dtype; gradient straight
    through."""
    return _QuantizeSTE.apply(x, fmt)


def _ste_grads(ctx, g, fmt: LNSFormat):
    """Straight-through gradients of the ideal linear product at the
    quantized operands: ``g ⊗ wqᵀ`` and ``xqᵀ ⊗ g`` over the flattened
    leading axes."""
    x, w = ctx.saved_tensors
    wq = _quantize(w, fmt)
    gx = gw = None
    if ctx.needs_input_grad[0]:
        gx = torch.matmul(g, wq.T)
    if ctx.needs_input_grad[1]:
        xq = _quantize(x, fmt)
        gw = torch.matmul(xq.reshape(-1, xq.shape[-1]).T,
                          g.reshape(-1, g.shape[-1]))
    return gx, gw


class _DotExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, fmt, spec):
        ctx.save_for_backward(x, w)
        ctx.fmt = fmt
        x2 = x.reshape(-1, x.shape[-1])
        z = lns_matmul(encode(x2, fmt), encode(w, fmt),
                       cached_engine(spec, fmt))
        return decode(z, fmt).reshape(x.shape[:-1] + (w.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        return _ste_grads(ctx, g, ctx.fmt) + (None, None)


def lns_dot_exact(x, w, fmt: LNSFormat, spec: DeltaSpec):
    """(..., K) @ (K, N) through the pairwise-tree ⊞-MAC; straight-through
    float gradients."""
    return _DotExact.apply(x, w, fmt, spec)


class _DotDispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, be):
        ctx.save_for_backward(x, w)
        ctx.fmt = be.fmt
        x2 = x.reshape(-1, x.shape[-1])
        z = be.matmul(encode(x2, be.fmt), encode(w, be.fmt))
        return decode(z, be.fmt).reshape(x.shape[:-1] + (w.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        return _ste_grads(ctx, g, ctx.fmt) + (None,)


def lns_dot_dispatch(x, w, be: LNSMatmulBackend):
    """(..., K) @ (K, N) forward on the ⊞-MAC backend (sequential, lane by
    device); straight-through float gradients, as :func:`lns_dot_exact`."""
    return _DotDispatch.apply(x, w, be)


def lns_dot_fused(x, w, be: LNSMatmulBackend):
    """(..., K) @ (K, N) forward-only through the *fused* ⊞-MAC
    (:meth:`~repro_torch.core.lns.LNSMatmulBackend.matmul_fused` with an
    empty epilogue, kernel row 1), for decode and prefill.  Bit-identical
    to :func:`lns_dot_dispatch`'s forward by the fusion contract; it runs
    under ``torch.no_grad`` and has no backward."""
    fmt = be.fmt
    with torch.no_grad():
        x2 = x.reshape(-1, x.shape[-1])
        z = be.matmul_fused(encode(x2, fmt), encode(w, fmt))
        return decode(z, fmt).reshape(x.shape[:-1] + (w.shape[-1],))

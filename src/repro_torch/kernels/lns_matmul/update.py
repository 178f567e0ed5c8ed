"""The elementwise fused ⊞-SGD update ``(w, m, g) → (w', m')``, lane by
device.

The bias updates of the fused train step go through it: bias gradients are
⊞-folds, not matmuls, so they have no dW flush to ride on.  For CUDA
tensors :func:`lns_fused_update` launches ``csrc/lns_mac.cu:
update_kernel`` (one thread per element, the block sized to the
update; replaces ``src/repro/kernels/lns_matmul/update.py:
_update_kernel``) and counts the launch; for CPU tensors it runs
:func:`update_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.delta import DeltaSpec
from ...core.formats import LNSFormat
from ...core.sgd import UpdateEpilogue
from .. import build
from .._common import checked, delta_fn, lane, lns_args, ptr
from .lns_matmul import _apply_update_epilogue, sgd_args


def update_plain(w_code, w_sign, g_code, g_sign, *, epilogue: UpdateEpilogue,
                 fmt: LNSFormat, spec: DeltaSpec, m_code=None, m_sign=None):
    """Plain PyTorch version of ``update_kernel`` on any device."""
    w_c, w_s, m_c, m_s = _apply_update_epilogue(
        w_code, w_sign, m_code, m_sign, g_code, g_sign, epilogue,
        delta_fn(spec, fmt, w_code.device), fmt)
    return (w_c, w_s) + ((m_c, m_s) if epilogue.has_momentum else ())


def update_cuda(w_code, w_sign, g_code, g_sign, *, epilogue: UpdateEpilogue,
                fmt: LNSFormat, spec: DeltaSpec, m_code=None, m_sign=None):
    """Launch ``update_kernel`` on the current stream over same-shape
    planes of any rank; same outputs as :func:`update_plain`."""
    lib = build.load_library()
    shape, dev = tuple(w_code.shape), w_code.device
    planes = [checked(w_code, torch.int32, shape, "w_code", dev),
              checked(w_sign, torch.int8, shape, "w_sign", dev),
              checked(g_code, torch.int32, shape, "g_code", dev),
              checked(g_sign, torch.int8, shape, "g_sign", dev)]
    if epilogue.has_momentum:
        planes += [checked(m_code, torch.int32, shape, "m_code", dev),
                   checked(m_sign, torch.int8, shape, "m_sign", dev)]
    else:
        planes += [None, None]
    outs = [torch.empty(shape, dtype=torch.int32, device=dev),
            torch.empty(shape, dtype=torch.int8, device=dev)]
    if epilogue.has_momentum:
        outs += [torch.empty(shape, dtype=torch.int32, device=dev),
                 torch.empty(shape, dtype=torch.int8, device=dev)]
    p = build.UpdateParams(
        lns=lns_args(fmt, spec, dev), sgd=sgd_args(epilogue),
        n=w_code.numel(),
        w_code=ptr(planes[0]), w_sign=ptr(planes[1]),
        g_code=ptr(planes[2]), g_sign=ptr(planes[3]),
        m_code=ptr(planes[4]), m_sign=ptr(planes[5]),
        w_code_out=ptr(outs[0]), w_sign_out=ptr(outs[1]))
    if epilogue.has_momentum:
        p.m_code_out, p.m_sign_out = ptr(outs[2]), ptr(outs[3])
    if p.n == 0:
        raise ValueError("empty update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lns_update_launch(ctypes.byref(p), ctypes.c_void_p(stream))
    build.check(lib, rc, "lns_update_launch")
    return tuple(outs)


def lns_fused_update(w_code, w_sign, g_code, g_sign, *,
                     epilogue: UpdateEpilogue, fmt: LNSFormat,
                     spec: DeltaSpec, m_code=None, m_sign=None):
    """One-pass ⊞-SGD over same-shape planes.  Returns ``(w_code',
    w_sign')`` plus ``(m_code', m_sign')`` when the epilogue has
    momentum."""
    if epilogue.has_momentum and (m_code is None or m_sign is None):
        raise ValueError("UpdateEpilogue has momentum but no momentum "
                         "planes (m_code/m_sign)")
    kw = dict(epilogue=epilogue, fmt=fmt, spec=spec, m_code=m_code,
              m_sign=m_sign)
    if lane(w_code) == "cuda":
        lns_fused_update.launches += 1
        return update_cuda(w_code, w_sign, g_code, g_sign, **kw)
    return update_plain(w_code, w_sign, g_code, g_sign, **kw)


lns_fused_update.launches = 0

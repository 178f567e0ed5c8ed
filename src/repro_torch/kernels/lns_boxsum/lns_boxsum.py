"""The row-wise sequential ⊞-reduce, lane by device.

``lns_boxsum`` folds each row of an (M, K) code / sign plane pair over its
K steps in ascending order into one accumulator, → (M,).  For CUDA
tensors it launches ``csrc/lns_mac.cu: boxsum_kernel`` (one thread per
row; replaces ``src/repro/kernels/lns_boxsum/lns_boxsum.py: _kernel``) and
counts the launch; for CPU tensors it runs :func:`boxsum_plain`.

The kernel reads the planes through their strides, so a transposed view
costs no copy: the data-parallel combine reduces (S, E) segment partials
as the (E, S) view ``parts.T``, where neighbouring rows are neighbouring
words.  Strides change where the kernel reads, never the order.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.delta import DeltaSpec
from ...core.formats import LNSFormat
from .. import build
from .._common import boxplus_codes, delta_fn, lane, lns_args, ptr


def _check(code, sign):
    if code.dim() != 2 or code.shape != sign.shape:
        raise ValueError(f"expected (M, K) code and sign planes, got "
                         f"{tuple(code.shape)} and {tuple(sign.shape)}")
    if code.dtype != torch.int32 or sign.dtype != torch.int8:
        raise ValueError(f"expected int32 codes and int8 signs, got "
                         f"{code.dtype} and {sign.dtype}")


def boxsum_plain(code, sign, *, fmt: LNSFormat, spec: DeltaSpec):
    """Plain PyTorch version of ``boxsum_kernel`` on any device."""
    _check(code, sign)
    delta = delta_fn(spec, fmt, code.device)
    acc_c = torch.full(code.shape[:1], fmt.zero_code, dtype=torch.int32,
                       device=code.device)
    acc_s = torch.zeros_like(acc_c, dtype=torch.int8)
    for k in range(code.shape[1]):
        acc_c, acc_s = boxplus_codes(acc_c, acc_s, code[:, k], sign[:, k],
                                      delta, fmt)
    return acc_c, acc_s


def boxsum_cuda(code, sign, *, fmt: LNSFormat, spec: DeltaSpec):
    """Launch ``boxsum_kernel`` on the current stream; same outputs as
    :func:`boxsum_plain`."""
    _check(code, sign)
    lib = build.load_library()
    dev = code.device
    if sign.device != dev:
        raise ValueError(f"sign is on {sign.device}; this launch runs on "
                         f"{dev}")
    if code.stride() != sign.stride():
        code, sign = code.contiguous(), sign.contiguous()
    m, k = code.shape
    if m == 0:
        raise ValueError("empty output")
    out_code = torch.empty((m,), dtype=torch.int32, device=dev)
    out_sign = torch.empty((m,), dtype=torch.int8, device=dev)
    p = build.BoxsumParams(
        lns=lns_args(fmt, spec, dev), code=ptr(code), sign=ptr(sign),
        rows=m, steps=k, row_stride=code.stride(0),
        step_stride=code.stride(1), out_code=ptr(out_code),
        out_sign=ptr(out_sign))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lns_boxsum_launch(ctypes.byref(p), ctypes.c_void_p(stream))
    build.check(lib, rc, "lns_boxsum_launch")
    return out_code, out_sign


def lns_boxsum(code, sign, *, fmt: LNSFormat, spec: DeltaSpec):
    """⊞-reduce (M, K) planes over axis 1, ascending → ``(code, sign)``
    (M,)."""
    if lane(code, "⊞-reduce") == "cuda":
        lns_boxsum.launches += 1
        return boxsum_cuda(code, sign, fmt=fmt, spec=spec)
    return boxsum_plain(code, sign, fmt=fmt, spec=spec)


lns_boxsum.launches = 0

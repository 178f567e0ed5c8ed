"""The row-wise sequential ⊞-reduce, lane by device.

``lns_boxsum`` folds each row of an (M, K) code / sign plane pair over its
K steps in ascending order into one accumulator, → (M,).  For CUDA
tensors it launches ``csrc/lns_mac.cu: boxsum_kernel`` (one thread per
row; replaces ``src/repro/kernels/lns_boxsum/lns_boxsum.py: _kernel``) and
counts the launch; for CPU tensors it runs :func:`boxsum_plain`.
``lns_boxsum_many`` reduces several such pairs, of any row and step
counts, in one launch per ``build.BOXSUM_MAX_SETS`` pairs, each counted
in ``lns_boxsum.launches``.

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


def boxsum_many_cuda(sets, *, fmt: LNSFormat, spec: DeltaSpec):
    """Launch ``boxsum_kernel`` once on the current stream over the
    (code, sign) pairs of ``sets`` (at most ``build.BOXSUM_MAX_SETS``);
    returns one :func:`boxsum_plain` result per pair."""
    if not 1 <= len(sets) <= build.BOXSUM_MAX_SETS:
        raise ValueError(f"one ⊞-reduce launch takes 1 to "
                         f"{build.BOXSUM_MAX_SETS} row sets, got "
                         f"{len(sets)}")
    lib = build.load_library()
    dev = sets[0][0].device
    p = build.BoxsumParams(lns=lns_args(fmt, spec, dev), n_sets=len(sets))
    outs, planes = [], []  # the planes stay alive until the launch
    for j, (code, sign) in enumerate(sets):
        _check(code, sign)
        for t in (code, sign):
            if t.device != dev:
                raise ValueError(f"a row set is on {t.device}; this launch "
                                 f"runs on {dev}")
        if code.stride() != sign.stride():
            code, sign = code.contiguous(), sign.contiguous()
        planes.append((code, sign))
        m, k = code.shape
        if m == 0:
            raise ValueError("empty output")
        out_code = torch.empty((m,), dtype=torch.int32, device=dev)
        out_sign = torch.empty((m,), dtype=torch.int8, device=dev)
        p.sets[j] = build.BoxsumSet(
            code=ptr(code), sign=ptr(sign), rows=m, steps=k,
            row_stride=code.stride(0), step_stride=code.stride(1),
            out_code=ptr(out_code), out_sign=ptr(out_sign))
        outs.append((out_code, out_sign))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lns_boxsum_launch(ctypes.byref(p), ctypes.c_void_p(stream))
    build.check(lib, rc, "lns_boxsum_launch")
    return outs


def boxsum_cuda(code, sign, *, fmt: LNSFormat, spec: DeltaSpec):
    """Launch ``boxsum_kernel`` on one row set; same outputs as
    :func:`boxsum_plain`."""
    return boxsum_many_cuda([(code, sign)], fmt=fmt, spec=spec)[0]


def lns_boxsum(code, sign, *, fmt: LNSFormat, spec: DeltaSpec):
    """⊞-reduce (M, K) planes over axis 1, ascending → ``(code, sign)``
    (M,): the one-set case of :func:`lns_boxsum_many`."""
    return lns_boxsum_many([(code, sign)], fmt=fmt, spec=spec)[0]


lns_boxsum.launches = 0


def lns_boxsum_many(sets, *, fmt: LNSFormat, spec: DeltaSpec):
    """⊞-reduce each (M_i, K_i) (code, sign) pair of ``sets`` over axis 1,
    ascending → a list of ``(code, sign)`` (M_i,), in order.  On CUDA
    tensors: one launch per ``build.BOXSUM_MAX_SETS`` pairs, each counted
    in ``lns_boxsum.launches``; on CPU tensors: :func:`boxsum_plain` per
    pair.  Every pair lies on one device."""
    sets = list(sets)
    lanes = {lane(t, "⊞-reduce") for pair in sets for t in pair}
    if len(lanes) > 1:
        raise ValueError("the row sets of one ⊞-reduce lie on the card and "
                         "on the CPU")
    if lanes != {"cuda"}:
        return [boxsum_plain(c, s, fmt=fmt, spec=spec) for c, s in sets]
    out = []
    for lo in range(0, len(sets), build.BOXSUM_MAX_SETS):
        lns_boxsum.launches += 1
        out += boxsum_many_cuda(sets[lo:lo + build.BOXSUM_MAX_SETS],
                                fmt=fmt, spec=spec)
    return out

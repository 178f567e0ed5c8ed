"""The sequential ⊞-MAC kernel and its flush-time epilogues, lane by device.

One CUDA ⊞-MAC body (``csrc/lns_mac.cu``) serves six launch
configurations, told apart by which axis of each operand is contracted,
the epilogue and the number of contraction segments.  It has two forms,
which the library's launcher picks from the steps per segment alone:
``mac_short_kernel`` for short contractions (the dW, dW-update and
partials over the batch of 5, the dX over 10 classes) and the tiled
``mac_kernel`` for long ones (the forward over 784 and 100 inputs,
anything over the batch of 500).  Every wrapper takes ``block_rows``, the
tiled form's output rows per block (1, 2, 4 or 8; 4 by default), which
the block autotuner picks under ``blocks=auto`` (``kernels/autotune.py``);
it changes no result.  The configurations:

* ``lns_matmul``           Z[m,n]  = ⊞_k X[m,k] ⊡ W[k,n], no epilogue;
* ``lns_matmul_fused``     the same with bias ⊞ / llReLU / requantize at
  flush (:class:`FwdEpilogue`);
* ``lns_matmul_dx``        dX[m,k] = ⊞_n dY[m,n] ⊡ W[k,n]  (= dY ⊞ Wᵀ);
* ``lns_matmul_dw``        dW[k,n] = ⊞_m X[m,k] ⊡ dY[m,n], no epilogue;
* ``lns_matmul_dw_update`` the same dW consumed at flush by the ⊞-SGD
  update (:class:`~repro_torch.core.sgd.UpdateEpilogue`): the outputs are
  the updated weights (and momentum);
* ``lns_matmul_dw_partials`` the batch cut into S equal contiguous
  segments, slot s = X[seg s]ᵀ ⊞-MAC dY[seg s]: (S, K, N) partials, the
  emission side of the data-parallel ⊞ reduce.

Each wrapper launches the kernel for CUDA tensors (and counts the launch
in its ``launches`` attribute) and runs :func:`mac_plain`, the plain
PyTorch version of the same arithmetic, for CPU tensors.  There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

The epilogue helpers below mirror the Pallas kernel's (``src/repro/
kernels/lns_matmul/lns_matmul.py``) op for op on int32 code / int8 sign
planes, on the plain ⊞ of ``kernels/_common.py``; the CUDA source mirrors
the same functions.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ...core.delta import DeltaSpec
from ...core.formats import LNSFormat
from ...core.sgd import UpdateEpilogue
from .. import build
from .._common import boxplus_codes, checked, delta_fn, lane, lns_args, ptr

_EPI_NONE, _EPI_FWD, _EPI_UPDATE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class FwdEpilogue:
    """Flush-time epilogue of the forward ⊞-MAC, applied in this order:

    1. ``bias=True``           — ⊞-add a broadcast (N,) bias row;
    2. ``llrelu_beta=β``       — log-leaky-ReLU (code += β on negatives,
                                 underflow flush);
    3. ``dst_fmt=<LNSFormat>`` — requantize onto another format's grid.

    ``emit_z_sign=True`` adds an output plane with the post-bias,
    pre-activation sign, the only piece of z that backward needs.
    """

    bias: bool = False
    llrelu_beta: Optional[int] = None
    dst_fmt: Optional[LNSFormat] = None
    emit_z_sign: bool = False


# ------------------------------------------------------------------------
# Plain PyTorch version (any device)
# ------------------------------------------------------------------------

def _apply_fwd_epilogue(code, sign, ep: FwdEpilogue, bias_c, bias_s,
                        delta, fmt: LNSFormat):
    """bias ⊞ → llReLU → requantize; returns ``(code, sign, z_sign)``."""
    zero = fmt.zero_code
    if ep.bias:
        code, sign = boxplus_codes(code, sign, bias_c, bias_s, delta, fmt)
    z_sign = sign
    if ep.llrelu_beta is not None:
        shifted = code + ep.llrelu_beta
        shifted = torch.where(shifted < fmt.min_nonzero_code, zero, shifted)
        act = torch.where(sign == 1, shifted, code)
        code = torch.where(code == zero, zero, act)
    if ep.dst_fmt is not None and ep.dst_fmt != fmt:
        dst = ep.dst_fmt
        shift = dst.qf - fmt.qf
        if shift >= 0:
            conv = code << shift
        else:
            conv = (code + (1 << (-shift - 1))) >> (-shift)
        is_zero = (code == zero) | (conv < dst.min_nonzero_code)
        conv = torch.clamp(conv, dst.min_nonzero_code, dst.code_max)
        code = torch.where(is_zero, dst.zero_code, conv)
        sign = torch.where(is_zero, 0, sign).to(torch.int8)
    return code, sign, z_sign


def _scalar_boxdot_codes(scode: int, t_c, t_s, fmt: LNSFormat):
    """⊡ by a positive nonzero scalar code."""
    zero = fmt.zero_code
    zt = t_c == zero
    code = torch.clamp(t_c + scode, max=fmt.code_max)
    code = torch.where(code < fmt.min_nonzero_code, zero, code)
    return (torch.where(zt, zero, code),
            torch.where(zt, 0, t_s).to(torch.int8))


def _apply_update_epilogue(w_c, w_s, m_c, m_s, g_c, g_s,
                           ep: UpdateEpilogue, delta, fmt: LNSFormat):
    """⊞-SGD: M ← (μ⊡M) ⊞ G; W ← W ⊟ (lr⊡M) ⊟ (lrλ⊡W).  Returns the
    updated ``(w_c, w_s, m_c, m_s)``."""
    if ep.momentum_code is not None:
        mm_c, mm_s = _scalar_boxdot_codes(ep.momentum_code, m_c, m_s, fmt)
        m_c, m_s = boxplus_codes(mm_c, mm_s, g_c, g_s, delta, fmt)
        g_c, g_s = m_c, m_s
    lg_c, lg_s = _scalar_boxdot_codes(ep.lr_code, g_c, g_s, fmt)
    w_c, w_s = boxplus_codes(w_c, w_s, lg_c, lg_s ^ 1, delta, fmt)
    if ep.weight_decay_code is not None:
        wd_c, wd_s = _scalar_boxdot_codes(ep.weight_decay_code, w_c, w_s,
                                          fmt)
        w_c, w_s = boxplus_codes(w_c, w_s, wd_c, wd_s ^ 1, delta, fmt)
    return w_c, w_s, m_c, m_s


def _check_segments(ct: int, segments: Optional[int], epilogue) -> int:
    """The segment count S of a launch (1 without segments), after the
    checks the kernel relies on."""
    if segments is None:
        return 1
    if segments < 1 or ct % segments:
        raise ValueError(f"batch {ct} not divisible into {segments} equal "
                         f"segments")
    if epilogue:
        raise ValueError("flush epilogues do not compose with segment "
                         "partials: the partials feed the ⊞-combine first")
    return segments


def mac_plain(a_code, a_sign, b_code, b_sign, *, a_contract_axis: int,
              b_contract_axis: int, fmt: LNSFormat, spec: DeltaSpec,
              segments: Optional[int] = None,
              fwd_epilogue: Optional[FwdEpilogue] = None,
              bias_code=None, bias_sign=None,
              update_epilogue: Optional[UpdateEpilogue] = None,
              w_code=None, w_sign=None, m_code=None, m_sign=None,
              block_rows: int = 4):
    """Plain PyTorch version of ``mac_kernel`` on any device.

    ``a``'s non-contracted axis gives the output rows, ``b``'s the output
    columns.  One (R, C) accumulator takes the contraction's products in
    ascending order; the epilogue runs once, at flush.  Returns the output
    planes in kernel order: ``code, sign[, z_sign][, m_code, m_sign]``.
    ``segments=S`` cuts the contraction into S equal runs, each folded
    into its own accumulator: the planes are then (S, R, C).
    ``block_rows`` is taken and ignored: tiles change no result, and the
    plain version has none.
    """
    a_c = a_code if a_contract_axis == 1 else a_code.T   # (R, CT)
    a_s = a_sign if a_contract_axis == 1 else a_sign.T
    b_c = b_code if b_contract_axis == 0 else b_code.T   # (CT, C)
    b_s = b_sign if b_contract_axis == 0 else b_sign.T
    (r, ct), c = a_c.shape, b_c.shape[1]
    n_seg = _check_segments(ct, segments,
                            fwd_epilogue or update_epilogue)
    seg = ct // n_seg
    # Segment z holds contraction steps [z·seg, (z+1)·seg): (S, R, seg)
    # and (S, seg, C) views, one accumulator slot per segment.
    a_c = a_c.reshape(r, n_seg, seg).permute(1, 0, 2)
    a_s = a_s.reshape(r, n_seg, seg).permute(1, 0, 2)
    b_c = b_c.reshape(n_seg, seg, c)
    b_s = b_s.reshape(n_seg, seg, c)
    zero = fmt.zero_code
    delta = delta_fn(spec, fmt, a_code.device)
    acc_c = torch.full((n_seg, r, c), zero, dtype=torch.int32,
                       device=a_code.device)
    acc_s = torch.zeros_like(acc_c, dtype=torch.int8)
    for i in range(seg):
        ac, asn = a_c[:, :, i:i + 1], a_s[:, :, i:i + 1]
        bc, bsn = b_c[:, i:i + 1, :], b_s[:, i:i + 1, :]
        pz = (ac == zero) | (bc == zero)
        pc = torch.clamp(ac + bc, max=fmt.code_max)
        pc.masked_fill_((pc < fmt.min_nonzero_code) | pz, zero)
        ps = (asn ^ bsn).masked_fill_(pz, 0)
        acc_c, acc_s = boxplus_codes(acc_c, acc_s, pc, ps, delta, fmt)
    if segments is not None:
        return acc_c, acc_s
    acc_c, acc_s = acc_c[0], acc_s[0]
    if fwd_epilogue is not None:
        code, sign, z_sign = _apply_fwd_epilogue(
            acc_c, acc_s, fwd_epilogue, bias_code, bias_sign, delta, fmt)
        return (code, sign) + ((z_sign,) if fwd_epilogue.emit_z_sign else ())
    if update_epilogue is not None:
        w_c, w_s, m_c, m_s = _apply_update_epilogue(
            w_code, w_sign, m_code, m_sign, acc_c, acc_s, update_epilogue,
            delta, fmt)
        return (w_c, w_s) + ((m_c, m_s) if update_epilogue.has_momentum
                             else ())
    return acc_c, acc_s


# ------------------------------------------------------------------------
# CUDA kernel launch
# ------------------------------------------------------------------------

def sgd_args(ep: UpdateEpilogue) -> build.SgdArgs:
    return build.SgdArgs(
        lr_code=ep.lr_code, mom_on=int(ep.has_momentum),
        mom_code=ep.momentum_code or 0,
        wd_on=int(ep.weight_decay_code is not None),
        wd_code=ep.weight_decay_code or 0)


#: The launcher's limits (``lns_mac_launch`` in ``csrc/lns_mac.cu``):
#: operand strides below 2^26, at most 65535 segments (grid z), and for the
#: tiled form (CT > ``lns_short_steps()``) at most 2^31 - 1 tiles of
#: ``block_rows`` rows (one of ``MAC_BLOCK_ROWS``) by ``MAC_TILE_COLS``
#: columns (grid x holds the row tiles times the column tiles); the short
#: form's S·R·C outputs fit an int32.
MAC_MAX_STRIDE = 1 << 26
MAC_MAX_GRID = 65535
MAC_MAX_TILES = 2**31 - 1
MAC_BLOCK_ROWS = (1, 2, 4, 8)
MAC_TILE_COLS = 32


def check_launch_limits(r: int, c: int, ct: int, n_seg: int,
                        strides, short_steps: int,
                        block_rows: int = 4) -> None:
    """Raise ``ValueError`` for a launch outside the kernel's limits, so
    that no grid or offset wraps: ``strides`` are the operands' element
    strides, ``ct`` the whole contraction, ``block_rows`` the tiled form's
    rows per block."""
    if block_rows not in MAC_BLOCK_ROWS:
        raise ValueError(f"block_rows={block_rows}; the tiled ⊞-MAC takes "
                         f"{', '.join(map(str, MAC_BLOCK_ROWS))} rows a "
                         f"block")
    if n_seg > MAC_MAX_GRID:
        raise ValueError(f"{n_seg} segments; the kernel takes at most "
                         f"{MAC_MAX_GRID}")
    if max(strides) >= MAC_MAX_STRIDE:
        raise ValueError(f"operand stride {max(strides)} >= 2^26: the "
                         f"kernel's offsets would overflow")
    if ct // n_seg > short_steps:
        tiles = -(-r // block_rows) * -(-c // MAC_TILE_COLS)
        if tiles > MAC_MAX_TILES:
            raise ValueError(
                f"{r} x {c} outputs make {tiles} tiles; the tiled ⊞-MAC "
                f"takes at most {MAC_MAX_TILES} (grid x)")
    elif n_seg * r * c > 2**31 - 1:
        raise ValueError(f"{n_seg * r * c} outputs; the short ⊞-MAC takes "
                         f"at most 2^31 - 1")


def mac_cuda(a_code, a_sign, b_code, b_sign, *, a_contract_axis: int,
             b_contract_axis: int, fmt: LNSFormat, spec: DeltaSpec,
             segments: Optional[int] = None,
             fwd_epilogue: Optional[FwdEpilogue] = None,
             bias_code=None, bias_sign=None,
             update_epilogue: Optional[UpdateEpilogue] = None,
             w_code=None, w_sign=None, m_code=None, m_sign=None,
             block_rows: int = 4):
    """Launch the ⊞-MAC (``mac_short_kernel`` or ``mac_kernel``, as the
    library's launcher picks) on the current stream; same arguments and
    outputs as :func:`mac_plain`.  The tiled form takes ``block_rows``
    output rows a block; the short form does not read it."""
    lib = build.load_library()
    dev = a_code.device
    r, ct = a_code.shape[1 - a_contract_axis], a_code.shape[a_contract_axis]
    c = b_code.shape[1 - b_contract_axis]
    if b_code.shape[b_contract_axis] != ct:
        raise ValueError(f"contraction lengths differ: {tuple(a_code.shape)}"
                         f" vs {tuple(b_code.shape)}")
    if r == 0 or c == 0:
        raise ValueError("empty output")
    n_seg = _check_segments(ct, segments, fwd_epilogue or update_epilogue)
    a_code = checked(a_code, torch.int32, a_code.shape, "a_code", dev)
    a_sign = checked(a_sign, torch.int8, a_code.shape, "a_sign", dev)
    b_code = checked(b_code, torch.int32, b_code.shape, "b_code", dev)
    b_sign = checked(b_sign, torch.int8, b_code.shape, "b_sign", dev)
    a_rows = a_code.shape[1]  # row-major stride of axis 0
    b_rows = b_code.shape[1]
    check_launch_limits(r, c, ct, n_seg, (a_rows, b_rows),
                        lib.lns_short_steps(), block_rows)
    p = build.MacParams(
        lns=lns_args(fmt, spec, dev),
        a_code=ptr(a_code), a_sign=ptr(a_sign),
        a_sr=a_rows if a_contract_axis == 1 else 1,
        a_st=1 if a_contract_axis == 1 else a_rows,
        b_code=ptr(b_code), b_sign=ptr(b_sign),
        b_st=b_rows if b_contract_axis == 0 else 1,
        b_sc=1 if b_contract_axis == 0 else b_rows,
        R=r, C=c, CT=ct // n_seg, S=n_seg, rows=block_rows,
        epilogue=_EPI_NONE)
    shape = (r, c) if segments is None else (n_seg, r, c)
    out_code = torch.empty(shape, dtype=torch.int32, device=dev)
    out_sign = torch.empty(shape, dtype=torch.int8, device=dev)
    outs = [out_code, out_sign]
    if fwd_epilogue is not None:
        ep = fwd_epilogue
        p.epilogue = _EPI_FWD
        if ep.bias:
            bias_code = checked(bias_code, torch.int32, (c,), "bias_code",
                                 dev)
            bias_sign = checked(bias_sign, torch.int8, (c,), "bias_sign",
                                 dev)
            p.bias_code, p.bias_sign = ptr(bias_code), ptr(bias_sign)
        if ep.llrelu_beta is not None:
            p.llrelu_on, p.beta = 1, ep.llrelu_beta
        if ep.dst_fmt is not None and ep.dst_fmt != fmt:
            d = ep.dst_fmt
            p.dst_on, p.dst_qf, p.dst_code_max = 1, d.qf, d.code_max
            p.dst_min_nz, p.dst_zero = d.min_nonzero_code, d.zero_code
        if ep.emit_z_sign:
            z_sign = torch.empty((r, c), dtype=torch.int8, device=dev)
            outs.append(z_sign)
            p.z_sign_out = ptr(z_sign)
    elif update_epilogue is not None:
        ep = update_epilogue
        p.epilogue = _EPI_UPDATE
        p.sgd = sgd_args(ep)
        w_code = checked(w_code, torch.int32, (r, c), "w_code", dev)
        w_sign = checked(w_sign, torch.int8, (r, c), "w_sign", dev)
        p.w_code, p.w_sign = ptr(w_code), ptr(w_sign)
        if ep.has_momentum:
            m_code = checked(m_code, torch.int32, (r, c), "m_code", dev)
            m_sign = checked(m_sign, torch.int8, (r, c), "m_sign", dev)
            m_out_c = torch.empty((r, c), dtype=torch.int32, device=dev)
            m_out_s = torch.empty((r, c), dtype=torch.int8, device=dev)
            outs += [m_out_c, m_out_s]
            p.m_code, p.m_sign = ptr(m_code), ptr(m_sign)
            p.m_code_out, p.m_sign_out = ptr(m_out_c), ptr(m_out_s)
    p.out_code, p.out_sign = ptr(out_code), ptr(out_sign)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lns_mac_launch(ctypes.byref(p), ctypes.c_void_p(stream))
    build.check(lib, rc, "lns_mac_launch")
    return tuple(outs)


# ------------------------------------------------------------------------
# Wrappers: kernel on the card, plain version on the CPU
# ------------------------------------------------------------------------

def _run(wrapper, a_code, a_sign, b_code, b_sign, **kw):
    """The kernel for CUDA operands, counted on ``wrapper``; the plain
    version for CPU operands."""
    if lane(a_code) == "cuda":
        wrapper.launches += 1
        return mac_cuda(a_code, a_sign, b_code, b_sign, **kw)
    return mac_plain(a_code, a_sign, b_code, b_sign, **kw)


def lns_matmul(x_code, x_sign, w_code, w_sign, *, fmt: LNSFormat,
               spec: DeltaSpec, block_rows: int = 4):
    """Forward x (M, K) ⊞-MAC w (K, N) → ``(z_code, z_sign)`` (M, N),
    ascending over K, no epilogue."""
    return _run(lns_matmul, x_code, x_sign, w_code, w_sign,
                a_contract_axis=1, b_contract_axis=0, fmt=fmt, spec=spec,
                block_rows=block_rows)


def lns_matmul_fused(x_code, x_sign, w_code, w_sign, *, fmt: LNSFormat,
                     spec: DeltaSpec, epilogue: FwdEpilogue,
                     bias_code=None, bias_sign=None, block_rows: int = 4):
    """Forward x (M, K) ⊞-MAC w (K, N) with the flush epilogue.  Returns
    ``(z_code, z_sign)`` plus the post-bias ``z_sign`` plane when
    ``epilogue.emit_z_sign``; in ``epilogue.dst_fmt`` when set."""
    return _run(lns_matmul_fused, x_code, x_sign, w_code, w_sign,
                a_contract_axis=1, b_contract_axis=0, fmt=fmt, spec=spec,
                fwd_epilogue=epilogue, bias_code=bias_code,
                bias_sign=bias_sign, block_rows=block_rows)


def lns_matmul_dx(dy_code, dy_sign, w_code, w_sign, *, fmt: LNSFormat,
                  spec: DeltaSpec, block_rows: int = 4):
    """dY (M, N) ⊞-MAC Wᵀ → dX (M, K), ascending over N; W is read in its
    stored (K, N) layout."""
    return _run(lns_matmul_dx, dy_code, dy_sign, w_code, w_sign,
                a_contract_axis=1, b_contract_axis=1, fmt=fmt, spec=spec,
                block_rows=block_rows)


def lns_matmul_dw(x_code, x_sign, dy_code, dy_sign, *, fmt: LNSFormat,
                  spec: DeltaSpec, block_rows: int = 4):
    """dW = Xᵀ ⊞-MAC dY → (K, N), ascending over the batch M; X is read in
    its stored (M, K) layout."""
    return _run(lns_matmul_dw, x_code, x_sign, dy_code, dy_sign,
                a_contract_axis=0, b_contract_axis=0, fmt=fmt, spec=spec,
                block_rows=block_rows)


def lns_matmul_dw_partials(x_code, x_sign, dy_code, dy_sign, *,
                           num_segments: int, fmt: LNSFormat,
                           spec: DeltaSpec, block_rows: int = 4):
    """Per-segment dW: the batch M cut into ``num_segments`` equal
    contiguous segments (M must divide exactly); returns (S, K, N) planes
    with slot s = X[seg s]ᵀ ⊞-MAC dY[seg s], ascending within the
    segment."""
    return _run(lns_matmul_dw_partials, x_code, x_sign, dy_code, dy_sign,
                a_contract_axis=0, b_contract_axis=0, fmt=fmt, spec=spec,
                segments=num_segments, block_rows=block_rows)


def lns_matmul_dw_update(x_code, x_sign, dy_code, dy_sign, *, w_code,
                         w_sign, epilogue: UpdateEpilogue, fmt: LNSFormat,
                         spec: DeltaSpec, m_code=None, m_sign=None,
                         block_rows: int = 4):
    """dW = Xᵀ ⊞-MAC dY (ascending over the batch M), consumed at flush
    by the ⊞-SGD against the resident (K, N) ``w`` (and ``m``).  Returns
    ``(w_code', w_sign')`` plus ``(m_code', m_sign')`` with momentum."""
    if epilogue.has_momentum and (m_code is None or m_sign is None):
        raise ValueError("UpdateEpilogue has momentum but no momentum "
                         "planes (m_code/m_sign)")
    return _run(lns_matmul_dw_update, x_code, x_sign, dy_code, dy_sign,
                a_contract_axis=0, b_contract_axis=0, fmt=fmt, spec=spec,
                update_epilogue=epilogue, w_code=w_code, w_sign=w_sign,
                m_code=m_code, m_sign=m_sign, block_rows=block_rows)


for _wrapper in (lns_matmul, lns_matmul_fused, lns_matmul_dx, lns_matmul_dw,
                 lns_matmul_dw_partials, lns_matmul_dw_update):
    _wrapper.launches = 0

"""The sequential ⊞-MAC kernel and its flush-time epilogues, lane by device.

One CUDA kernel (``csrc/lns_mac.cu: mac_kernel``) serves three launch
configurations, told apart by which axis of each operand is contracted:

* ``lns_matmul_fused``     Z[m,n]  = ⊞_k X[m,k] ⊡ W[k,n], with bias ⊞ /
  llReLU / requantize at flush (:class:`FwdEpilogue`);
* ``lns_matmul_dx``        dX[m,k] = ⊞_n dY[m,n] ⊡ W[k,n]  (= dY ⊞ Wᵀ);
* ``lns_matmul_dw_update`` dW[k,n] = ⊞_m X[m,k] ⊡ dY[m,n], consumed at
  flush by the ⊞-SGD update (:class:`~repro_torch.core.sgd.UpdateEpilogue`):
  the outputs are the updated weights (and momentum).

Each wrapper launches the kernel for CUDA tensors (and counts the launch
in its ``launches`` attribute) and runs :func:`mac_plain`, the plain
PyTorch version of the same arithmetic, for CPU tensors.  There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

The helpers below mirror the Pallas kernel's (``src/repro/kernels/
lns_matmul/lns_matmul.py``) op for op on int32 code / int8 sign planes;
the CUDA source mirrors the same functions.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ...core import f32
from ...core.delta import DeltaSpec, cached_engine
from ...core.formats import LNSFormat
from ...core.sgd import UpdateEpilogue
from .. import build

_DELTA_KIND = {"lut": 0, "bitshift": 1, "exact": 2}
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

def _delta_fn(spec: DeltaSpec, fmt: LNSFormat, device):
    """Δ±(d, same) on int32 d-codes: ``_delta_from_tables`` /
    ``_delta_bitshift`` / ``_delta_exact`` of the Pallas source."""
    eng = cached_engine(spec, fmt)
    uf = eng.underflow
    if spec.kind == "bitshift":
        def fn(d, same):
            d_int = torch.clamp(d >> fmt.qf, max=30)
            dp = torch.full_like(d_int, 1 << fmt.qf) >> d_int
            dm = -(torch.full_like(d_int, 3 << fmt.qf) >> (d_int + 1))
            return torch.where(same, dp, dm.masked_fill_(d == 0, uf))
    elif spec.kind == "exact":
        def fn(d, same):
            dp_f = d.to(torch.float32) / fmt.scale
            dp = torch.round(f32.log2(1.0 + f32.exp2(-dp_f)) * fmt.scale)
            dm_f = torch.clamp(d, min=1).to(torch.float32) / fmt.scale
            dm = torch.round(f32.log2(-f32.expm1(-dm_f * f32.LN2_F32))
                             * fmt.scale)
            dm = torch.where(d <= 0, uf, dm.to(torch.int32))
            return torch.where(same, dp.to(torch.int32), dm)
    else:
        tab_plus, tab_minus = eng.tables(device)
        n, r_code = spec.table_size, eng.r_code

        def fn(d, same):
            idx = (d + r_code // 2) // r_code
            idx_c = torch.clamp(idx, 0, n - 1)
            oob = idx >= n
            dp = tab_plus[idx_c].masked_fill_(oob, 0)
            dm = tab_minus[idx_c].masked_fill_(oob, 0)
            return torch.where(same, dp, dm.masked_fill_(d == 0, uf))
    return fn


def _boxplus_codes(ac, asn, bc, bsn, delta_fn, fmt: LNSFormat):
    """⊞ on raw (code, sign) planes — ``_boxplus_codes`` of the Pallas
    source."""
    zero = fmt.zero_code
    za = ac == zero
    zb = bc == zero
    d = torch.abs(ac - bc)
    same = asn == bsn
    code = torch.clamp(torch.maximum(ac, bc) + delta_fn(d, same),
                       max=fmt.code_max)
    code.masked_fill_(code < fmt.min_nonzero_code, zero)
    code.masked_fill_(~same & (d == 0), zero)
    sign = torch.where(same | (ac > bc), asn, bsn)
    code = torch.where(za, bc, torch.where(zb, ac, code))
    sign = torch.where(za, bsn, torch.where(zb, asn, sign))
    return code, sign.masked_fill_(code == zero, 0)


def _apply_fwd_epilogue(code, sign, ep: FwdEpilogue, bias_c, bias_s,
                        delta_fn, fmt: LNSFormat):
    """bias ⊞ → llReLU → requantize; returns ``(code, sign, z_sign)``."""
    zero = fmt.zero_code
    if ep.bias:
        code, sign = _boxplus_codes(code, sign, bias_c, bias_s, delta_fn, fmt)
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
                           ep: UpdateEpilogue, delta_fn, fmt: LNSFormat):
    """⊞-SGD: M ← (μ⊡M) ⊞ G; W ← W ⊟ (lr⊡M) ⊟ (lrλ⊡W).  Returns the
    updated ``(w_c, w_s, m_c, m_s)``."""
    if ep.momentum_code is not None:
        mm_c, mm_s = _scalar_boxdot_codes(ep.momentum_code, m_c, m_s, fmt)
        m_c, m_s = _boxplus_codes(mm_c, mm_s, g_c, g_s, delta_fn, fmt)
        g_c, g_s = m_c, m_s
    lg_c, lg_s = _scalar_boxdot_codes(ep.lr_code, g_c, g_s, fmt)
    w_c, w_s = _boxplus_codes(w_c, w_s, lg_c, lg_s ^ 1, delta_fn, fmt)
    if ep.weight_decay_code is not None:
        wd_c, wd_s = _scalar_boxdot_codes(ep.weight_decay_code, w_c, w_s,
                                          fmt)
        w_c, w_s = _boxplus_codes(w_c, w_s, wd_c, wd_s ^ 1, delta_fn, fmt)
    return w_c, w_s, m_c, m_s


def mac_plain(a_code, a_sign, b_code, b_sign, *, a_contract_axis: int,
              b_contract_axis: int, fmt: LNSFormat, spec: DeltaSpec,
              fwd_epilogue: Optional[FwdEpilogue] = None,
              bias_code=None, bias_sign=None,
              update_epilogue: Optional[UpdateEpilogue] = None,
              w_code=None, w_sign=None, m_code=None, m_sign=None):
    """Plain PyTorch version of ``mac_kernel`` on any device.

    ``a``'s non-contracted axis gives the output rows, ``b``'s the output
    columns.  One (R, C) accumulator takes the contraction's products in
    ascending order; the epilogue runs once, at flush.  Returns the output
    planes in kernel order: ``code, sign[, z_sign][, m_code, m_sign]``.
    """
    a_c = a_code if a_contract_axis == 1 else a_code.T   # (R, CT)
    a_s = a_sign if a_contract_axis == 1 else a_sign.T
    b_c = b_code if b_contract_axis == 0 else b_code.T   # (CT, C)
    b_s = b_sign if b_contract_axis == 0 else b_sign.T
    zero = fmt.zero_code
    delta = _delta_fn(spec, fmt, a_code.device)
    acc_c = torch.full((a_c.shape[0], b_c.shape[1]), zero, dtype=torch.int32,
                       device=a_code.device)
    acc_s = torch.zeros_like(acc_c, dtype=torch.int8)
    for i in range(a_c.shape[1]):
        ac, asn = a_c[:, i:i + 1], a_s[:, i:i + 1]
        bc, bsn = b_c[i:i + 1, :], b_s[i:i + 1, :]
        pz = (ac == zero) | (bc == zero)
        pc = torch.clamp(ac + bc, max=fmt.code_max)
        pc.masked_fill_((pc < fmt.min_nonzero_code) | pz, zero)
        ps = (asn ^ bsn).masked_fill_(pz, 0)
        acc_c, acc_s = _boxplus_codes(acc_c, acc_s, pc, ps, delta, fmt)
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

def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _checked(t, dtype, shape, what, device):
    """The operand as a contiguous tensor, after checking what the kernel
    cannot take."""
    if t is None:
        raise ValueError(f"{what} is required by this launch")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}; this launch runs on "
                         f"{device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def lns_args(fmt: LNSFormat, spec: DeltaSpec, device) -> build.LnsArgs:
    """The format / Δ block of a launch; LUTs must stay alive (they are
    held by the engine's per-device cache)."""
    eng = cached_engine(spec, fmt)
    tp = tm = None
    n_tab = 0
    if spec.kind == "lut":
        tp, tm = eng.tables(device)
        n_tab = spec.table_size
    return build.LnsArgs(
        qf=fmt.qf, code_max=fmt.code_max, min_nz=fmt.min_nonzero_code,
        zero_code=fmt.zero_code, delta_kind=_DELTA_KIND[spec.kind],
        n_tab=n_tab, r_code=eng.r_code, underflow=eng.underflow,
        tab_plus=_ptr(tp), tab_minus=_ptr(tm))


def sgd_args(ep: UpdateEpilogue) -> build.SgdArgs:
    return build.SgdArgs(
        lr_code=ep.lr_code, mom_on=int(ep.has_momentum),
        mom_code=ep.momentum_code or 0,
        wd_on=int(ep.weight_decay_code is not None),
        wd_code=ep.weight_decay_code or 0)


def mac_cuda(a_code, a_sign, b_code, b_sign, *, a_contract_axis: int,
             b_contract_axis: int, fmt: LNSFormat, spec: DeltaSpec,
             fwd_epilogue: Optional[FwdEpilogue] = None,
             bias_code=None, bias_sign=None,
             update_epilogue: Optional[UpdateEpilogue] = None,
             w_code=None, w_sign=None, m_code=None, m_sign=None):
    """Launch ``mac_kernel`` on the current stream; same arguments and
    outputs as :func:`mac_plain`."""
    lib = build.load_library()
    if spec.kind == "lut" and spec.table_size > lib.lns_max_table():
        raise ValueError(f"Δ table of {spec.table_size} entries exceeds the "
                         f"kernel's {lib.lns_max_table()}")
    dev = a_code.device
    r, ct = a_code.shape[1 - a_contract_axis], a_code.shape[a_contract_axis]
    c = b_code.shape[1 - b_contract_axis]
    if b_code.shape[b_contract_axis] != ct:
        raise ValueError(f"contraction lengths differ: {tuple(a_code.shape)}"
                         f" vs {tuple(b_code.shape)}")
    if r == 0 or c == 0:
        raise ValueError("empty output")
    a_code = _checked(a_code, torch.int32, a_code.shape, "a_code", dev)
    a_sign = _checked(a_sign, torch.int8, a_code.shape, "a_sign", dev)
    b_code = _checked(b_code, torch.int32, b_code.shape, "b_code", dev)
    b_sign = _checked(b_sign, torch.int8, b_code.shape, "b_sign", dev)
    a_rows = a_code.shape[1]  # row-major stride of axis 0
    b_rows = b_code.shape[1]
    p = build.MacParams(
        lns=lns_args(fmt, spec, dev),
        a_code=_ptr(a_code), a_sign=_ptr(a_sign),
        a_sr=a_rows if a_contract_axis == 1 else 1,
        a_st=1 if a_contract_axis == 1 else a_rows,
        b_code=_ptr(b_code), b_sign=_ptr(b_sign),
        b_st=b_rows if b_contract_axis == 0 else 1,
        b_sc=1 if b_contract_axis == 0 else b_rows,
        R=r, C=c, CT=ct, epilogue=_EPI_NONE)
    out_code = torch.empty((r, c), dtype=torch.int32, device=dev)
    out_sign = torch.empty((r, c), dtype=torch.int8, device=dev)
    outs = [out_code, out_sign]
    if fwd_epilogue is not None:
        ep = fwd_epilogue
        p.epilogue = _EPI_FWD
        if ep.bias:
            bias_code = _checked(bias_code, torch.int32, (c,), "bias_code",
                                 dev)
            bias_sign = _checked(bias_sign, torch.int8, (c,), "bias_sign",
                                 dev)
            p.bias_code, p.bias_sign = _ptr(bias_code), _ptr(bias_sign)
        if ep.llrelu_beta is not None:
            p.llrelu_on, p.beta = 1, ep.llrelu_beta
        if ep.dst_fmt is not None and ep.dst_fmt != fmt:
            d = ep.dst_fmt
            p.dst_on, p.dst_qf, p.dst_code_max = 1, d.qf, d.code_max
            p.dst_min_nz, p.dst_zero = d.min_nonzero_code, d.zero_code
        if ep.emit_z_sign:
            z_sign = torch.empty((r, c), dtype=torch.int8, device=dev)
            outs.append(z_sign)
            p.z_sign_out = _ptr(z_sign)
    elif update_epilogue is not None:
        ep = update_epilogue
        p.epilogue = _EPI_UPDATE
        p.sgd = sgd_args(ep)
        w_code = _checked(w_code, torch.int32, (r, c), "w_code", dev)
        w_sign = _checked(w_sign, torch.int8, (r, c), "w_sign", dev)
        p.w_code, p.w_sign = _ptr(w_code), _ptr(w_sign)
        if ep.has_momentum:
            m_code = _checked(m_code, torch.int32, (r, c), "m_code", dev)
            m_sign = _checked(m_sign, torch.int8, (r, c), "m_sign", dev)
            m_out_c = torch.empty((r, c), dtype=torch.int32, device=dev)
            m_out_s = torch.empty((r, c), dtype=torch.int8, device=dev)
            outs += [m_out_c, m_out_s]
            p.m_code, p.m_sign = _ptr(m_code), _ptr(m_sign)
            p.m_code_out, p.m_sign_out = _ptr(m_out_c), _ptr(m_out_s)
    p.out_code, p.out_sign = _ptr(out_code), _ptr(out_sign)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lns_mac_launch(ctypes.byref(p), ctypes.c_void_p(stream))
    build.check(lib, rc, "lns_mac_launch")
    return tuple(outs)


# ------------------------------------------------------------------------
# Wrappers: kernel on the card, plain version on the CPU
# ------------------------------------------------------------------------

def _lane(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no ⊞-MAC lane for device {t.device}")


def lns_matmul_fused(x_code, x_sign, w_code, w_sign, *, fmt: LNSFormat,
                     spec: DeltaSpec, epilogue: FwdEpilogue,
                     bias_code=None, bias_sign=None):
    """Forward x (M, K) ⊞-MAC w (K, N) with the flush epilogue.  Returns
    ``(z_code, z_sign)`` plus the post-bias ``z_sign`` plane when
    ``epilogue.emit_z_sign``; in ``epilogue.dst_fmt`` when set."""
    kw = dict(a_contract_axis=1, b_contract_axis=0, fmt=fmt, spec=spec,
              fwd_epilogue=epilogue, bias_code=bias_code, bias_sign=bias_sign)
    if _lane(x_code) == "cuda":
        lns_matmul_fused.launches += 1
        return mac_cuda(x_code, x_sign, w_code, w_sign, **kw)
    return mac_plain(x_code, x_sign, w_code, w_sign, **kw)


def lns_matmul_dx(dy_code, dy_sign, w_code, w_sign, *, fmt: LNSFormat,
                  spec: DeltaSpec):
    """dY (M, N) ⊞-MAC Wᵀ → dX (M, K), ascending over N; W is read in its
    stored (K, N) layout."""
    kw = dict(a_contract_axis=1, b_contract_axis=1, fmt=fmt, spec=spec)
    if _lane(dy_code) == "cuda":
        lns_matmul_dx.launches += 1
        return mac_cuda(dy_code, dy_sign, w_code, w_sign, **kw)
    return mac_plain(dy_code, dy_sign, w_code, w_sign, **kw)


def lns_matmul_dw_update(x_code, x_sign, dy_code, dy_sign, *, w_code,
                         w_sign, epilogue: UpdateEpilogue, fmt: LNSFormat,
                         spec: DeltaSpec, m_code=None, m_sign=None):
    """dW = Xᵀ ⊞-MAC dY (ascending over the batch M), consumed at flush
    by the ⊞-SGD against the resident (K, N) ``w`` (and ``m``).  Returns
    ``(w_code', w_sign')`` plus ``(m_code', m_sign')`` with momentum."""
    if epilogue.has_momentum and (m_code is None or m_sign is None):
        raise ValueError("UpdateEpilogue has momentum but no momentum "
                         "planes (m_code/m_sign)")
    kw = dict(a_contract_axis=0, b_contract_axis=0, fmt=fmt, spec=spec,
              update_epilogue=epilogue, w_code=w_code, w_sign=w_sign,
              m_code=m_code, m_sign=m_sign)
    if _lane(x_code) == "cuda":
        lns_matmul_dw_update.launches += 1
        return mac_cuda(x_code, x_sign, dy_code, dy_sign, **kw)
    return mac_plain(x_code, x_sign, dy_code, dy_sign, **kw)


lns_matmul_fused.launches = 0
lns_matmul_dx.launches = 0
lns_matmul_dw_update.launches = 0

"""What the kernel packages share: the lane rule, the launch-argument
helpers, the plain ⊞ on (code, sign) planes and the launch floor.

The plain helpers mirror the Pallas kernels' (``src/repro/kernels/
lns_matmul/lns_matmul.py``) op for op on int32 code / int8 sign planes;
``csrc/lns_mac.cu`` mirrors the same functions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..core import f32
from ..core.delta import DeltaSpec, cached_engine
from ..core.formats import LNSFormat
from . import build

DELTA_KIND = {"lut": 0, "bitshift": 1, "exact": 2}


def lane(t: torch.Tensor, kernel: str = "⊞-MAC") -> str:
    """``"cuda"`` for a CUDA tensor (launch the kernel), ``"cpu"`` for a
    CPU tensor (run the plain version); any other device raises."""
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no {kernel} lane for device {t.device}")


def delta_fn(spec: DeltaSpec, fmt: LNSFormat, device):
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


def boxplus_codes(ac, asn, bc, bsn, delta, fmt: LNSFormat):
    """⊞ on raw (code, sign) planes — ``_boxplus_codes`` of the Pallas
    source."""
    zero = fmt.zero_code
    za = ac == zero
    zb = bc == zero
    d = torch.abs(ac - bc)
    same = asn == bsn
    code = torch.clamp(torch.maximum(ac, bc) + delta(d, same),
                       max=fmt.code_max)
    code.masked_fill_(code < fmt.min_nonzero_code, zero)
    code.masked_fill_(~same & (d == 0), zero)
    sign = torch.where(same | (ac > bc), asn, bsn)
    code = torch.where(za, bc, torch.where(zb, ac, code))
    sign = torch.where(za, bsn, torch.where(zb, asn, sign))
    return code, sign.masked_fill_(code == zero, 0)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def checked(t, dtype, shape, what, device):
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


@functools.lru_cache(maxsize=None)
def lut_index_args(r_code: int, n_tab: int) -> tuple:
    """``(half, lim, mul, shift)``: how the kernels form the LUT index
    ``(d + r_code // 2) // r_code`` of a difference ``d >= 0`` without a
    divide.  ``x = min(d + half, lim)``, then ``x >> shift`` where
    ``r_code`` is a power of two (``mul = 0``), else the multiply-high
    ``(x * mul) >> (32 + shift)`` with ``mul = ceil(2^(32+shift) /
    r_code)`` and ``shift = floor(log2 r_code)`` (Granlund–Montgomery).
    ``lim = n_tab * r_code`` sends every ``d`` past the table to index
    ``n_tab``.  The multiplier is checked against the divide for every
    ``x`` the kernels can form."""
    half, lim = r_code // 2, n_tab * r_code
    if lim >= 1 << 30:
        raise ValueError(f"Δ table of {n_tab} entries of step {r_code} "
                         f"spans {lim} codes; the kernels take < 2^30")
    shift = r_code.bit_length() - 1
    if r_code == 1 << shift:
        return half, lim, 0, shift
    mul = -(-(1 << (32 + shift)) // r_code)
    x = np.arange(lim + 1, dtype=np.uint64)
    if not np.array_equal((x * np.uint64(mul)) >> np.uint64(32 + shift),
                          x // np.uint64(r_code)):
        raise AssertionError(f"no exact multiply-high for step {r_code}")
    return half, lim, mul, shift


@functools.lru_cache(maxsize=None)
def lut_pairs(spec: DeltaSpec, fmt: LNSFormat, device) -> torch.Tensor:
    """The kernels' Δ table on ``device``: (n_tab + 1, 2) int32 rows
    (Δ+, Δ−), the last row (0, 0), the Δ past the table."""
    tp, tm = cached_engine(spec, fmt).tables(device)
    pairs = torch.stack([tp, tm], 1)
    return torch.cat([pairs, pairs.new_zeros((1, 2))]).contiguous()


def lns_args(fmt: LNSFormat, spec: DeltaSpec, device) -> build.LnsArgs:
    """The format / Δ block of a launch; the table stays alive in
    :func:`lut_pairs`' cache."""
    eng = cached_engine(spec, fmt)
    args = build.LnsArgs(
        qf=fmt.qf, code_max=fmt.code_max, min_nz=fmt.min_nonzero_code,
        zero_code=fmt.zero_code, delta_kind=DELTA_KIND[spec.kind],
        underflow=eng.underflow)
    if spec.kind == "lut":
        n_max = build.load_library().lns_max_table()
        if not 1 <= spec.table_size <= n_max:
            raise ValueError(f"Δ table of {spec.table_size} entries; the "
                             f"kernels take 1 to {n_max}")
        args.n_tab = spec.table_size
        (args.idx_half, args.idx_lim, args.idx_mul,
         args.idx_shift) = lut_index_args(eng.r_code, spec.table_size)
        args.tab = ptr(lut_pairs(spec, fmt, torch.device(device)))
    return args


def launch_empty(device) -> None:
    """Enqueue the library's empty kernel (one warp that does nothing) on
    ``device``'s current stream: the launch floor that the kernels' times
    are read against."""
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lns_empty_launch(ctypes.c_void_p(stream))
    build.check(lib, rc, "lns_empty_launch")

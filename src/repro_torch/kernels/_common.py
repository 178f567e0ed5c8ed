"""What the kernel packages share: the lane rule, the launch-argument
helpers and the plain ⊞ on (code, sign) planes.

The plain helpers mirror the Pallas kernels' (``src/repro/kernels/
lns_matmul/lns_matmul.py``) op for op on int32 code / int8 sign planes;
``csrc/lns_mac.cu`` mirrors the same functions.
"""
from __future__ import annotations

from typing import Optional

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
        zero_code=fmt.zero_code, delta_kind=DELTA_KIND[spec.kind],
        n_tab=n_tab, r_code=eng.r_code, underflow=eng.underflow,
        tab_plus=ptr(tp), tab_minus=ptr(tm))

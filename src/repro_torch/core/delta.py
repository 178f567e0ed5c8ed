"""Δ± correction terms for log-domain addition (paper Sec. 3).

Exact:      Δ+(d) = log2(1 + 2^-d)   (d >= 0)
            Δ-(d) = log2(1 - 2^-d)   (d > 0;  Δ-(0) = -inf → exact cancel)

* ``lut``      — uniform table over [0, d_max] with resolution ``r``;
                 nearest-sample lookup; Δ := 0 beyond d_max.
* ``bitshift`` — eq. (9): Δ+(d) ≈ 2^-⌊d⌋, Δ-(d) ≈ -1.5 · 2^-⌊d⌋.
* ``exact``    — float32 evaluation (``core.f32``), rounded to the code
                 grid (oracle).

All engines map integer difference codes ``d_code = |X-Y|·2^qf`` to integer
Δ codes on the same grid.  ``minus`` at d=0 returns the ``underflow``
sentinel so a saturating add flushes the result to the zero code.
"""
from __future__ import annotations

import copy
import dataclasses
import functools

import numpy as np
import torch

from . import f32
from .formats import LNSFormat


def delta_plus_float(d):
    """Exact Δ+ on floats (numpy float64; for Fig. 1 and oracles)."""
    return np.log2(1.0 + np.exp2(-np.asarray(d, np.float64)))


def delta_minus_float(d):
    """Exact Δ- on floats (numpy float64); d must be > 0."""
    return np.log2(-np.expm1(-np.asarray(d, np.float64) * np.log(2.0)))


@dataclasses.dataclass(frozen=True)
class DeltaSpec:
    """Configuration of the Δ approximation.

    ``d_max``/``r`` only parameterize the ``lut`` kind; for ``exact`` and
    ``bitshift`` they are normalized back to the defaults so that equal
    behaviour means equal (and equal-hash) specs.
    """

    kind: str = "lut"  # 'exact' | 'lut' | 'bitshift'
    d_max: float = 10.0
    r: float = 0.5

    def __post_init__(self):
        if self.kind != "lut":
            object.__setattr__(self, "d_max", 10.0)
            object.__setattr__(self, "r", 0.5)

    @property
    def table_size(self) -> int:
        return int(round(self.d_max / self.r))


DELTA_DEFAULT = DeltaSpec(kind="lut", d_max=10.0, r=0.5)
DELTA_SOFTMAX = DeltaSpec(kind="lut", d_max=10.0, r=1.0 / 64.0)
DELTA_BITSHIFT = DeltaSpec(kind="bitshift")
DELTA_EXACT = DeltaSpec(kind="exact")


class DeltaEngine:
    """Evaluates Δ± on integer d-code tensors for a given LNS format.

    The LUTs are built on the host in numpy float64 (byte-equal to the JAX
    package's tables); :meth:`tables` hands out int32 copies per device.
    """

    def __init__(self, spec: DeltaSpec, fmt: LNSFormat):
        self.spec = spec
        self.fmt = fmt
        # More negative than (code_max - code_min): flushes through a
        # saturating add.
        self.underflow = -(1 << (fmt.qi + fmt.qf + 2))
        self.r_code = 1
        self._tab_plus = self._tab_minus = np.zeros(0, np.int32)
        if spec.kind == "lut":
            r_code = spec.r * fmt.scale
            if abs(r_code - round(r_code)) > 1e-9 or round(r_code) < 1:
                raise ValueError(
                    f"LUT resolution r={spec.r} is not representable on the "
                    f"qf={fmt.qf} grid (r*2^qf must be a positive integer)")
            self.r_code = int(round(r_code))
            n = spec.table_size
            d = np.arange(n, dtype=np.float64) * spec.r
            plus = np.round(delta_plus_float(d) * fmt.scale
                            ).astype(np.int32)
            minus = np.zeros(n, np.int32)
            minus[0] = self.underflow
            if n > 1:
                minus[1:] = np.round(
                    np.log2(-np.expm1(-d[1:] * np.log(2.0))) * fmt.scale
                ).astype(np.int32)
            self._tab_plus = plus
            self._tab_minus = minus
        self._device_tables: dict = {}

    def with_tables(self, tab_plus: np.ndarray,
                    tab_minus: np.ndarray) -> "DeltaEngine":
        """A copy of this engine with other (host int32) Δ+ / Δ- tables
        and a device-table cache of its own: a shallow copy would share
        :meth:`tables`' cache, serving the old tables on a device they are
        already on and writing the new ones into the shared engine's
        cache (engines from :func:`cached_engine` are shared by every
        model)."""
        new = copy.copy(self)
        new._tab_plus = np.asarray(tab_plus, np.int32)
        new._tab_minus = np.asarray(tab_minus, np.int32)
        new._device_tables = {}
        return new

    def tables(self, device) -> tuple:
        """(Δ+ table, Δ- table) as int32 tensors on ``device``."""
        device = torch.device(device)
        if device not in self._device_tables:
            self._device_tables[device] = (
                torch.as_tensor(self._tab_plus, device=device),
                torch.as_tensor(self._tab_minus, device=device))
        return self._device_tables[device]

    def plus(self, d_code: torch.Tensor) -> torch.Tensor:
        fmt = self.fmt
        if self.spec.kind == "exact":
            d = d_code.to(torch.float32) / fmt.scale
            val = f32.log2(1.0 + f32.exp2(-d))
            return torch.round(val * fmt.scale).to(torch.int32)
        if self.spec.kind == "bitshift":
            d_int = torch.clamp(d_code >> fmt.qf, max=31)
            return torch.full_like(d_int, 1 << fmt.qf) >> d_int
        n = self.spec.table_size
        idx = (d_code + self.r_code // 2) // self.r_code
        val = self.tables(d_code.device)[0][torch.clamp(idx, 0, n - 1)]
        return torch.where(idx >= n, 0, val)

    def minus(self, d_code: torch.Tensor) -> torch.Tensor:
        """Δ- on d_code; the caller special-cases d_code == 0 (exact
        cancel), but index 0 still returns the flush sentinel."""
        fmt = self.fmt
        if self.spec.kind == "exact":
            d = torch.clamp(d_code, min=1).to(torch.float32) / fmt.scale
            val = f32.log2(-f32.expm1(-d * f32.LN2_F32))
            code = torch.round(val * fmt.scale).to(torch.int32)
            return torch.where(d_code <= 0, self.underflow, code)
        if self.spec.kind == "bitshift":
            d_int = torch.clamp(d_code >> fmt.qf, max=30)
            mag = torch.full_like(d_int, 3 << fmt.qf) >> (d_int + 1)
            return torch.where(d_code == 0, self.underflow, -mag)
        n = self.spec.table_size
        idx = (d_code + self.r_code // 2) // self.r_code
        val = self.tables(d_code.device)[1][torch.clamp(idx, 0, n - 1)]
        val = torch.where(idx >= n, 0, val)
        return torch.where(d_code == 0, self.underflow, val)

    # -- the approximation on floats (Fig. 1), host numpy float64 ---------
    def _lut_float(self, d, tab) -> np.ndarray:
        idx = (np.round(d * self.fmt.scale).astype(np.int64)
               + self.r_code // 2) // self.r_code
        n = self.spec.table_size
        return np.where(idx >= n, 0.0,
                        tab[np.clip(idx, 0, n - 1)] / self.fmt.scale)

    def plus_float(self, d) -> np.ndarray:
        """Δ+ of this engine at real differences ``d`` (the code grid's
        table entry, or the bit-shift or exact value)."""
        d = np.asarray(d, np.float64)
        if self.spec.kind == "exact":
            return delta_plus_float(d)
        if self.spec.kind == "bitshift":
            return np.exp2(-np.floor(d))
        return self._lut_float(d, self._tab_plus)

    def minus_float(self, d) -> np.ndarray:
        d = np.asarray(d, np.float64)
        if self.spec.kind == "exact":
            return delta_minus_float(d)
        if self.spec.kind == "bitshift":
            return -1.5 * np.exp2(-np.floor(d))
        return self._lut_float(d, self._tab_minus.astype(np.float64))


@functools.lru_cache(maxsize=None)
def cached_engine(spec: DeltaSpec, fmt: LNSFormat) -> DeltaEngine:
    """One shared engine per (Δ spec, format) pair.  The key must hold the
    format: the same Δ spec gives other integer tables under lns16 and
    lns12."""
    return DeltaEngine(spec, fmt)

"""LNS tensor type, float <-> LNS codecs, and the ⊞-MAC dispatcher.

An :class:`LNSArray` carries two tensors of identical shape:

* ``code``: int32, fixed-point encoding of ``X = log2|v|`` (``qf`` fraction
  bits), with ``fmt.zero_code`` as the reserved exact-zero sentinel;
* ``sign``: int8, **1 = negative**, 0 = positive.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..obs import metrics as _obs
from . import f32
from .delta import cached_engine
from .formats import LNSFormat


@dataclasses.dataclass
class LNSArray:
    code: torch.Tensor  # int32
    sign: torch.Tensor  # int8, 1 = negative

    @property
    def shape(self):
        return self.code.shape

    @property
    def ndim(self):
        return self.code.ndim

    @property
    def device(self) -> torch.device:
        return self.code.device

    def __getitem__(self, idx):
        return LNSArray(self.code[idx], self.sign[idx])

    @property
    def T(self):
        return LNSArray(self.code.T, self.sign.T)

    def to(self, device) -> "LNSArray":
        return LNSArray(self.code.to(device), self.sign.to(device))


def encode(v: torch.Tensor, fmt: LNSFormat) -> LNSArray:
    """Quantize a float tensor into LNS fixed point (paper eq. 1).

    Zeros (and magnitudes underflowing the format) map to ``zero_code``;
    magnitudes overflowing saturate to ``code_max``.
    """
    v = torch.as_tensor(v).to(torch.float32)
    mag = torch.abs(v)
    nonzero = mag > 0
    x = f32.log2(torch.where(nonzero, mag, 1.0))
    raw = torch.round(x * fmt.scale)
    code = raw.to(torch.int32)
    if _obs.scope_active():
        # Quantization health before the clip (pure reads).
        _obs.observe_quantize(code, nonzero, fmt)
    code = torch.clamp(code, fmt.min_nonzero_code, fmt.code_max)
    # Zeros and true underflow (rounded below the representable range).
    zero = ~nonzero | (raw < fmt.min_nonzero_code)
    code = torch.where(zero, fmt.zero_code, code)
    return LNSArray(code, (v < 0).to(torch.int8))


def decode(a: LNSArray, fmt: LNSFormat) -> torch.Tensor:
    """Map LNS codes back to float32: v = ±2^(code / 2^qf)."""
    mag = f32.exp2(a.code.to(torch.float32) / fmt.scale)
    mag = torch.where(a.code == fmt.zero_code, 0.0, mag)
    return torch.where(a.sign == 1, -mag, mag)


def zeros(shape, fmt: LNSFormat, device="cpu") -> LNSArray:
    return LNSArray(
        torch.full(shape, fmt.zero_code, dtype=torch.int32, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device))


def from_parts(code, sign, device=None) -> LNSArray:
    """An :class:`LNSArray` of the given code and sign planes, as int32
    and int8 (on ``device``, else where ``code`` and ``sign`` are)."""
    return LNSArray(torch.as_tensor(code, dtype=torch.int32, device=device),
                    torch.as_tensor(sign, dtype=torch.int8, device=device))


def scalar(v: float, fmt: LNSFormat, device="cpu") -> LNSArray:
    """Host-side scalar constant in LNS (e.g. learning rate, log2(e))."""
    if v == 0:
        code, sign = fmt.zero_code, 0
    else:
        code = fmt.to_code(float(np.log2(abs(v))))
        sign = 1 if v < 0 else 0
    return LNSArray(torch.tensor(code, dtype=torch.int32, device=device),
                    torch.tensor(sign, dtype=torch.int8, device=device))


def convert_format(a: LNSArray, src: LNSFormat, dst: LNSFormat) -> LNSArray:
    """Re-encode LNS codes between formats by integer shifts.

    A left shift when widening (exact), an add-half + arithmetic right
    shift (round-half-up) when narrowing.  Zero sentinels are preserved,
    out-of-range magnitudes saturate, and magnitudes below the
    destination's resolution flush to zero.
    """
    if src == dst:
        return a
    shift = dst.qf - src.qf
    if shift >= 0:
        code = a.code << shift
    else:
        code = (a.code + (1 << (-shift - 1))) >> (-shift)
    if _obs.scope_active():
        # Crossing health against the destination grid, before the clip.
        _obs.observe_convert(a.code != src.zero_code, code, dst)
    zero = (a.code == src.zero_code) | (code < dst.min_nonzero_code)
    code = torch.clamp(code, dst.min_nonzero_code, dst.code_max)
    return LNSArray(torch.where(zero, dst.zero_code, code),
                    torch.where(zero, 0, a.sign).to(torch.int8))


def quantization_bound(fmt: LNSFormat) -> float:
    """The largest relative error of encode/decode for in-range values:
    |v̂ - v| / |v| <= 2^(2^-(qf+1)) - 1 (half an ulp of the log code)."""
    return float(2.0 ** (0.5 / fmt.scale) - 1.0)


# ------------------------------------------------------------------------
# ⊞-MAC dispatcher
# ------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LNSMatmulBackend:
    """The ⊞-MAC products of the training steps, lane by device.

    The lane is chosen by where the operands lie, never by configuration:
    CUDA tensors go to the hand-written kernels (``kernels/lns_matmul``),
    which launch or raise; CPU tensors run the kernels' plain PyTorch
    versions.  The two lanes are bit-exact to each other.

    * ``matmul(x, w)``              Z  = X ⊞-MAC W
    * ``affine(x, w, b)``           Z  = X ⊞-MAC W, then ⊞ b
    * ``matmul_fused(x, w)``        Z  = X ⊞-MAC W with the flush epilogue
    * ``matmul_dx(dy, w)``          dX = dY ⊞-MAC Wᵀ
    * ``matmul_dw(x, dy)``          dW = Xᵀ ⊞-MAC dY
    * ``matmul_dw_partials(x, dy, S)``  (S, K, N) per-segment dW
    * ``matmul_dw_update(x, dy, ...)``  ⊞-SGD of W by Xᵀ ⊞-MAC dY
    * ``fused_update(w, g, ...)``   elementwise ⊞-SGD

    Under an ambient telemetry scope (``obs.metrics``) the epilogued
    products tap their outputs' code health (``epi_fwd``,
    ``epi_dw_update``, ``epi_update``): reads of a kernel's output after
    its launch, the same labels on both lanes.

    ``blocks`` is the spec's tiling axis, which sets the one launch
    parameter the kernels read: the tiled ⊞-MAC's output rows per block
    (:meth:`_op_blocks`).  ``"default"`` keeps 4; ``"auto"`` asks the
    autotuner (``kernels/autotune.py``) per op and shape; an explicit
    ``"MxNxK"`` takes the largest of 1, 2, 4, 8 rows that is at most M.
    ``block_m`` / ``block_n`` / ``block_k`` are the JAX package's Pallas
    tiles, kept so that its calls carry across; they route nothing.  No
    choice changes a result: every output is one thread walking its
    contraction in ascending order.
    """

    fmt: LNSFormat
    spec: Any  # DeltaSpec
    block_m: int = 128
    block_n: int = 128
    block_k: int = 128
    blocks: str = "default"   # "default", "auto" or "<M>x<N>x<K>"

    def __post_init__(self):
        if self.blocks not in ("default", "auto"):
            from .spec import parse_blocks  # spec.py imports this module
            parse_blocks(self.blocks)

    def _op_blocks(self, op: str, r: int, c: int, ct: int,
                   device="cuda"):
        """The launch geometry ``(rows, cols, steps)`` of one ⊞-MAC
        launch of ``op`` at ``(R, C, CT)`` on ``device``'s lane
        (``autotune.OPS``' shape convention).

        ``blocks="auto"`` looks it up in the autotuner (measured entries
        on the card, the default geometry on the CPU lane, whose plain
        version reads no launch parameter); otherwise the rows per block
        are 4 (``"default"``) or the explicit M's.  Where the short form
        runs, every mode gives its one fixed geometry.
        """
        from ..kernels import autotune
        shape = (r, c, ct)
        if self.blocks == "auto":
            return autotune.lookup(
                op, shape, fmt=self.fmt, spec=self.spec,
                interpret=torch.device(device).type != "cuda")
        if self.blocks == "default":
            rows = autotune.DEFAULT_ROWS
        else:
            from .spec import parse_blocks
            rows = autotune.rows_for(parse_blocks(self.blocks)[0])
        return autotune.geometry(op, shape, rows)

    def _rows(self, op: str, a: LNSArray, r: int, c: int, ct: int) -> int:
        """``block_rows`` of the launch of ``op`` at ``(R, C, CT)`` whose
        first operand is ``a``: :meth:`_op_blocks`' rows where the tiled
        form runs, else the default, which the short form does not
        read."""
        from ..kernels import autotune
        if not autotune.tiled(op, (r, c, ct)):
            return autotune.DEFAULT_ROWS
        return self._op_blocks(op, r, c, ct, a.device)[0]

    def matmul(self, x: LNSArray, w: LNSArray) -> LNSArray:
        """Forward (M, K) ⊞-MAC (K, N) → (M, N), sequential over K."""
        from ..kernels.lns_matmul import lns_matmul_kernel
        rows = self._rows("fwd", x, x.shape[0], w.shape[1], x.shape[1])
        return lns_matmul_kernel(x, w, fmt=self.fmt, spec=self.spec,
                                 block_rows=rows)

    def affine(self, x: LNSArray, w: LNSArray, b: LNSArray) -> LNSArray:
        """z = x·W ⊞ b: the forward product, then the bias in its own
        pass."""
        from .arithmetic import bias_add
        return bias_add(self.matmul(x, w), b,
                        cached_engine(self.spec, self.fmt))

    def matmul_dw(self, x: LNSArray, dy: LNSArray) -> LNSArray:
        """Backward dW = Xᵀ (K, M) ⊞-MAC dY (M, N), sequential over M."""
        from ..kernels.lns_matmul import lns_matmul_dw_kernel
        rows = self._rows("dw", x, x.shape[1], dy.shape[1], x.shape[0])
        return lns_matmul_dw_kernel(x, dy, fmt=self.fmt, spec=self.spec,
                                    block_rows=rows)

    def matmul_dw_partials(self, x: LNSArray, dy: LNSArray,
                           num_segments: int) -> LNSArray:
        """Segmented dW: (S, K, N) partials, slot s the sequential ⊞-MAC
        over segment s of ``num_segments`` equal contiguous segments of
        the batch.  ⊞-combining the slots in order on a fixed schedule
        gives the same codes whichever rank computed which slot."""
        from ..kernels.lns_matmul import lns_matmul_dw_partials_kernel
        rows = self._rows("dw_partials", x, x.shape[1], dy.shape[1],
                          x.shape[0] // max(num_segments, 1))
        return lns_matmul_dw_partials_kernel(
            x, dy, num_segments=num_segments, fmt=self.fmt, spec=self.spec,
            block_rows=rows)

    def matmul_fused(self, x: LNSArray, w: LNSArray, *,
                     bias: "LNSArray | None" = None,
                     llrelu_beta: "int | None" = None,
                     out_fmt: "LNSFormat | None" = None,
                     emit_z_sign: bool = False):
        """Forward ⊞-MAC with the flush-time epilogue, one pass.

        Applied in order at accumulator flush: bias ⊞, log-leaky-ReLU
        (``llrelu_beta``) and a requantize onto ``out_fmt``'s grid.
        Returns the epilogued product, or ``(z, z_sign)`` with the
        post-bias pre-activation sign plane when ``emit_z_sign``.
        """
        from ..kernels.lns_matmul import FwdEpilogue, lns_matmul_fused_kernel
        if out_fmt is not None and out_fmt == self.fmt:
            out_fmt = None
        ep = FwdEpilogue(bias=bias is not None, llrelu_beta=llrelu_beta,
                         dst_fmt=out_fmt, emit_z_sign=emit_z_sign)
        rows = self._rows("fwd", x, x.shape[0], w.shape[1], x.shape[1])
        # The product taps nothing inside: only the epi_fwd tap below.
        with _obs.suspended():
            out = lns_matmul_fused_kernel(x, w, epilogue=ep, bias=bias,
                                          fmt=self.fmt, spec=self.spec,
                                          block_rows=rows)
        if _obs.scope_active():
            _obs.observe_codes(out[0] if emit_z_sign else out,
                               out_fmt if out_fmt is not None else self.fmt,
                               op="epi_fwd")
        return out

    def matmul_dx(self, dy: LNSArray, w: LNSArray) -> LNSArray:
        """Backward dX = dY (M, N) ⊞-MAC Wᵀ (N, K), sequential over N."""
        from ..kernels.lns_matmul import lns_matmul_dx_kernel
        rows = self._rows("dx", dy, dy.shape[0], w.shape[0], dy.shape[1])
        return lns_matmul_dx_kernel(dy, w, fmt=self.fmt, spec=self.spec,
                                    block_rows=rows)

    def matmul_dw_update(self, x: LNSArray, dy: LNSArray, w: LNSArray,
                         m: "LNSArray | None", epilogue):
        """Backward-weight ⊞-MAC with the ⊞-SGD update fused at flush.
        Returns ``(w_new, m_new)`` (``m_new is None`` without momentum)."""
        from ..kernels.lns_matmul import lns_matmul_dw_update_kernel
        rows = self._rows("dw", x, x.shape[1], dy.shape[1], x.shape[0])
        out = lns_matmul_dw_update_kernel(x, dy, w=w, m=m, epilogue=epilogue,
                                          fmt=self.fmt, spec=self.spec,
                                          block_rows=rows)
        if _obs.scope_active():
            _obs.observe_codes(out[0], self.fmt, op="epi_dw_update")
        return out

    def fused_update(self, w: LNSArray, g: LNSArray, m: "LNSArray | None",
                     epilogue):
        """One-pass elementwise ⊞-SGD update: ``(w, m, g) → (w', m')``."""
        from ..kernels.lns_matmul import lns_fused_update_kernel
        out = lns_fused_update_kernel(w, g, m=m, epilogue=epilogue,
                                      fmt=self.fmt, spec=self.spec)
        if _obs.scope_active():
            _obs.observe_codes(out[0], self.fmt, op="epi_update")
        return out

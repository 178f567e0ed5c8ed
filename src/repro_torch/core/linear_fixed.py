"""Linear-domain fixed-point arithmetic: the paper's Table 1 baseline.

Two's-complement codes with ``bf`` fraction bits carried as int32 with
explicit width saturation.  Multiplies rescale back to the ``bf`` grid
(round to nearest, ties away from zero) *before* accumulation, emulating a
MAC whose products are rounded to the bus width: raw int products summed
over K = 784 would overflow a 32-bit accumulator.  Every plane stays int32,
as in the JAX package, so codes and dtypes match it.
"""
from __future__ import annotations

import torch

from .formats import FixedPointFormat


def fxp_encode(v, fmt: FixedPointFormat) -> torch.Tensor:
    """round(v · 2^bf) (half to even), saturated to the format."""
    c = torch.round(torch.as_tensor(v, dtype=torch.float32) * fmt.scale)
    return torch.clamp(c, fmt.code_min, fmt.code_max).to(torch.int32)


def fxp_decode(c: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    return c.to(torch.float32) / fmt.scale


def fxp_sat(c: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    return torch.clamp(c, fmt.code_min, fmt.code_max)


def fxp_add(a, b, fmt: FixedPointFormat) -> torch.Tensor:
    return fxp_sat(a + b, fmt)


def _rescale(prod: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """Shift a raw product (2·bf fraction bits) back to bf bits, rounding to
    nearest with ties away from zero: the right shift acts on |prod|."""
    r = (torch.abs(prod) + (1 << (fmt.bf - 1))) >> fmt.bf
    return torch.where(prod < 0, -r, r)


def fxp_mul(a, b, fmt: FixedPointFormat) -> torch.Tensor:
    # |a|, |b| <= 2^15 for the formats used here: the product fits int32.
    return fxp_sat(_rescale(a * b, fmt), fmt)


def fxp_matmul(x: torch.Tensor, w: torch.Tensor,
               fmt: FixedPointFormat) -> torch.Tensor:
    """(..., M, K) by (K, N): the broadcast (..., M, K, N) product, each
    product rescaled, then an int32 sum over K, saturated.  Not a matrix
    product: CUDA has no int32 one, and float would round.  Rescaled
    products are <= code_max, so the int32 sum holds up to 2^16 terms."""
    prod = x[..., :, :, None] * w
    return fxp_sat(torch.sum(_rescale(prod, fmt), dim=-2, dtype=torch.int32),
                   fmt)


def fxp_affine(x, w, b, fmt: FixedPointFormat) -> torch.Tensor:
    return fxp_sat(fxp_matmul(x, w, fmt) + b, fmt)


def fxp_leaky_relu(z, alpha_code, fmt: FixedPointFormat) -> torch.Tensor:
    """leaky-ReLU with the leak slope given as a fixed-point code."""
    return torch.where(z > 0, z, fxp_sat(_rescale(z * alpha_code, fmt), fmt))


def fxp_leaky_relu_grad(z, alpha_code, fmt: FixedPointFormat
                        ) -> torch.Tensor:
    return torch.where(z > 0, fmt.scale, alpha_code).to(torch.int32)

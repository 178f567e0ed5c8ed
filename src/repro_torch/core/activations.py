"""Log-domain activation functions (paper eq. 11)."""
from __future__ import annotations

import math

import torch

from .formats import LNSFormat
from .lns import LNSArray


def beta_code(alpha: float, fmt: LNSFormat) -> int:
    """β = log2(α) as an integer code for the llReLU leak slope α."""
    return fmt.to_code(math.log2(alpha))


def llrelu(a: LNSArray, beta: int, fmt: LNSFormat) -> LNSArray:
    """log-leaky-ReLU: identity on positives; code += β on negatives, with
    underflow flushed to zero (β < 0 encodes a leak slope α = 2^β)."""
    shifted = a.code + beta
    shifted = torch.where(shifted < fmt.min_nonzero_code, fmt.zero_code,
                          shifted)
    code = torch.where(a.sign == 1, shifted, a.code)
    code = torch.where(a.code == fmt.zero_code, fmt.zero_code, code)
    return LNSArray(code, a.sign)


def llrelu_grad(a: LNSArray, beta: int, fmt: LNSFormat) -> LNSArray:
    """d llReLU/dz in the log domain: 1 for positives, α = 2^β for
    negatives (:func:`llrelu_grad_from_sign` of ``a``'s sign plane)."""
    return llrelu_grad_from_sign(a.sign, beta)


def llrelu_grad_from_sign(sign: torch.Tensor, beta: int) -> LNSArray:
    """d llReLU/dz from the pre-activation sign plane alone: code 0
    (= log2 1) for positives, β for negatives; always positive."""
    code = torch.where(sign == 1, beta, 0).to(torch.int32)
    return LNSArray(code, torch.zeros_like(sign, dtype=torch.int8))

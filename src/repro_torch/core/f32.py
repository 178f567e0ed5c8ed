"""float32 log2 / exp2 / expm1 as ``jax.numpy`` evaluates them, and a
float32 softmax that depends on its input alone.

``jnp.log2(x)`` lowers to ``log(x) / log(2)`` and ``jnp.exp2(x)`` to
``exp(log(2) · x)``, each step rounded to float32.  These helpers keep
that structure and take each elementary function (log, exp, expm1) in
float64, rounded once to float32, so a result depends on its input alone:
torch's own float32 ``exp2`` rounds differently in its vectorized and
scalar loops, which would tie a code to its position in the tensor and
to the thread count, and the card's float32 functions round differently
again.  Against XLA on a CPU this agrees on every code the train step
converts (tests/test_torch_core.py).
"""
from __future__ import annotations

import numpy as np
import torch

#: float32 ln 2, the constant jnp's lowering multiplies and divides by.
LN2_F32 = float(np.float32(np.log(2.0)))


def log2(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float() / LN2_F32


def exp2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp((LN2_F32 * x).double()).float()


def expm1(x: torch.Tensor) -> torch.Tensor:
    return torch.expm1(x.double()).float()


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in float64, rounded once to float32: the
    same on every device (XLA's float32 one can differ from it by an ulp,
    which moves a code only where a value lies at a half-code boundary)."""
    return torch.softmax(x.double(), dim=-1).float()

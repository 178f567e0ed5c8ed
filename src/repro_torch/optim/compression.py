"""Log-domain int8 gradient compression with error feedback.

A gradient leaf is encoded as (sign, 6-bit log2-magnitude code) packed in
int8 with a per-leaf float32 max-scale: an LNS-8 block format, the paper's
number system applied to gradient traffic.  :func:`fake_compress_roundtrip`
quantizes and dequantizes every leaf around the update with error
feedback (the residual carries what the round trip lost), so it models the
accuracy impact, not the savings on the wire.
"""
from __future__ import annotations

import torch

from ..core import f32
from ..pytree import tree_flatten, tree_map, tree_unflatten

_QF = 4            # fraction bits of the log2 code
_CODE_MIN = -63    # reserved -64 → exact zero


def compress_int8_log(g, amax=None):
    """float grad → (int8 codes, float32 scale).  code = round(log2|g/s| ·
    2^qf) with the sign in the int8's sign bit; |code| ≤ 63.  ``amax``:
    the leaf's largest magnitude when ``g`` is one shard of it."""
    if amax is None:
        amax = torch.max(torch.abs(g))
    s = amax.to(torch.float32) + 1e-30
    mag = torch.abs(g).to(torch.float32) / s
    code = torch.round(f32.log2(torch.clamp(mag, min=2.0 ** -40)) * (1 << _QF))
    code = torch.clamp(code, _CODE_MIN, 0.0)
    code = torch.where(mag == 0, float(_CODE_MIN - 1), code)
    signed = torch.where(g < 0, code - 64.0, code + 64.0)  # ±[1, 127]
    return signed.to(torch.int8), s


def decompress_int8_log(codes, s):
    c = codes.to(torch.float32)
    neg = c < 0
    code = torch.where(neg, c + 64.0, c - 64.0)
    mag = f32.exp2(code / (1 << _QF)) * s
    mag = torch.where(code <= _CODE_MIN, 0.0, mag)
    return torch.where(neg, -mag, mag)


def fake_compress_roundtrip(grads, residual=None, leaf_max=None):
    """Quantize → dequantize each leaf with error feedback.  Returns
    ``(grads_hat, new_residual)``; ``residual=None`` starts at zero.
    ``leaf_max(i, local max)`` gives leaf ``i``'s largest magnitude when
    the leaves are shards (under a mesh)."""
    if residual is None:
        residual = tree_map(torch.zeros_like, grads)
    leaves, treedef = tree_flatten(grads)
    ghat, res = [], []
    for i, (g, r) in enumerate(zip(leaves, tree_flatten(residual)[0])):
        gc = g + r.to(g.dtype)
        amax = None if leaf_max is None else leaf_max(
            i, torch.max(torch.abs(gc)))
        h = decompress_int8_log(*compress_int8_log(gc, amax)).to(g.dtype)
        ghat.append(h)
        res.append((gc - h).to(g.dtype))
    return tree_unflatten(treedef, ghat), tree_unflatten(treedef, res)

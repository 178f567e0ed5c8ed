"""Attention for training and prefill: GQA, query-chunked and causal-exact.

A loop over key bands, each with a loop over query chunks: chunk ``i`` of
band ``j`` attends only to keys ``[0, end of band j)``, so only one (c ×
band end) score block is live at a time.  Scores and softmax are float32.
Plain tensor ops (no fused attention), as the JAX package computes them in
jnp, so that the float results stay close to the reference's.  Decode,
the paged cache and MLA are not ported (ROADMAP queue 1 items 11 and 12).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.numerics import NumericsPolicy
from .config import ModelConfig
from .layers import _normal, apply_rope, rms_head_norm


class KVCache(NamedTuple):
    k: torch.Tensor          # GQA: (B, S, KV, hd)
    v: torch.Tensor          # GQA: (B, S, KV, hd)


# ------------------------------------------------------------- GQA -------
def init_gqa(gen, cfg: ModelConfig, dtype):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = d ** -0.5
    p = {"wq": _normal(gen, (d, h * hd), dtype, s),
         "wk": _normal(gen, (d, kv * hd), dtype, s),
         "wv": _normal(gen, (d, kv * hd), dtype, s),
         "wo": _normal(gen, (h * hd, d), dtype, (h * hd) ** -0.5)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def _sdpa_block(q, k, v, scale, mask):
    """q: (B,c,KV,G,hd), k/v: (B,t,KV,hd) → (B,c,KV,G,hd); fp32 softmax."""
    sc = torch.einsum("bckgh,btkh->bkgct", q, k).to(torch.float32) * scale
    if mask is not None:
        sc = torch.where(mask, sc, torch.tensor(-1e30, dtype=torch.float32,
                                                device=sc.device))
    p = torch.softmax(sc, dim=-1).to(v.dtype)
    return torch.einsum("bkgct,btkh->bckgh", p, v)


def gqa_qkv(p, x, cfg: ModelConfig, pol: NumericsPolicy, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = pol.linear(x, p["wq"]).reshape(b, s, h, hd)
    k = pol.linear(x, p["wk"]).reshape(b, s, kv, hd)
    v = pol.linear(x, p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _banded_causal(qg, k, v, scale, cfg: ModelConfig):
    """Banded-causal SDPA: ``attn_bands`` bands of queries, band ``j``
    against the keys up to its end (exact FLOPs at band granularity), a
    loop over query chunks of ``q_chunk`` inside each band."""
    b, s, kvh, g, hd = qg.shape
    c = min(cfg.q_chunk, s)
    nb = max(min(cfg.attn_bands, s // c), 1) if cfg.causal else 1
    per_band = s // nb
    if per_band % c and per_band:
        raise ValueError(f"band of {per_band} queries is not a multiple of "
                         f"the query chunk {c} (seq {s}, {nb} bands)")
    outs = []
    for j in range(nb):
        lo, hi = j * per_band, ((j + 1) * per_band if cfg.causal else s)
        kj, vj = k[:, :hi], v[:, :hi]
        for off in range(lo, lo + per_band, c):
            mask = None
            if cfg.causal:
                qpos = off + torch.arange(c, device=qg.device)
                mask = (qpos[:, None] >= torch.arange(hi, device=qg.device
                                                      )[None, :])
                mask = mask[None, None, None]
            outs.append(_sdpa_block(qg[:, off:off + c], kj, vj, scale, mask))
    return torch.cat(outs, dim=1)


def gqa_attention(p, x, cfg: ModelConfig, pol: NumericsPolicy,
                  positions, rt=None) -> "tuple[torch.Tensor, KVCache]":
    """Causal self-attention over a full sequence (train / prefill); K/V
    repeated to the full head count."""
    from .layers import _single_device
    _single_device(rt, "gqa_attention")
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = gqa_qkv(p, x, cfg, pol, positions)
    kr = torch.repeat_interleave(k, h // kv, dim=2)
    vr = torch.repeat_interleave(v, h // kv, dim=2)
    qg = q.reshape(b, s, h, 1, hd)
    o = _banded_causal(qg, kr, vr, hd ** -0.5, cfg)
    o = o.reshape(b, s, h * hd)
    return pol.linear(o, p["wo"]), KVCache(k, v)

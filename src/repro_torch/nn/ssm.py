"""Mamba2 (state-space duality) block — chunked SSD scan + decode step.

Follows Dao & Gu 2024 [arXiv:2405.21060]: per-head scalar A, grouped B/C
projections, short causal depthwise conv, gated RMSNorm output.  The SSD
scan splits the sequence into chunks: quadratic attention-like compute
within a chunk + a linear inter-chunk state scan (a loop over chunks,
where the JAX package runs ``lax.scan``).

Decode keeps (conv_state, ssd_state) per layer: O(1) per token.  Under
a mesh each rank keeps its block of the conv channels and of the state's
heads and steps them alone (:func:`mamba2_decode`'s ``split``).

The two projections (``in_proj``, ``out_proj``) go through the numerics
runtime's ``linear`` (the ⊞-MAC under the LNS train modes); the conv, the
scan, the softplus and the gated norm are float32 tensor ops, as the JAX
package computes them in jnp.  The decode step alone takes its two
contractions (the conv over its window, C·h over the state) from its
runtime's float reductions (``layers.float_ops``): the serving views'
order-free float64 form, so that a head's or a channel's value does not
depend on how many share the call (a card's batched float32 contraction
orders its sums by the batch count).  The multi-operand einsums of the
JAX package are written here as fixed pairwise contractions: the same
values up to float32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.numerics import NumericsPolicy
from .attention import WHOLE, KVSplit
from .config import ModelConfig
from .layers import _normal, float_ops


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_in + 2·G·N)
    state: torch.Tensor  # (B, H, P, N)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_dim


def init_mamba2(gen, cfg: ModelConfig, dtype):
    """The JAX package's tree, shapes and standard deviations (the values
    are torch's draws; ``A_log = log(linspace(1, 16, nh))``)."""
    s, d_in, nh, conv_dim = _dims(cfg)
    d = cfg.d_model
    dev = gen.device
    return {
        "in_proj": _normal(gen, (d, 2 * d_in + 2 * s.n_groups * s.d_state
                                 + nh), dtype, d ** -0.5),
        "conv_w": _normal(gen, (s.d_conv, conv_dim), dtype, 0.1),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)
                           ).to(dtype),
        "D": torch.ones((nh,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=dev),
        "norm": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": _normal(gen, (d_in, d), dtype, d_in ** -0.5),
    }


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, that is ``max(x, 0) +
    log1p(exp(-|x|))`` with no threshold, and ``logaddexp``'s derivative
    ``exp(x - softplus(x))`` (autograd of the max would give 1 at x = 0,
    not 1/2)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) \
            + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def softplus(x):
    return _Softplus.apply(x)


def _split_proj(p, x, cfg, pol):
    s, d_in, nh, conv_dim = _dims(cfg)
    zxbcdt = pol.linear(x, p["in_proj"])
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + conv_dim]
    dt = zxbcdt[..., d_in + conv_dim:]
    return z, xbc, dt


def _conv_full(p, xbc):
    """Causal depthwise conv over (B, S, C) with kernel (K, C): the K
    shifted products summed in order ``i = 0..K-1``."""
    k = p["conv_w"].shape[0]
    pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * p["conv_w"][i][None, None, :]
              for i in range(k))
    return torch.nn.functional.silu(out + p["conv_b"])


def _gated_out(p, y, z, cfg, pol):
    yf = (y * torch.nn.functional.silu(z)).to(torch.float32)
    nrm = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-5)
    y = (nrm * p["norm"].to(torch.float32)).to(y.dtype)
    return pol.linear(y, p["out_proj"])


def _ssd_chunked(xh, dt_a, dtx_scale, bmat, cmat, chunk):
    """Chunked SSD core.

    xh: (B,S,H,P) inputs; dt_a: (B,S,H) = Δt·A (decay log); dtx_scale:
    (B,S,H) = Δt (input scale); bmat/cmat: (B,S,H,N) per-head B/C rows.
    Returns y: (B,S,H,P) and final state (B,H,P,N).  ``S`` must be a
    multiple of ``min(chunk, S)``, as in the JAX package.
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk "
                         f"{q}")
    nc = s // q
    dt = xh.dtype
    xc = xh.reshape(b, nc, q, h, p)
    ac = dt_a.reshape(b, nc, q, h)
    dtc = dtx_scale.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, h, n)
    cc = cmat.reshape(b, nc, q, h, n)

    a_cs = torch.cumsum(ac, dim=2)                     # (B,nc,Q,H)
    # intra-chunk: L[i,j] = exp(a_cs_i - a_cs_j), i >= j.  The i<j entries
    # have positive exponents (a_cs is decreasing): zero them *inside* the
    # exp argument too, or their overflow poisons gradients through where.
    li = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=xh.device))[None, None, :, :, None]
    zero = torch.zeros((), dtype=li.dtype, device=li.device)
    lmat = torch.where(causal, torch.exp(torch.where(causal, li, zero)),
                       zero)
    cb = torch.einsum("bcihn,bcjhn->bcijh", cc, bc)
    # y_intra[i] = sum_j (C_i·B_j · L[i,j]) Δt_j x_j
    xs = dtc.to(dt)[..., None] * xc                    # (B,nc,Q,H,P)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", (cb * lmat).to(dt), xs)
    # chunk states: sum_j exp(a_cs_last - a_cs_j) dt_j x_j ⊗ B_j
    decay_tail = torch.exp(a_cs[:, :, -1:, :] - a_cs)  # (B,nc,Q,H)
    ws = (decay_tail.to(dt) * dtc.to(dt))[..., None] * xc
    states = torch.einsum("bcjhp,bcjhn->bchpn", ws, bc)
    chunk_decay = torch.exp(a_cs[:, :, -1, :])         # (B,nc,H)

    hprev = torch.zeros((b, h, p, n), dtype=dt, device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None].to(dt) \
            + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)              # (B,nc,H,P,N)
    y_inter = torch.einsum("bcihn,bchpn->bcihp",
                           cc * torch.exp(a_cs)[..., None].to(cc.dtype),
                           h_prevs)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, hprev


def mamba2_forward(p, x, cfg: ModelConfig, pol: NumericsPolicy
                   ) -> "tuple[torch.Tensor, SSMCache]":
    """Full-sequence Mamba2 block (train / prefill)."""
    s_cfg, d_in, nh, conv_dim = _dims(cfg)
    b, s, _ = x.shape
    g, n, hd = s_cfg.n_groups, s_cfg.d_state, s_cfg.head_dim
    z, xbc_raw, dt = _split_proj(p, x, cfg, pol)
    xbc = _conv_full(p, xbc_raw)
    xh = xbc[..., :d_in].reshape(b, s, nh, hd)
    bmat = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    cmat = xbc[..., d_in + g * n:].reshape(b, s, g, n)
    rep = nh // g
    bmat = torch.repeat_interleave(bmat, rep, dim=2)
    cmat = torch.repeat_interleave(cmat, rep, dim=2)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["A_log"].to(torch.float32))
    y, final = _ssd_chunked(xh, dt * a[None, None, :], dt, bmat, cmat,
                            s_cfg.chunk)
    y = y + xh * p["D"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_in)
    conv_tail = xbc_raw[:, -(s_cfg.d_conv - 1):, :]
    return _gated_out(p, y, z, cfg, pol), SSMCache(conv_tail, final)


def _own(extent: int, split: KVSplit, leaf: str) -> slice:
    """This rank's contiguous block of ``extent`` entries (all of them
    for ``WHOLE``); raises where the ranks cannot share them evenly."""
    if extent % split.n:
        raise ValueError(f"{leaf}: {extent} do not divide over {split.n} "
                         f"ranks of the model axis")
    c = extent // split.n
    return slice(split.rank * c, (split.rank + 1) * c)


def mamba2_decode(p, x, cfg: ModelConfig, pol: NumericsPolicy,
                  cache: SSMCache, split: KVSplit = WHOLE
                  ) -> "tuple[torch.Tensor, SSMCache]":
    """One-token recurrent step: h ← exp(ΔtA)·h + Δt·x⊗B; y = C·h + D·x.

    With ``split`` (under a mesh: the model axis) ``cache`` is this
    rank's share in the ``cache_specs`` layout, its block of the conv
    channels and of the state's heads, and so is the cache returned.
    The projections run whole (the token is replicated over the ranks);
    the rank convolves its own channels and updates its own heads, and
    two gathers join the ranks' conv outputs (each head reads the whole
    B and C rows) and ``y`` (the gated norm and ``out_proj`` read all of
    it).  The activations and the per-head Δt and decay are taken on the
    whole tensors, as the one-rank step takes them, and the two
    contractions by ``pol``'s float reductions (order-free under the
    serving views), so a rank's caches hold the same values as its block
    of the one-rank step's."""
    s_cfg, d_in, nh, conv_dim = _dims(cfg)
    b = x.shape[0]
    g, n, hd = s_cfg.n_groups, s_cfg.d_state, s_cfg.head_dim
    ch = _own(conv_dim, split, "the Mamba2 conv cache's channels")
    hs = _own(nh, split, "the Mamba2 state's heads")
    z, xbc_raw, dt = _split_proj(p, x, cfg, pol)       # (B,1,·)
    window = torch.cat([cache.conv, xbc_raw[..., ch]], dim=1)  # (B,K,C/n)
    fl = float_ops(pol)
    conv = fl.einsum("bkc,kc->bc", window, p["conv_w"][:, ch]) \
        + p["conv_b"][ch]
    xbc = torch.nn.functional.silu(split.gather(conv, 1))     # (B,C)
    xh = xbc[..., :d_in].reshape(b, nh, hd)[:, hs]
    bvec = xbc[..., d_in:d_in + g * n].reshape(b, g, n)
    cvec = xbc[..., d_in + g * n:].reshape(b, g, n)
    rep = nh // g
    bvec = torch.repeat_interleave(bvec, rep, dim=1)[:, hs]
    cvec = torch.repeat_interleave(cvec, rep, dim=1)[:, hs]
    dt = softplus(dt[:, 0].to(torch.float32)
                  + p["dt_bias"].to(torch.float32))    # (B,H)
    a = -torch.exp(p["A_log"].to(torch.float32))
    decay = torch.exp(dt * a[None, :]).to(x.dtype)[:, hs]     # (B,H/n)
    upd = (dt[:, hs].to(x.dtype)[:, :, None] * xh)[..., None] \
        * bvec[:, :, None, :]                          # (B,H/n,P,N)
    state = cache.state * decay[..., None, None] + upd
    y = fl.einsum("bhpn,bhn->bhp", state, cvec)
    y = y + xh * p["D"][hs].to(xh.dtype)[None, :, None]
    y = split.gather(y.reshape(b, -1), 1).reshape(b, 1, d_in)
    out = _gated_out(p, y, z[:, :1], cfg, pol)
    return out, SSMCache(window[:, 1:], state)


def make_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device="cpu") -> SSMCache:
    s_cfg, d_in, nh, conv_dim = _dims(cfg)
    return SSMCache(
        torch.zeros((batch, s_cfg.d_conv - 1, conv_dim), dtype=dtype,
                    device=device),
        torch.zeros((batch, nh, s_cfg.head_dim, s_cfg.d_state), dtype=dtype,
                    device=device))

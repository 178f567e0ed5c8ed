"""Shared layers: norms, MLPs, embeddings, rotary embedding, chunked CE.

Pure functions over the JAX package's nested parameter dict, holding
tensors.  Weight products route through per-layer resolved numerics
runtimes (:class:`~repro_torch.core.spec.LNSRuntime`): ``nn/model.py``
parses the config's ``numerics`` as a plan and hands every component
(``layers.attn``, ``layers.mlp``, ``emb``, ``head``, ...) the runtime its
layer path resolves to.  Under a mesh (a ``Runtime`` with one, and the
stream layout ``distributed.spmd.Sharded``) the embedding is the Megatron
vocab-parallel lookup and the cross-entropy runs on the rank's tokens.
"""
from __future__ import annotations

import torch

from ..core.numerics import NumericsPolicy  # = core.spec.LNSRuntime
from .config import ModelConfig


def _mesh(rt):
    return None if rt is None else getattr(rt, "mesh", None)


class MetaGen:
    """The generator of :func:`~repro_torch.nn.model.init_params` on the
    ``meta`` device: shapes and dtypes, no values."""
    device = torch.device("meta")


def _normal(gen, shape, dtype, std: float):
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype) * std


# ----------------------------------------------------------- norms -------
def init_norm(cfg: ModelConfig, dtype, device=None):
    if cfg.norm_kind == "rmsnorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device)}
    if cfg.norm_kind == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device),
                "bias": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    if cfg.norm_kind == "nonparam_ln":   # OLMo: no learnable params
        return {}
    raise ValueError(cfg.norm_kind)


class FloatOps:
    """The float reductions beside the weight products: norm means and
    variances, attention's contractions and softmax, the MoE router and
    routed experts.  A path takes them in one of two forms:

    * :data:`FLOAT32` — float32 ops, as the JAX package runs them (the
      training and full-sequence paths);
    * :data:`ORDER_FREE` — each op in float64, rounded once to its
      operands' dtype (the decode and prefill paths).  Products of float32
      values are exact in float64, so a token's result does not depend on
      the summation order, which a float32 reduction picks by shape (a
      chunk of C queries against one query, a batch of slots) and by
      device.

    The serving views of the numerics runtimes carry ``ORDER_FREE``
    (:func:`float_ops`)."""

    __slots__ = ("wide",)

    def __init__(self, wide):
        self.wide = wide

    def _up(self, t):
        return t if self.wide is None else t.to(self.wide)

    def einsum(self, eq: str, *ops):
        dtype = torch.result_type(*ops)
        return torch.einsum(eq, *(self._up(o) for o in ops)).to(dtype)

    def matmul(self, a, b):
        return (self._up(a) @ self._up(b)).to(torch.result_type(a, b))

    def softmax(self, x):
        """Over the last axis."""
        return torch.softmax(self._up(x), dim=-1).to(x.dtype)

    def mean(self, x):
        """Over the last axis, kept."""
        return torch.mean(self._up(x), -1, keepdim=True).to(x.dtype)

    def sum(self, x):
        """Over the last axis, kept."""
        return torch.sum(self._up(x), -1, keepdim=True).to(x.dtype)

    def var(self, x):
        """The biased variance over the last axis, kept."""
        if self.wide is None:
            return torch.var(x, -1, keepdim=True, unbiased=False)
        d = x - self.mean(x)
        return self.mean(d * d)


FLOAT32 = FloatOps(None)
ORDER_FREE = FloatOps(torch.float64)


def float_ops(pol) -> FloatOps:
    """The float reductions a component runs beside ``pol``'s products:
    the serving view's (``nn/model.py: _ServePol``) ``ORDER_FREE``, else
    ``FLOAT32``."""
    return getattr(pol, "fl", FLOAT32)


def _rsqrt_norm(xf, eps, fl):
    return xf * torch.rsqrt(fl.mean(xf * xf) + eps)


def apply_norm(p, x, cfg: ModelConfig, eps: float = 1e-5,
               fl: FloatOps = FLOAT32):
    """The config's norm over the last axis, in float32, its means taken
    by ``fl``."""
    xf = x.to(torch.float32)
    if cfg.norm_kind == "rmsnorm":
        return (_rsqrt_norm(xf, eps, fl) * p["scale"].to(torch.float32)
                ).to(x.dtype)
    nrm = (xf - fl.mean(xf)) * torch.rsqrt(fl.var(xf) + eps)
    if cfg.norm_kind == "layernorm":
        nrm = nrm * p["scale"].to(torch.float32) \
            + p["bias"].to(torch.float32)
    return nrm.to(x.dtype)


def rms_head_norm(x, scale, eps: float = 1e-6, fl: FloatOps = FLOAT32):
    """Per-head RMS norm for qk-norm (Qwen3) and MLA's latents: x (...,
    d_head)."""
    xf = x.to(torch.float32)
    return (_rsqrt_norm(xf, eps, fl) * scale.to(torch.float32)
            ).to(x.dtype)


# ------------------------------------------------------------- mlp -------
def init_mlp(gen, cfg: ModelConfig, d_hidden: int, dtype):
    d = cfg.d_model
    s_in, s_out = (2.0 / d) ** 0.5, (2.0 / d_hidden) ** 0.5
    if cfg.mlp_kind == "glu":
        return {"w_gate": _normal(gen, (d, d_hidden), dtype, s_in),
                "w_up": _normal(gen, (d, d_hidden), dtype, s_in),
                "w_down": _normal(gen, (d_hidden, d), dtype, s_out)}
    return {"w_up": _normal(gen, (d, d_hidden), dtype, s_in),
            "w_down": _normal(gen, (d_hidden, d), dtype, s_out)}


def _act(x, kind: str):
    if kind == "silu":
        return torch.nn.functional.silu(x)
    if kind == "gelu":   # jax.nn.gelu's default: the tanh form
        return torch.nn.functional.gelu(x, approximate="tanh")
    if kind == "relu":
        return torch.relu(x)
    raise ValueError(kind)


def apply_mlp(p, x, cfg: ModelConfig, pol: NumericsPolicy):
    if cfg.mlp_kind == "glu":
        h = _act(pol.linear(x, p["w_gate"]), cfg.act) \
            * pol.linear(x, p["w_up"])
    else:
        h = _act(pol.linear(x, p["w_up"]), cfg.act)
    return pol.linear(h, p["w_down"])


# ------------------------------------------------------- embeddings ------
def init_embeddings(gen, cfg: ModelConfig, dtype):
    v, d = cfg.padded_vocab, cfg.d_model
    p = {"tok": _normal(gen, (v, d), dtype, d ** -0.5)}
    if not cfg.tie_embeddings:
        p["head"] = _normal(gen, (d, v), dtype, d ** -0.5)
    return p


def embed_tokens(p, tokens, pol: NumericsPolicy, rt=None, scatter=None):
    """Embedding lookup of the (STE-quantized) table: a gather.  The
    quantizer is elementwise, so the gathered rows are quantized, not the
    whole table: the same values and the same straight-through
    gradient.

    Under a mesh (``rt`` a ``Runtime`` with one) the table is split over
    the vocabulary on the model axis: the Megatron masked local lookup,
    then a reduce-scatter over the sequence when its length divides the
    model axis (``scatter``; the rank keeps its block of the sequence),
    else an all-reduce.  Each token's row lives on one rank, so the sum
    is exact."""
    if _mesh(rt) is None:
        return pol.q_param(p["tok"][tokens.long()])
    from ..distributed.sharding import P
    from ..distributed.spmd import Sharded, all_reduce, reduce_scatter
    sh = Sharded(rt.mesh, tuple(rt.data_axes), rt.model_axis, False)
    if scatter is None:
        scatter = tokens.ndim > 1 and tokens.shape[1] % sh.tp == 0
    w_loc = sh.use(p["tok"], P("model", None), gather=())
    vloc = w_loc.shape[0]
    idx = tokens.long() - sh.model_rank * vloc
    ok = (idx >= 0) & (idx < vloc)
    x = pol.q_param(w_loc[torch.clamp(idx, 0, vloc - 1)])
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    if scatter:
        return reduce_scatter(x, 1, sh.model_group)
    return all_reduce(x, sh.model_group)


def _mask_pad(logits, cfg: ModelConfig):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) \
        >= cfg.vocab_size
    return torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                         device=logits.device), logits)


def _head_weight(emb_params, cfg: ModelConfig, sh=None):
    """(d, V): the tied table's transposed view, or the head; under a mesh
    (``sh``, a stream layout) gathered whole."""
    if sh is not None:
        from ..distributed.sharding import P
        if cfg.tie_embeddings:
            return sh.use(emb_params["tok"], P("model", None)).T
        return sh.use(emb_params["head"], P(None, "model"))
    return emb_params["tok"].T if cfg.tie_embeddings else emb_params["head"]


def lm_logits(p, x, pol: NumericsPolicy, cfg: ModelConfig, sh=None):
    return _mask_pad(pol.linear(x, _head_weight(p, cfg, sh)), cfg)


# ----------------------------------------------------------- rotary ------
def rope_freqs(cfg: ModelConfig, d_rot: int, device=None):
    return _freqs(cfg.rope_theta, d_rot, device)


def _freqs(theta: float, d: int, device):
    return torch.pow(torch.tensor(theta, dtype=torch.float32),
                     -torch.arange(0, d, 2, dtype=torch.float32,
                                   device=device) / d)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D) with D even; positions: (B, S) int."""
    d = x.shape[-1]
    freqs = _freqs(theta, d, x.device)
    ang = positions[..., None].to(torch.float32) * freqs   # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ----------------------------------------------- chunked cross-entropy ---
def chunked_ce_loss(x, emb_params, labels, pol: NumericsPolicy,
                    cfg: ModelConfig, chunk: "int | None" = None, rt=None,
                    offset: int = 0):
    """Mean CE over (B, S) without the (B, S, V) logits at once: a loop
    over sequence chunks, logits and LSE in float32 per chunk.

    Under a mesh (``rt`` the stream layout of ``x``, whose position
    ``offset + t`` carries label ``t``): :func:`_sharded_ce_loss`."""
    chunk = chunk or cfg.ce_chunk
    if _mesh(rt) is not None:
        return _sharded_ce_loss(x, emb_params, labels, pol, cfg, chunk, rt,
                                offset)
    if offset:
        x = x[:, offset:]
    b, s, d = x.shape
    n = max(s // chunk, 1)
    c = s // n
    xs = x[:, :n * c].reshape(b, n, c, d)
    ys = labels[:, :n * c].reshape(b, n, c).long()
    w = _head_weight(emb_params, cfg)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        logits = _mask_pad(pol.linear(xs[:, i], w), cfg).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, ys[:, i, :, None])[..., 0]
        total = total + torch.sum(lse - ll)
    return total / (b * n * c)


def _sharded_ce_loss(x, emb_params, labels, pol, cfg, chunk, sh, offset):
    """The chunked CE on the rank's tokens: each chunk of label positions
    cut to this rank's block of the sequence (batch → data, chunk
    sequence → model), the head gathered whole.  The per-token terms of
    every rank are gathered and summed chunk by chunk in the one-device
    order, so the loss is the one-device float on every rank; its gradient
    reaches each rank's own terms."""
    from ..distributed.spmd import all_reduce_raw, shared_value
    b, s_loc, _ = x.shape
    s = labels.shape[1]
    n = max(s // chunk, 1)
    c = s // n
    w = _head_weight(emb_params, cfg, sh)
    pos0 = sh.model_rank * s_loc if sh.seq else 0
    ys = labels.long()
    segs, at = [], 0

    def zeros(k):
        return torch.zeros((b, k), dtype=torch.float32, device=x.device)
    for i in range(n):
        lo = max(i * c + offset, pos0)
        hi = min((i + 1) * c + offset, pos0 + s_loc)
        if lo >= hi:
            continue
        logits = _mask_pad(pol.linear(x[:, lo - pos0:hi - pos0], w),
                           cfg).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          ys[:, lo - offset:hi - offset, None])[..., 0]
        if lo - offset > at:
            segs.append(zeros(lo - offset - at))
        segs.append(lse - ll)
        at = hi - offset
    if at < n * c:
        segs.append(zeros(n * c - at))
    grid = torch.cat(segs, dim=1)                 # this rank's terms
    if at == 0:
        # No label on this rank: its backward still runs every collective
        # behind x and the head, with zero gradients.
        grid = grid + 0.0 * (x.sum() + w.sum())
    with torch.no_grad():
        full = grid.detach()
        if sh.seq:
            full = all_reduce_raw(full, sh.model_group)
        full = sh.gather_data(full)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            total = total + torch.sum(full[:, i * c:(i + 1) * c].contiguous())
        denom = full.shape[0] * n * c
    return shared_value(total / denom, grid.sum() / (denom * sh.rep))

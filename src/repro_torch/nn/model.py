"""Model assembly of every family: dense, vlm, moe, ssm (Mamba2), hybrid
(Mamba2 with a shared attention block) and encdec / audio.

Entry points (``params`` from :func:`init_params`, or the JAX package's
carried across by :func:`params_from_numpy`):

  loss_fn(params, batch, cfg, rt)            train:   mean CE (+ MoE aux)
  prefill(params, batch, cfg, rt)            prefill: last-pos logits + caches
  decode_step(params, tok, caches, pos, cfg) decode:  next logits + caches
  decode_step_paged / prefill_chunk          the serving engine's paged pair
                                             (dense, vlm and moe only)

``params`` is the JAX package's nested parameter dict, holding tensors:
each layer stack is stacked along a leading axis (``params["layers"]``;
the moe family's leading dense layers in ``params["dense_layers"]``, the
hybrid's ``tail_layers`` and its one ``shared_attn`` block, the enc-dec
family's ``enc_layers``), and a Python loop over that axis takes the place
of ``lax.scan``, with the same results.  ``cfg.remat == "block"``
recomputes each block in backward (``torch.utils.checkpoint``,
non-reentrant); the ⊞-MAC kernels are deterministic, so the results do not
change.

The hybrid runs its ``layers`` in groups of ``hybrid.attn_every``, the
shared attention block after each group (its gradients add up over the
groups), then the ``tail_layers`` (only when ``attn_every`` does not
divide ``layers``).  The enc-dec family runs a non-causal encoder over the
frames (``frontend_proj`` of the audio stub's embeddings, or the embedded
``enc_tokens``), then the decoder: self-attention, cross-attention over
the encoder memory, MLP.  Decode caches: per-layer ``KVCache`` stacks, the
Mamba2 layers' ``ssm.SSMCache`` stacks, and for enc-dec a ``(self KV,
cross KV)`` pair and ``enc_out``.  :func:`caches_from_numpy` and
:func:`caches_to_numpy` carry decode caches across the package boundary.

Numerics are a per-layer property: ``cfg.numerics`` parses as a
:class:`~repro_torch.core.plan.NumericsPlan` whose glob rules match the
dotted layer paths of :func:`known_layer_paths` (``emb``, ``layers.attn``,
``layers.mlp``, ``layers.moe``, ``layers.mamba``, ``layers.xattn``,
``shared_attn.*``, ``enc_layers.*``, ``tail_layers.mamba``,
``dense_layers.*``, ``frontend``, ``head``); each component receives the
runtime its resolved spec describes.

The serving functions (the decode steps and ``prefill_chunk``) hand every
component the serving view of its runtime (:class:`_ServePol`), which
takes the float reductions (norms, attention and cross-attention, MoE
routing and routed experts) in the order-free float64 form of
``layers.ORDER_FREE``, so that a token's logits do not depend on the
batch, chunk or cache width it is computed in.  The Mamba2 decode step
takes its conv and C·h contractions in that form too (so that its heads
split over a mesh give the one-device values); its scan in prefill, its
elementwise ops and its gated norm stay float32, as in the JAX package
(no paged engine serves the ssm and hybrid families).  Under the LNS specs every
weight product is a ⊞-MAC, whose order is fixed, and the paged engine
then reproduces the dense token-by-token oracle exactly; under the float
specs the weight products are float32 matmuls, which round by shape, and
the two agree only up to those roundings.

Under a :class:`Runtime` with a mesh, every entry point runs on the
rank's shards (see :class:`Runtime`): ``loss_fn`` returns the global loss
on every rank, ``prefill`` returns the rank's caches in the
``cache_specs`` layout, and the decode steps take and return caches in
that layout.  No cache leaf is gathered over the model axis
(``attention.KVSplit``): each rank attends over its own KV lines and its
own frames of ``enc_out``, the softmax combined over the axis, and steps
its own Mamba2 channels and heads.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import sys
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.numerics import get_plan
from ..core.spec import TORCH_DTYPES
from ..devices import resolve_device
from ..distributed.spmd import own_block
from ..pytree import tree_flatten, tree_map, tree_unflatten
from .attention import (WHOLE, KVCache, KVSplit, _dense_share, _sdpa,
                        _sdpa_split, gqa_attention, gqa_decode,
                        gqa_decode_paged, gqa_prefill_paged, init_gqa,
                        init_mla, make_cache, make_paged_cache,
                        mla_attention, mla_decode, mla_decode_paged,
                        mla_prefill_paged, token_writer)
from .config import ModelConfig
from .layers import (ORDER_FREE, MetaGen, _normal, apply_mlp, apply_norm,
                     chunked_ce_loss, embed_tokens, float_ops,
                     init_embeddings, init_mlp, init_norm, lm_logits)
from .moe import init_moe, moe_block
from .ssm import (SSMCache, init_mamba2, make_ssm_cache, mamba2_decode,
                  mamba2_forward)


#: Families whose training and serving paths this port builds.
PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec",
                   "audio")

#: Families the paged serving data plane supports: every per-layer cache
#: is a KVCache growing along the sequence axis.
PAGED_FAMILIES = ("dense", "vlm", "moe")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Distribution context; ``mesh=None`` is the single-device mode.

    With a ``torch.distributed.device_mesh.DeviceMesh`` every rank runs the
    same code on its local tensors (explicit SPMD,
    :mod:`repro_torch.distributed.spmd`): parameters are the rank's shards
    by :func:`~repro_torch.distributed.sharding.param_specs`, gathered
    around their use; the batch is split over ``data_axes``; the token
    stream's sequence over ``model_axis`` when its length divides that
    axis (else replicated over it); attention heads over ``model``; MoE
    experts over ``model`` (``moe_ep`` / ``moe_ep_replicated``); the
    embedding is vocab-parallel."""
    mesh: Optional[Any] = None
    data_axes: tuple = ("data",)
    model_axis: str = "model"

    def __post_init__(self):
        if self.mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(self.mesh, DeviceMesh):
                raise TypeError(f"Runtime(mesh=...) takes a torch.distributed"
                                f".device_mesh.DeviceMesh, not "
                                f"{type(self.mesh).__name__}")
        object.__setattr__(self, "data_axes", tuple(self.data_axes))

    @property
    def tp(self) -> int:
        from ..distributed.sharding import axis_size
        return 1 if self.mesh is None else axis_size(self.mesh,
                                                     self.model_axis)

    def sharded(self, seq_len: int):
        """The layout of a token stream of ``seq_len`` positions (None
        without a mesh)."""
        if self.mesh is None:
            return None
        from ..distributed.spmd import Sharded
        return Sharded(self.mesh, self.data_axes, self.model_axis,
                       seq_len % self.tp == 0)


# ----------------------------------------------- per-layer numerics ------
@dataclasses.dataclass(frozen=True)
class BlockPols:
    """The per-component numerics runtimes one block consumes, resolved
    from the model's plan at a layer-path prefix (``layers``,
    ``dense_layers``, ``enc_layers``, ``shared_attn``, ``tail_layers``):
    e.g. ``layers.attn``, ``layers.mamba``.  Components whose resolved
    specs are equal share one cached runtime."""
    attn: Any = None
    mlp: Any = None
    moe: Any = None
    mamba: Any = None
    xattn: Any = None


def _block_pols(plan, prefix: str, *kinds: str) -> BlockPols:
    return BlockPols(**{k: plan.runtime_for(f"{prefix}.{k}")
                        for k in kinds})


def known_layer_paths(cfg: ModelConfig) -> tuple:
    """The layer paths this config instantiates, the vocabulary of
    NumericsPlan patterns (the JAX package's, for every family)."""
    paths = ["emb", "head"]
    if cfg.frontend:
        paths.append("frontend")
    fam = cfg.family
    if fam in ("dense", "vlm"):
        paths += ["layers.attn", "layers.mlp"]
    elif fam == "moe":
        if cfg.moe.first_dense_layers > 0:
            paths += ["dense_layers.attn", "dense_layers.mlp"]
        paths += ["layers.attn", "layers.moe"]
    elif fam == "ssm":
        paths += ["layers.mamba"]
    elif fam == "hybrid":
        paths += ["layers.mamba", "shared_attn.attn", "shared_attn.mlp"]
        if cfg.layers % cfg.hybrid.attn_every:
            paths.append("tail_layers.mamba")
    elif fam in ("encdec", "audio"):
        paths += ["enc_layers.attn", "enc_layers.mlp", "layers.attn",
                  "layers.xattn", "layers.mlp"]
    return tuple(paths)


def _model_plan(cfg: ModelConfig):
    """The config's numerics plan, its patterns checked against the
    family's layer paths (a typo'd pattern fails loudly)."""
    return get_plan(cfg.numerics).validate_paths(known_layer_paths(cfg))


def _check_family(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{what}: unknown family {cfg.family!r}")
    kinds = ("gqa", "mla", "none") if cfg.family == "ssm" else ("gqa", "mla")
    if cfg.attn_kind not in kinds:
        raise ValueError(f"{what}: attn_kind={cfg.attn_kind!r} for the "
                         f"{cfg.family!r} family (supported: {kinds})")


# ------------------------------------------------------------- init ------
def _init_attn(gen, cfg, dtype):
    if cfg.attn_kind == "mla":
        return init_mla(gen, cfg, dtype)
    return init_gqa(gen, cfg, dtype)


def _init_dense_layer(gen, cfg: ModelConfig, dtype):
    return {"attn": _init_attn(gen, cfg, dtype),
            "mlp": init_mlp(gen, cfg, cfg.d_ff, dtype),
            "norm1": init_norm(cfg, dtype, gen.device),
            "norm2": init_norm(cfg, dtype, gen.device)}


def _init_moe_layer(gen, cfg: ModelConfig, dtype):
    return {"attn": _init_attn(gen, cfg, dtype),
            "moe": init_moe(gen, cfg, dtype),
            "norm1": init_norm(cfg, dtype, gen.device),
            "norm2": init_norm(cfg, dtype, gen.device)}


def _init_ssm_layer(gen, cfg: ModelConfig, dtype):
    return {"mamba": init_mamba2(gen, cfg, dtype),
            "norm1": init_norm(cfg, dtype, gen.device)}


def _init_xattn_layer(gen, cfg: ModelConfig, dtype):
    """Decoder layer with cross-attention (enc-dec family)."""
    return {"attn": _init_attn(gen, cfg, dtype),
            "xattn": init_gqa(gen, cfg, dtype),
            "mlp": init_mlp(gen, cfg, cfg.d_ff, dtype),
            "norm1": init_norm(cfg, dtype, gen.device),
            "norm2": init_norm(cfg, dtype, gen.device),
            "norm3": init_norm(cfg, dtype, gen.device)}


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _hybrid_split(cfg: ModelConfig):
    """(groups, attn_every, tail) of a hybrid stack."""
    k = cfg.hybrid.attn_every
    groups = cfg.layers // k
    return groups, k, cfg.layers - groups * k


def _device(device) -> torch.device:
    """``resolve_device``, and the ``meta`` device (shapes, no values)."""
    if str(device) == "meta":
        return torch.device("meta")
    return resolve_device(device)


def init_params(key, cfg: ModelConfig, device="cuda"):
    """Fresh parameters of a config of any family on ``device``.

    ``key`` is a seed or a ``torch.Generator`` (drawn on its own device,
    then moved).  The tree, shapes, dtypes and per-leaf standard deviations
    are the JAX package's; the values are torch's draws (threefry is not
    matched): carry the reference's values across with
    :func:`params_from_numpy`.  As in the JAX package, the moe family
    stacks ``max(fd, 1)`` dense layers and ``max(layers - fd, 1)`` MoE
    layers (``fd = moe.first_dense_layers``), and the hybrid
    ``max(groups · attn_every, 1)`` Mamba2 layers: a hybrid shallower than
    ``attn_every`` stacks one layer that no group runs.  On the ``meta``
    device the tree has its shapes and dtypes and no values (for the
    sharding specs of a config at any width).
    """
    device = _device(device)
    _check_family(cfg, "init_params")
    gen = MetaGen() if device.type == "meta" else key \
        if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key))
    dtype = TORCH_DTYPES[cfg.param_dtype]
    p: dict = {"emb": init_embeddings(gen, cfg, dtype),
               "final_norm": init_norm(cfg, dtype, gen.device)}
    fam = cfg.family

    def stack(init, n):
        return _stack([init(gen, cfg, dtype) for _ in range(n)])

    if fam in ("dense", "vlm"):
        p["layers"] = stack(_init_dense_layer, cfg.layers)
    elif fam == "moe":
        fd = cfg.moe.first_dense_layers
        p["dense_layers"] = stack(_init_dense_layer, max(fd, 1))
        p["layers"] = stack(_init_moe_layer, max(cfg.layers - fd, 1))
    elif fam == "ssm":
        p["layers"] = stack(_init_ssm_layer, cfg.layers)
    elif fam == "hybrid":
        groups, k, tail = _hybrid_split(cfg)
        p["layers"] = stack(_init_ssm_layer, max(groups * k, 1))
        if tail:
            p["tail_layers"] = stack(_init_ssm_layer, tail)
        p["shared_attn"] = _init_dense_layer(gen, cfg, dtype)
    else:                                  # encdec, audio
        p["enc_layers"] = stack(_init_dense_layer, cfg.encdec.n_enc_layers)
        p["layers"] = stack(_init_xattn_layer, cfg.encdec.n_dec_layers)
    if cfg.frontend and fam not in ("moe", "ssm", "hybrid"):
        p["frontend_proj"] = _normal(gen, (cfg.d_model, cfg.d_model),
                                     dtype, cfg.d_model ** -0.5)
    return tree_map(lambda t: t.to(device), p)


def params_from_numpy(tree, device="cuda"):
    """The JAX package's parameter (or state) tree, as numpy arrays, as
    tensors on ``device``, 1:1 by path."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(device),
                    tree)


def params_to_numpy(params):
    """Tensors → numpy arrays, 1:1 by path (the inverse of
    :func:`params_from_numpy`)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


# ----------------------------------------------------------- blocks ------
def _res(x, y):
    """A branch output in the residual stream's dtype (the embedding
    output's, under mixed per-layer compute dtypes)."""
    return y.to(x.dtype)


def _attn_fwd(lp, x, cfg, pol, positions, rt=None):
    if cfg.attn_kind == "mla":
        return mla_attention(lp, x, cfg, pol, positions, rt)
    return gqa_attention(lp, x, cfg, pol, positions, rt)


def _attn_dec(lp, x, cfg, pol, cache, pos, split=WHOLE, inplace=False):
    if cfg.attn_kind == "mla":
        return mla_decode(lp, x, cfg, pol, cache, pos, split, inplace)
    return gqa_decode(lp, x, cfg, pol, cache, pos, split, inplace)


# Each block takes ``attn(attn params, normed x, pol) → (out, cache)``: the
# full-sequence attention in training and prefill, a decode or chunked
# prefill against a cache in serving.  Its norms take the float reductions
# of ``bp.attn`` (``layers.float_ops``).
def _dense_block(lp, x, cfg, bp: BlockPols, attn):
    fl = float_ops(bp.attn)
    if cfg.block_style == "parallel":      # command-r style
        h = apply_norm(lp["norm1"], x, cfg, fl=fl)
        a, cache = attn(lp["attn"], h, bp.attn)
        f = apply_mlp(lp["mlp"], h, cfg, bp.mlp)
        x = x + _res(x, a) + _res(x, f)
    else:
        a, cache = attn(lp["attn"], apply_norm(lp["norm1"], x, cfg, fl=fl),
                        bp.attn)
        x = x + _res(x, a)
        x = x + _res(x, apply_mlp(lp["mlp"],
                                  apply_norm(lp["norm2"], x, cfg, fl=fl),
                                  cfg, bp.mlp))
    return x, cache


def _moe_layer_fwd(lp, x, cfg, bp: BlockPols, attn, sh=None):
    """``sh``: the stream layout under a mesh (``moe_block``'s EP forms)."""
    fl = float_ops(bp.attn)
    a, cache = attn(lp["attn"], apply_norm(lp["norm1"], x, cfg, fl=fl),
                    bp.attn)
    x = x + _res(x, a)
    y, aux = moe_block(lp["moe"], apply_norm(lp["norm2"], x, cfg, fl=fl),
                       cfg, bp.moe, sh)
    return x + _res(x, y), cache, aux


def _ssm_block(lp, x, cfg, bp: BlockPols, mamba):
    """``mamba(mamba params, normed x, pol) → (out, SSMCache)``: the
    full-sequence Mamba2 block, or its one-token decode step."""
    y, cache = mamba(lp["mamba"], apply_norm(lp["norm1"], x, cfg,
                                             fl=float_ops(bp.mamba)),
                     bp.mamba)
    return x + _res(x, y), cache


def _xattn_block(lp, x, cfg, bp: BlockPols, attn, enc_out, sh=None,
                 enc_sh=None, split: KVSplit = WHOLE):
    """Enc-dec decoder layer: self-attention, cross-attention over
    ``enc_out``, MLP; returns (x, (self cache, cross cache)).  ``sh`` /
    ``enc_sh``: the decoder's and the encoder's stream layouts under a
    mesh; ``split``: in decode, this rank's share of ``enc_out``'s
    frames (:func:`_cross_attention`)."""
    fl = float_ops(bp.attn)
    a, cache = attn(lp["attn"], apply_norm(lp["norm1"], x, cfg, fl=fl),
                    bp.attn)
    x = x + _res(x, a)
    q = apply_norm(lp["norm2"], x, cfg, fl=fl)
    xa, xcache = _cross_attention(lp["xattn"], q, enc_out, cfg, bp.xattn,
                                  sh, enc_sh, split)
    x = x + _res(x, xa)
    x = x + _res(x, apply_mlp(lp["mlp"], apply_norm(lp["norm3"], x, cfg,
                                                    fl=fl), cfg, bp.mlp))
    return x, (cache, xcache)


def _cross_attention(lp, q_in, enc_out, cfg, pol, sh=None, enc_sh=None,
                     split: KVSplit = WHOLE):
    """Non-causal attention of decoder queries over the encoder memory:
    the banded SDPA with one band.  As in the JAX package, that band's
    keys are the first ``min(S, T)`` frames (its extent is the query
    count S), so a one-token decode step attends to frame 0 only.

    With ``split`` (decode under a mesh) ``enc_out`` is this rank's
    block of the frames: K and V are projected over it alone, the band
    is masked by global frame index, and the softmax is combined over
    the ranks (``attention.combine_softmax``; a rank whose frames all lie
    past the band adds nothing)."""
    b, s, _ = q_in.shape
    t = enc_out.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = pol.linear(q_in, lp["wq"]).reshape(b, s, h, hd)
    k = pol.linear(enc_out, lp["wk"]).reshape(b, t, kv, hd)
    v = pol.linear(enc_out, lp["wv"]).reshape(b, t, kv, hd)
    kr = torch.repeat_interleave(k, h // kv, dim=2)
    vr = torch.repeat_interleave(v, h // kv, dim=2)
    if split.n > 1:
        _, frames = _dense_share(enc_out, split)
        mask = (frames < s)[None, None, None, None, :]
        o = _sdpa_split(q.reshape(b, s, h, 1, hd), kr, vr, hd ** -0.5, mask,
                        float_ops(pol), split.pmax, split.psum)
    else:
        o = _sdpa(q, kr, vr, hd ** -0.5, cfg.with_(causal=False),
                  float_ops(pol), sh, enc_sh)
    o = o.reshape(b, s, h * hd)
    return pol.linear(o, lp["wo"]), KVCache(k, v)


def _unstack(stacked) -> list:
    """A stacked layer tree → one tree per layer (views; their gradients
    stack back in one op)."""
    leaves, treedef = tree_flatten(stacked)
    parts = [t.unbind(0) for t in leaves]
    return [tree_unflatten(treedef, [p[i] for p in parts])
            for i in range(leaves[0].shape[0])]


def _stack_caches(caches: list, empty=None):
    """Per-layer caches (``KVCache`` or ``SSMCache``) → one of the same
    type stacked along a leading layer axis, as ``lax.scan`` stacks them;
    ``empty`` when there are none."""
    if not caches:
        return empty
    return type(caches[0])(*(torch.stack(xs) for xs in zip(*caches)))


def _layer_caches(stacked) -> list:
    return [type(stacked)(*parts)
            for parts in zip(*(t.unbind(0) for t in stacked))]


def _import_dynamo() -> None:
    """Import ``torch._dynamo`` in a thread of its own, once.  The first
    ``checkpoint`` call of a process imports it otherwise, with the
    caller's frames on the stack, and ``torch.fx``'s ``wrap`` keeps those
    frames in a reference cycle: the first remat step's gradients would
    outlive it until the cyclic collector ran.  A fresh thread's stack
    holds none of the caller's frames."""
    if "torch._dynamo" not in sys.modules:
        t = threading.Thread(target=importlib.import_module,
                             args=("torch._dynamo",))
        t.start()
        t.join()


def _maybe_remat(fn, cfg):
    if cfg.remat != "block":
        return fn
    _import_dynamo()
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------- forward ------
def _full(params, key, sh):
    """``params[key]`` as used: gathered whole under a mesh."""
    return params[key] if sh is None else sh.full(params[key], key)


def _frontend_in(batch, cfg):
    return batch.get("frontend_embeds") if cfg.frontend else None


def _stream(batch, cfg, rt: Runtime):
    """The layout of :func:`_embed_inputs`' stream (None without a
    mesh)."""
    fe = _frontend_in(batch, cfg)
    return rt.sharded(batch["tokens"].shape[1]
                      + (0 if fe is None else fe.shape[1]))


def _embed_inputs(params, batch, cfg, plan, rt: Runtime = Runtime()):
    """tokens (+ optional stub frontend embeds) → (B, S, d).  Under a mesh
    the rank's block of the stream: the frontend's prefix and the text
    are joined whole over the model axis, then cut to the rank's block of
    the sequence."""
    fe_in = _frontend_in(batch, cfg)
    x = embed_tokens(params["emb"], batch["tokens"], plan.runtime_for("emb"),
                     rt, scatter=False if fe_in is not None else None)
    if fe_in is not None:
        fpol = plan.runtime_for("frontend")
        proj = _full(params, "frontend_proj", rt.sharded(1))
        fe = fpol.linear(fe_in.to(fpol.dtype), proj)
        x = torch.cat([fe.to(x.dtype), x], dim=1)
        if rt.mesh is not None:
            x = _stream(batch, cfg, rt).own_seq(x)
    return x


def _empty_hybrid_caches(cfg: ModelConfig, x):
    """The prefill caches of a hybrid with no group (``layers <
    attn_every``): zero-length stacks of the shapes the JAX package's
    empty scans give."""
    s_cfg = cfg.ssm
    b, s = x.shape[:2]
    d_in = s_cfg.expand * cfg.d_model
    nh = d_in // s_cfg.head_dim
    conv_dim = d_in + 2 * s_cfg.n_groups * s_cfg.d_state
    k = cfg.hybrid.attn_every

    def empty(*shape):
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    kv = (0, b, s, cfg.n_kv_heads, cfg.d_head)
    return (SSMCache(empty(0, k, b, min(s_cfg.d_conv - 1, s), conv_dim),
                     empty(0, k, b, nh, s_cfg.head_dim, s_cfg.d_state)),
            KVCache(empty(*kv), empty(*kv)))


def _mamba_fn(cfg, sh):
    """The full-sequence Mamba2 block; under a mesh over the whole
    sequence (gathered), the output cut back to the rank's block and the
    caches to its block of the channels and heads (``cache_specs``)."""
    def mamba(mp, h, pol):
        if sh is None:
            return mamba2_forward(mp, h, cfg, pol)
        y, c = mamba2_forward(mp, sh.gather_seq(h), cfg, pol)
        grp = sh.model_group
        return sh.own_seq(y), SSMCache(own_block(c.conv, 2, grp).clone(),
                                       own_block(c.state, 1, grp).clone())
    return mamba


def _layer_stack(params, x, cfg: ModelConfig, rt: Runtime, positions,
                 want_caches: bool = False, sh=None):
    """Full-sequence pass through the layer stacks of a decoder-only
    family → (x, caches, aux).

    ``want_caches=False`` (training) keeps no per-layer cache.  The moe
    family runs its ``first_dense_layers`` dense layers, then the MoE
    layers, and sums their load-balance aux terms; the hybrid runs each
    group of ``attn_every`` Mamba2 layers and then the shared attention
    block, then its tail, and its prefill caches stack the groups' Mamba2
    caches as (groups, attn_every, ...), as the JAX package's nested scan
    does.  Under a mesh (``sh`` the stream layout of ``x``) each layer's
    parameters are gathered inside its block (again in the recompute of
    ``remat``)."""
    _check_family(cfg, "the layer stack")
    plan = _model_plan(cfg)
    caches = {}

    def attn(ap, h, pol):
        return _attn_fwd(ap, h, cfg, pol, positions, sh)

    mamba = _mamba_fn(cfg, sh)
    moe_layer = functools.partial(_moe_layer_fwd, sh=sh)

    def run(x, lps, prefix, kinds, block, fn):
        """x through ``block`` for each layer of ``lps``; returns x and,
        per layer, what the block returns beside it."""
        bp = _block_pols(plan, prefix, *kinds)
        blk = _maybe_remat(lambda h, lp: block(
            lp if sh is None else sh.full(lp, prefix), h, cfg, bp, fn), cfg)
        rest = []
        for lp in lps:
            x, *r = blk(x, lp)
            rest.append(r)
        return x, rest

    def kept(rest):
        return [r[0] for r in rest] if want_caches else []

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family
    if fam == "moe":
        fd = cfg.moe.first_dense_layers
        x, dense = run(x, _unstack(params["dense_layers"])[:fd],
                       "dense_layers", ("attn", "mlp"), _dense_block, attn)
        x, rest = run(x, _unstack(params["layers"]), "layers",
                      ("attn", "moe"), moe_layer, attn)
        if want_caches:
            caches["layers"] = _stack_caches(kept(rest))
            if dense:
                caches["dense_layers"] = _stack_caches(kept(dense))
        aux_total = torch.stack([r[1] for r in rest]).sum()
    elif fam == "ssm":
        x, rest = run(x, _unstack(params["layers"]), "layers", ("mamba",),
                      _ssm_block, mamba)
        if want_caches:
            caches["layers"] = _stack_caches(kept(rest))
    elif fam == "hybrid":
        groups, k, _ = _hybrid_split(cfg)
        lps = _unstack(params["layers"])
        ssm_c, kv = [], []
        for g in range(groups):
            x, rest = run(x, lps[g * k:(g + 1) * k], "layers", ("mamba",),
                          _ssm_block, mamba)
            ssm_c += [_stack_caches(kept(rest))]
            x, rest = run(x, [params["shared_attn"]], "shared_attn",
                          ("attn", "mlp"), _dense_block, attn)
            kv += kept(rest)
        if "tail_layers" in params:
            x, rest = run(x, _unstack(params["tail_layers"]), "tail_layers",
                          ("mamba",), _ssm_block, mamba)
            if want_caches:
                caches["tail_layers"] = _stack_caches(kept(rest))
        if want_caches:
            empty_ssm, empty_kv = _empty_hybrid_caches(cfg, x)
            caches["layers"] = _stack_caches(ssm_c, empty_ssm)
            caches["shared_attn"] = _stack_caches(kv, empty_kv)
    elif fam in ("dense", "vlm"):
        x, rest = run(x, _unstack(params["layers"]), "layers",
                      ("attn", "mlp"), _dense_block, attn)
        if want_caches:
            caches["layers"] = _stack_caches(kept(rest))
    else:
        raise ValueError(f"the {fam!r} family runs an encoder and a decoder "
                         f"(_encoder, _decoder), not one layer stack")
    return x, caches, aux_total


def _backbone(params, x, cfg: ModelConfig, rt: Runtime, positions):
    """The layer stacks' output for training (no caches, aux dropped)."""
    return _layer_stack(params, x, cfg, rt, positions)[0]


def _positions(x, sh=None):
    """The positions of ``x``'s tokens (of the rank's block under a
    mesh)."""
    pos = torch.arange(x.shape[1], device=x.device)
    if sh is not None and sh.seq:
        pos = pos + sh.model_rank * x.shape[1]
    return pos[None].expand(x.shape[:2])


def _encoder(params, enc_in, cfg: ModelConfig, rt: Runtime, sh=None):
    """The enc-dec encoder: dense blocks with non-causal attention."""
    plan = _model_plan(cfg)
    bp = _block_pols(plan, "enc_layers", "attn", "mlp")
    enc_cfg = cfg.with_(causal=False)
    positions = _positions(enc_in, sh)

    def attn(ap, h, pol):
        return _attn_fwd(ap, h, enc_cfg, pol, positions, sh)
    blk = _maybe_remat(
        lambda h, lp: _dense_block(lp if sh is None else
                                   sh.full(lp, "enc_layers"), h, enc_cfg,
                                   bp, attn)[0], cfg)
    x = enc_in
    for lp in _unstack(params["enc_layers"]):
        x = blk(x, lp)
    return x


def _decoder(params, x, enc_out, cfg: ModelConfig, rt: Runtime, positions,
             want_caches: bool = True, sh=None, enc_sh=None):
    """The enc-dec decoder stack → (x, (self KV, cross KV) stacked along
    the layer axis, or None)."""
    plan = _model_plan(cfg)
    bp = _block_pols(plan, "layers", "attn", "mlp", "xattn")

    def attn(ap, h, pol):
        return _attn_fwd(ap, h, cfg, pol, positions, sh)
    blk = _maybe_remat(
        lambda h, lp: _xattn_block(lp if sh is None else sh.full(lp, "layers"),
                                   h, cfg, bp, attn, enc_out, sh, enc_sh),
        cfg)
    out = []
    for lp in _unstack(params["layers"]):
        x, c = blk(x, lp)
        if want_caches:
            out.append(c)
    if not want_caches:
        return x, None
    return x, (_stack_caches([c for c, _ in out]),
               _stack_caches([c for _, c in out]))


def _enc_dec(params, batch, cfg, plan, rt, want_caches):
    """Encoder then decoder: (decoder output, decoder caches, enc_out).
    The encoder's input is ``frontend_proj`` of the stub frontend's
    embeddings (audio), else the embedded ``enc_tokens``."""
    emb_pol = plan.runtime_for("emb")
    if cfg.frontend:
        fpol = plan.runtime_for("frontend")
        fe = batch["frontend_embeds"]
        enc_sh = rt.sharded(fe.shape[1])
        enc_in = fpol.linear(fe.to(fpol.dtype),
                             _full(params, "frontend_proj", enc_sh))
        if enc_sh is not None:
            enc_in = enc_sh.own_seq(enc_in)
    else:
        enc_sh = rt.sharded(batch["enc_tokens"].shape[1])
        enc_in = embed_tokens(params["emb"], batch["enc_tokens"], emb_pol,
                              rt)
    enc_out = _encoder(params, enc_in, cfg, rt, enc_sh)
    sh = rt.sharded(batch["tokens"].shape[1])
    x = embed_tokens(params["emb"], batch["tokens"], emb_pol, rt)
    x, caches = _decoder(params, x, enc_out, cfg, rt, _positions(x, sh),
                         want_caches=want_caches, sh=sh, enc_sh=enc_sh)
    return x, caches, enc_out, sh


# ------------------------------------------------------------- API -------
def loss_fn(params, batch, cfg: ModelConfig, rt: Runtime = Runtime()):
    """Mean next-token CE + 0.01 · the MoE load-balance aux term (zero
    outside the moe family).  batch: tokens, labels[, frontend_embeds |
    enc_tokens], tensors on the parameters' device; the enc-dec loss is
    over the decoder tokens."""
    plan = _model_plan(cfg)
    if cfg.family in ("encdec", "audio"):
        x, _, _, sh = _enc_dec(params, batch, cfg, plan, rt,
                               want_caches=False)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        sh = _stream(batch, cfg, rt)
        x = _embed_inputs(params, batch, cfg, plan, rt)
        x, _, aux = _layer_stack(params, x, cfg, rt, _positions(x, sh),
                                 sh=sh)
    x = apply_norm(_full(params, "final_norm", sh), x, cfg)
    labels = batch["labels"]
    # the frontend prefix carries no loss
    s = x.shape[1] * (sh.tp if sh is not None and sh.seq else 1)
    loss = chunked_ce_loss(x, params["emb"], labels,
                           plan.runtime_for("head"), cfg, rt=sh,
                           offset=s - labels.shape[1])
    return loss + 0.01 * aux


def prefill(params, batch, cfg: ModelConfig, rt: Runtime = Runtime()):
    """Run the full prompt; return last-position logits (B, 1, V) and the
    per-stack caches (stacked along the layer axis; enc-dec:
    ``{"layers": (self KV, cross KV), "enc_out"}``)."""
    plan = _model_plan(cfg)
    if cfg.family in ("encdec", "audio"):
        x, dec, enc_out, sh = _enc_dec(params, batch, cfg, plan, rt,
                                       want_caches=True)
        caches = {"layers": dec, "enc_out": enc_out}
    else:
        sh = _stream(batch, cfg, rt)
        x = _embed_inputs(params, batch, cfg, plan, rt)
        x, caches, _ = _layer_stack(params, x, cfg, rt, _positions(x, sh),
                                    want_caches=True, sh=sh)
    if sh is not None and not sh.seq:
        raise ValueError(f"prefill under a mesh needs a sequence that "
                         f"divides the {rt.model_axis!r} axis ({sh.tp}), so "
                         f"that the caches take the cache_specs layout")
    x = x[:, -1:] if sh is None else sh.gather_seq(x[:, -1:])[:, -1:]
    x = apply_norm(_full(params, "final_norm", sh), x, cfg)
    return lm_logits(params["emb"], x, plan.runtime_for("head"), cfg,
                     sh), caches


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, enc_len: "int | None" = None,
                       device="cuda"):
    """Empty fixed-capacity caches for decode, on ``device``: KV stacks,
    Mamba2 state stacks (``ssm.SSMCache``), and for enc-dec the ``(self
    KV, cross KV)`` pair over ``enc_len`` frames (``max_len`` when None)
    with an ``enc_out`` of zeros."""
    _check_family(cfg, "init_decode_caches")
    device = _device(device)

    def stack(one, n):
        return type(one)(*(t.expand((n,) + t.shape).clone() for t in one))

    def stack_kv(n):
        return stack(make_cache(cfg, batch, max_len, dtype, device), n)

    def stack_ssm(n):
        return stack(make_ssm_cache(cfg, batch, dtype, device), n)

    fam = cfg.family
    if fam == "moe":
        fd = cfg.moe.first_dense_layers
        return {"dense_layers": stack_kv(max(fd, 1)),
                "layers": stack_kv(max(cfg.layers - fd, 1))}
    if fam == "ssm":
        return {"layers": stack_ssm(cfg.layers)}
    if fam == "hybrid":
        groups, k, tail = _hybrid_split(cfg)
        out = {"layers": stack_ssm(groups * k),
               "shared_attn": stack_kv(groups)}
        if tail:
            out["tail_layers"] = stack_ssm(tail)
        return out
    if fam in ("encdec", "audio"):
        n = cfg.encdec.n_dec_layers
        enc_len = enc_len or max_len
        xkv = make_cache(cfg.with_(attn_kind="gqa"), batch, enc_len, dtype,
                         device)
        return {"layers": (stack_kv(n), stack(xkv, n)),
                "enc_out": torch.zeros((batch, enc_len, cfg.d_model),
                                       dtype=dtype, device=device)}
    return {"layers": stack_kv(cfg.layers)}


_CACHE_TYPES = {KVCache._fields: KVCache, SSMCache._fields: SSMCache}


def _cache_tree(tree, leaf):
    """``tree`` rebuilt with ``leaf`` on every array; any namedtuple with
    the fields of ``KVCache`` or ``SSMCache`` (the JAX package's or this
    package's) becomes this package's."""
    if isinstance(tree, dict):
        return {k: _cache_tree(v, leaf) for k, v in tree.items()}
    fields = getattr(type(tree), "_fields", None)
    if fields is not None:
        if fields not in _CACHE_TYPES:
            raise TypeError(f"a cache namedtuple with fields {fields}")
        return _CACHE_TYPES[fields](*(leaf(v) for v in tree))
    if type(tree) in (list, tuple):
        return type(tree)(_cache_tree(v, leaf) for v in tree)
    return leaf(tree)


def caches_from_numpy(tree, device="cuda"):
    """The JAX package's decode caches (``init_decode_caches``,
    ``prefill``, ``decode_step``), as numpy arrays, as this package's on
    ``device``: the same dicts and tuples, its ``KVCache`` and
    ``SSMCache`` namedtuples as this package's.  (A namedtuple is a leaf
    of :mod:`repro_torch.pytree` and a node of JAX's trees, so
    :func:`params_from_numpy` cannot carry caches.)"""
    device = resolve_device(device)
    return _cache_tree(
        tree, lambda a: torch.as_tensor(np.asarray(a)).to(device))


def caches_to_numpy(caches):
    """This package's decode caches as numpy arrays, in the same tree (the
    inverse of :func:`caches_from_numpy`); the JAX package's functions
    take them as they take their own."""
    return _cache_tree(caches, lambda t: t.detach().cpu().numpy())


class _ServePol:
    """Serving view of a layer's numerics runtime.

    Its float reductions are ``layers.ORDER_FREE`` (``fl``).  With
    ``infer`` (the paged pair) matmuls route through
    ``LNSRuntime.linear_infer`` — the fused forward ⊞-MAC
    (``matmul_fused``, kernel row 1) on the LNS kernel paths,
    bit-identical to ``linear``'s forward — with no autograd machinery;
    without it (the dense decode oracle) through the runtime's ``linear``.
    Everything else forwards to the wrapped runtime.
    """

    __slots__ = ("rt", "linear")
    fl = ORDER_FREE

    def __init__(self, rt, infer: bool):
        self.rt = rt
        self.linear = rt.linear_infer if infer else rt.linear

    def q_param(self, w):
        return self.rt.q_param(w)

    def q_act(self, x):
        return self.rt.q_act(x)

    @property
    def dtype(self):
        return self.rt.dtype

    @property
    def name(self):
        return self.rt.name


def _serve_pols(bp: BlockPols, infer: bool) -> BlockPols:
    return BlockPols(**{
        f.name: (_ServePol(v, infer) if v is not None else None)
        for f in dataclasses.fields(BlockPols)
        for v in [getattr(bp, f.name)]})


def _kv_split(rt: Runtime) -> KVSplit:
    """This rank's share of the decode caches under a mesh whose model
    axis has more than one rank (the ``cache_specs`` block; the model
    group's max and sum all-reduces and its all-gather);
    ``attention.WHOLE`` otherwise, when the caches are whole."""
    if rt.mesh is None:
        return WHOLE
    import torch.distributed as dist
    from ..distributed.sharding import axis_group, axis_rank
    from ..distributed.spmd import all_gather_raw, all_reduce_raw
    grp = axis_group(rt.mesh, rt.model_axis)
    if grp is None:
        return WHOLE
    return KVSplit(axis_rank(rt.mesh, rt.model_axis), rt.tp,
                   functools.partial(all_reduce_raw, group=grp,
                                     op=dist.ReduceOp.MAX),
                   functools.partial(all_reduce_raw, group=grp),
                   functools.partial(all_gather_raw, group=grp))


def _serve(params, tok, caches, cfg, rt, infer, attn, split=WHOLE,
           last=None, donate=False):
    """One serving forward: embed ``tok``, run every layer stack through
    the serving views (:class:`_ServePol`) with ``attn(lp, h, pol, cache)
    → (out, cache)`` and the Mamba2 decode step, then the final norm and
    the head at the positions ``last`` keeps (all when None).  The moe
    family's dense stack runs every one of its layers, as the JAX
    package's decode does; the hybrid's Mamba2 caches stay flat
    (``groups · attn_every`` layers); the enc-dec cross cache passes
    through unchanged (K and V are recomputed from ``enc_out``).

    Under a mesh the caches come and go in the ``cache_specs`` layout
    (the pool's for the paged steps), and no leaf is gathered over the
    model axis: each rank steps its own share (``split``, the callers'
    :func:`_kv_split`).  ``attn`` gets the rank's block of a layer's KV
    cache and combines its attention over the axis; the Mamba2 step its
    block of the channels and heads (``ssm.mamba2_decode``); the
    cross-attention its frames of ``enc_out`` (:func:`_cross_attention`).
    The tokens are replicated over the model axis, the weights gathered
    around their use, the MoE layers' experts split over it.

    With ``donate`` (the JAX package's ``donate_argnums``) each layer's new
    cache goes into that layer's slice of the stacked input caches (under
    a mesh: the rank's own block), and the caches returned are the input
    tensors: no second stack of caches is built.  ``attn`` then writes
    its KV lines in place; a Mamba2 cache is copied in.  Returns
    (logits, new caches)."""
    plan = _model_plan(cfg)
    sh = rt.sharded(tok.shape[1])
    if sh is not None:
        sh = sh.with_seq(False)
    x = embed_tokens(params["emb"], tok,
                     _ServePol(plan.runtime_for("emb"), infer), rt,
                     scatter=False)
    new_caches = dict(caches)

    def run(x, lps, cs, prefix, kinds, block, fn):
        bp = _serve_pols(_block_pols(plan, prefix, *kinds), infer)
        out = []
        for lp, c in zip(lps, cs):
            if sh is not None:
                lp = sh.full(lp, prefix)
            x, c2 = block(lp, x, cfg, bp,
                          lambda p_, h, pol, c=c: fn(p_, h, pol, c))[:2]
            if donate:
                with torch.no_grad():
                    for old, new in zip(c, c2):
                        if new is not old:
                            old.copy_(new)
                c2 = c
            out.append(c2)
        return x, out

    def mamba(mp, h, pol, c):
        return mamba2_decode(mp, h, cfg, pol, c, split)

    def stack(prefix, kinds, block, fn):
        nonlocal x
        x, out = run(x, _unstack(params[prefix]),
                     _layer_caches(caches[prefix]), prefix, kinds, block, fn)
        new_caches[prefix] = caches[prefix] if donate else \
            _stack_caches(out)

    fam = cfg.family
    if fam == "moe":
        stack("dense_layers", ("attn", "mlp"), _dense_block, attn)
        stack("layers", ("attn", "moe"),
              functools.partial(_moe_layer_fwd, sh=sh), attn)
    elif fam == "ssm":
        stack("layers", ("mamba",), _ssm_block, mamba)
    elif fam == "hybrid":
        groups, k, _ = _hybrid_split(cfg)
        lps, cs = _unstack(params["layers"]), _layer_caches(caches["layers"])
        shared = _layer_caches(caches["shared_attn"])
        ssm_c, kv = [], []
        for g in range(groups):
            x, out = run(x, lps[g * k:(g + 1) * k], cs[g * k:(g + 1) * k],
                         "layers", ("mamba",), _ssm_block, mamba)
            ssm_c += out
            x, out = run(x, [params["shared_attn"]], shared[g:g + 1],
                         "shared_attn", ("attn", "mlp"), _dense_block, attn)
            kv += out
        if not donate:
            new_caches["layers"] = _stack_caches(ssm_c, caches["layers"])
            new_caches["shared_attn"] = _stack_caches(kv,
                                                      caches["shared_attn"])
        if "tail_layers" in params:
            stack("tail_layers", ("mamba",), _ssm_block, mamba)
    elif fam in ("encdec", "audio"):
        self_c, cross_c = caches["layers"]

        def block(lp, h, cfg_, bp, fn):
            h, (c, _) = _xattn_block(lp, h, cfg_, bp, fn, caches["enc_out"],
                                     split=split)
            return h, c
        x, out = run(x, _unstack(params["layers"]), _layer_caches(self_c),
                     "layers", ("attn", "mlp", "xattn"), block, attn)
        if not donate:
            new_caches["layers"] = (_stack_caches(out), cross_c)
    else:
        stack("layers", ("attn", "mlp"), _dense_block, attn)
    if last is not None:
        x = x[:, last]
    x = apply_norm(_full(params, "final_norm", sh), x, cfg, fl=ORDER_FREE)
    logits = lm_logits(params["emb"], x,
                       _ServePol(plan.runtime_for("head"), infer), cfg, sh)
    return logits, new_caches


def decode_step(params, tok, caches, pos, cfg: ModelConfig,
                rt: Runtime = Runtime(), donate: bool = False):
    """One token for every sequence in the batch, against the dense
    fixed-capacity caches (:func:`init_decode_caches`); matmuls through
    the runtimes' ``linear``.

    tok: (B, 1) int32; pos: (B,) int32 current positions.
    Returns (logits (B, 1, V), new caches).  With ``donate`` the new
    caches are written into ``caches``, which are returned (see
    :func:`_serve`); bit-equal to ``donate=False``.
    """
    _check_family(cfg, "decode_step")
    split = _kv_split(rt)
    return _serve(params, tok, caches, cfg, rt, False,
                  lambda ap, h, pol, c: _attn_dec(ap, h, cfg, pol, c, pos,
                                                  split, donate),
                  split, donate=donate)


# ------------------------------------------------- paged serving ---------

def _check_paged(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(f"{what}: unsupported family {cfg.family!r} "
                         f"(supported: {PAGED_FAMILIES})")


def init_paged_caches(cfg: ModelConfig, num_blocks: int, block_size: int,
                      dtype=torch.bfloat16, device="cuda"):
    """Empty paged decode caches: per-stack page pools, shared block ids.

    Every layer owns ``num_blocks`` physical blocks addressed by ONE
    block-table space (a slot's logical block *i* lives at the same
    physical id in every layer) — allocation happens once per logical
    block, in :class:`~repro_torch.serve.paged_cache.BlockManager`.
    """
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(
            f"family {cfg.family!r} has no paged KV cache (supported: "
            f"{PAGED_FAMILIES}); serve it via the dense path "
            f"(init_decode_caches / reference_generate)")
    device = _device(device)

    def stack(n):
        one = make_paged_cache(cfg, num_blocks, block_size, dtype, device)
        return KVCache(*(t.expand((n,) + t.shape).clone() for t in one))

    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        return {"dense_layers": stack(max(fd, 1)),
                "layers": stack(max(cfg.layers - fd, 1))}
    return {"layers": stack(cfg.layers)}


def _attn_dec_paged(lp, x, cfg, pol, cache, bt, pos, active, write, split):
    if cfg.attn_kind == "mla":
        return mla_decode_paged(lp, x, cfg, pol, cache, bt, pos, active,
                                write, split)
    return gqa_decode_paged(lp, x, cfg, pol, cache, bt, pos, active, write,
                            split)


def _attn_prefill_paged(lp, x, cfg, pol, cache, bt_row, pos_base, n_valid,
                        split):
    if cfg.attn_kind == "mla":
        return mla_prefill_paged(lp, x, cfg, pol, cache, bt_row, pos_base,
                                 n_valid, split)
    return gqa_prefill_paged(lp, x, cfg, pol, cache, bt_row, pos_base,
                             n_valid, split)


def decode_step_paged(params, tok, caches, bt, pos, active,
                      cfg: ModelConfig, rt: Runtime = Runtime(),
                      donate: bool = False):
    """One token for every slot against the paged KV cache.

    tok: (B, 1) int32; bt: (B, W) block tables; pos: (B,) int32; active:
    (B,) bool — inactive slots (free, or mid-prefill) write to the null
    block and their logits are meaningless.  Matmuls run the fused-infer
    numerics path (:class:`_ServePol`).  Returns (logits (B, 1, V), new
    caches).

    Under a mesh every rank holds its data block of the slots and its
    share of each block's lines (the model axis splits them), and the
    pool, replicated over the data axes, takes every data rank's new
    lines that the rank holds, so that each replica holds its share of
    what the one-device pool holds.

    With ``donate`` the lines are written into the pool in place and the
    input caches are returned (see :func:`_serve`).
    """
    _check_paged(cfg, "decode_step_paged")
    split = _kv_split(rt)
    write = token_writer(bt, pos, active, split, donate, None
                         if rt.mesh is None else
                         rt.sharded(tok.shape[1]).gather_data)
    return _serve(params, tok, caches, cfg, rt, True,
                  lambda ap, h, pol, c: _attn_dec_paged(ap, h, cfg, pol, c,
                                                        bt, pos, active,
                                                        write, split),
                  split, donate=donate)


def prefill_chunk(params, tok, caches, bt_row, pos_base, n_valid,
                  cfg: ModelConfig, rt: Runtime = Runtime()):
    """One chunked-prefill step for ONE slot: splice C cache lines, return
    the logits at the last valid position.

    tok: (1, C) int32 — a prompt chunk at logical positions ``pos_base +
    arange(C)``, padded beyond ``n_valid``.  KV lines are written directly
    into the slot's pages (cache splice) — prompt tokens never pass
    through the batched decode step.  Returns (logits (1, 1, V), new
    caches); the logits are those of position ``pos_base + n_valid - 1``
    (what the first sampled continuation token conditions on).  Under a
    mesh each rank writes the chunk's lines it holds and attends over
    its share of the pool (:func:`decode_step_paged`).
    """
    _check_paged(cfg, "prefill_chunk")
    # Only the last valid position's logits matter: slicing before the
    # head keeps the head's product at (1, 1, d) whatever the chunk.
    last = max(int(n_valid) - 1, 0)
    split = _kv_split(rt)
    return _serve(params, tok, caches, cfg, rt, True,
                  lambda ap, h, pol, c: _attn_prefill_paged(
                      ap, h, cfg, pol, c, bt_row, pos_base, n_valid, split),
                  split, last=slice(last, last + 1))

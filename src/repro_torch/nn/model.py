"""Model assembly of the dense, vlm and moe transformer families.

Entry points (``params`` from :func:`init_params`, or the JAX package's
carried across by :func:`params_from_numpy`):

  loss_fn(params, batch, cfg, rt)            train:   mean CE (+ MoE aux)
  prefill(params, batch, cfg, rt)            prefill: last-pos logits + caches
  decode_step(params, tok, caches, pos, cfg) decode:  next logits + caches
  decode_step_paged / prefill_chunk          the serving engine's paged pair

``params`` is the JAX package's nested parameter dict, holding tensors:
each layer stack is stacked along a leading axis (``params["layers"]``,
and the moe family's leading dense layers in ``params["dense_layers"]``),
and a Python loop over that axis takes the place of ``lax.scan``, with the
same results.  ``cfg.remat == "block"`` recomputes each block in backward
(``torch.utils.checkpoint``, non-reentrant); the ⊞-MAC kernels are
deterministic, so the results do not change.

Numerics are a per-layer property: ``cfg.numerics`` parses as a
:class:`~repro_torch.core.plan.NumericsPlan` whose glob rules match the
dotted layer paths of :func:`known_layer_paths` (``emb``, ``layers.attn``,
``layers.mlp``, ``layers.moe``, ``dense_layers.*``, ``head``); each
component receives the runtime its resolved spec describes.  The paged
serving pair routes every matmul through the runtime's ``linear_infer``
(:class:`_ServePol`), the fused forward ⊞-MAC on the LNS paths.

The serving functions (the decode steps and ``prefill_chunk``) hand every
component the serving view of its runtime (:class:`_ServePol`), which
takes the float reductions (norms, attention, MoE routing and routed
experts) in the order-free float64 form of ``layers.ORDER_FREE``, so that
a token's logits do not depend on the batch, chunk or cache width it is
computed in.  Under the LNS specs every weight product is a ⊞-MAC, whose
order is fixed, and the paged engine then reproduces the dense
token-by-token oracle exactly; under the float specs the weight products
are float32 matmuls, which round by shape, and the two agree only up to
those roundings.

Ported: the ``dense``, ``vlm`` and ``moe`` families (GQA and MLA
attention) on one device.  The ssm, hybrid and encdec/audio families
raise ``NotImplementedError`` naming ROADMAP queue 1 item 11; a
:class:`Runtime` with a mesh raises naming item 13.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.numerics import get_plan
from ..core.spec import TORCH_DTYPES
from ..devices import resolve_device
from ..pytree import tree_flatten, tree_map, tree_unflatten
from .attention import (KVCache, gqa_attention, gqa_decode,
                        gqa_decode_paged, gqa_prefill_paged, init_gqa,
                        init_mla, make_cache, make_paged_cache,
                        mla_attention, mla_decode, mla_decode_paged,
                        mla_prefill_paged)
from .config import ModelConfig
from .layers import (ORDER_FREE, _normal, apply_mlp, apply_norm,
                     chunked_ce_loss, embed_tokens, float_ops,
                     init_embeddings, init_mlp, init_norm, lm_logits)
from .moe import init_moe, moe_block


#: Families whose training and serving paths this port builds.
PORTED_FAMILIES = ("dense", "vlm", "moe")

#: Families the paged serving data plane supports: every per-layer cache
#: is a KVCache growing along the sequence axis.
PAGED_FAMILIES = ("dense", "vlm", "moe")


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported (ROADMAP queue 1 "
                               f"item {item})")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Distribution context.  ``mesh=None`` is the single-device mode, the
    only one ported: a mesh raises (ROADMAP queue 1 item 13)."""
    mesh: Optional[Any] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise _unported("Runtime(mesh=...): sharded execution", "13")


# ----------------------------------------------- per-layer numerics ------
@dataclasses.dataclass(frozen=True)
class BlockPols:
    """The per-component numerics runtimes one block consumes, resolved
    from the model's plan at a layer-path prefix (``layers.attn``,
    ``layers.mlp``, ``layers.moe``, ...).  Components whose resolved specs
    are equal share one cached runtime."""
    attn: Any = None
    mlp: Any = None
    moe: Any = None


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
        raise _unported(f"{what} of the {cfg.family!r} family", "11")
    if cfg.attn_kind not in ("gqa", "mla"):
        raise _unported(f"{what} with attn_kind={cfg.attn_kind!r}", "11")


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


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_params(key, cfg: ModelConfig, device="cuda"):
    """Fresh parameters of a dense, vlm or moe config on ``device``.

    ``key`` is a seed or a ``torch.Generator`` (drawn on its own device,
    then moved).  The tree, shapes, dtypes and per-leaf standard deviations
    are the JAX package's; the values are torch's draws (threefry is not
    matched): carry the reference's values across with
    :func:`params_from_numpy`.  The moe family stacks ``max(fd, 1)``
    dense layers and ``max(layers - fd, 1)`` MoE layers, as the JAX
    package does (``fd = moe.first_dense_layers``).
    """
    device = resolve_device(device)
    _check_family(cfg, "init_params")
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key))
    dtype = TORCH_DTYPES[cfg.param_dtype]
    p: dict = {"emb": init_embeddings(gen, cfg, dtype),
               "final_norm": init_norm(cfg, dtype, gen.device)}
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        p["dense_layers"] = _stack([_init_dense_layer(gen, cfg, dtype)
                                    for _ in range(max(fd, 1))])
        p["layers"] = _stack([_init_moe_layer(gen, cfg, dtype)
                              for _ in range(max(cfg.layers - fd, 1))])
    else:
        p["layers"] = _stack([_init_dense_layer(gen, cfg, dtype)
                              for _ in range(cfg.layers)])
        if cfg.frontend:
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


def _attn_dec(lp, x, cfg, pol, cache, pos):
    if cfg.attn_kind == "mla":
        return mla_decode(lp, x, cfg, pol, cache, pos)
    return gqa_decode(lp, x, cfg, pol, cache, pos)


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


def _moe_layer_fwd(lp, x, cfg, bp: BlockPols, attn):
    fl = float_ops(bp.attn)
    a, cache = attn(lp["attn"], apply_norm(lp["norm1"], x, cfg, fl=fl),
                    bp.attn)
    x = x + _res(x, a)
    y, aux = moe_block(lp["moe"], apply_norm(lp["norm2"], x, cfg, fl=fl),
                       cfg, bp.moe)
    return x + _res(x, y), cache, aux


def _unstack(stacked) -> list:
    """A stacked layer tree → one tree per layer (views; their gradients
    stack back in one op)."""
    leaves, treedef = tree_flatten(stacked)
    parts = [t.unbind(0) for t in leaves]
    return [tree_unflatten(treedef, [p[i] for p in parts])
            for i in range(leaves[0].shape[0])]


def _stack_caches(caches: list) -> KVCache:
    """Per-layer caches → one KVCache stacked along a leading layer axis,
    as ``lax.scan`` stacks them."""
    return KVCache(torch.stack([c.k for c in caches]),
                   torch.stack([c.v for c in caches]))


def _layer_caches(stacked: KVCache) -> list:
    return [KVCache(k, v) for k, v in zip(stacked.k.unbind(0),
                                          stacked.v.unbind(0))]


def _maybe_remat(fn, cfg):
    if cfg.remat != "block":
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------- forward ------
def _embed_inputs(params, batch, cfg, plan, rt=None):
    """tokens (+ optional stub frontend embeds) → (B, S, d)."""
    x = embed_tokens(params["emb"], batch["tokens"], plan.runtime_for("emb"),
                     rt)
    if cfg.frontend and "frontend_embeds" in batch:
        fpol = plan.runtime_for("frontend")
        fe = fpol.linear(batch["frontend_embeds"].to(fpol.dtype),
                         params["frontend_proj"])
        x = torch.cat([fe.to(x.dtype), x], dim=1)
    return x


def _layer_stack(params, x, cfg: ModelConfig, rt: Runtime, positions,
                 want_caches: bool = False):
    """Full-sequence pass through the layer stacks → (x, caches, aux).

    ``want_caches=False`` (training) keeps no per-layer KV cache; the moe
    family runs its ``first_dense_layers`` dense layers, then the MoE
    layers, and sums their load-balance aux terms."""
    _check_family(cfg, "the layer stack")
    plan = _model_plan(cfg)
    caches = {}

    def attn(ap, h, pol):
        return _attn_fwd(ap, h, cfg, pol, positions, rt)

    def run_dense(x, stack, n, prefix):
        bp = _block_pols(plan, prefix, "attn", "mlp")
        blk = _maybe_remat(
            lambda h, lp: _dense_block(lp, h, cfg, bp, attn), cfg)
        kv = []
        for lp in _unstack(stack)[:n]:
            x, c = blk(x, lp)
            if want_caches:
                kv.append(c)
        return x, kv

    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        x, dense_kv = run_dense(x, params["dense_layers"], fd,
                                "dense_layers")
        bp = _block_pols(plan, "layers", "attn", "moe")
        blk = _maybe_remat(
            lambda h, lp: _moe_layer_fwd(lp, h, cfg, bp, attn), cfg)
        kv, auxs = [], []
        for lp in _unstack(params["layers"]):
            x, c, aux = blk(x, lp)
            if want_caches:
                kv.append(c)
            auxs.append(aux)
        if want_caches:
            caches["layers"] = _stack_caches(kv)
            if dense_kv:
                caches["dense_layers"] = _stack_caches(dense_kv)
        aux_total = torch.stack(auxs).sum()
    else:
        x, kv = run_dense(x, params["layers"], None, "layers")
        if want_caches:
            caches["layers"] = _stack_caches(kv)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, caches, aux_total


def _backbone(params, x, cfg: ModelConfig, rt: Runtime, positions):
    """The layer stacks' output for training (no caches, aux dropped)."""
    return _layer_stack(params, x, cfg, rt, positions)[0]


def _positions(x):
    return torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[:2])


# ------------------------------------------------------------- API -------
def loss_fn(params, batch, cfg: ModelConfig, rt: Runtime = Runtime()):
    """Mean next-token CE + 0.01 · the MoE load-balance aux term (zero
    outside the moe family).  batch: tokens, labels[, frontend_embeds],
    tensors on the parameters' device."""
    if cfg.family in ("encdec", "audio"):
        raise _unported(f"loss_fn of the {cfg.family!r} family", "11")
    plan = _model_plan(cfg)
    x = _embed_inputs(params, batch, cfg, plan, rt)
    x, _, aux = _layer_stack(params, x, cfg, rt, _positions(x))
    x = apply_norm(params["final_norm"], x, cfg)
    labels = batch["labels"]
    if x.shape[1] != labels.shape[1]:  # frontend prefix carries no loss
        x = x[:, x.shape[1] - labels.shape[1]:]
    loss = chunked_ce_loss(x, params["emb"], labels,
                           plan.runtime_for("head"), cfg, rt=rt)
    return loss + 0.01 * aux


def prefill(params, batch, cfg: ModelConfig, rt: Runtime = Runtime()):
    """Run the full prompt; return last-position logits (B, 1, V) and the
    per-stack KV caches (stacked along the layer axis)."""
    if cfg.family in ("encdec", "audio"):
        raise _unported(f"prefill of the {cfg.family!r} family", "11")
    plan = _model_plan(cfg)
    x = _embed_inputs(params, batch, cfg, plan, rt)
    x, caches, _ = _layer_stack(params, x, cfg, rt, _positions(x),
                                want_caches=True)
    x = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return lm_logits(params["emb"], x, plan.runtime_for("head"), cfg), caches


def _check_serving(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise _unported(f"{what} of the {cfg.family!r} family (its decode "
                        f"caches)", "11")


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, enc_len: "int | None" = None,
                       device="cuda"):
    """Empty fixed-capacity caches for decode, on ``device``."""
    _check_serving(cfg, "init_decode_caches")
    device = resolve_device(device)

    def stack_kv(n):
        one = make_cache(cfg, batch, max_len, dtype, device)
        return KVCache(*(t.expand((n,) + t.shape).clone() for t in one))

    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        return {"dense_layers": stack_kv(max(fd, 1)),
                "layers": stack_kv(max(cfg.layers - fd, 1))}
    return {"layers": stack_kv(cfg.layers)}


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


def _serve(params, tok, caches, cfg, rt, infer, attn, last=None):
    """One serving forward: embed ``tok``, run every layer stack through
    the serving views (:class:`_ServePol`) with ``attn(lp, h, pol, cache)
    → (out, cache)``, then the final norm and the head at the positions
    ``last`` keeps (all when None).  The moe family's dense stack runs
    every one of its layers, as the JAX package's decode does.  Returns
    (logits, new caches)."""
    plan = _model_plan(cfg)
    x = embed_tokens(params["emb"], tok,
                     _ServePol(plan.runtime_for("emb"), infer), rt)
    new_caches = dict(caches)
    stacks = [("layers", ("attn", "mlp"), _dense_block)]
    if cfg.family == "moe":
        stacks = [("dense_layers", ("attn", "mlp"), _dense_block),
                  ("layers", ("attn", "moe"), _moe_layer_fwd)]
    for prefix, kinds, block in stacks:
        bp = _serve_pols(_block_pols(plan, prefix, *kinds), infer)
        out = []
        for lp, c in zip(_unstack(params[prefix]),
                         _layer_caches(caches[prefix])):
            x, c2 = block(lp, x, cfg, bp,
                          lambda ap, h, pol, c=c: attn(ap, h, pol, c))[:2]
            out.append(c2)
        new_caches[prefix] = _stack_caches(out)
    if last is not None:
        x = x[:, last]
    x = apply_norm(params["final_norm"], x, cfg, fl=ORDER_FREE)
    return lm_logits(params["emb"], x,
                     _ServePol(plan.runtime_for("head"), infer), cfg), \
        new_caches


def decode_step(params, tok, caches, pos, cfg: ModelConfig,
                rt: Runtime = Runtime()):
    """One token for every sequence in the batch, against the dense
    fixed-capacity caches; matmuls through the runtimes' ``linear``.

    tok: (B, 1) int32; pos: (B,) int32 current positions.
    Returns (logits (B, 1, V), new caches).
    """
    _check_serving(cfg, "decode_step")
    return _serve(params, tok, caches, cfg, rt, False,
                  lambda ap, h, pol, c: _attn_dec(ap, h, cfg, pol, c, pos))


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
    device = resolve_device(device)

    def stack(n):
        one = make_paged_cache(cfg, num_blocks, block_size, dtype, device)
        return KVCache(*(t.expand((n,) + t.shape).clone() for t in one))

    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        return {"dense_layers": stack(max(fd, 1)),
                "layers": stack(max(cfg.layers - fd, 1))}
    return {"layers": stack(cfg.layers)}


def _attn_dec_paged(lp, x, cfg, pol, cache, bt, pos, active):
    if cfg.attn_kind == "mla":
        return mla_decode_paged(lp, x, cfg, pol, cache, bt, pos, active)
    return gqa_decode_paged(lp, x, cfg, pol, cache, bt, pos, active)


def _attn_prefill_paged(lp, x, cfg, pol, cache, bt_row, pos_base, n_valid):
    if cfg.attn_kind == "mla":
        return mla_prefill_paged(lp, x, cfg, pol, cache, bt_row, pos_base,
                                 n_valid)
    return gqa_prefill_paged(lp, x, cfg, pol, cache, bt_row, pos_base,
                             n_valid)


def decode_step_paged(params, tok, caches, bt, pos, active,
                      cfg: ModelConfig, rt: Runtime = Runtime()):
    """One token for every slot against the paged KV cache.

    tok: (B, 1) int32; bt: (B, W) block tables; pos: (B,) int32; active:
    (B,) bool — inactive slots (free, or mid-prefill) write to the null
    block and their logits are meaningless.  Matmuls run the fused-infer
    numerics path (:class:`_ServePol`).  Returns (logits (B, 1, V), new
    caches).
    """
    _check_paged(cfg, "decode_step_paged")
    return _serve(params, tok, caches, cfg, rt, True,
                  lambda ap, h, pol, c: _attn_dec_paged(ap, h, cfg, pol, c,
                                                        bt, pos, active))


def prefill_chunk(params, tok, caches, bt_row, pos_base, n_valid,
                  cfg: ModelConfig, rt: Runtime = Runtime()):
    """One chunked-prefill step for ONE slot: splice C cache lines, return
    the logits at the last valid position.

    tok: (1, C) int32 — a prompt chunk at logical positions ``pos_base +
    arange(C)``, padded beyond ``n_valid``.  KV lines are written directly
    into the slot's pages (cache splice) — prompt tokens never pass
    through the batched decode step.  Returns (logits (1, 1, V), new
    caches); the logits are those of position ``pos_base + n_valid - 1``
    (what the first sampled continuation token conditions on).
    """
    _check_paged(cfg, "prefill_chunk")
    # Only the last valid position's logits matter: slicing before the
    # head keeps the head's product at (1, 1, d) whatever the chunk.
    last = max(int(n_valid) - 1, 0)
    return _serve(params, tok, caches, cfg, rt, True,
                  lambda ap, h, pol, c: _attn_prefill_paged(
                      ap, h, cfg, pol, c, bt_row, pos_base, n_valid),
                  last=slice(last, last + 1))

"""Model assembly of the dense transformer family, for training.

    loss_fn(params, batch, cfg, rt)     mean next-token CE

``params`` is the JAX package's nested parameter dict, holding tensors:
the layer stack is stacked along a leading axis (``params["layers"]``),
and a Python loop over that axis takes the place of ``lax.scan``, with the
same results.  ``cfg.remat == "block"`` recomputes each block in backward
(``torch.utils.checkpoint``, non-reentrant); the ⊞-MAC kernels are
deterministic, so the results do not change.

Numerics are a per-layer property: ``cfg.numerics`` parses as a
:class:`~repro_torch.core.plan.NumericsPlan` whose glob rules match the
dotted layer paths of :func:`known_layer_paths` (``emb``, ``layers.attn``,
``layers.mlp``, ``head``); each component receives the runtime its
resolved spec describes.

Ported: the ``dense`` and ``vlm`` families' training path on one device.
The moe, ssm, hybrid and encdec/audio families, prefill, decode and the
paged cache raise ``NotImplementedError`` naming their ROADMAP item; a
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
from .attention import gqa_attention, init_gqa
from .config import ModelConfig
from .layers import (_normal, apply_mlp, apply_norm, chunked_ce_loss,
                     embed_tokens, init_embeddings, init_mlp, init_norm)


#: Families whose training path this port builds.
PORTED_FAMILIES = ("dense", "vlm")


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
    ``layers.mlp``, ...).  Components whose resolved specs are equal share
    one cached runtime."""
    attn: Any = None
    mlp: Any = None


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
    if cfg.attn_kind != "gqa":
        raise _unported(f"{what} with attn_kind={cfg.attn_kind!r}", "11")


# ------------------------------------------------------------- init ------
def _init_dense_layer(gen, cfg: ModelConfig, dtype):
    return {"attn": init_gqa(gen, cfg, dtype),
            "mlp": init_mlp(gen, cfg, cfg.d_ff, dtype),
            "norm1": init_norm(cfg, dtype, gen.device),
            "norm2": init_norm(cfg, dtype, gen.device)}


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_params(key, cfg: ModelConfig, device="cuda"):
    """Fresh parameters of a dense (or vlm) config on ``device``.

    ``key`` is a seed or a ``torch.Generator`` (drawn on its own device,
    then moved).  The tree, shapes, dtypes and per-leaf standard deviations
    are the JAX package's; the values are torch's draws (threefry is not
    matched): carry the reference's values across with
    :func:`params_from_numpy`.
    """
    device = resolve_device(device)
    _check_family(cfg, "init_params")
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key))
    dtype = TORCH_DTYPES[cfg.param_dtype]
    p: dict = {"emb": init_embeddings(gen, cfg, dtype),
               "final_norm": init_norm(cfg, dtype, gen.device),
               "layers": _stack([_init_dense_layer(gen, cfg, dtype)
                                 for _ in range(cfg.layers)])}
    if cfg.frontend:
        p["frontend_proj"] = _normal(gen, (cfg.d_model, cfg.d_model), dtype,
                                     cfg.d_model ** -0.5)
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


def _dense_block(lp, x, cfg, bp: BlockPols, rt, positions):
    if cfg.block_style == "parallel":      # command-r style
        h = apply_norm(lp["norm1"], x, cfg)
        a, _ = gqa_attention(lp["attn"], h, cfg, bp.attn, positions, rt)
        f = apply_mlp(lp["mlp"], h, cfg, bp.mlp)
        x = x + _res(x, a) + _res(x, f)
    else:
        a, _ = gqa_attention(lp["attn"], apply_norm(lp["norm1"], x, cfg),
                             cfg, bp.attn, positions, rt)
        x = x + _res(x, a)
        x = x + _res(x, apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg),
                                  cfg, bp.mlp))
    return x


def _unstack(stacked) -> list:
    """A stacked layer tree → one tree per layer (views; their gradients
    stack back in one op)."""
    leaves, treedef = tree_flatten(stacked)
    parts = [t.unbind(0) for t in leaves]
    return [tree_unflatten(treedef, [p[i] for p in parts])
            for i in range(leaves[0].shape[0])]


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


def _backbone(params, x, cfg: ModelConfig, rt: Runtime, positions):
    """Full-sequence pass through the dense layer stack, for training: it
    keeps no KV caches (they serve prefill, ROADMAP queue 1 item 12)."""
    _check_family(cfg, "the layer stack")
    bp = _block_pols(_model_plan(cfg), "layers", "attn", "mlp")

    def blk(h, lp):
        return _dense_block(lp, h, cfg, bp, rt, positions)

    for lp in _unstack(params["layers"]):
        if cfg.remat == "block":
            x = checkpoint(blk, x, lp, use_reentrant=False)
        else:
            x = blk(x, lp)
    return x


def _positions(x):
    return torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[:2])


# ------------------------------------------------------------- API -------
def loss_fn(params, batch, cfg: ModelConfig, rt: Runtime = Runtime()):
    """Mean next-token CE.  batch: tokens, labels[,
    frontend_embeds], tensors on the parameters' device."""
    if cfg.family in ("encdec", "audio"):
        raise _unported(f"loss_fn of the {cfg.family!r} family", "11")
    plan = _model_plan(cfg)
    x = _embed_inputs(params, batch, cfg, plan, rt)
    x = _backbone(params, x, cfg, rt, _positions(x))
    x = apply_norm(params["final_norm"], x, cfg)
    labels = batch["labels"]
    if x.shape[1] != labels.shape[1]:  # frontend prefix carries no loss
        x = x[:, x.shape[1] - labels.shape[1]:]
    loss = chunked_ce_loss(x, params["emb"], labels,
                           plan.runtime_for("head"), cfg, rt=rt)
    return loss


def _serving(name: str):
    def fn(*args, **kwargs):
        raise _unported(f"{name} (serving)", "12")
    fn.__name__ = name
    fn.__doc__ = f"The JAX package's ``{name}``: not ported (ROADMAP " \
                 f"queue 1 item 12)."
    return fn


prefill = _serving("prefill")
prefill_chunk = _serving("prefill_chunk")
decode_step = _serving("decode_step")
decode_step_paged = _serving("decode_step_paged")
init_decode_caches = _serving("init_decode_caches")
init_paged_caches = _serving("init_paged_caches")

"""Sharding rules: parameter, optimizer, batch and cache partition specs by
path, and the local shards they give on a ``DeviceMesh``.

Layout (the JAX package's ``repro.distributed.sharding``):

* FSDP: parameters sharded over the ``data`` axis (ZeRO-3: a rank holds its
  shard and gathers a full weight only around its use).
* TP: attention heads / FFN hidden sharded over ``model``.
* EP: MoE expert dim over ``model``.
* pod axis: pure data parallel (parameters replicated across pods).

Rules key off the flattened parameter path (``layers/attn/wq``, list
indices as digits, a namedtuple's fields by name), so they apply uniformly
to stacked (L, ...) and unstacked trees.  A spec is a
:class:`PartitionSpec`: a tuple of ``None``, an axis name or a tuple of
names per dimension, equal as a tuple to the JAX package's.

:func:`shard_tree` cuts a full tree into this rank's local shards and
:func:`gather_tree` puts full leaves back together on every rank (plain
collectives, no autograd: for set-up, checkpoints and tests).  The model's
own gathers, which carry gradients, are in :mod:`repro_torch.distributed.
spmd`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

FSDP = "data"
TP = "model"


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``None`` (replicated), an axis name, or a
    tuple of names (the dimension split over their product, the first
    major).  A one-name tuple is the name, as JAX normalizes it."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return p[0] if len(p) == 1 else (p or None)
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# (path regex, spec builder taking ndim) — first match wins.  Specs are
# given for the *unstacked* parameter; leading stacked dims are padded
# with None.
_COL = lambda nd: P(*([None] * (nd - 2) + [FSDP, TP]))    # (.., d_in, d_out)
_ROW = lambda nd: P(*([None] * (nd - 2) + [TP, FSDP]))
_REP = lambda nd: P()
RULES = [
    # Embeddings are vocab-parallel only (no FSDP).
    (r"emb/tok$", lambda nd: P(TP, None)),
    (r"emb/head$", lambda nd: P(None, TP)),
    (r"moe/router$", _REP),
    (r"moe/w_(gate|up)$", lambda nd: P(TP, FSDP, None)),   # (E, d, de)
    (r"moe/w_down$", lambda nd: P(TP, None, FSDP)),        # (E, de, d)
    (r"(wo|w_down|out_proj|shared_down)$", _ROW),
    (r"(wq|wk|wv|w_dkv|w_ukv|w_gate|w_up|shared_gate|shared_up|in_proj"
     r"|frontend_proj)$", _COL),
    (r"conv_w$", lambda nd: P(None, TP)),                  # (K, C)
    (r"(conv_b|norm|A_log|D|dt_bias)$", lambda nd: P(TP)),  # (C,)/(H,)
    (r".*", _REP),                                          # norms, scalars
]


def _spec_for(path: str, ndim: int, stacked: int) -> PartitionSpec:
    for pat, fn in RULES:
        if re.search(pat, path):
            base = fn(ndim - stacked)
            return P(*([None] * stacked + list(base)))
    raise AssertionError(path)


def _stacked_depth(path: str) -> int:
    """Number of leading stacked dims: layers → 1, hybrid groups keep 1."""
    return 1 if re.search(
        r"(^|/)(layers|dense_layers|tail_layers|enc_layers)/", path) else 0


def map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *matching leaves of rest)`` over a tree of dicts
    (sorted keys), lists, tuples and namedtuples (descended into, by field
    name, as JAX's trees are); ``None`` stays ``None``.  The result keeps
    the containers."""
    def join(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 path=join(k)) for k in sorted(tree)}
    fields = getattr(type(tree), "_fields", None)
    if fields is not None:
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          *(getattr(r, f) for r in rest),
                                          path=join(f)) for f in fields))
    if type(tree) in (list, tuple):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        path=join(i))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree, *rest)


def param_specs(params):
    """PartitionSpec tree matching an ``init_params`` tree (tensors on any
    device, ``meta`` included)."""
    return map_with_path(
        lambda ps, leaf: _spec_for(ps, leaf.ndim, _stacked_depth(ps)),
        params)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what ``load_checkpoint(..., shardings=)`` cuts each
    restored leaf by."""
    mesh: Any
    spec: PartitionSpec


def param_shardings(mesh, params):
    return map_with_path(lambda _p, s: NamedSharding(mesh, s),
                         param_specs(params))


def batch_specs(batch, data_axes=("data",)):
    """Batch dim over the data axes; everything else replicated."""
    data_axes = tuple(data_axes) or None

    def one(_path, leaf):
        return P(data_axes, *([None] * (leaf.ndim - 1)))
    return map_with_path(one, batch)


def cache_specs(caches, data_axes=("data",), model_axis="model",
                paged: bool = False):
    """Decode caches: batch over data; sequence (or the last dim) over model.

    Layouts: GQA KV (L,B,S,KV,hd) and MLA latents (L,B,S,r) → sequence
    on model (each rank attends over its block and the softmax is
    combined over model: ``nn/attention.py: combine_softmax``); SSM conv
    (L,B,K,C) → last dim on model; SSM state (L,B,H,P,N) → heads on
    model; enc_out (B,S,d) → sequence on model.

    ``paged=True`` is the serving pool layout (no batch dim): GQA pages
    (L,NB,bs,KV,hd) / MLA pages (L,NB,bs,r) shard the within-block dim
    ``bs`` over model.
    """
    data_axes = tuple(data_axes) or None
    if paged:
        def one_paged(_path, leaf):
            nd = leaf.ndim
            if nd == 5:
                return P(None, None, model_axis, None, None)
            if nd == 4:
                return P(None, None, model_axis, None)
            return P()
        return map_with_path(one_paged, caches)

    def one(ps, leaf):
        nd = leaf.ndim
        if ps.endswith("enc_out"):
            return P(data_axes, model_axis, None)
        if ps.endswith("conv"):
            return P(None, data_axes, None, model_axis)
        if nd == 5:
            return P(None, data_axes, model_axis, None, None)
        if nd == 4:
            return P(None, data_axes, model_axis, None)
        if nd == 3:
            return P(None, data_axes, None)
        return P()
    return map_with_path(one, caches)


# ------------------------------------------------------ mesh axes --------
def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``; 1 for an axis the mesh lacks."""
    names = axis_names(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def axis_rank(mesh, name: str) -> int:
    return mesh.get_local_rank(name) if name in axis_names(mesh) else 0


def axis_group(mesh, name: str):
    """The process group of axis ``name``, None when it has one rank."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec names."""
    return tuple(a for e in spec for a in _entry_axes(e))


def _slot(mesh, entry) -> "tuple[int, int]":
    """(this rank's index, count) of a dimension split by ``entry``."""
    idx, n = 0, 1
    for a in _entry_axes(entry):
        idx, n = idx * axis_size(mesh, a) + axis_rank(mesh, a), \
            n * axis_size(mesh, a)
    return idx, n


def local_shard(t, spec, mesh):
    """This rank's block of the full tensor ``t`` under ``spec``: a copy
    of its own where it is cut (a view would keep the whole storage
    alive), ``t`` itself where it is not."""
    full = t
    for dim, entry in enumerate(spec):
        i, n = _slot(mesh, entry)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does "
                             f"not split over {n} ranks ({spec})")
        c = t.shape[dim] // n
        t = t.narrow(dim, i * c, c)
    if t is full:
        return t.contiguous()
    return t.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh):
    """The local shards of a full tree (every rank holds the whole tree)."""
    return map_with_path(lambda _p, t, s: local_shard(t, s, mesh), tree,
                         specs)


def full_leaf(t, spec, mesh):
    """The full tensor from every rank's shard ``t`` under ``spec``."""
    from .spmd import all_gather_raw
    for dim, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):   # minor axis first
            t = all_gather_raw(t, dim, axis_group(mesh, a))
    return t


def gather_tree(tree, specs, mesh):
    """The inverse of :func:`shard_tree`: full leaves on every rank."""
    with torch.no_grad():
        return map_with_path(lambda _p, t, s: full_leaf(t, s, mesh), tree,
                             specs)


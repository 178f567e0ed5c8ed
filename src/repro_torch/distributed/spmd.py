"""Explicit SPMD over a ``DeviceMesh``: collectives written out, with their
gradients, and the per-call layout of the model's token stream.

One process per rank holds local tensors.  Gradients follow one
convention: every rank differentiates its own share of the objective, and
the objective is the sum of the shares.  So the gradient of an all-gather
is a reduce-scatter, of an all-reduce an all-reduce, of an all-to-all the
reverse all-to-all, and taking this rank's slice of a replicated tensor
sends gradient to that slice only.  A loss every rank reports in full is
:func:`shared_value`: the full value forward, the rank's share backward.

:class:`Sharded` is the layout of one token stream under a
:class:`~repro_torch.nn.model.Runtime` with a mesh: the batch split over
the data axes and, when the stream's length divides the model axis, the
sequence split over ``model`` in contiguous blocks (the JAX package's
``scatter_seq``); otherwise replicated over ``model``.  Weights are
gathered around their use (:meth:`Sharded.full`); the gradient of a
gathered weight goes back to its shard by a float reduce-scatter, and to
the ranks that replicate it by an all-reduce.  No ⊞-MAC contraction is
split across ranks: parallelism comes from the output rows (tokens) and
the attention heads only.

On the CPU the collectives run over gloo, on the card over NCCL; a group
of one rank skips them.  The ``fake`` backend of the dry run
(:mod:`repro_torch.launch.dryrun`) takes NCCL's calls.  The raw functions
below are the model's only collectives; :func:`count_collectives` tallies
their bytes on the wire by kind (:func:`wire_bytes`), the same whatever
the backend.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any

import torch
import torch.distributed as dist

from .sharding import (_entry_axes, _spec_for, axis_group, axis_names,
                       axis_rank, axis_size, map_with_path, spec_axes)


_EXPERTS = r"moe/w_(gate|up|down)$"


def _n(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _nccl(group) -> bool:
    """NCCL's calls (``all_gather_into_tensor``, ``reduce_scatter_tensor``),
    which the dry run's ``fake`` backend takes too; gloo has its own."""
    return dist.get_backend(group) in ("nccl", "fake")


# --------------------------------------------------- counting -------------
def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Per-rank bytes on the wire of one collective over ``g`` ranks, on a
    ring (the JAX package's dry-run cost model).  ``nbytes`` is the
    gathered output of an all-gather, the scattered output of a
    reduce-scatter, the reduced tensor of an all-reduce and the sent
    tensor of an all-to-all or a collective-permute.  A group of one
    moves nothing."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}")


_TALLIES: list = []       # the open count_collectives() dicts


@contextlib.contextmanager
def count_collectives():
    """``{kind: bytes on the wire}`` of every raw collective this process
    runs inside the block (:func:`wire_bytes`, this rank's share); nested
    blocks each count."""
    tally: dict = {}
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def _count(kind: str, t, g: int) -> None:
    if _TALLIES:
        w = wire_bytes(kind, t.numel() * t.element_size(), g)
        for tally in _TALLIES:
            tally[kind] = tally.get(kind, 0.0) + w


# ------------------------------------------------------ raw ---------------
def all_gather_raw(x, dim: int, group):
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    n = _n(group)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    if _nccl(group):
        out = torch.empty((n * xs.shape[0],) + xs.shape[1:], dtype=xs.dtype,
                          device=xs.device)
        dist.all_gather_into_tensor(out, xs, group=group)
    else:
        parts = [torch.empty_like(xs) for _ in range(n)]
        dist.all_gather(parts, xs, group=group)
        out = torch.cat(parts)
    _count("all-gather", out, n)
    return out.movedim(0, dim)


def all_reduce_raw(x, group, op=dist.ReduceOp.SUM):
    """The ranks' ``x`` reduced by ``op`` (the sum)."""
    n = _n(group)
    if n == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    _count("all-reduce", out, n)
    return out


def reduce_scatter_raw(x, dim: int, group):
    """This rank's block along ``dim`` of the sum of the ranks' ``x``."""
    n = _n(group)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    if _nccl(group):
        out = torch.empty((xs.shape[0] // n,) + xs.shape[1:],
                          dtype=xs.dtype, device=xs.device)
        dist.reduce_scatter_tensor(out, xs, group=group)
    else:                                   # gloo has no reduce-scatter
        dist.all_reduce(xs, group=group)
        out = xs.chunk(n)[dist.get_rank(group)]
    _count("reduce-scatter", out, n)
    return out.movedim(0, dim).contiguous()


def all_to_all_raw(x, split_dim: int, cat_dim: int, group):
    """Block ``j`` of ``x`` along ``split_dim`` goes to rank ``j``; the
    blocks received are concatenated along ``cat_dim`` in rank order."""
    n = _n(group)
    if n == 1:
        return x
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    _count("all-to-all", send, n)
    return torch.cat(out.unbind(0), dim=cat_dim)


# --------------------------------------------------- autograd -------------
class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return all_to_all_raw(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return all_to_all_raw(g, cat_dim, split_dim, ctx.group), None, None, \
            None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, ctx.dim, ctx.group), None, None


class _GradSum(torch.autograd.Function):
    """Identity forward; the gradient summed over ``groups``: a leaf that
    those ranks replicate."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for grp in ctx.groups:
            g = all_reduce_raw(g, grp)
        return g, None


def all_gather(x, dim: int, group):
    return x if _n(group) == 1 else _AllGather.apply(x, dim, group)


def all_reduce(x, group):
    return x if _n(group) == 1 else _AllReduce.apply(x, group)


def all_to_all(x, split_dim: int, cat_dim: int, group):
    return x if _n(group) == 1 else _AllToAll.apply(x, split_dim, cat_dim,
                                                    group)


def reduce_scatter(x, dim: int, group):
    return x if _n(group) == 1 else _ReduceScatter.apply(x, dim, group)


def own_block(x, dim: int, group):
    """This rank's block along ``dim`` of a tensor every rank of ``group``
    holds whole."""
    n = _n(group)
    if n == 1:
        return x
    c = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * c, c)


def shared_value(full, share):
    """``full`` (no gradient) forward; the gradient goes to ``share``, this
    rank's part of the objective."""
    return full.detach() + (share - share.detach())


# ------------------------------------------------------ layout ------------
@dataclasses.dataclass(frozen=True)
class Sharded:
    """The layout of one token stream on a mesh (see the module doc)."""
    mesh: Any
    data_axes: tuple
    model_axis: str
    seq: bool                     # the sequence split over model

    @property
    def tp(self) -> int:
        return axis_size(self.mesh, self.model_axis)

    @property
    def model_group(self):
        return axis_group(self.mesh, self.model_axis)

    @property
    def model_rank(self) -> int:
        return axis_rank(self.mesh, self.model_axis)

    @property
    def world(self) -> int:
        n = 1
        for a in axis_names(self.mesh):
            n *= axis_size(self.mesh, a)
        return n

    @property
    def rep(self) -> int:
        """How many ranks hold each token: the model axis when the stream
        is replicated over it."""
        return 1 if self.seq else self.tp

    def with_seq(self, seq: bool) -> "Sharded":
        return dataclasses.replace(self, seq=seq)

    # --- the token stream
    def gather_seq(self, x, dim: int = 1):
        """The whole sequence of a stream (its block where replicated)."""
        return all_gather(x, dim, self.model_group) if self.seq else x

    def own_seq(self, x, dim: int = 1):
        """This rank's block of a whole-sequence tensor."""
        return own_block(x, dim, self.model_group) if self.seq else x

    def gather_data(self, x, dim: int = 0):
        """The whole batch (data axes, major first)."""
        for a in reversed(self.data_axes):
            x = all_gather(x, dim, axis_group(self.mesh, a))
        return x

    def heads_split(self, h: int) -> bool:
        return self.tp > 1 and h % self.tp == 0

    def own_heads(self, x, dim: int = 2):
        """Heads over model (the JAX package's ``_head_sharded``)."""
        if not self.heads_split(x.shape[dim]):
            return x
        return own_block(x, dim, self.model_group)

    def heads_back(self, o, h: int, head_dim: int = 2, seq_dim: int = 1):
        """``o`` over the whole sequence for this rank's heads (or all heads
        when they are not split) → this stream's layout with all heads."""
        if not self.heads_split(h):
            return self.own_seq(o, seq_dim)
        if self.seq:
            return all_to_all(o, seq_dim, head_dim, self.model_group)
        return all_gather(o, head_dim, self.model_group)

    def psum_model(self, x):
        return all_reduce(x, self.model_group)

    def mean_all(self, local):
        """``pmean`` over every axis: the mean value, this rank's share of
        it backward."""
        full = local.detach()
        for a in axis_names(self.mesh):
            full = all_reduce_raw(full, axis_group(self.mesh, a))
        return shared_value(full / self.world, local / self.world)

    # --- weights
    def use(self, t, spec, gather=None):
        """Parameter shard ``t`` (laid out by ``spec``) as used here: the
        axes in ``gather`` (default: all the spec names) gathered; the
        gradient reduce-scattered back over them and summed over the axes
        that replicate the leaf."""
        named = spec_axes(spec)
        rep = [axis_group(self.mesh, a) for a in axis_names(self.mesh)
               if a not in named]
        rep = [g for g in rep if g is not None]
        if rep:
            t = _GradSum.apply(t, rep)
        for dim, entry in enumerate(spec):
            for a in reversed(_entry_axes(entry)):
                if gather is None or a in gather:
                    t = all_gather(t, dim, axis_group(self.mesh, a))
        return t

    def full(self, tree, prefix: str):
        """A parameter subtree (one unstacked layer, or the leaves under
        ``prefix``) with every leaf gathered, but the MoE routed experts,
        which stay split over the model axis (the EP forms' layout)."""
        def one(path, t):
            ps = f"{prefix}/{path}" if path else prefix
            spec = _spec_for(ps, t.ndim, 0)
            keep = re.search(_EXPERTS, ps) is not None
            gather = [a for a in spec_axes(spec)
                      if not (keep and a == self.model_axis)]
            return self.use(t, spec, gather)
        return map_with_path(one, tree)

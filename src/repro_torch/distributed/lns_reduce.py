"""Deterministic log-domain gradient all-reduce (the data-parallel ⊞
contract) on ``torch.distributed``.

⊞ is only approximately associative, so the order in which the ranks'
gradient partials are combined is part of the result.  A plain
``all_reduce`` combines in an order set by the backend and the topology,
and would change the weight codes whenever the rank count changes.  The
schedule used instead:

1. The global batch is cut into canonical contiguous segments, numbered in
   batch order; each rank owns a contiguous run of them and emits one
   partial per segment.
2. :func:`gather_partials` all-gathers the partials along dim 0 in rank
   order, which is segment order, so every rank holds slots 0..S-1.
3. :func:`combine_partials` ⊞-combines the S slots on a schedule that is a
   function of S alone: the sequential left fold (the ⊞-reduce kernel on
   the card, its plain version on the CPU) or a balanced tree.
   :func:`combine_partials_many` does the same for several parameters,
   one ⊞-reduce launch for all that share a format and Δ engine.

Neither the segmentation nor the schedule mentions the rank count, so 1,
2 or 4 ranks give bit-identical codes.  :func:`float_psum_allreduce` is
the fast escape hatch: decode, ``all_reduce(SUM)`` in float, re-encode.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.arithmetic import boxsum_partials
from ..core.delta import DeltaEngine
from ..core.lns import LNSArray, decode, encode
from ..core.spec import REDUCE_MODES, REDUCE_SCHEDULES  # noqa: F401
from ..kernels.lns_boxsum import dp_combine_blocks  # noqa: F401
from ..kernels.lns_boxsum import lns_boxsum_many


def world_size(num_ranks: int) -> int:
    """The size of the default process group, checked against the
    ``num_ranks`` a data-parallel config asks for: a missing or other-sized
    group raises, so a multi-rank config never runs single-rank
    silently."""
    have = dist.get_world_size() if dist.is_initialized() else 1
    if num_ranks != have:
        raise RuntimeError(
            f"data-parallel training over {num_ranks} ranks needs a process "
            f"group of that size; "
            + (f"the group has {have}" if dist.is_initialized() else
               "none is initialized (torch.distributed."
               "init_process_group)"))
    return have


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def gather_partials(p: LNSArray, num_ranks: int = 1) -> LNSArray:
    """All-gather (S_local, ...) partials along dim 0 in rank order →
    (S, ...).  Without a process group it is the identity; with a group
    (one rank included) the collective runs."""
    world_size(num_ranks)
    if not dist.is_initialized():
        return p
    planes = []
    for t in (p.code, p.sign):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(num_ranks)]
        dist.all_gather(parts, t)
        planes.append(torch.cat(parts))
    return LNSArray(*planes)


def combine_partials(parts: LNSArray, eng: DeltaEngine, *,
                     schedule: str = "sequential", interpret: bool = True,
                     blocks: str = "default") -> LNSArray:
    """⊞-combine (S, ...) stacked partials along dim 0 on a fixed schedule:
    the one-parameter case of :func:`combine_partials_many`.

    ``sequential`` reduces every element's S slots in one ⊞-reduce
    launch, reading the (S, E) planes in place as E rows of S steps;
    ``tree`` is :func:`~repro_torch.core.arithmetic.boxsum_partials`'
    balanced tree.  ``interpret`` and ``blocks`` are the JAX package's
    arguments, taken so that its calls carry across; they route nothing
    (the ⊞-reduce has one geometry: :func:`dp_combine_blocks`).
    """
    if blocks not in ("default", "auto"):
        from ..core.spec import parse_blocks
        parse_blocks(blocks)
    return combine_partials_many({0: parts}, {0: eng},
                                 schedule=schedule)[0]


def group_by_arithmetic(engines: dict) -> list:
    """The keys of ``engines`` grouped by their engines' (format, Δ spec),
    in first-seen order: the parameters one grouped combine reduces
    together."""
    groups = {}
    for k, eng in engines.items():
        groups.setdefault((eng.fmt, eng.spec), []).append(k)
    return list(groups.values())


def combine_partials_many(parts: dict, engines: dict, *,
                          schedule: str = "sequential") -> dict:
    """:func:`combine_partials` of every ``parts[k]`` under
    ``engines[k]``.  ``sequential`` reduces the parameters that share a
    format and Δ spec (:func:`group_by_arithmetic`) in one
    :func:`~repro_torch.kernels.lns_boxsum.lns_boxsum_many`, each read in
    place as E rows of S steps; ``tree`` combines each parameter on its
    own."""
    if schedule != "sequential":
        return {k: boxsum_partials(p, engines[k], schedule=schedule)
                for k, p in parts.items()}
    out = {}
    for keys in group_by_arithmetic({k: engines[k] for k in parts}):
        eng = engines[keys[0]]
        rows = [(parts[k].code.reshape(parts[k].shape[0], -1).T,
                 parts[k].sign.reshape(parts[k].shape[0], -1).T)
                for k in keys]
        for k, (code, sign) in zip(keys, lns_boxsum_many(
                rows, fmt=eng.fmt, spec=eng.spec)):
            tail = parts[k].shape[1:]
            out[k] = LNSArray(code.reshape(tail), sign.reshape(tail))
    return {k: out[k] for k in parts}


def deterministic_boxplus_allreduce(p: LNSArray, eng: DeltaEngine, *,
                                    num_ranks: int = 1,
                                    schedule: str = "sequential"
                                    ) -> LNSArray:
    """Gather the partials, then combine them on the fixed schedule; every
    rank returns the same codes."""
    return combine_partials(gather_partials(p, num_ranks), eng,
                            schedule=schedule)


def float_psum_allreduce(p: LNSArray, eng: DeltaEngine, *,
                         num_ranks: int = 1) -> LNSArray:
    """Decode the local partials, sum them in float32, ``all_reduce(SUM)``
    across ranks and re-encode.  Not bit-stable across rank counts."""
    world_size(num_ranks)
    total = decode(p, eng.fmt).sum(dim=0)
    if dist.is_initialized():
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return encode(total, eng.fmt)

"""Train-step factory: loss → grads → optimizer update, with microbatch
gradient accumulation, global-norm clipping, log-domain gradient
compression and a non-finite guard.

``make_train_step`` returns a function ``(state, batch) → (state,
metrics)``.  The train state is a plain dict, ``{"params", "opt", "step"
[, "residual"]}``, the JAX package's tree; gradients come from
``torch.autograd`` through the model's ``LNSRuntime`` products (the ⊞-MAC
kernels under ``lns16-train-*``).

Three layouts:

* one device: the state and the batch whole;
* ``Runtime(mesh=...)``: every rank holds its shards of the state
  (:func:`train_state_specs`: the optimizer state like its parameter,
  ``step`` replicated) and its block of the batch (``batch_specs``); the
  model's collectives give each shard its gradient, and the global-norm
  clip, the non-finite guard and the compression's per-leaf scale reduce
  over the ranks that split a leaf;
* ``TrainConfig(data_parallel=N)``: the N ranks of the default process
  group each hold the whole state and their block of the batch; the float
  gradients and the loss are all-reduced to their mean (``float-psum``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from ..core.plan import NumericsPlan
from ..core.spec import NumericsSpec
from ..nn import Runtime, loss_fn
from ..nn.config import ModelConfig
from ..optim import fake_compress_roundtrip, make_optimizer
from ..optim.optimizers import OptimizerConfig
from ..pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Execution config of the LM train step.

    Numerics axes belong to the model's spec (``ModelConfig.numerics``).
    The loose ``matmul_backend=`` and ``reduce_mode=`` keywords are the
    JAX package's deprecated spelling: they still fold into the spec
    (:func:`resolve_numerics`), with a ``DeprecationWarning``.
    """

    microbatches: int = 1            # gradient-accumulation splits
    grad_clip: float = 0.0           # global-norm clip; 0 = off
    compress_grads: bool = False     # log-int8 roundtrip + error feedback
    loss_dtype: str = "float32"
    matmul_backend: Optional[str] = None  # DEPRECATED → 'backend='
    data_parallel: int = 1           # ranks of the default process group
    nan_guard: bool = False          # skip the update (params, opt state
                                     # and residual unchanged, step
                                     # advances) when the loss or a grad is
                                     # non-finite;
                                     # metrics report 'update_skipped'
    reduce_mode: Optional[str] = None  # DEPRECATED → 'reduce.mode='

    def __post_init__(self):
        legacy = [f"{k}={v!r}" for k, v in
                  (("matmul_backend", self.matmul_backend),
                   ("reduce_mode", self.reduce_mode)) if v is not None]
        if legacy:
            hints = []
            if self.matmul_backend is not None:
                hints.append(f"backend={self.matmul_backend}")
            if self.reduce_mode is not None:
                hints.append(f"reduce.mode={self.reduce_mode}")
            warnings.warn(
                f"TrainConfig({', '.join(legacy)}) is deprecated; append "
                f"the override to the numerics spec instead, e.g. "
                f"ModelConfig.numerics='<spec>,{','.join(hints)}'",
                DeprecationWarning, stacklevel=3)


def resolve_numerics(cfg: ModelConfig, tc: "TrainConfig" = None
                     ) -> "tuple[ModelConfig, NumericsPlan]":
    """Fold TrainConfig's deprecated numerics overrides into one plan:
    ``(cfg with the canonical numerics string, plan)``."""
    plan = NumericsPlan.parse(cfg.numerics)
    if tc is not None and tc.matmul_backend is not None:
        if not plan.lns_grad:
            raise ValueError(
                f"the matmul-backend override requires an LNS end-to-end "
                f"training spec (quantize includes 'grads'), got "
                f"{cfg.numerics!r}")
        plan = plan.with_(backend=tc.matmul_backend)
    if tc is not None and tc.reduce_mode is not None:
        plan = plan.with_(**{"reduce.mode": tc.reduce_mode})
    return cfg.with_(numerics=str(plan)), plan


def init_train_state(params, opt_cfg: OptimizerConfig,
                     tc: TrainConfig = TrainConfig()):
    """``{"params", "opt", "step"[, "residual"]}`` on the parameters'
    device; ``step`` a 0-d int32 tensor."""
    opt_init, _ = make_optimizer(opt_cfg)
    device = tree_leaves(params)[0].device
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if tc.compress_grads:
        state["residual"] = tree_map(torch.zeros_like, params)
    return state


def _split_batch(batch, n):
    return [{k: v[i::n] for k, v in batch.items()} for i in range(n)]


def train_state_specs(state):
    """The PartitionSpec tree of a train state under a mesh (the JAX
    package's ``sspecs``)."""
    from ..distributed.sharding import P, param_specs
    pspecs = param_specs(state["params"])
    out = {"params": pspecs, "step": P(),
           "opt": {k: pspecs for k in state["opt"]}}
    if "residual" in state:
        out["residual"] = pspecs
    return out


def _leaf_reducer(rt: Runtime, params, op):
    """``fn(i, t)``: ``t`` reduced by ``op`` over the ranks that split leaf
    ``i`` of ``params`` (identity without a mesh)."""
    if rt.mesh is None:
        return None
    from ..distributed.sharding import axis_group, param_specs, spec_axes
    from ..distributed.spmd import all_reduce_raw
    groups = [[g for g in (axis_group(rt.mesh, a) for a in spec_axes(s))
               if g is not None]
              for s in tree_leaves(param_specs(params))]

    def fn(i, t):
        for g in groups[i]:
            t = all_reduce_raw(t, g, op)
        return t
    return fn


def _clip(grads, max_norm, reduce=None, inplace=False):
    """``(grads scaled to a global norm of at most max_norm, the norm)``;
    ``inplace`` scales the given gradients (the same bits)."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in tree_leaves(grads)]
    if reduce is not None:
        sq = [reduce(i, t) for i, t in enumerate(sq)]
    gn = torch.sqrt(sum(sq))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    if inplace:
        for g in tree_leaves(grads):
            g.mul_(scale.to(g.dtype))
        return grads, gn
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def _check_donatable(state) -> None:
    """Raise if two leaves of ``state`` share a storage: an in-place
    update would be applied to it twice."""
    seen = {}
    for i, t in enumerate(tree_leaves(state)):
        st = t.untyped_storage()
        if id(st) in seen:
            raise ValueError(
                f"donate=True: leaves {seen[id(st)][0]} and {i} of the "
                f"train state share one storage; give each leaf its own "
                f"tensor (e.g. clone it) or build the step with "
                f"donate=False")
        seen[id(st)] = (i, st)


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    rt: Runtime = Runtime(),
                    tc: TrainConfig = TrainConfig(), donate: bool = False):
    """The step function ``(state, batch) → (new_state, metrics)``.

    With ``donate=False`` the state it is given is not modified.  With
    ``donate=True`` (the JAX package's ``donate_argnums=0``) the step
    writes the new parameters, optimizer state, ``step`` and
    ``residual`` into the tensors of the state it is given, a slice of a
    leaf at a time (``make_optimizer(..., inplace=True)``), and returns
    that state: no second copy of the state is alive at the update.  The
    results are bit-equal to ``donate=False``.  The caller must not read the old
    state afterwards; a leaf it needs (a checkpoint) is copied first
    (``CheckpointManager.save`` copies to the host before it returns).
    Under a mesh the leaves are the rank's local shards."""
    # The LM step reduces float gradients; only an explicit request for
    # the ⊞ reduce (the paper MLP's) trips the guard, as in the JAX
    # package.
    default_seg = str(cfg.numerics).split(";", 1)[0]
    requested_boxplus = (
        tc.reduce_mode == "boxplus"
        or ("reduce.mode" in NumericsSpec.explicit_keys(default_seg)
            and NumericsPlan.parse(cfg.numerics).reduce.mode == "boxplus"))
    cfg, _ = resolve_numerics(cfg, tc)
    if requested_boxplus and tc.data_parallel > 1:
        raise NotImplementedError(
            "reduce.mode='boxplus' applies to the end-to-end LNS paper-MLP "
            "path (distributed/lns_dp.LNSDataParallelMLP / "
            "run_experiment(..., data_parallel=...)); the LM train step "
            "reduces float gradients — use reduce.mode='float-psum'")
    dp = tc.data_parallel
    if dp > 1:
        if rt.mesh is not None:
            raise ValueError("data_parallel > 1 with a mesh: the mesh's data "
                             "axes carry the batch")
        if not dist.is_initialized() or dist.get_world_size() != dp:
            have = dist.get_world_size() if dist.is_initialized() else None
            raise RuntimeError(
                f"data_parallel={dp} runs on the {dp} ranks of the default "
                f"process group (have: {have}): call torch.distributed."
                f"init_process_group with world_size={dp} first (torchrun, "
                f"or python -m repro_torch.launch.train --data-parallel "
                f"{dp})")
    _, opt_update = make_optimizer(opt_cfg, inplace=donate)

    def grads_of(params, batch):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(tree_unflatten(treedef, live), batch, cfg, rt)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        loss = loss.detach()
        if dp > 1:                                  # float-psum
            flat = torch.cat([loss.reshape(1).to(torch.float32)]
                             + [g.reshape(-1).to(torch.float32)
                                for g in grads])
            dist.all_reduce(flat)
            flat = flat / dp
            loss, at = flat[0].to(loss.dtype), 1
            out = []
            for g in grads:
                out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
                at += g.numel()
            grads = out
        return loss, tree_unflatten(treedef, grads)

    def step(state, batch):
        if donate:
            _check_donatable(state)
        params = state["params"]
        if tc.microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=state["step"].device)
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            for mb in _split_batch(batch, tc.microbatches):
                l_mb, g_mb = grads_of(params, mb)
                loss = loss + l_mb
                grads = tree_map(torch.add, grads, g_mb)
            inv = 1.0 / tc.microbatches
            loss = loss * inv
            grads = tree_map(lambda g: g * inv, grads)
        else:
            loss, grads = grads_of(params, batch)
        metrics = {"loss": loss}
        if tc.nan_guard:
            # A non-finite loss or gradient would poison the params, the
            # optimizer state and the residual for good: keep the old ones
            # instead, selected on the device (no host read).  Read before
            # the clip and the compression (its int8 code turns a NaN
            # into zeros).
            finite = torch.isfinite(loss)
            for g in tree_leaves(grads):
                finite = finite & torch.all(torch.isfinite(
                    g.to(torch.float32)))
            if rt.mesh is not None:          # every rank keeps or skips
                from ..distributed.spmd import all_reduce_raw
                finite = all_reduce_raw(finite.to(torch.int32),
                                        dist.group.WORLD,
                                        dist.ReduceOp.MIN).to(torch.bool)
        if tc.grad_clip:
            grads, gn = _clip(grads, tc.grad_clip, _leaf_reducer(
                rt, params, dist.ReduceOp.SUM), inplace=donate)
            metrics["grad_norm"] = gn
        if tc.compress_grads:
            grads, res = fake_compress_roundtrip(
                grads, state["residual"],
                _leaf_reducer(rt, params, dist.ReduceOp.MAX))
        if donate:
            return donated(state, grads, res if tc.compress_grads else None,
                           finite if tc.nan_guard else None, metrics)
        with torch.no_grad():
            new_params, new_opt = opt_update(params, grads, state["opt"],
                                             state["step"])
        if tc.nan_guard:
            keep = lambda new, old: tree_map(
                lambda n, o: torch.where(finite, n, o), new, old)
            new_params = keep(new_params, params)
            new_opt = keep(new_opt, state["opt"])
            if tc.compress_grads:
                res = keep(res, state["residual"])
            metrics["update_skipped"] = (~finite).to(torch.int32)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if tc.compress_grads:
            new_state["residual"] = res
        return new_state, metrics

    @torch.no_grad()
    def donated(state, grads, res, finite, metrics):
        """The update written into ``state``: the residual, then the
        parameters and optimizer state (AdamW reads ``step`` first), then
        ``step``; under the guard each leaf takes ``where(finite, new,
        old)``."""
        keep = None if finite is None else \
            (lambda new, old: torch.where(finite, new, old))
        if res is not None:
            # A residual leaf takes its gradient's dtype (float32 under
            # microbatches), as in the functional step; one whose dtype
            # changes is replaced, as JAX leaves such a donated buffer
            # unused.
            olds, treedef = tree_flatten(state["residual"])
            out = []
            for old, new in zip(olds, tree_leaves(res)):
                new = new if keep is None else keep(new, old)
                if new.dtype == old.dtype:
                    new = old.copy_(new)
                out.append(new)
            state["residual"] = tree_unflatten(treedef, out)
        opt_update(state["params"], grads, state["opt"], state["step"],
                   keep=keep)
        state["step"].add_(1)
        if finite is not None:
            metrics["update_skipped"] = (~finite).to(torch.int32)
        return state, metrics

    return step

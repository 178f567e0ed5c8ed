"""Data-parallel LNS training with the deterministic ⊞ gradient reduce, on
``torch.distributed``.

The paper MLP's log-domain step (``paper/mlp.py: LNSMLP``) scaled over
ranks, with the ⊞ accumulation order, which is part of the result, fixed
by the problem and never by the rank count (see ``lns_reduce.py``):

* the global batch is cut into ``grad_segments`` canonical contiguous
  segments; rank r trains on the r-th contiguous run of them;
* each rank emits one dW partial per segment (the segment-partial ⊞-MAC
  kernel) and one bias partial per segment (a sequential ⊞-fold);
* the partials are all-gathered in rank order and ⊞-combined on a fixed
  schedule, so 1, 2 or 4 ranks give the codes of the one-process
  :func:`reference_train_step`; the update then runs on the replicated
  gradients.

With ``grad_segments`` equal to the batch each segment is one sample and
the sequential combine is the paper's sequential MAC over the batch.
``reduce.mode=float-psum`` decodes, sums in float and re-encodes: cheaper
on the wire, not bit-stable across rank counts.

The metrics and fault entry points are :class:`~repro_torch.paper.mlp.
LNSMLP`'s: weight-code flips hit the replicated parameters before the
step, segment faults (``drop_seg`` / ``dup_seg``) hit the per-segment
partials at their global slots (rank × local segments on), and the
telemetry and the other faults are suspended across the per-segment
backward, the gather and the combine; the combined gradients are tapped
as ``dp_grad.<param>``.

Process groups are the caller's: ``num_devices > 1`` needs
``torch.distributed.init_process_group`` with that world size (gloo on
the CPU, NCCL on the card, one card per rank); a missing or other-sized
group raises.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import shutil
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core.plan import NumericsPlan
from ..core.spec import ReduceSpec
from ..devices import resolve_device
from ..obs import metrics as _obs
from ..obs.trace import phase_scope
from ..resil import inject as _inj
from .lns_reduce import (combine_partials_many, float_psum_allreduce,
                         gather_partials, rank, world_size)


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Data-parallel execution config of the LNS train step.

    The reduce semantics live in one :class:`~repro_torch.core.spec.
    ReduceSpec`, the one a spec carries (:meth:`from_spec`).
    ``reduce.grad_segments`` fixes the canonical segmentation of the global
    batch; ``0`` resolves to ``num_devices``.  The device of the partials
    picks the combine's lane, so ``reduce_with_kernel`` is not ported: any
    value but ``None`` raises.  The JAX package's loose ``reduce_mode=`` /
    ``grad_segments=`` / ``reduce_schedule=`` keywords fold into
    ``reduce``, and the same names read back as properties.
    """

    num_devices: int = 1
    reduce: ReduceSpec = ReduceSpec()
    reduce_with_kernel: "bool | None" = None
    reduce_mode: dataclasses.InitVar["str | None"] = None
    grad_segments: dataclasses.InitVar["int | None"] = None
    reduce_schedule: dataclasses.InitVar["str | None"] = None

    def __post_init__(self, reduce_mode, grad_segments, reduce_schedule):
        legacy = {k: v for k, v in (("mode", reduce_mode),
                                    ("grad_segments", grad_segments),
                                    ("schedule", reduce_schedule))
                  if v is not None}
        if legacy:
            object.__setattr__(self, "reduce", self.reduce.with_(**legacy))
        if self.reduce_with_kernel is not None:
            raise NotImplementedError(
                "DPConfig(reduce_with_kernel=) is not ported: the combine "
                "launches the ⊞-reduce kernel on CUDA tensors and runs its "
                "plain version on CPU tensors")
        if self.num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got "
                             f"{self.num_devices}")

    @classmethod
    def from_spec(cls, spec, num_devices: int = 1, **kw) -> "DPConfig":
        """The DP plan a spec or plan (or their strings) describes; the
        reduce axis lives on the plan's default spec."""
        return cls(num_devices=num_devices,
                   reduce=NumericsPlan.parse(spec).reduce, **kw)

    def segments(self, global_batch: int) -> int:
        s = self.reduce.grad_segments or self.num_devices
        if s % self.num_devices:
            raise ValueError(f"grad_segments={s} not divisible by "
                             f"num_devices={self.num_devices}")
        if global_batch % s:
            raise ValueError(f"global batch {global_batch} not divisible "
                             f"into {s} canonical segments")
        return s


# Read-back of the loose keywords, as views of ``reduce``.  The names double
# as InitVars above, so the properties are attached after the class.
DPConfig.reduce_mode = property(lambda self: self.reduce.mode)
DPConfig.grad_segments = property(lambda self: self.reduce.grad_segments)
DPConfig.reduce_schedule = property(lambda self: self.reduce.schedule)


def _attached(device: torch.device) -> int:
    """The devices a mesh on ``device`` can take: the cards of this host,
    or on the CPU the ranks of the process group (one without one)."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return dist.get_world_size() if dist.is_initialized() else 1


def make_data_mesh(num_devices: int, axis_name: str = "data",
                   device="cuda"):
    """A one-axis ``DeviceMesh`` of ``num_devices`` ranks named
    ``axis_name`` (``launch/mesh.py: make_mesh``, one card a rank on
    ``cuda``).  Raises when fewer devices are attached than asked for."""
    from ..launch.mesh import make_mesh
    device = resolve_device(device)
    have = _attached(device)
    if num_devices > have:
        raise ValueError(
            f"requested data_parallel={num_devices} but only {have} "
            f"devices are attached (on the CPU, run that many ranks of "
            f"a gloo process group)")
    return make_mesh((num_devices,), (axis_name,), device)


class LNSDataParallelMLP:
    """``make_mlp``'s data-parallel LNS model: the ``init`` /
    ``init_momentum`` / ``train_step`` / ``predict`` surface of
    :class:`~repro_torch.paper.mlp.LNSMLP`, so ``run_experiment`` drives
    it unchanged.

    Every rank passes the same global batch and the same parameters; each
    trains on its own contiguous run of segments and returns the
    replicated updated parameters.  Each parameter's partials combine in
    its own layer's format and Δ engine, so the invariance holds under
    mixed-format plans too; the parameters that share them combine in one
    ⊞-reduce launch.  The update (fused or not, with or without
    ⊞-momentum) runs after the combine, on the replicated gradients.
    """

    def __init__(self, cfg, dp: DPConfig, device="cuda"):
        from ..paper.mlp import LNSMLP
        world_size(dp.num_devices)
        self.cfg = cfg
        self.dp = dp
        self.inner = LNSMLP(cfg, device)
        self.fault_plan = self.inner.fault_plan

    def init(self, gen: torch.Generator):
        return self.inner.init(gen)

    def init_momentum(self, params):
        return self.inner.init_momentum(params)

    def predict(self, params, xb) -> torch.Tensor:
        return self.inner.predict(params, xb)

    def _step_impl(self, params, x, y, momentum=None):
        from ..paper.mlp import PARAM_LAYER
        inner, dp = self.inner, self.dp
        n = dp.num_devices
        segments = dp.segments(x.shape[0])
        segs_local = segments // n
        rows = x.shape[0] // n
        r = rank()
        # Faults (no-ops without an active plan): weight-code flips on the
        # replicated parameters; segment faults on this rank's partials,
        # with the plan passed explicitly since the ambient plan is
        # suspended with the telemetry across the per-segment region.
        fplan = _inj.active_plan()
        params = _inj.inject_param_codes(params, param_fmts=inner.param_fmts,
                                         param_layer=PARAM_LAYER)
        engs = inner.param_engines
        with phase_scope("reduce"), _obs.suspended(), _inj.suspended():
            grads, loss = inner.per_segment_grads(
                params, x[r * rows:(r + 1) * rows],
                y[r * rows:(r + 1) * rows], segs_local)
            if fplan is not None:
                grads = _inj.inject_segment_partials(
                    grads, param_fmts=inner.param_fmts,
                    param_layer=PARAM_LAYER, segs_local=segs_local, rank=r,
                    plan=fplan)
            if dp.reduce.mode == "boxplus":
                grads = combine_partials_many(
                    {k: gather_partials(g, n) for k, g in grads.items()},
                    engs, schedule=dp.reduce.schedule)
            else:
                grads = {k: float_psum_allreduce(g, engs[k], num_ranks=n)
                         for k, g in grads.items()}
            if dist.is_initialized():
                loss = loss.clone()
                dist.all_reduce(loss, op=dist.ReduceOp.SUM)
                loss = loss / n
        if _obs.enabled():
            for k, g in grads.items():
                layer = PARAM_LAYER[k]
                if inner.metrics_levels[layer] != "off":
                    _obs.observe_codes(g, inner.param_fmts[k], layer=layer,
                                       op=f"dp_grad.{k}")
        with phase_scope("update"):
            new_params, momentum = inner.apply_updates(params, grads,
                                                       momentum)
        if momentum is None:
            return new_params, loss
        return new_params, momentum, loss

    def train_step(self, params, xb, yb, momentum=None):
        """One step on the global batch (numpy or tensors); returns
        (params, loss), or (params, momentum, loss) with a momentum dict.
        The loss is the mean of the ranks' batch losses."""
        x, y = self.inner._inputs(xb, yb)
        return self._step_impl(params, x, y, momentum)

    def train_step_metrics(self, params, xb, yb, momentum=None):
        """:meth:`train_step` and its taps: the combined gradients'
        health (``dp_grad.*``) and the update's taps; the per-segment
        region reports nothing.  ``(step_outputs, taps)``, the outputs
        exactly :meth:`train_step`'s."""
        x, y = self.inner._inputs(xb, yb)
        with _obs.collecting() as col:
            out = self._step_impl(params, x, y, momentum)
        return out, col.taps()

    def train_step_faults(self, params, xb, yb, step, momentum=None):
        """:meth:`train_step` with the config's :class:`FaultPlan` armed
        at ``step`` (an int, or an integer tensor on the model's
        device)."""
        x, y = self.inner._inputs(xb, yb)
        with _inj.injecting(self.fault_plan, step):
            return self._step_impl(params, x, y, momentum)

    def train_step_faults_metrics(self, params, xb, yb, step,
                                  momentum=None):
        """:meth:`train_step_faults` and its taps (the guardrails' entry
        point)."""
        x, y = self.inner._inputs(xb, yb)
        with _inj.injecting(self.fault_plan, step):
            with _obs.collecting() as col:
                out = self._step_impl(params, x, y, momentum)
        return out, col.taps()


def reference_train_step(inner, params, xb, yb, *, grad_segments: int,
                         reduce_schedule: str = "sequential",
                         momentum=None):
    """One-process baseline of the canonical DP schedule: the same
    segmented backward and fixed-schedule combine with no process group.
    The DP step must give its codes at every rank count dividing
    ``grad_segments``.  With a momentum dict the return is ``(params,
    momentum, loss)``."""
    x, y = inner._inputs(xb, yb)
    grads, loss = inner.per_segment_grads(params, x, y, grad_segments)
    grads = combine_partials_many(grads, inner.param_engines,
                                  schedule=reduce_schedule)
    new_params, momentum = inner.apply_updates(params, grads, momentum)
    if momentum is None:
        return new_params, loss
    return new_params, momentum, loss


def _train(step, params, mom, xb, yb, steps: int):
    """``steps`` calls of ``step(params, xb, yb, mom, i)`` (``i`` the step
    index); returns the numpy (params, momentum or None) and the last
    loss."""
    from ..paper.mlp import params_to_numpy
    for i in range(steps):
        out = step(params, xb, yb, mom, i)
        params, loss = out[0], out[-1]
        if mom is not None:
            mom = out[1]
    return (params_to_numpy(params),
            None if mom is None else params_to_numpy(mom), float(loss))


def _mlp_rank(rank_: int, world: int, job: dict, device):
    """One rank of :func:`_train_on_ranks`: trains; returns its replica of
    the parameters."""
    from ..paper.mlp import params_from_numpy
    model = LNSDataParallelMLP(job["cfg"], DPConfig.from_spec(
        job["plan"], num_devices=world), device=device)
    params = params_from_numpy(job["params"], device)
    # With no fault plan train_step_faults is train_step.
    return _train(lambda p, x, y, m, i: model.train_step_faults(
                      p, x, y, i, m), params,
                  model.init_momentum(params), job["xb"], job["yb"],
                  job["steps"])


def _rank_main(rank_: int, world: int, job: dict) -> None:
    """One rank (gloo on the CPU, NCCL on card ``rank_``): runs
    ``job["fn"](rank, world, job, device)`` (default: the MLP's
    :func:`_mlp_rank`) inside the process group and writes what it returns
    to the job's directory."""
    torch.set_num_threads(1)
    device = job["device"]
    if device == "cuda":
        torch.cuda.set_device(rank_)
        device = f"cuda:{rank_}"
    dist.init_process_group(
        "nccl" if device != "cpu" else "gloo",
        init_method=f"file://{job['dir']}/store_{world}",
        world_size=world, rank=rank_,
        timeout=datetime.timedelta(seconds=job["timeout"]))
    try:
        out = job.get("fn", _mlp_rank)(rank_, world, job, device)
        path = Path(job["dir"]) / f"out_{world}_{rank_}.pkl"
        path.write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def _spawn(world: int, job: dict, deadline: float):
    """Run ``world`` ranks; returns what every rank returned."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, job), nprocs=world,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{job['timeout']} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [pickle.loads((Path(job["dir"]) / f"out_{world}_{r}.pkl"
                          ).read_bytes()) for r in range(world)]


def run_on_ranks(world: int, fn, job: dict, *, device: str = "cuda",
                 timeout: float = 300.0) -> list:
    """``fn(rank, world, job, device)`` on ``world`` ranks of one process
    group, each in a process of its own (gloo on the CPU, or NCCL with
    rank r on card r); ``fn`` must be importable by name (a module-level
    function).  Returns what each rank returned, in rank order."""
    workdir = tempfile.mkdtemp()  # the ranks' file store and results
    job = dict(job, fn=fn, dir=workdir, timeout=timeout, device=device)
    try:
        return _spawn(world, job, time.monotonic() + timeout)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _train_on_ranks(world: int, cfg, plan, params, xb, yb, *,
                    steps: int = 3, device: str = "cuda",
                    timeout: float = 300.0) -> list:
    """Train the data-parallel model of ``cfg`` under the plan ``plan``
    (its ``reduce.grad_segments`` the segmentation) on ``world`` ranks of
    one process group, each in a process of its own (gloo on the CPU, or
    NCCL with rank r on card r), ``steps`` steps on the global batch
    ``xb``, ``yb`` from ``params`` (``params_to_numpy`` form).  Each step
    is ``train_step_faults`` at its index (``train_step`` when ``cfg``
    plans no faults).  Returns every rank's (params, momentum
    or None, last loss), in numpy form."""
    return run_on_ranks(world, _mlp_rank, dict(
        cfg=cfg, plan=plan, params=params, xb=xb, yb=yb, steps=steps),
        device=device, timeout=timeout)


def _same(a, b) -> bool:
    """Equal (params, momentum) codes and signs; momentum may be None."""
    if a is None or b is None:
        return a is b
    return all(np.array_equal(a[k][0], b[k][0])
               and np.array_equal(a[k][1], b[k][1]) for k in b)


def run_device_count_invariance_check(device_counts=(1, 2, 4), *,
                                      steps: int = 3, batch: int = 8,
                                      numerics=None, momentum: float = 0.0,
                                      fused: bool = True, n_in: int = 12,
                                      n_hidden: int = 9, n_out: int = 4,
                                      seed: int = 0, init_params=None,
                                      device: str = "cuda",
                                      timeout: float = 300.0,
                                      verbose: bool = False,
                                      grad_segments=None,
                                      matmul_backend=None,
                                      reduce_mode=None):
    """Train the paper MLP at several rank counts, one process group of
    that size each, and compare the weight codes with
    :func:`reference_train_step`.

    ``device="cuda"`` runs NCCL ranks, rank r on card r, and raises unless
    there are as many cards as the largest rank count; ``device="cpu"``
    runs gloo ranks on the CPU.  The reference step runs in this process
    on the first card, or on the CPU.  ``numerics`` is a spec or plan
    string whose ``reduce.grad_segments`` fixes the segmentation (default
    4).  The data come from ``numpy.random.default_rng(seed)`` as in the
    JAX package; ``init_params`` (``params_to_numpy`` form) sets the
    initial weights, else they are drawn from ``seed``.  Returns ``(ok,
    runs)``: ``ok`` is True when every rank count under
    ``reduce.mode=boxplus`` gave the reference's weight (and momentum)
    codes on every rank, and ``runs[d]`` holds rank 0's ``params``,
    ``momentum`` (``None`` without), ``loss``, ``matches_reference`` and
    ``replicas_agree``.  The momentum after the first step is the
    combined gradient itself, so it shows a combine in another order where
    the weights may not.  The loose ``grad_segments=`` /
    ``matmul_backend=`` / ``reduce_mode=`` are the deprecated spelling of
    the spec's keys: they fold into ``numerics`` with a
    ``DeprecationWarning``.
    """
    from ..paper.mlp import (LNSMLP, MLPConfig, params_from_numpy,
                             params_to_numpy)
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < max(device_counts):
            raise RuntimeError(
                f"{max(device_counts)} NCCL ranks need as many cards; "
                f"{cards} present (device='cpu' runs gloo ranks)")
    ref_device = "cuda:0" if device == "cuda" else "cpu"
    plan = NumericsPlan.parse(
        numerics or "lns16-train-pallas,reduce.grad_segments=4")
    legacy = {k: v for k, v in (("backend", matmul_backend),
                                ("reduce.mode", reduce_mode),
                                ("reduce.grad_segments", grad_segments))
              if v is not None}
    if legacy:
        plan = plan.with_(**legacy)
        warnings.warn(
            f"run_device_count_invariance_check(matmul_backend=/"
            f"reduce_mode=/grad_segments=) are deprecated; pass the "
            f"unified descriptor instead: numerics={str(plan)!r}",
            DeprecationWarning, stacklevel=2)
    segs = plan.reduce.grad_segments or 4
    plan = plan.with_(**{"reduce.grad_segments": segs})
    rng = np.random.default_rng(seed)
    xb = rng.uniform(0, 1, size=(batch, n_in)).astype(np.float32)
    yb = rng.integers(0, n_out, size=(batch,))
    cfg = MLPConfig(n_in=n_in, n_hidden=n_hidden, n_out=n_out,
                    spec=plan.with_(**{"reduce.grad_segments": 0}),
                    momentum=momentum, fused=fused)
    inner = LNSMLP(cfg, ref_device)
    if init_params is None:
        init_params = params_to_numpy(inner.init(
            torch.Generator().manual_seed(seed)))
    params = params_from_numpy(init_params, ref_device)
    ref, ref_mom, _ = _train(
        lambda p, x, y, m, i: reference_train_step(
            inner, p, x, y, grad_segments=segs,
            reduce_schedule=plan.reduce.schedule, momentum=m),
        params, inner.init_momentum(params), xb, yb, steps)
    deadline = time.monotonic() + timeout
    runs, ok = {}, True
    for d in device_counts:
        outs = _train_on_ranks(d, cfg, plan, init_params, xb, yb,
                               steps=steps, device=device,
                               timeout=max(0.0, deadline - time.monotonic()))
        params, mom, loss = outs[0]
        agree = all(_same(o[0], params) and _same(o[1], mom) for o in outs)
        same = _same(params, ref) and _same(mom, ref_mom) and agree
        runs[d] = dict(params=params, momentum=mom, loss=loss,
                       matches_reference=same, replicas_agree=agree)
        ok = ok and (same if plan.reduce.mode == "boxplus" else agree)
        if verbose:
            print(f"[lns_dp] ranks={d} loss={loss:.4f} "
                  f"bit-identical-to-reference={same}")
    return ok, runs

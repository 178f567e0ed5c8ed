"""What the port's mesh tests share (it holds no test of its own): the
reference on a forced host mesh in subprocesses, the port on gloo ranks,
and the checks between them.

* :func:`start_reference` runs this file as a script with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, in two
  processes per test module: every task (a loss and its gradients on a
  mesh, an EP MoE call, a paged decode step, data-parallel train steps)
  runs on the JAX package's meshes, and the numbers come back pickled.
* :func:`on_ranks` runs a module-level function of this file on four gloo
  ranks (``run_on_ranks`` of the port), each at one thread; it imports no
  JAX, so the ranks start while the reference computes.
* The parameters are drawn once (:func:`numpy_params`, the port's
  ``init_params`` at seed 0, as numpy) and given to both packages, the
  reference through ``jnp.asarray`` and the port through
  ``params_from_numpy``; a rank gets its shards by ``shard_tree`` and the
  tests gather the gradients back with ``gather_tree``.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
import time

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
MESHES = ((2, 2), (1, 4))
AXES = ("data", "model")
WORLD = 4


# ------------------------------------------------------- reference ----
def start_reference(tasks, path, procs=2):
    """Start the reference on ``tasks`` (dicts with a ``kind``) in
    ``procs`` processes (task ``i`` in process ``i % procs``); returns
    them.  Results go to ``path`` (see :func:`finish_reference`)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    out = []
    for k in range(min(procs, len(tasks))):
        part = f"{path}.{k}"
        with open(part + ".tasks", "wb") as f:
            pickle.dump(tasks[k::procs], f)
        out.append((part, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), part], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return out


def finish_reference(procs, timeout=600):
    """The results of :func:`start_reference`'s processes, in task
    order."""
    parts = []
    for part, proc in procs:
        out, _ = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, out[-4000:]
        with open(part, "rb") as f:
            parts.append(pickle.load(f))
    n = sum(len(p) for p in parts)
    return [parts[i % len(parts)][i // len(parts)] for i in range(n)]


def _jmesh(shape, axes=AXES):
    import jax
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def _place(tree, specs, mesh):
    import jax
    from jax.sharding import NamedSharding
    return jax.device_put(tree, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs))


def _jcfg(arch, numerics, **kw):
    from repro import configs
    return configs.reduced(configs.get_config(arch)).with_(
        numerics=numerics, remat="none", **kw)


def _ref_loss_grads(t):
    """The loss and gradients on ``t["mesh"]``, or on one device when it is
    None."""
    import jax
    import jax.numpy as jnp
    from repro.distributed.sharding import batch_specs, param_specs
    from repro.nn import Runtime
    from repro.nn.model import loss_fn
    cfg = _jcfg(t["arch"], t["numerics"])
    p = jax.tree.map(jnp.asarray, t["params"])
    b = jax.tree.map(jnp.asarray, t["batch"])
    rt = Runtime()
    if t["mesh"] is not None:
        mesh = _jmesh(t["mesh"])
        p = _place(p, param_specs(p), mesh)
        b = _place(b, batch_specs(b), mesh)
        rt = Runtime(mesh=mesh)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p_, b_: loss_fn(p_, b_, cfg, rt)))(p, b)
    return float(loss), [np.asarray(x) for x in jax.tree.leaves(g)]


def _ref_moe(t):
    import jax
    import jax.numpy as jnp
    from repro.core.numerics import get_policy
    from repro.nn.moe import MoERuntime, moe_ep, moe_ep_replicated
    cfg = _jcfg(t["arch"], "fp32")
    mesh = _jmesh((WORLD // t["tp"], t["tp"]))
    fn = moe_ep if t["form"] == "ep" else moe_ep_replicated
    p = jax.tree.map(jnp.asarray, t["p"])
    out, aux = jax.jit(lambda p_, x_: fn(p_, x_, cfg, get_policy("fp32"),
                                         MoERuntime(mesh)))(
        p, jnp.asarray(t["x"]))
    return np.asarray(out), float(aux)


def _ref_decode_paged(t):
    import jax
    import jax.numpy as jnp
    from repro.distributed.sharding import cache_specs, param_specs
    from repro.nn import Runtime
    from repro.nn.model import decode_step_paged, init_paged_caches
    cfg = _jcfg(t["arch"], "fp32")
    mesh = _jmesh(t["mesh"])
    p = jax.tree.map(jnp.asarray, t["params"])
    p = _place(p, param_specs(p), mesh)
    caches = init_paged_caches(cfg, t["num_blocks"], t["block_size"],
                               jnp.float32)
    caches = _place(caches, cache_specs(caches, paged=True), mesh)
    rt = Runtime(mesh=mesh)
    step = jax.jit(lambda p_, tok, c, bt, pos, act: decode_step_paged(
        p_, tok, c, bt, pos, act, cfg, rt))
    logits = []
    for tok, pos in zip(t["toks"], t["pos"]):
        lg, caches = step(p, jnp.asarray(tok), caches, jnp.asarray(t["bt"]),
                          jnp.asarray(pos), jnp.ones((tok.shape[0],), bool))
        logits.append(np.asarray(lg))
    return logits


def _ref_train_dp(t):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.optim.optimizers import AdamWConfig
    from repro.train import (TrainConfig, init_train_state,
                             make_train_step)
    cfg = _jcfg(t["arch"], "fp32")
    mesh = _jmesh((t["dp"],), ("data",))
    opt = AdamWConfig(lr=1e-3)
    tc = TrainConfig(grad_clip=1.0, data_parallel=t["dp"])
    state = init_train_state(jax.tree.map(jnp.asarray, t["params"]), opt,
                             tc)
    rep, bsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    state = jax.device_put(state, rep)
    step = jax.jit(make_train_step(cfg, opt, tc=tc), in_shardings=(rep, bsh),
                   out_shardings=(rep, None))
    losses, grads = [], []
    for b in t["batches"]:
        mu0 = [np.asarray(m) for m in jax.tree.leaves(state["opt"]["mu"])]
        state, m = step(state, jax.device_put(
            jax.tree.map(jnp.asarray, b), bsh))
        losses.append(float(m["loss"]))
        grads.append([(np.asarray(m1) - opt.b1 * m0) / (1 - opt.b1)
                      for m0, m1 in zip(mu0, jax.tree.leaves(
                          state["opt"]["mu"]))])
    return losses, [np.asarray(x) for x in jax.tree.leaves(
        state["params"])], grads


_REF = {"loss_grads": _ref_loss_grads, "moe": _ref_moe,
        "decode_paged": _ref_decode_paged, "train_dp": _ref_train_dp}


def _reference_main(path):
    with open(path + ".tasks", "rb") as f:
        tasks = pickle.load(f)
    t0 = time.time()
    results = [_REF[t["kind"]](t) for t in tasks]
    with open(path, "wb") as f:
        pickle.dump(results, f)
    print(f"reference: {len(tasks)} tasks in {time.time() - t0:.1f} s")


# ------------------------------------------------------------ port ----
def on_ranks(fn, job, timeout=300):
    """``fn(rank, world, job, device)`` of this module on four gloo
    ranks; returns each rank's result."""
    from repro_torch.distributed.lns_dp import run_on_ranks
    return run_on_ranks(WORLD, fn, job, device="cpu", timeout=timeout)


def numpy_params(arch, seed=0):
    """The port's ``init_params`` of the reduced ``arch`` at ``seed``, as
    numpy."""
    from repro_torch.nn import init_params, params_to_numpy
    return params_to_numpy(init_params(seed, _tcfg(arch, "fp32"),
                                       device="cpu"))


def _tcfg(arch, numerics, **kw):
    from repro_torch import configs
    return configs.reduced(configs.get_config(arch)).with_(
        numerics=numerics, remat="none", **kw)


def _tmesh(shape, axes=AXES):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, "cpu")


def loss_and_grads(params, batch, cfg, rt):
    """``loss_fn`` and the gradient of every leaf of ``params`` (tensors),
    zero where unused."""
    import torch
    from repro_torch.nn import loss_fn
    from repro_torch.pytree import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(params)
    live = [t.detach().requires_grad_() for t in leaves]
    loss = loss_fn(tree_unflatten(treedef, live), batch, cfg, rt)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(live, grads)]
    return loss.detach(), tree_unflatten(treedef, grads)


class LinearLog:
    """Records every ``LNSRuntime.linear`` output while active."""

    def __enter__(self):
        from repro_torch.core.spec import LNSRuntime
        self.outs, self._orig = [], LNSRuntime.linear
        orig, outs = self._orig, self.outs

        def rec(rt_, x, w):
            y = orig(rt_, x, w)
            outs.append(y.detach())
            return y
        LNSRuntime.linear = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.core.spec import LNSRuntime
        LNSRuntime.linear = self._orig


def rank_loss_grads(rank, world, job, device, meshes=None):
    """Each case of ``job["cases"]`` (arch, port numerics, mesh shape, log,
    batch): the loss and the full gradients (gathered) from the sharded
    parameters and batch; with ``log`` also every linear's output
    gathered whole (the meshes' model axes split the sequence, so a
    block of it is shorter than the whole)."""
    import torch
    from repro_torch.distributed.sharding import (batch_specs, gather_tree,
                                                  param_specs, shard_tree)
    from repro_torch.distributed.spmd import Sharded
    from repro_torch.nn import Runtime, params_from_numpy
    from repro_torch.pytree import tree_leaves
    meshes = meshes or {s: _tmesh(s) for s in MESHES}
    out = []
    for arch, numerics, shape, log, batch in job["cases"]:
        cfg = _tcfg(arch, numerics)
        mesh = meshes[tuple(shape)]
        full = params_from_numpy(job["params"][arch], "cpu")
        specs = param_specs(full)
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        b = shard_tree(b, batch_specs(b), mesh)
        with LinearLog() as rec:
            loss, g = loss_and_grads(shard_tree(full, specs, mesh), b, cfg,
                                     Runtime(mesh=mesh))
        g = [x.numpy() for x in tree_leaves(gather_tree(g, specs, mesh))]
        outs = None
        if log:
            # A linear runs on the rank's block of the sequence, or on the
            # whole sequence where its block gathers it first (Mamba2).
            seq = batch["tokens"].shape[1]
            sh = Sharded(mesh, ("data",), "model", True)
            outs = [sh.gather_data(y if y.shape[1] == seq else
                                   sh.gather_seq(y)).numpy()
                    for y in rec.outs]
        out.append((float(loss), g, outs))
    return out


def _moe_pol():
    from repro_torch.core.numerics import get_policy
    return get_policy("fp32")


def _moe_unit(c, meshes):
    """The port's ``moe_ep`` / ``moe_ep_replicated`` of a unit case on this
    rank's block, gathered whole."""
    import torch
    from repro_torch.distributed.sharding import P, local_shard
    from repro_torch.distributed.spmd import Sharded
    from repro_torch.nn.moe import MoERuntime, moe_ep, moe_ep_replicated
    cfg = _tcfg(c["arch"], "fp32")
    mesh = meshes[(WORLD // c["tp"], c["tp"])]
    p = {k: torch.from_numpy(v) for k, v in c["p"].items()}
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = local_shard(p[k], P("model", None, None), mesh)
    seq = c["form"] == "ep"
    x = local_shard(torch.from_numpy(c["x"]),
                    P("data", "model" if seq else None, None), mesh)
    fn = moe_ep if seq else moe_ep_replicated
    with torch.no_grad():
        y, aux = fn(p, x, cfg, _moe_pol(), MoERuntime(mesh))
    sh = Sharded(mesh, ("data",), "model", seq)
    return sh.gather_data(sh.gather_seq(y)).numpy(), float(aux)


def _decode_paged(c, mesh):
    """Paged decode steps under a mesh: the logits of each step, gathered
    over the batch."""
    import torch
    from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                                  param_specs, shard_tree)
    from repro_torch.distributed.spmd import Sharded
    from repro_torch.nn import (Runtime, decode_step_paged,
                                init_paged_caches, params_from_numpy)
    cfg = _tcfg(c["arch"], "fp32")
    full = params_from_numpy(c["params"], "cpu")
    p = shard_tree(full, param_specs(full), mesh)
    caches = init_paged_caches(cfg, c["num_blocks"], c["block_size"],
                               torch.float32, device="cpu")
    caches = shard_tree(caches, cache_specs(caches, paged=True), mesh)
    rt = Runtime(mesh=mesh)
    sh = Sharded(mesh, ("data",), "model", False)
    logits = []
    for tok, pos in zip(c["toks"], c["pos"]):
        b = {"tok": torch.from_numpy(tok), "pos": torch.from_numpy(pos),
             "bt": torch.from_numpy(c["bt"]),
             "active": torch.ones((tok.shape[0],), dtype=torch.bool)}
        b = shard_tree(b, batch_specs(b), mesh)
        with torch.no_grad():
            lg, caches = decode_step_paged(p, b["tok"], caches, b["bt"],
                                           b["pos"], b["active"], cfg, rt)
        logits.append(sh.gather_data(lg).numpy())
    return logits


def decode_run(arch, params, toks, mesh=None, paged=False, max_len=8,
               block_size=4):
    """``decode_step`` (or ``decode_step_paged`` with ``paged``) of the
    reduced ``arch`` in fp32, teacher-forced through ``toks`` (steps × B
    × 1) from empty caches, on one device or sharded on ``mesh``: every
    step's logits and the final caches, whole, as numpy."""
    import torch
    from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                                  gather_tree, map_with_path,
                                                  param_specs, shard_tree)
    from repro_torch.distributed.spmd import Sharded
    from repro_torch.nn import (Runtime, decode_step, decode_step_paged,
                                init_decode_caches, init_paged_caches,
                                params_from_numpy)
    cfg = _tcfg(arch, "fp32")
    b = toks.shape[1]
    p = params_from_numpy(params, "cpu")
    w = max_len // block_size
    if paged:
        caches = init_paged_caches(cfg, 1 + b * w, block_size, torch.float32,
                                   device="cpu")
    else:
        caches = init_decode_caches(cfg, b, max_len, torch.float32,
                                    enc_len=max_len, device="cpu")
    specs = cache_specs(caches, paged=paged)
    rt = Runtime()
    if mesh is not None:
        p = shard_tree(p, param_specs(p), mesh)
        caches = shard_tree(caches, specs, mesh)
        rt = Runtime(mesh=mesh)
    logits = []
    for i, tok in enumerate(toks):
        x = {"tok": torch.from_numpy(tok),
             "pos": torch.full((b,), i, dtype=torch.int32),
             "bt": 1 + torch.arange(b * w, dtype=torch.int32).reshape(b, w),
             "active": torch.ones((b,), dtype=torch.bool)}
        if mesh is not None:
            x = shard_tree(x, batch_specs(x), mesh)
        with torch.no_grad():
            if paged:
                lg, caches = decode_step_paged(p, x["tok"], caches, x["bt"],
                                               x["pos"], x["active"], cfg, rt)
            else:
                lg, caches = decode_step(p, x["tok"], caches, x["pos"], cfg,
                                         rt)
        if mesh is not None:
            lg = Sharded(mesh, ("data",), "model", False).gather_data(lg)
        logits.append(lg.numpy())
    if mesh is not None:
        caches = gather_tree(caches, specs, mesh)
    leaves = []
    map_with_path(lambda _p, t: leaves.append(t.numpy()), caches)
    return logits, leaves


def rank_decode(rank, world, job, device):
    """:func:`decode_run` of each case of ``job["cases"]`` (arch, mesh
    shape, paged) on the sharded parameters and caches, and
    :func:`counted_calls` on the (2, 2) mesh."""
    meshes = {s: _tmesh(s) for s in MESHES}
    runs = [decode_run(a, job["params"][a], job["toks"][a], meshes[m], paged)
            for a, m, paged in job["cases"]]
    return dict(runs=runs, counts=counted_calls(meshes[(2, 2)], "cpu"))


def counted_calls(mesh, device):
    """``{call: bytes on the wire per kind}`` (``count_collectives``) of
    ``loss_fn`` with its gradients (reduced olmo-1b and
    deepseek-v2-lite-16b, fp32, batch 4 × 8) and of a paged decode step
    (olmo-1b, 4 slots of 2 four-line blocks), on this rank's shards built
    on ``device``: real tensors on gloo ranks, ``meta`` on a fake
    world."""
    import torch
    from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                                  param_specs, shard_tree)
    from repro_torch.distributed.spmd import count_collectives
    from repro_torch.nn import (Runtime, decode_step_paged,
                                init_paged_caches, init_params)
    rt, out = Runtime(mesh=mesh), {}

    def local(tree, specs):
        return shard_tree(tree, specs, mesh)

    def ints(*shape):
        return torch.ones(shape, dtype=torch.int32, device=device)
    for arch in ("olmo-1b", "deepseek-v2-lite-16b"):
        cfg = _tcfg(arch, "fp32")
        p = init_params(0, cfg, device=device)
        b = {"tokens": ints(4, 8), "labels": ints(4, 8)}
        with count_collectives() as tally:
            loss_and_grads(local(p, param_specs(p)),
                           local(b, batch_specs(b)), cfg, rt)
        out[f"{arch} loss_fn"] = tally
    cfg = _tcfg("olmo-1b", "fp32")
    p = init_params(0, cfg, device=device)
    c = init_paged_caches(cfg, 9, 4, torch.float32, device=device)
    x = {"tok": ints(4, 1), "pos": ints(4),
         "bt": 1 + torch.arange(8, dtype=torch.int32,
                                device=device).reshape(4, 2),
         "active": torch.ones((4,), dtype=torch.bool, device=device)}
    x = local(x, batch_specs(x))
    with torch.no_grad(), count_collectives() as tally:
        decode_step_paged(local(p, param_specs(p)), x["tok"],
                          local(c, cache_specs(c, paged=True)), x["bt"],
                          x["pos"], x["active"], cfg, rt)
    out["olmo-1b decode_step_paged"] = tally
    return out


def rank_moe_jobs(rank, world, job, device):
    """The MoE tests' port side: the EP unit cases, the whole-model losses
    and the paged decode steps."""
    meshes = {s: _tmesh(s) for s in MESHES}
    units = [_moe_unit(c, meshes) for c in job["units"]]
    losses = [r[0] for r in rank_loss_grads(
        rank, world, dict(cases=job["losses"], params=job["params"]),
        device, meshes)]
    dec = job["decode"]
    return dict(units=units, losses=losses,
                decode=_decode_paged(dec, meshes[tuple(dec["mesh"])]))


def _steps(step, state, batches, block=None):
    """``step`` over ``batches`` (numpy), each cut to ``block`` (a function
    of the batch) when given; returns (the losses, the state)."""
    import torch
    losses = []
    for b in batches:
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        if block is not None:
            b = block(b)
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, state


def _state(arch, params, opt, tc):
    from repro_torch.nn import params_from_numpy
    from repro_torch.train import init_train_state
    return init_train_state(params_from_numpy(params, "cpu"), opt, tc)


def rank_train_dp(rank, world, job, device):
    """``make_train_step`` with ``data_parallel=world`` on the default
    group: every rank its block of each global batch; returns the losses
    and the final parameters (numpy)."""
    from repro_torch.nn import Runtime, params_to_numpy
    from repro_torch.optim.optimizers import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step
    cfg = _tcfg(job["arch"], "fp32")
    opt, tc = AdamWConfig(lr=1e-3), TrainConfig(grad_clip=1.0,
                                                data_parallel=world)
    n = job["batches"][0]["tokens"].shape[0] // world
    losses, state = _steps(
        make_train_step(cfg, opt, Runtime(), tc),
        _state(job["arch"], job["params"], opt, tc), job["batches"],
        lambda b: {k: v[rank * n:(rank + 1) * n] for k, v in b.items()})
    return losses, params_to_numpy(state["params"])


def _poison_grad(leaf):
    """``torch.autograd.grad`` with the gradient of ``leaf`` made NaN."""
    import torch
    orig = torch.autograd.grad

    def grad(*a, **k):
        out = list(orig(*a, **k))
        out[leaf] = torch.full_like(out[leaf], float("nan"))
        return tuple(out)
    return grad


def rank_train_guard_compress(rank, world, job, device):
    """``make_train_step`` under a (2, 2) mesh with ``compress_grads`` and
    ``nan_guard``: a clean step, then a step whose gradient of leaf 0 is
    NaN on the last rank only.  Then, with ``nan_guard`` alone, one step
    so poisoned, where the other ranks' gradients stay finite until the
    guard.  Returns (the clean step's loss, its parameters, residual and
    AdamW first moment gathered whole; each poisoned step's
    ``update_skipped`` and whether it left the parameters and the
    optimizer state as they were, bit for bit)."""
    from unittest import mock
    import torch
    from repro_torch.distributed.sharding import (batch_specs, gather_tree,
                                                  shard_tree)
    from repro_torch.nn import Runtime, params_to_numpy
    from repro_torch.optim.optimizers import AdamWConfig
    from repro_torch.pytree import tree_leaves
    from repro_torch.train import (TrainConfig, make_train_step,
                                   train_state_specs)
    cfg = _tcfg(job["arch"], "fp32")
    mesh = _tmesh((2, 2))
    opt = AdamWConfig(lr=1e-3)

    def batch(i):
        b = {k: torch.from_numpy(v) for k, v in job["batches"][i].items()}
        return shard_tree(b, batch_specs(b), mesh)

    def poisoned(step, state, b):
        with mock.patch.object(torch.autograd, "grad", _poison_grad(0)) \
                if rank == world - 1 else contextlib.nullcontext():
            new, m = step(state, b)
        kept = all(torch.equal(a, c) for a, c in zip(
            tree_leaves({k: new[k] for k in ("params", "opt")}),
            tree_leaves({k: state[k] for k in ("params", "opt")})))
        return int(m["update_skipped"]), kept and int(new["step"]) == \
            int(state["step"]) + 1

    out = []
    for tc in (TrainConfig(grad_clip=1.0, compress_grads=True,
                           nan_guard=True), TrainConfig(nan_guard=True)):
        full = _state(job["arch"], job["params"], opt, tc)
        specs = train_state_specs(full)
        state = shard_tree(full, specs, mesh)
        step = make_train_step(cfg, opt, Runtime(mesh=mesh), tc)
        if tc.compress_grads:
            state, m = step(state, batch(0))
            done = gather_tree(state, specs, mesh)
            out.append((float(m["loss"]), params_to_numpy(done["params"]),
                        params_to_numpy(done["residual"]),
                        params_to_numpy(done["opt"]["mu"])))
        out.append(poisoned(step, state, batch(1)))
    return out


def rank_train_mesh_and_ckpt(rank, world, job, device):
    """On four ranks: ``data_parallel=4`` steps (:func:`rank_train_dp`);
    ``make_train_step`` under a (2, 2) mesh on the sharded state; then a
    checkpoint of that sharded state saved at (2, 2), restored at (1, 4)
    with ``shardings=``, and the reference's checkpoint restored at
    (1, 4).  Returns (dp result, (mesh losses, final full params), whether
    each restore equals the shards of the full tree,
    :func:`rank_train_guard_compress`'s result)."""
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import CheckpointManager, load_checkpoint
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  batch_specs, gather_tree,
                                                  map_with_path, shard_tree)
    from repro_torch.nn import Runtime, params_from_numpy, params_to_numpy
    from repro_torch.optim.optimizers import AdamWConfig
    from repro_torch.pytree import tree_leaves
    from repro_torch.train import (TrainConfig, make_train_step,
                                   train_state_specs)
    dp = rank_train_dp(rank, world, job, device)
    cfg = _tcfg(job["arch"], "fp32")
    opt, tc = AdamWConfig(lr=1e-3), TrainConfig(grad_clip=1.0)
    m22, m14 = _tmesh((2, 2)), _tmesh((1, 4))
    full = _state(job["arch"], job["params"], opt, tc)
    specs = train_state_specs(full)
    losses, state = _steps(
        make_train_step(cfg, opt, Runtime(mesh=m22), tc),
        shard_tree(full, specs, m22), job["batches"],
        lambda b: shard_tree(b, batch_specs(b), m22))
    done = gather_tree(state, specs, m22)
    mesh_run = (losses, params_to_numpy(done["params"]))

    def shardings(mesh):
        return map_with_path(lambda _p, s: NamedSharding(mesh, s), specs)
    CheckpointManager(job["ckpt_dir"]).save(3, state, shardings=shardings(m22))
    dist.barrier()
    restored = {}
    for name, tree, where in (("port", done, job["ckpt_dir"]),
                              ("reference", params_from_numpy(
                                  job["ref_state"], "cpu"), job["ref_dir"])):
        want = shard_tree(tree, specs, m14)
        got = load_checkpoint(where, 3, want, shardings=shardings(m14))
        restored[name] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got), tree_leaves(want)))
    return dp, mesh_run, restored, rank_train_guard_compress(
        rank, world, job, device)


def adamw_ratio(want_params, want_grads, got_params, lr=1e-3, eps=1e-8):
    """The fp32 AdamW steps' tier of ``tests/test_torch_lm_steps.py``: the
    largest ratio of |got - want| to 1e-5 × the leaf's largest magnitude
    plus lr × Σ_t min(2, 2 · 1e-5 · max|g_t| / (|g_t| + ε))."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(want_params, got_params)):
        a, b = np.asarray(a), np.asarray(b)
        carried = sum(np.minimum(2.0, 2e-5 * np.abs(g[i]).max()
                                 / (np.abs(g[i]) + eps)) for g in want_grads)
        tol = 1e-5 * np.abs(a).max() + lr * carried
        d = np.abs(b - a)
        ratio = np.divide(d, tol, out=np.zeros_like(d), where=d > 0)
        worst = max(worst, float(ratio.max()))
    return worst


def lm_batch(cfg, b, s, seed):
    """Tokens and labels (b × s) and the audio stub's frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("encdec", "audio"):
        out["frontend_embeds"] = rng.normal(
            size=(b, s, cfg.d_model)).astype(np.float32)
    return out


def loss_grad_runs(tmpdir, fp32, lns=(), b=2):
    """The runs the loss-and-gradient tests read, every case from one
    reference subprocess and one run of four ranks.

    ``fp32``: (arch, mesh, seq) cases, each against the reference on the
    same mesh.  ``lns``: (arch, reference mesh) cases of lns16-train at
    seq 32 on both meshes, the port's linears logged, with the port's
    one-device forward beside them.  Returns ``{"fp32": [(port rank 0's
    (loss, grads), every rank's loss, (ref loss, grads))], "lns": [(arch,
    ref mesh, ref (loss, grads), [(mesh, port (loss, grads, linears),
    ranks' losses)], one-device (loss, linears))]}``."""
    import torch
    from repro_torch.nn import Runtime, loss_fn, params_from_numpy
    path = os.path.join(str(tmpdir), "ref.pkl")
    archs = sorted({c[0] for c in list(fp32) + list(lns)})
    params = {a: numpy_params(a) for a in archs}
    batches = {(a, s): lm_batch(_tcfg(a, "fp32"), b, s, len(a) + s)
               for a, _, s in fp32}
    batches.update({(a, 32): lm_batch(_tcfg(a, "fp32"), b, 32, len(a) + 32)
                    for a, _ in lns})
    tasks = [dict(kind="loss_grads", arch=a, numerics="fp32", mesh=m,
                  batch=batches[a, s], params=params[a])
             for a, m, s in fp32]
    for a, m in lns:
        tasks.append(dict(kind="loss_grads", arch=a,
                          numerics="lns16-train-emulate", mesh=m,
                          batch=batches[a, 32], params=params[a]))
    proc = start_reference(tasks, path)
    cases = [(a, "fp32", m, False, batches[a, s]) for a, m, s in fp32] + \
        [(a, "lns16-train-pallas", m, True, batches[a, 32])
         for a, _ in lns for m in MESHES]
    ranks = on_ranks(rank_loss_grads, dict(cases=cases, params=params))
    ones = []
    for a, _ in lns:
        tb = {k: torch.from_numpy(v) for k, v in batches[a, 32].items()}
        with LinearLog() as rec, torch.no_grad():
            one = float(loss_fn(params_from_numpy(params[a], "cpu"), tb,
                                _tcfg(a, "lns16-train-pallas"), Runtime()))
        ones.append((one, [y.numpy() for y in rec.outs]))
    ref = finish_reference(proc)
    out = {"fp32": [], "lns": []}
    for i in range(len(fp32)):
        out["fp32"].append((ranks[0][i][:2], [r[i][0] for r in ranks],
                            ref[i]))
    at = len(fp32)
    for j, (a, m) in enumerate(lns):
        per = [(mesh, ranks[0][at + k], [r[at + k][0] for r in ranks])
               for k, mesh in enumerate(MESHES)]
        out["lns"].append((a, m, ref[len(fp32) + j], per, ones[j]))
        at += len(MESHES)
    return out


def check_fp32(case, what):
    """A fp32 case of :func:`loss_grad_runs`: every rank reports one loss,
    within rtol 1e-5 of the reference's mesh loss; every gradient within
    1e-5 × its leaf's largest magnitude (the fp32 tier of
    ``tests/lm_parity.py``)."""
    (loss, grads), losses, (jloss, jgrads) = case
    rel = abs(loss - jloss) / abs(jloss)
    worst = leaf_rel_max(grads, jgrads)
    print(f"\n{what}: loss {loss:.7f} vs {jloss:.7f} (rel {rel:.3g}); "
          f"grad max |diff| / leaf max {worst:.3g}")
    assert len(set(losses)) == 1
    assert rel <= 1e-5
    assert worst <= 1e-5


def check_lns_forward(case, mesh):
    """The lns16-train forward on ``mesh`` equals the one-device forward
    bit for bit: every linear's output (its ⊞-MAC codes, decoded) and the
    loss, on every rank."""
    arch, _, _, per, (one, one_lin) = case
    _, (loss, _, linears), losses = per[MESHES.index(mesh)]
    print(f"\n{arch} lns16-train {mesh}: loss {loss!r} vs one device "
          f"{one!r}; {len(linears)} linear outputs compared")
    assert set(losses) == {one}
    assert len(linears) == len(one_lin)
    for k, (a, b) in enumerate(zip(linears, one_lin)):
        assert a.shape == b.shape, k
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), k


def check_lns_grads(case, mesh, tier):
    """The lns16-train gradients on ``mesh`` within ``tier`` relative L2
    over the tree of the reference's on its mesh."""
    arch, rmesh, (jloss, jgrads), per, _ = case
    _, (_, grads, _), _ = per[MESHES.index(mesh)]
    grel = rel_l2_tree(grads, jgrads)
    print(f"\n{arch} lns16-train {mesh}: gradient relative L2 to the "
          f"reference's on {rmesh} {grel:.4g} (tier {tier}); worst leaf "
          f"max |diff| / leaf max {leaf_rel_max(grads, jgrads):.3g}")
    assert grel <= tier


def inferred_drops(out, x, p, cfg, shared=True):
    """The (token, k) assignments missing from an MoE output ``out`` (N,
    d) of tokens ``x`` (N, d), fp32, parameters ``p`` (numpy): per token,
    the subset of its top-k routed contributions (computed here in
    float64) that the output holds."""
    import itertools
    m = cfg.moe
    x = x.astype(np.float64)
    logits = x @ p["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :m.top_k]
    w = np.take_along_axis(probs, ids, -1)
    w /= w.sum(-1, keepdims=True)

    def silu(v):
        return v / (1 + np.exp(-v))

    def ffn(xt, e):
        g = silu(xt @ p["w_gate"][e].astype(np.float64))
        u = xt @ p["w_up"][e].astype(np.float64)
        return (g * u) @ p["w_down"][e].astype(np.float64)
    base = np.zeros_like(x)
    if shared and m.n_shared:
        h = silu(x @ p["shared_gate"].astype(np.float64)) \
            * (x @ p["shared_up"].astype(np.float64))
        base = h @ p["shared_down"].astype(np.float64)
    drops = set()
    for t in range(x.shape[0]):
        ys = [w[t, j] * ffn(x[t], ids[t, j]) for j in range(m.top_k)]
        best = min((float(np.abs(out[t] - base[t] - sum(
            (ys[j] for j in keep), np.zeros(x.shape[1]))).max()), keep)
            for r in range(m.top_k + 1)
            for keep in itertools.combinations(range(m.top_k), r))
        drops |= {(t, j) for j in range(m.top_k) if j not in best[1]}
    return drops


def rel_l2_tree(got, want):
    """The whole tree's relative L2 distance of ``got`` from ``want``."""
    num = sum(float(((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                     ** 2).sum()) for a, b in zip(got, want))
    den = sum(float((np.asarray(b, np.float64) ** 2).sum()) for b in want)
    return float(np.sqrt(num / den))


def leaf_rel_max(got, want):
    """Per leaf max |diff| / the leaf's largest magnitude; the largest."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        m = float(np.abs(b).max())
        d = float(np.abs(a - b).max())
        worst = max(worst, d / m if m else (0.0 if d == 0 else np.inf))
    return worst


if __name__ == "__main__":
    _reference_main(sys.argv[1])

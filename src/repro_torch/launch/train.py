"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Wires the data pipeline → train step → checkpoint manager, with restart:
kill the process mid-run and relaunch with the same ``--ckpt-dir``, and it
resumes from the latest atomic checkpoint at the exact batch index (the
data are a function of the step).  The flags and the ``[train] ...`` lines
are the JAX package's, plus ``--device`` (``cuda`` by default, which needs
a card; ``cpu`` runs the kernels' plain versions).

``--data-parallel N`` trains on N ranks (``float-psum``: each rank its
block of the batch, the gradients all-reduced to their mean): the ranks of
``torchrun``, or N processes this launcher spawns (gloo on the CPU, NCCL
with one card each).  Rank 0 alone prints the loss and writes the
checkpoints and the metrics.
"""
from __future__ import annotations

import argparse
import os
import time

import torch.distributed as dist

from ..ckpt import CheckpointManager
from ..configs import get_config, reduced
from ..core.plan import NumericsPlan
from ..data import DataConfig, SyntheticLMDataset
from ..devices import resolve_device
from ..nn import Runtime, init_params
from ..nn.config import ShapeCell
from ..nn.model import known_layer_paths
from ..obs import JsonlSink, MetricsRegistry, StepTimer, maybe_profile
from ..obs import metrics as _obs
from ..optim.optimizers import AdamWConfig, SGDConfig
from ..train import TrainConfig, init_train_state, make_train_step


def _leaf_layer(path: str, known) -> str:
    """The longest known layer path that is a prefix of a parameter's
    dotted path (else its first component)."""
    best = ""
    for kp in known:
        if (path == kp or path.startswith(kp + ".")) and len(kp) > len(best):
            best = kp
    return best or path.split(".")[0]


def _param_paths(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _param_paths(v, path)
        else:
            yield path, v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", choices=["adamw", "sgd"], default="adamw")
    ap.add_argument("--numerics", default="bf16",
                    help="a NumericsSpec alias (bf16 | fp32 | lns16-qat | "
                    "lns12-qat | lns16-exact | lns16-train-{emulate,pallas} "
                    "| ...) optionally followed by key=value overrides, "
                    "e.g. 'lns16-train-pallas,reduce.mode=boxplus', or a "
                    "per-layer NumericsPlan string with ';'-separated "
                    "<pattern>=<key>:<value> rules, e.g. "
                    "'bf16;layers.mlp=fmt:lns16,delta:lut20,"
                    "quantize:params'")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="ranks of the data-parallel step (torchrun's, or "
                    "processes spawned here)")
    ap.add_argument("--reduce-mode", default=None,
                    choices=["float-psum", "boxplus"],
                    help="gradient all-reduce semantics; 'boxplus' is the "
                    "paper-MLP data-parallel path, the LM step uses "
                    "float-psum.  Default: whatever the --numerics spec "
                    "says (reduce.mode=...), else float-psum")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write per-step numerics + timing telemetry as "
                    "JSONL (loss, step_time_ms, per-layer saturation/"
                    "zero-rate counters of the updated parameters); weight "
                    "values stay identical to a run without --metrics")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the training loop "
                    "there (also honours $REPRO_TRACE_DIR)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--allow-numerics-mismatch", action="store_true",
                    help="restore a checkpoint whose stamped numerics "
                    "plan differs from --numerics (deliberate format "
                    "migration; LNS codes are NOT re-encoded)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels on the card) or cpu (their "
                    "plain PyTorch versions)")
    args = ap.parse_args(argv)

    dp = args.data_parallel
    if dp > 1:
        if args.batch % dp:
            raise SystemExit(f"--batch {args.batch} not divisible by "
                             f"--data-parallel {dp}")
        if not dist.is_initialized():
            return _launch_ranks(args, argv)
    rank = dist.get_rank() if dp > 1 else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    # An explicit --reduce-mode goes onto the default spec's segment; the
    # string is kept as written so an explicit reduce.mode=boxplus still
    # reaches make_train_step's guard.
    head, *rules = args.numerics.split(";")
    if args.reduce_mode is not None:
        head += f",reduce.mode={args.reduce_mode}"
    numerics = ";".join([head] + rules)
    plan = NumericsPlan.parse(numerics)
    cfg = cfg.with_(numerics=numerics,
                    remat="none" if args.reduced else "block")
    known = known_layer_paths(cfg)
    plan.validate_paths(known)
    say(f"[train] numerics spec: {plan}")
    cell = ShapeCell("train_cli", args.seq, args.batch, "train")

    opt = (AdamWConfig(lr=args.lr) if args.optimizer == "adamw"
           else SGDConfig(lr=args.lr, momentum=0.9))
    tc = TrainConfig(microbatches=args.microbatches, grad_clip=1.0,
                     compress_grads=args.compress_grads,
                     data_parallel=args.data_parallel)
    rt = Runtime()
    if dp > 1:
        from ..core.spec import NumericsSpec
        eff_mode = (plan.reduce.mode
                    if "reduce.mode" in NumericsSpec.explicit_keys(head)
                    else "float-psum")
        say(f"[train] data-parallel over {dp} devices "
            f"(reduce.mode={eff_mode})")

    params = init_params(args.seed, cfg, device=device)
    state = init_train_state(params, opt, tc)
    # Checkpoints carry the canonical plan string; a restore under another
    # arithmetic fails unless explicitly allowed.
    mgr = CheckpointManager(
        args.ckpt_dir, numerics=plan,
        allow_numerics_mismatch=args.allow_numerics_mismatch) \
        if args.ckpt_dir else None
    start = 0
    if mgr is not None:
        restored, step0 = mgr.restore_latest(state, device)
        if restored is not None:
            state, start = restored, int(step0)
            say(f"[train] resumed from step {start}")
        if rank != 0:
            mgr = None

    ds = SyntheticLMDataset(cfg, cell, DataConfig(seed=args.seed))
    # The state is donated, as the JAX package's CLI jits its step with
    # donate_argnums=0: the step writes it in place.
    base_step = make_train_step(cfg, opt, rt, tc, donate=True)
    if args.metrics and rank == 0:
        # The plain step inside a collector; the updated parameters are
        # observed per leaf after the step (reads only, so the weights are
        # those of a run without --metrics).
        def step_fn(state, batch):
            with _obs.collecting() as col:
                state2, metrics = base_step(state, batch)
                for path, leaf in _param_paths(state2["params"]):
                    layer = _leaf_layer(path, known)
                    spec = plan.resolve(layer)
                    if spec.metrics == "off" or spec.fmt is None:
                        continue
                    _obs.observe_float(leaf, spec.fmt, layer=layer,
                                       op=f"param.{path.rsplit('.', 1)[-1]}")
                return state2, metrics, col.taps()

        registry = MetricsRegistry(base_labels={
            "component": "train", "arch": args.arch, "spec": str(plan)})
        lanes = {p: plan.runtime_for(p).lane_on(device) for p in known}
        sink = JsonlSink(args.metrics)
    else:
        step_fn = base_step
        registry = sink = None
    timer = StepTimer(device=device)

    t0 = time.time()
    losses = []
    with maybe_profile(args.profile_dir):
        for step in range(start, args.steps):
            batch = ds.batch_on(step, device)
            if dp > 1:
                n = args.batch // dp
                batch = {k: v[rank * n:(rank + 1) * n]
                         for k, v in batch.items()}
            with timer.span("train.step"):
                if sink is not None:
                    state, metrics, taps = step_fn(state, batch)
                else:
                    state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))  # waits for the card
            if sink is not None:
                registry.merge_numerics_taps(_obs.host_taps(taps),
                                             lanes=lanes)
                sink.write(registry.rows(reset=True), step=step + 1,
                           loss=losses[-1],
                           step_time_ms=timer.last("train.step"))
            if (step + 1) % args.log_every == 0 or step == args.steps - 1:
                dt = (time.time() - t0) / max(len(losses), 1)
                say(f"[train] step {step + 1}/{args.steps} "
                      f"loss {losses[-1]:.4f} ({dt * 1e3:.0f} ms/step)")
            if mgr is not None and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, state, blocking=False)
    if mgr is not None:
        mgr.save(args.steps, state, blocking=True)
    if sink is not None:
        summary = timer.summary(skip_first=1)["train.step"]
        sink.write_row({"kind": "summary", "name": "train.step_time_ms",
                        **summary, "arch": args.arch, "spec": str(plan),
                        "steps": len(losses), "final_loss": losses[-1]})
        sink.close()
        say(f"[train] metrics written to {args.metrics} "
              f"(mean step {summary['mean_ms']:.1f} ms)")
    say(f"[train] done: first loss {losses[0]:.4f} → last "
          f"{losses[-1]:.4f}")
    return losses


def _cli_rank(rank: int, world: int, job: dict, device):
    """One rank of :func:`_launch_ranks`: the launcher inside the group."""
    return main(job["argv"])


def _launch_ranks(args, argv):
    """``--data-parallel N`` with no process group: join torchrun's
    (``WORLD_SIZE`` in the environment), else spawn N ranks here and
    return rank 0's losses."""
    import sys
    from ..distributed.lns_dp import run_on_ranks
    dp = args.data_parallel
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != dp:
            raise SystemExit(f"--data-parallel {dp} under torchrun with "
                             f"WORLD_SIZE={os.environ['WORLD_SIZE']}")
        if device.type == "cuda":
            import torch
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        try:
            return main(argv)
        finally:
            dist.destroy_process_group()
    if device.type == "cuda":
        import torch
        if dp > torch.cuda.device_count():
            raise SystemExit(f"--data-parallel {dp} needs {dp} CUDA cards; "
                             f"this host has {torch.cuda.device_count()}")
    outs = run_on_ranks(dp, _cli_rank,
                        {"argv": sys.argv[1:] if argv is None else argv},
                        device=device.type, timeout=24 * 3600)
    return outs[0]


if __name__ == "__main__":
    main()

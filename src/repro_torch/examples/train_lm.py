"""End-to-end LM training: data → train_step → checkpoints.

The default preset trains a ~25M-param qwen3-family model for 100 steps.
``--preset 100m --steps 300`` is the larger run (~100M
params, a few hundred steps); ``python -m repro_torch.launch.train`` runs
any full config of ``repro_torch.configs``.

Run:  python -m repro_torch.examples.train_lm [--steps 100] [--device cpu]
Resume drill: Ctrl-C mid-run, re-run with the same --ckpt-dir.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from ..ckpt import CheckpointManager
from ..configs import get_config
from ..data import DataConfig, SyntheticLMDataset
from ..devices import resolve_device
from ..nn import Runtime, init_params
from ..nn.config import ShapeCell
from ..optim.optimizers import AdamWConfig
from ..train import TrainConfig, init_train_state, make_train_step

PRESETS = {
    # ~25M params: d=256, 8 layers
    "25m": dict(n_layers=8, d_model=256, n_heads=8, n_kv_heads=4,
                d_head=32, d_ff=1024, vocab_size=8192),
    # ~100M params: d=640, 12 layers
    "100m": dict(n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
                 d_head=64, d_ff=2560, vocab_size=32768),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="25m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--numerics", default="bf16")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("qwen3-1.7b").with_(
        name=f"lm-{args.preset}", numerics=args.numerics, remat="none",
        q_chunk=128, **PRESETS[args.preset])
    print(f"[example] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"numerics={cfg.numerics}")
    cell = ShapeCell("train", args.seq, args.batch, "train")
    opt = AdamWConfig(lr=3e-4)
    tc = TrainConfig(grad_clip=1.0)

    state = init_train_state(init_params(0, cfg, device=device), opt, tc)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    restored, step0 = mgr.restore_latest(state, device)
    start = 0
    if restored is not None:
        state, start = restored, int(step0)
        print(f"[example] resumed from step {start}")

    step_fn = make_train_step(cfg, opt, Runtime(), tc)
    ds = SyntheticLMDataset(cfg, cell, DataConfig(seed=0))
    t0 = time.time()
    first = loss = None
    for step in range(start, args.steps):
        state, m = step_fn(state, ds.batch_on(step, device))
        loss = float(m["loss"])
        first = first if first is not None else loss
        if (step + 1) % 10 == 0:
            tps = cell.tokens_per_step * (step + 1 - start) / (time.time()
                                                               - t0)
            print(f"step {step+1:4d}  loss {loss:.4f}  ({tps:,.0f} tok/s)")
        if (step + 1) % 50 == 0:
            mgr.save(step + 1, state, blocking=False)
    mgr.save(args.steps, state, blocking=True)
    if first is None:
        print(f"[example] nothing to do: the checkpoint is at step {start}")
        return state
    print(f"[example] loss {first:.4f} → {loss:.4f} over "
          f"{args.steps - start} steps")
    if not loss < first:
        raise RuntimeError("training did not reduce loss")
    return state


if __name__ == "__main__":
    main()

"""The paper's technique at LM scale: bf16 vs LNS-QAT.

Trains the same small transformer LM under four numerics policies and
compares loss curves — the LM-scale analogue of the paper's Table 1
(``lns16-qat`` keeps values on the paper's LNS grid while the products
stay float matmuls; ``lns16-exact`` would route them through the ⊞-MAC
kernels).

Run:  python -m repro_torch.examples.lns_modes_comparison [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from ..configs import get_config
from ..data import DataConfig, SyntheticLMDataset
from ..devices import resolve_device
from ..nn import Runtime, init_params
from ..nn.config import ShapeCell
from ..optim.optimizers import AdamWConfig
from ..train import TrainConfig, init_train_state, make_train_step

SMALL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
             d_ff=512, vocab_size=2048, remat="none", q_chunk=64)
STEPS = 40
MODES = ("fp32", "bf16", "lns16-qat", "lns12-qat")


def train(numerics: str, device, steps: int):
    """The losses of ``steps`` AdamW steps under ``numerics``, and the
    seconds they took."""
    cfg = get_config("qwen3-1.7b").with_(numerics=numerics, **SMALL)
    cell = ShapeCell("t", 128, 4, "train")
    opt = AdamWConfig(lr=1e-3)
    state = init_train_state(init_params(0, cfg, device=device), opt)
    fn = make_train_step(cfg, opt, Runtime(), TrainConfig())
    ds = SyntheticLMDataset(cfg, cell, DataConfig(seed=0))
    t0 = time.time()
    losses = []
    for s in range(steps):
        state, m = fn(state, ds.batch_on(s, device))
        losses.append(float(m["loss"]))
    return losses, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = {}
    for mode in MODES:
        losses, dt = train(mode, device, STEPS)
        rows[mode] = losses
        print(f"{mode:10s} loss {losses[0]:.4f} → {losses[-1]:.4f} "
              f"({dt:.1f}s for {len(losses)} steps)")
    gap = rows["lns16-qat"][-1] - rows["bf16"][-1]
    print(f"\nLNS-16 QAT final-loss gap vs bf16: {gap:+.4f} "
          f"(paper's ≤~1% accuracy-gap claim, LM edition)")
    return rows


if __name__ == "__main__":
    main()

"""Training harness of the paper-reproduction experiments (Sec. 5)."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import datasets
from .mlp import MLPConfig, make_mlp, params_to_numpy

# Paper Sec. 5: weight decay tuned per dataset; the 12-bit runs needed
# larger regularization (applied every 16 steps by the fixed-point model,
# see FxpMLP.apply_decay).
WEIGHT_DECAY = {16: 0.01, 12: 0.3}


@dataclasses.dataclass
class RunResult:
    backend: str
    dataset: str
    bits: int
    approx: str
    val_curve: list
    test_acc: float
    seconds: float
    params: dict  # final weights as params_to_numpy gives them


def evaluate(model, params, x, y, batch: int = 500) -> float:
    correct = 0
    for i in range(0, len(x), batch):
        pred = model.predict(params, x[i:i + batch]).cpu().numpy()
        correct += int((pred == y[i:i + batch]).sum())
    return correct / len(x)


def run_experiment(backend: str, dataset: str, *, bits: int = 16,
                   approx: str = "lut", epochs: int = 5,
                   batch_size: int = 5, lr: float = 0.01,
                   weight_decay: float | None = None,
                   momentum: float = 0.0, seed: int = 0,
                   data_dir: str = "data", stochastic_round: bool = False,
                   numerics=None, matmul_backend: str | None = None,
                   fused: bool = True, data_parallel: int = 1,
                   reduce_mode: str | None = None,
                   grad_segments: int | None = None,
                   max_steps_per_epoch: int | None = None,
                   device="cuda") -> RunResult:
    """Train the paper MLP of ``backend`` (``"float"``, ``"fxp"`` or
    ``"lns"``) on ``device``; returns the learning curve, the test accuracy
    and the final weights.

    Paper hyperparameters: SGD, minibatch 5, lr 0.01, 20 epochs, 1:5
    validation holdout.  ``stochastic_round`` (fxp only) rounds the weight
    update stochastically, with bits from a CPU ``torch.Generator`` seeded
    ``seed * 1_000_003 + step`` (the step counted across epochs); the
    fixed-point model applies its weight decay after every 16th step of an
    epoch.  ``momentum`` (lns only) is the ⊞-momentum update.
    ``numerics`` (lns) is a spec or per-layer plan string
    (``"lns16-train-pallas"``, ``"lns16-train-pallas;hidden=fmt:lns12"``).
    ``fused=False`` trains the unfused LNS step (same codes, one pass per
    piece).  A spec with ``reduce.grad_segments`` (e.g.
    ``"lns16-train-pallas,reduce.grad_segments=5"``) trains the segmented
    data-parallel step; ``data_parallel > 1`` runs it over that many
    ranks of the caller's process group, each rank calling this function
    with its own ``device``.  ``batch_size`` must divide into the
    canonical segment count.  The loose ``matmul_backend=`` /
    ``reduce_mode=`` / ``grad_segments=`` are the deprecated spelling of
    the spec's keys (``MLPConfig`` warns).  The weights are drawn from a
    CPU ``torch.Generator`` seeded with ``seed``, so every device starts
    from the same weights.
    """
    x, yl, x_te, y_te, spec = datasets.load(dataset, data_dir, seed)
    x_tr, y_tr, x_val, y_val = datasets.train_val_split(x, yl, 5, seed)
    wd = WEIGHT_DECAY[bits] if weight_decay is None else weight_decay
    legacy = {k: v for k, v in (("matmul_backend", matmul_backend),
                                ("reduce_mode", reduce_mode),
                                ("grad_segments", grad_segments))
              if v is not None}
    if momentum and backend != "lns":
        raise ValueError(
            f"momentum={momentum} is the pure-LNS ⊞-momentum update "
            f"(core/sgd.py); the {backend!r} backend does not implement it")
    cfg = MLPConfig(n_out=spec.n_classes, lr=lr, weight_decay=wd,
                    momentum=momentum, bits=bits, approx=approx,
                    stochastic_round=stochastic_round, spec=numerics,
                    fused=fused, data_parallel=data_parallel, **legacy)
    model = make_mlp(backend, cfg, device)
    params = model.init(torch.Generator().manual_seed(seed))
    mom = model.init_momentum(params) if backend == "lns" else None
    sr = stochastic_round and backend == "fxp"
    decay = wd and hasattr(model, "apply_decay")

    rng = np.random.default_rng(seed)
    t0 = time.time()
    curve = []
    gstep = 0
    for _ in range(epochs):
        order = rng.permutation(len(x_tr))
        steps = len(order) // batch_size
        if max_steps_per_epoch is not None:
            steps = min(steps, max_steps_per_epoch)
        for s in range(steps):
            sl = order[s * batch_size:(s + 1) * batch_size]
            if sr:
                params, _ = model.train_step(
                    params, x_tr[sl], y_tr[sl],
                    torch.Generator().manual_seed(seed * 1_000_003 + gstep))
            elif mom is not None:
                params, mom, _ = model.train_step(params, x_tr[sl], y_tr[sl],
                                                  mom)
            else:
                params, _ = model.train_step(params, x_tr[sl], y_tr[sl])
            gstep += 1
            if decay and (s + 1) % 16 == 0:
                params = model.apply_decay(params, 16)
        curve.append(evaluate(model, params, x_val, y_val))
    test = evaluate(model, params, x_te, y_te)
    return RunResult(backend, dataset, bits, approx, curve, test,
                     time.time() - t0, params_to_numpy(params))

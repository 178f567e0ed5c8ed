"""SGD (+momentum) and AdamW as plain functions over the parameter tree.

Not ``torch.optim``: the state mirrors the parameter tree leaf for leaf, as
in the JAX package, and each update is a pure function ``(params, grads,
state, step) → (params, state)`` whose arithmetic, update order and
epsilon placement are the reference's, in float32.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.spec import TORCH_DTYPES
from ..pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten



@dataclasses.dataclass(frozen=True)
class SGDConfig:
    kind: str = "sgd"
    lr: float = 1e-2
    momentum: float = 0.0
    weight_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    kind: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"   # bf16 moments halve optimizer memory


OptimizerConfig = SGDConfig | AdamWConfig


def sgd_init(cfg: SGDConfig, params):
    if cfg.momentum == 0.0:
        return {}
    return {"m": tree_map(torch.zeros_like, params)}


def sgd_update(cfg: SGDConfig, params, grads, state, step):
    del step
    if cfg.momentum:
        m = tree_map(lambda m_, g: cfg.momentum * m_ + g.to(m_.dtype),
                     state["m"], grads)
        state, eff = {"m": m}, m
    else:
        eff = grads
    new = tree_map(
        lambda p, g: (p - cfg.lr * (g.to(p.dtype)
                                    + cfg.weight_decay * p)).to(p.dtype),
        params, eff)
    return new, state


def adamw_init(cfg: AdamWConfig, params):
    dt = TORCH_DTYPES[cfg.moment_dtype]
    z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": tree_map(z, params), "nu": tree_map(z, params)}


def adamw_update(cfg: AdamWConfig, params, grads, state, step):
    """``step`` is the 0-based step count, a 0-d int tensor (or an int);
    the bias corrections are taken in float32 on the parameters' device."""
    t = (torch.as_tensor(step) + 1).to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                      device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                      device=t.device), t)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        mu2 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        nu2 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g32 * g32
        step_ = (mu2 / c1) / (torch.sqrt(nu2 / c2) + cfg.eps)
        p32 = p.to(torch.float32)
        p2 = p32 - cfg.lr * (step_ + cfg.weight_decay * p32)
        return p2.to(p.dtype), mu2.to(m.dtype), nu2.to(v.dtype)

    leaves, treedef = tree_flatten(params)
    out = [upd(*xs) for xs in zip(leaves, tree_leaves(grads),
                                  tree_leaves(state["mu"]),
                                  tree_leaves(state["nu"]))]
    new_p, mu, nu = (tree_unflatten(treedef, [o[i] for o in out])
                     for i in range(3))
    return new_p, {"mu": mu, "nu": nu}


def make_optimizer(cfg: OptimizerConfig):
    """``(init(params), update(params, grads, state, step))``."""
    if cfg.kind == "sgd":
        return (lambda p: sgd_init(cfg, p),
                lambda p, g, s, t: sgd_update(cfg, p, g, s, t))
    if cfg.kind == "adamw":
        return (lambda p: adamw_init(cfg, p),
                lambda p, g, s, t: adamw_update(cfg, p, g, s, t))
    raise ValueError(cfg.kind)

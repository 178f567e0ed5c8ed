"""SGD (+momentum) and AdamW as plain functions over the parameter tree.

Not ``torch.optim``: the state mirrors the parameter tree leaf for leaf, as
in the JAX package, and each update is a pure function ``(params, grads,
state, step) → (params, state)`` whose arithmetic, update order and
epsilon placement are the reference's, in float32.  Each has an in-place
form (``sgd_update_``, ``adamw_update_``) with the same arithmetic, which
writes the results into the tensors it was given: the train step's
buffer donation (``make_train_step(..., donate=True)``).
"""
from __future__ import annotations

import dataclasses
import functools

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


def _sgd_leaf(cfg: SGDConfig, p, g, *m):
    """One leaf's step: ``(new p[, new m])``."""
    if m:
        m = (cfg.momentum * m[0] + g.to(m[0].dtype),)
        g = m[0]
    return ((p - cfg.lr * (g.to(p.dtype)
                           + cfg.weight_decay * p)).to(p.dtype),) + m


def sgd_update(cfg: SGDConfig, params, grads, state, step):
    del step
    return _functional(functools.partial(_sgd_leaf, cfg), params, grads,
                       state, ["m"] if cfg.momentum else [])


def sgd_update_(cfg: SGDConfig, params, grads, state, step, keep=None):
    """:func:`sgd_update` written into ``params`` and ``state`` (see
    :func:`_in_place`)."""
    del step
    return _in_place(functools.partial(_sgd_leaf, cfg), params, grads,
                     state, ["m"] if cfg.momentum else [], keep)


def adamw_init(cfg: AdamWConfig, params):
    dt = TORCH_DTYPES[cfg.moment_dtype]
    z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": tree_map(z, params), "nu": tree_map(z, params)}


def _adamw_leaf_fn(cfg: AdamWConfig, step):
    """One leaf's step ``(p, g, mu, nu) → (new p, new mu, new nu)``.
    ``step`` is the 0-based step count, a 0-d int tensor (or an int); the
    bias corrections are taken in float32 on the parameters' device."""
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
    return upd


def adamw_update(cfg: AdamWConfig, params, grads, state, step):
    return _functional(_adamw_leaf_fn(cfg, step), params, grads, state,
                       ["mu", "nu"])


def adamw_update_(cfg: AdamWConfig, params, grads, state, step,
                  keep=None):
    """:func:`adamw_update` written into ``params`` and ``state`` (see
    :func:`_in_place`); ``step`` is read before any leaf is written."""
    return _in_place(_adamw_leaf_fn(cfg, step), params, grads, state,
                     ["mu", "nu"], keep)


def _leaf_args(params, grads, state, slots):
    """Per leaf: (parameter, gradient, its ``slots`` of ``state``)."""
    return zip(tree_leaves(params), tree_leaves(grads),
               *(tree_leaves(state[k]) for k in slots))


def _functional(leaf, params, grads, state, slots):
    """``(new params, new state)``: ``leaf`` over every leaf, the inputs
    untouched."""
    out = [leaf(*xs) for xs in _leaf_args(params, grads, state, slots)]
    treedef = tree_flatten(params)[1]
    new = [tree_unflatten(treedef, [o[i] for o in out])
           for i in range(1 + len(slots))]
    return new[0], ({k: t for k, t in zip(slots, new[1:])} if slots
                    else state)


#: Elements of a leaf that the in-place forms update at a time: the
#: arithmetic is elementwise, so a slice of a leaf gives the same bits as
#: the whole, and only one slice's temporaries are alive.
CHUNK = 1 << 22


def _chunks(olds, args):
    """``(targets, arguments)`` of each slice of one leaf: ``olds`` (the
    tensors written) and ``args`` (all that the leaf's step reads),
    flattened and cut into ``CHUNK`` elements; the whole leaf when a
    target is not contiguous."""
    if not all(t.is_contiguous() for t in olds):
        yield olds, args
        return
    olds = [t.view(-1) for t in olds]
    args = [t.reshape(-1) for t in args]
    n = olds[0].numel()
    for i in range(0, n, CHUNK):
        yield ([t[i:i + CHUNK] for t in olds],
               [t[i:i + CHUNK] for t in args])


@torch.no_grad()
def _in_place(leaf, params, grads, state, slots, keep):
    """``(params, state)`` after ``leaf``'s results are ``copy_``'d into
    them, a slice of a leaf at a time (:data:`CHUNK`), so that one slice's
    temporaries are alive at a time.  The same arithmetic as
    :func:`_functional`, bit for bit: each result is already in its leaf's
    dtype.  ``keep(new, old)`` picks what is written (the train step's
    non-finite guard), after the slice is computed."""
    for xs in _leaf_args(params, grads, state, slots):
        for olds, args in _chunks((xs[0],) + xs[2:], xs):
            _write(olds, leaf(*args), keep)
    return params, state


def _write(olds, news, keep):
    for old, new in zip(olds, news):
        old.copy_(new if keep is None else keep(new, old))


def make_optimizer(cfg: OptimizerConfig, inplace: bool = False):
    """``(init(params), update(params, grads, state, step))``; with
    ``inplace`` the update is the in-place form, ``update(params, grads,
    state, step, keep=None)``, which writes into ``params`` and ``state``
    and returns them."""
    kinds = {"sgd": (sgd_init, sgd_update, sgd_update_),
             "adamw": (adamw_init, adamw_update, adamw_update_)}
    if cfg.kind not in kinds:
        raise ValueError(cfg.kind)
    init, update, update_ = kinds[cfg.kind]
    return (functools.partial(init, cfg),
            functools.partial(update_ if inplace else update, cfg))

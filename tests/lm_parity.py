"""What the port's LM parity tests share (not a test module): the
``reduced()`` dense configs of both packages, their batches, the
whole-model check of ``loss_fn`` and its gradients, and a runner of three
``make_train_step`` steps in both packages from the reference's
parameters on the same batches (microbatches=2, grad_clip=1.0, batch 2 ×
seq 16), free-running or teacher-forced (each port step from the
reference's state before it).  The tiers and their tolerances are stated
in the test modules that call them.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.nn import layers as jlayers
from repro.nn import model as jmodel
from repro.nn.config import ShapeCell as JCell
from repro.optim import optimizers as jopt
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as jinit_state
from repro.train import make_train_step as jmake_step
from repro_torch import configs as tconfigs
from repro_torch.core import LNS16, encode
from repro_torch.nn import layers as tlayers
from repro_torch.nn import model as tmodel
from repro_torch.optim.optimizers import AdamWConfig, SGDConfig
from repro_torch.pytree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.train import (TrainConfig, init_train_state,
                               make_train_step)

DENSE = ["olmo-1b", "qwen3-1.7b", "yi-6b", "command-r-35b"]
B, S = 2, 16
STEPS = 3
OPTS = {"adamw": (jopt.AdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)),
        "sgd": (jopt.SGDConfig(lr=1e-2, momentum=0.9),
                SGDConfig(lr=1e-2, momentum=0.9))}
#: mode → (the reference's numerics, the port's)
NUMERICS = {"fp32": ("fp32", "fp32"), "bf16": ("bf16", "bf16"),
            "lns16-qat": ("lns16-qat", "lns16-qat"),
            "lns16-train": ("lns16-train-emulate", "lns16-train-pallas")}
LOSS_RTOL = {"fp32": 1e-5, "bf16": 2e-2, "lns16-qat": 1e-3,
             "lns16-train": 1e-2}
#: The LNS modes' gradients of ``loss_fn``: the whole tree's relative L2
#: distance from the reference's (fp32's are held elementwise).
GRAD_RTOL = {"lns16-qat": 3e-2, "lns16-train": 0.3}


def cfgs(arch, numerics, tnumerics=None, **kw):
    j = jconfigs.reduced(jconfigs.get_config(arch)).with_(
        numerics=numerics, remat="none", **kw)
    t = tconfigs.reduced(tconfigs.get_config(arch)).with_(
        numerics=tnumerics or numerics, remat="none", **kw)
    return j, t


def batch(cfg, seed=0):
    """Tokens and labels (B × S); the enc-dec families' encoder input too:
    S frames of the audio stub's embeddings, or S ``enc_tokens``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("encdec", "audio"):
        if cfg.frontend:
            out["frontend_embeds"] = rng.normal(
                size=(B, S, cfg.d_model)).astype(np.float32)
        else:
            out["enc_tokens"] = rng.integers(
                0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return out


def grid(rng, shape, *, zero_frac=0.15, lo=-3.0, hi=1.5):
    """Float32 values on lns16's grid (2^(code/scale) rounded once to
    float32, which both packages encode back to the code), some zero:
    inputs whose codes the two packages agree on (ROADMAP queue 3 item
    2: off the grid, their float32 ``log`` may part by an ulp)."""
    code = np.round(rng.uniform(lo, hi, size=shape) * LNS16.scale)
    v = np.exp2(code / LNS16.scale).astype(np.float32)
    v[rng.random(shape) < 0.5] *= -1
    v[rng.random(shape) < zero_frac] = 0.0
    return v


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def leaf_paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float()
    return torch.tensor(np.asarray(a, np.float32))


def code_diff(a, b):
    """(codes that differ, largest difference) of two float arrays
    encoded in lns16."""
    d = (encode(_f32(a), LNS16).code - encode(_f32(b), LNS16).code).abs()
    return int((d > 0).sum()), int(d.max()) if d.numel() else 0


def final_hidden(mod, params, b, cfg):
    """The head's input: the normed output of the layer stack (of the
    decoder, for the enc-dec families)."""
    plan = mod._model_plan(cfg)
    rt = mod.Runtime()
    if cfg.family in ("encdec", "audio"):
        norm = jlayers.apply_norm if mod is jmodel else tlayers.apply_norm
        if mod is jmodel:
            enc_in = (plan.runtime_for("frontend").linear(
                b["frontend_embeds"], params["frontend_proj"])
                if cfg.frontend else jlayers.embed_tokens(
                    params["emb"], b["enc_tokens"], plan.runtime_for("emb")))
            enc = mod._encoder(params, enc_in, cfg, rt)
            x = jlayers.embed_tokens(params["emb"], b["tokens"],
                                     plan.runtime_for("emb"))
            pos = jnp.broadcast_to(jnp.arange(x.shape[1])[None],
                                   x.shape[:2])
            x = mod._decoder(params, x, enc, cfg, rt, pos,
                             want_caches=False)[0]
        else:
            x = mod._enc_dec(params, b, cfg, plan, rt, False)[0]
        return norm(params["final_norm"], x, cfg)
    x = mod._embed_inputs(params, b, cfg, plan, rt)
    if mod is jmodel:
        pos = jnp.broadcast_to(jnp.arange(x.shape[1])[None], x.shape[:2])
        return jlayers.apply_norm(params["final_norm"], mod._backbone(
            params, x, cfg, rt, pos, want_caches=False)[0], cfg)
    return tlayers.apply_norm(params["final_norm"], mod._backbone(
        params, x, cfg, rt, mod._positions(x)), cfg)


def close(got, want, rel, what):
    """Assert ``got`` (a tensor or array) finite and within ``rel`` × the
    largest magnitude of ``want`` everywhere; prints the gap."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"  {what}: max |diff| {err:.3g} of max |ref| {scale:.3g}")
    assert err <= rel * max(scale, 1e-30), (what, err, scale)


def rel_l2(got, want):
    """(the whole tree's relative L2 distance, the largest leaf's) of
    the port's leaves (tensors or arrays) from the reference's."""
    num = den = 0.0
    per_leaf = []
    for t, j in zip(got, want):
        t = t.detach().float().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t, np.float64)
        j = np.asarray(j, np.float64)
        n, d = float(((t - j) ** 2).sum()), float((j ** 2).sum())
        num, den = num + n, den + d
        per_leaf.append(np.sqrt(n / d) if d else (0.0 if n == 0 else np.inf))
    return float(np.sqrt(num / den)), max(per_leaf)


def check_loss_and_grads(arch, mode, nums=None, loss_rtol=None,
                         grad_rtol=None, **kw):
    """``loss_fn`` and its gradients from the reference's parameters: the
    loss within ``LOSS_RTOL[mode]``, fp32's gradients within 1e-5 × each
    leaf's largest magnitude, the LNS modes' within ``GRAD_RTOL[mode]``
    in relative L2 over the whole tree; prints the gaps and, for the LNS
    modes, how many codes of the head's input and of the gradients
    differ.  ``nums``: (the reference's numerics, the port's) in place of
    ``NUMERICS[mode]`` (a per-layer plan held at ``mode``'s tier);
    ``loss_rtol`` / ``grad_rtol``: a family's own bounds in place of the
    tier's; ``kw``: config overrides.  Returns the port's gradients by
    leaf path."""
    jnum, tnum = nums or NUMERICS[mode]
    jcfg, tcfg = cfgs(arch, jnum, tnum, **kw)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    b = batch(jcfg, seed=len(arch))
    jb = jax.tree.map(jnp.asarray, b)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jmodel.loss_fn(p, bb, jcfg)))(jp, jb)
    leaves, treedef = tree_flatten(tmodel.params_from_numpy(
        to_numpy(jp), "cpu"))
    leaves = [t.requires_grad_() for t in leaves]
    tp = tree_unflatten(treedef, leaves)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = tmodel.loss_fn(tp, tb, tcfg)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    loss = float(loss.detach())
    rel = abs(loss - float(jloss)) / abs(float(jloss))
    paths, jleaves = leaf_paths(jgrads), jax.tree.leaves(jgrads)
    worst = {}
    for path, g, jg in zip(paths, grads, jleaves):
        jg = np.asarray(jg, np.float32)
        worst[path] = float(np.abs(g.float().numpy() - jg).max()
                            / max(np.abs(jg).max(), 1e-30))
    grel, leaf_rel = rel_l2(grads, jleaves)
    print(f"\n{arch} {mode}: loss {loss:.7f} vs {float(jloss):.7f} "
          f"(rel {rel:.3g}); grad max |diff| / leaf max "
          f"{max(worst.values()):.3g}; grad relative L2 {grel:.3g} (worst "
          f"leaf {leaf_rel:.3g})")
    if mode.startswith("lns"):
        with torch.no_grad():
            h = final_hidden(tmodel, tp, tb, tcfg)
        n, m = code_diff(h, jax.jit(lambda pp, bb: final_hidden(
            jmodel, pp, bb, jcfg))(jp, jb))
        print(f"  head-input activation codes differing: {n} of "
              f"{h.numel()} (max {m})")
        for path, g, jg in zip(paths, grads, jleaves):
            n, m = code_diff(g, jg)
            print(f"  grad {path}: {n} of {g.numel()} codes differ "
                  f"(max {m})")
    assert np.isfinite(loss)
    assert rel <= (loss_rtol or LOSS_RTOL[mode])
    if mode == "fp32":
        assert max(worst.values()) <= 1e-5, worst
    if mode in GRAD_RTOL:
        assert grel <= (grad_rtol or GRAD_RTOL[mode])
    return dict(zip(paths, grads))


def run(arch, jnum, tnum, opt, forced=False, seed=0):
    """``(ref_losses, port_losses, ref_states, port_states)``: the losses
    of each of ``STEPS`` steps, the reference's state before and after
    each step, and the port's after each step.  ``forced``: each port step
    starts from the reference's state before it (teacher forcing), so that
    every step is held from the same parameters and optimizer state.
    ``seed``: of the reference's parameters and of the data."""
    jcfg, tcfg = cfgs(arch, jnum, tnum)
    jo, to = OPTS[opt]
    jtc = JTrainConfig(microbatches=2, grad_clip=1.0)
    tc = TrainConfig(microbatches=2, grad_clip=1.0)
    ds = JDataset(jcfg, JCell("t", S, B, "train"), JDataConfig(seed=seed))
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    jstep = jax.jit(jmake_step(jcfg, jo, tc=jtc))
    jstate = jinit_state(jp, jo, jtc)
    tstate = init_train_state(tmodel.params_from_numpy(to_numpy(jp), "cpu"),
                              to, tc)
    tstep = make_train_step(tcfg, to, tc=tc)
    jl, tl, jstates, tstates = [], [], [jstate], []
    for i in range(STEPS):
        b = ds.batch_at(i)
        if forced:
            tstate = tmodel.params_from_numpy(to_numpy(jstate), "cpu")
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        jstates.append(jstate)
        tstates.append(tstate)
    return jl, tl, jstates, tstates


def rel_gaps(jl, tl):
    return [abs(t - j) / abs(j) for j, t in zip(jl, tl)]


def param_gaps(jparams, tparams):
    """Per leaf, max |diff| / the leaf's largest magnitude."""
    out = []
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
        a = np.asarray(a)
        d, m = float(np.abs(b.numpy() - a).max()), float(np.abs(a).max())
        out.append(d / m if m else (0.0 if d == 0 else np.inf))
    return out


def adam_grads(jstates, b1):
    """The clipped, accumulated gradient of each step, per leaf, from the
    reference's first moments: g_t = (mu_t - b1·mu_{t-1}) / (1 - b1)."""
    mus = [jax.tree.leaves(s["opt"]["mu"]) for s in jstates]
    return [[(np.asarray(m1) - b1 * np.asarray(m0)) / (1 - b1)
             for m0, m1 in zip(a, c)] for a, c in zip(mus, mus[1:])]


def forced_step_gaps(jstates, tstates, b1):
    """Per teacher-forced AdamW step: (relative L2 of the clipped,
    accumulated gradient, of the parameter update), each over the whole
    tree, of the port's step from the reference's state against the
    reference's.  The gradient is read from the first moments:
    g_t = (mu_t - b1·mu_{t-1}) / (1 - b1), with the reference's mu_{t-1}
    on both sides."""
    out = []
    for j0, j1, t1 in zip(jstates, jstates[1:], tstates):
        mu0 = jax.tree.leaves(j0["opt"]["mu"])
        jg = [(np.asarray(m1) - b1 * np.asarray(m0)) / (1 - b1)
              for m0, m1 in zip(mu0, jax.tree.leaves(j1["opt"]["mu"]))]
        tg = [(m1.numpy() - b1 * np.asarray(m0)) / (1 - b1)
              for m0, m1 in zip(mu0, tree_leaves(t1["opt"]["mu"]))]
        p0 = [np.asarray(p) for p in jax.tree.leaves(j0["params"])]
        ju = [np.asarray(p) - q for p, q in zip(
            jax.tree.leaves(j1["params"]), p0)]
        tu = [p.numpy() - q for p, q in zip(tree_leaves(t1["params"]), p0)]
        out.append((rel_l2(tg, jg)[0], rel_l2(tu, ju)[0]))
    return out

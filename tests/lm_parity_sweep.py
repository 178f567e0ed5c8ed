"""The loss gap of the LM stack under ``lns16-train`` between the JAX
package (``emulate`` lane) and the port (CPU lane), over seeds: the four
``reduced()`` dense configs, batch 2 × seq 16, the reference's parameters
and batch of each seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_parity_sweep.py [seeds]

Prints one line per config: the relative loss gap of each seed.  Not a
test (no ``test_`` prefix): it takes about two minutes.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_parity_sweep.py \
        families [seeds]

does the same for the ssm, hybrid and enc-dec configs (mamba2-370m,
zamba2-7b, seamless-m4t-medium and its ``encdec`` variant without a
frontend), with the gradients' relative L2 distance over the tree, then
three teacher-forced AdamW steps of each seed but the variant's (``run``
of ``tests/lm_parity.py`` with the data and parameters of that seed):
the largest loss gap, gradient and update relative L2 of the three, the
quantities ``tests/test_torch_lm_families_steps.py`` bounds.  About
fifteen minutes.
"""
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget, reduced as jreduced
from repro.nn import init_params as jinit, loss_fn as jloss
from repro_torch.configs import get_config, reduced
from repro_torch.nn import loss_fn, params_from_numpy

DENSE = ["olmo-1b", "qwen3-1.7b", "yi-6b", "command-r-35b"]
FAMILIES = [("mamba2-370m", {}), ("zamba2-7b", {}),
            ("seamless-m4t-medium", {}),
            ("seamless-m4t-medium", {"family": "encdec", "frontend": None})]


def main(seeds=6):
    for arch in DENSE:
        jcfg = jreduced(jget(arch)).with_(numerics="lns16-train-emulate",
                                          remat="none")
        cfg = reduced(get_config(arch)).with_(numerics="lns16-train-pallas",
                                              remat="none")
        f = jax.jit(lambda p, b, jcfg=jcfg: jloss(p, b, jcfg))
        gaps = []
        for seed in range(seeds):
            jp = jinit(jax.random.PRNGKey(seed), jcfg)
            rng = np.random.default_rng(seed)
            toks = rng.integers(0, cfg.vocab_size, size=(2, 17)
                                ).astype(np.int32)
            b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            want = float(f(jp, jax.tree.map(jnp.asarray, b)))
            with torch.no_grad():
                got = float(loss_fn(
                    params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                    {k: torch.from_numpy(v) for k, v in b.items()}, cfg))
            gaps.append(abs(got - want) / abs(want))
        print(arch, " ".join(f"{g:.3g}" for g in gaps), flush=True)


def families(seeds=6):
    from lm_parity import (OPTS, batch, cfgs, forced_step_gaps, rel_gaps,
                           rel_l2, run, to_numpy)
    from repro_torch.pytree import tree_flatten, tree_unflatten
    from repro.nn import model as jmodel
    from repro_torch.nn import model as tmodel
    for arch, kw in FAMILIES:
        jcfg, tcfg = cfgs(arch, "lns16-train-emulate", "lns16-train-pallas",
                          **kw)
        f = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, b,
                                                                   jcfg)))
        rows = []
        for seed in range(seeds):
            jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
            b = batch(jcfg, seed=seed)
            jl, jg = f(jp, jax.tree.map(jnp.asarray, b))
            leaves, td = tree_flatten(tmodel.params_from_numpy(
                to_numpy(jp), "cpu"))
            leaves = [t.requires_grad_() for t in leaves]
            loss = tmodel.loss_fn(tree_unflatten(td, leaves), {
                k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
            g = [torch.zeros_like(t) if x is None else x for t, x in zip(
                leaves, torch.autograd.grad(loss, leaves,
                                            allow_unused=True))]
            gap = abs(float(loss.detach()) - float(jl)) / abs(float(jl))
            rows.append((gap, rel_l2(g, jax.tree.leaves(jg))[0]))
        print(arch, kw or "", "loss_fn (loss gap, gradient relative L2):",
              " ".join(f"({a:.3g}, {b:.3g})" for a, b in rows), flush=True)
        if kw:
            continue
        worst = []
        for seed in range(seeds):
            jl, tl, js, ts = run(arch, "lns16-train-emulate",
                                 "lns16-train-pallas", "adamw", forced=True,
                                 seed=seed)
            steps = forced_step_gaps(js, ts, OPTS["adamw"][1].b1)
            worst.append((max(rel_gaps(jl, tl)), max(g for g, _ in steps),
                          max(u for _, u in steps)))
        print(arch, "3 teacher-forced steps, per seed, the largest (loss "
              "gap, gradient, update relative L2):",
              " ".join(f"({a:.3g}, {b:.3g}, {c:.3g})" for a, b, c in worst),
              flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["families"]:
        families(*(int(a) for a in sys.argv[2:]))
    else:
        main(*(int(a) for a in sys.argv[1:]))

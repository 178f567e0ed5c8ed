"""The loss gap of the LM stack under ``lns16-train`` between the JAX
package (``emulate`` lane) and the port (CPU lane), over seeds: the four
``reduced()`` dense configs, batch 2 × seq 16, the reference's parameters
and batch of each seed.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_parity_sweep.py [seeds]

Prints one line per config: the relative loss gap of each seed.  Not a
test (no ``test_`` prefix): it takes about two minutes.
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


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))

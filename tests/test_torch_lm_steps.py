"""Three train steps of the four ``reduced()`` dense configs in the port
against the JAX package, under ``fp32`` and ``bf16`` (the runner is
``run`` of ``tests/lm_parity.py``): microbatches=2, grad_clip=1.0, AdamW
and SGD with momentum, from the reference's parameters, on the
reference's batches.

* ``fp32``: the loss of every step within rtol 1e-5.  SGD's parameters
  after three steps within 1e-5 × each leaf's largest magnitude.  AdamW
  divides each element's step by its own gradient's magnitude, so a
  gradient difference within the stated 1e-5 × the leaf's largest
  gradient (``test_torch_lm.py``) moves a step by up to that over |g| + ε:
  a near-zero gradient (two microbatches that cancel to ~1e-8, a
  zero-initialized LayerNorm bias) turns float32 rounding into up to 1% of
  an update.  AdamW's parameters are held to 1e-5 × the leaf's largest
  magnitude plus lr × Σ_t min(2, 2 · 1e-5 · max|g_t| / (|g_t| + ε)), that
  gradient bound carried through Adam's normalization, with g_t the
  reference's accumulated gradient of step t.
* ``bf16``: the loss of every step within rtol 2e-2 (AdamW here, SGD in
  ``test_torch_lm_sgd_steps.py``).
"""
import numpy as np
import pytest
import torch

from lm_parity import DENSE, OPTS, adam_grads, param_gaps, rel_gaps, run
from repro_torch.pytree import tree_leaves

torch.set_num_threads(1)


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
@pytest.mark.parametrize("arch", DENSE)
def test_fp32_steps_equal_reference(arch, opt):
    jl, tl, jstates, tstates = run(arch, "fp32", "fp32", opt)
    gaps = rel_gaps(jl, tl)
    pg = param_gaps(jstates[-1]["params"], tstates[-1]["params"])
    print(f"\n{arch} {opt} fp32: loss gaps {gaps}; parameter max |diff| / "
          f"leaf max {max(pg):.3g}")
    assert max(gaps) <= 1e-5
    if opt == "sgd":
        assert max(pg) <= 1e-5
        return
    import jax
    cfg = OPTS["adamw"][1]
    grads = adam_grads(jstates, cfg.b1)
    worst = 0.0
    for i, (a, b) in enumerate(zip(jax.tree.leaves(jstates[-1]["params"]),
                                   tree_leaves(tstates[-1]["params"]))):
        a, b = np.asarray(a), b.numpy()
        carried = sum(np.minimum(2.0, 2e-5 * np.abs(g[i]).max()
                                 / (np.abs(g[i]) + cfg.eps)) for g in grads)
        tol = 1e-5 * np.abs(a).max() + cfg.lr * carried
        d = np.abs(b - a)
        # 0/0 (a leaf that stays zero in both) is no difference; d/0 is inf.
        ratio = np.divide(d, tol, out=np.zeros_like(d), where=d > 0)
        worst = max(worst, float(ratio.max()))
    print(f"  AdamW: max |diff| / tolerance {worst:.3g}")
    assert worst <= 1.0


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_steps_equal_reference(arch):
    jl, tl, _, _ = run(arch, "bf16", "bf16", "adamw")
    gaps = rel_gaps(jl, tl)
    print(f"\n{arch} adamw bf16: loss gaps {gaps}")
    assert max(gaps) <= 2e-2

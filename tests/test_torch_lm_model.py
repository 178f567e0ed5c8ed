"""The whole model in the port against the JAX package: the four
``reduced()`` dense configs (batch 2, seq 16) start from the reference's
parameters (``params_from_numpy``), and ``loss_fn`` and its gradients are
held to the reference's:

* ``fp32``: loss within rtol 1e-5, every gradient within 1e-5 × its
  leaf's largest magnitude;
* ``bf16``: loss within rtol 2e-2.

``lns16-qat`` is in ``test_torch_lm_qat.py``, ``lns16-train`` in
``test_torch_lm_lns_model.py``.  The vlm family's
backbone with its vision stub (``frontend_proj`` over precomputed patch
embeddings, their positions carrying no loss) is held under ``fp32``.
"""
import pytest
import torch

from lm_parity import DENSE, check_loss_and_grads

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_equal_reference(arch, mode):
    check_loss_and_grads(arch, mode)


def test_vlm_frontend_loss_equals_reference():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lm_parity import cfgs, leaf_paths, to_numpy
    from repro.data import DataConfig, SyntheticLMDataset
    from repro.nn import model as jmodel
    from repro.nn.config import ShapeCell
    from repro_torch.nn import model as tmodel
    from repro_torch.pytree import tree_flatten, tree_unflatten
    jcfg, tcfg = cfgs("internvl2-76b", "fp32")
    b = SyntheticLMDataset(jcfg, ShapeCell("t", 16, 2, "train"),
                           DataConfig(seed=2)).batch_at(0)
    assert b["frontend_embeds"].shape == (2, 4, jcfg.d_model)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jmodel.loss_fn(p, bb, jcfg)))(
        jp, jax.tree.map(jnp.asarray, b))
    leaves, treedef = tree_flatten(tmodel.params_from_numpy(
        to_numpy(jp), "cpu"))
    leaves = [t.requires_grad_() for t in leaves]
    loss = tmodel.loss_fn(tree_unflatten(treedef, leaves),
                          {k: torch.from_numpy(v) for k, v in b.items()},
                          tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) / float(jloss) - 1) <= 1e-5
    for path, g, jg in zip(leaf_paths(jgrads), grads,
                           jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        assert np.abs(g.numpy() - jg).max() <= 1e-5 * np.abs(jg).max(), path

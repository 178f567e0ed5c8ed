"""The whole model under ``lns16-train`` in the port (its CPU lane)
against the JAX package (its ``emulate`` lane): the four ``reduced()``
dense configs from the reference's parameters.

Float ops surround every ⊞-MAC, so a float32 ulp can move an ``encode``
by one code at a half-code boundary, and the ⊞-MAC amplifies it: a
one-code change of a difference can cross a step of the Δ table (r = 1/2,
up to 0.2 in log2), and a ⊞ of nearly opposite terms cancels.  The first
products see the same codes
(``test_lns_train_first_products_see_identical_codes``); the loss of
``loss_fn`` then lies within rtol 1e-2 of the reference's, not the 1e-3
first stated: over 6 seeds × 4 configs the gap spreads from 0 to 9.05e-3
(``tests/lm_parity_sweep.py``; ROADMAP queue 3 item 7).  Its gradients
lie within a relative L2 distance of 0.3 from the reference's over the
whole tree (0.022-0.166 measured on these draws); most of their codes
differ by a little, so the share of differing codes is printed, not held.
The test prints how many codes of the head's input and of the gradients
differ.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lm_parity import DENSE, batch, cfgs, check_loss_and_grads, code_diff, \
    to_numpy
from repro.nn import model as jmodel
from repro_torch.nn import model as tmodel

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_equal_reference(arch):
    check_loss_and_grads(arch, "lns16-train")


def test_lns_train_first_products_see_identical_codes(monkeypatch):
    """Under ``lns16-train`` the first block's q/k/v products take the same
    activation codes in both packages (the gather and the norm agree to the
    code); the printout shows where the codes first part: after the float
    attention, whose ulps the ⊞-MACs then amplify."""
    import repro.core.spec as jspec
    import repro_torch.core.spec as tspec
    jcfg, tcfg = cfgs("yi-6b", "lns16-train-emulate", "lns16-train-pallas",
                      scan_layers=False)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    b = batch(jcfg, seed=5)
    jrec, trec = [], []
    jlin, tlin = jspec.LNSRuntime.linear, tspec.LNSRuntime.linear

    def jrecord(self, x, w):
        jax.debug.callback(lambda a: jrec.append(np.asarray(a)), x)
        return jlin(self, x, w)

    def trecord(self, x, w):
        trec.append(x.detach().clone())
        return tlin(self, x, w)

    monkeypatch.setattr(jspec.LNSRuntime, "linear", jrecord)
    monkeypatch.setattr(tspec.LNSRuntime, "linear", trecord)
    jax.jit(lambda p, bb: jmodel.loss_fn(p, bb, jcfg))(
        jp, jax.tree.map(jnp.asarray, b)).block_until_ready()
    with torch.no_grad():
        tmodel.loss_fn(tmodel.params_from_numpy(to_numpy(jp), "cpu"),
                       {k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
    assert len(jrec) == len(trec) == 2 * 7 + 1
    flips = [code_diff(t, j) for t, j in zip(trec, jrec)]
    print("\nproduct input codes differing (count, max):", flips)
    assert flips[:3] == [(0, 0)] * 3

"""The port's MoE block (``repro_torch.nn.moe``) and the moe family's
training path (``reduced(deepseek-moe-16b)``, GQA) against the JAX
package, from the same numpy parameters.

Tiers (``tests/lm_parity.py``): fp32 loss within rtol 1e-5 and gradients
within 1e-5 × each leaf's largest magnitude; lns16-train (the port's CPU
lane against the reference's emulate lane) loss within 1e-2 and gradients
within 0.3 relative L2 over the tree, its ⊞-MAC products bit-exact
(``test_torch_runtime.py``).  The router picks experts by ``top_k`` on
float32 probabilities, so the expert ids are held equal on the test
inputs and the smallest top-k margin is printed (``-s``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.numerics import get_policy as jget_policy
from repro.nn import moe as jmoe
from repro_torch.core.numerics import get_policy as tget_policy
from repro_torch.nn import moe as tmoe
from repro_torch.nn.layers import FLOAT32, ORDER_FREE
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

from lm_parity import cfgs, check_loss_and_grads, rel_l2, to_numpy

torch.set_num_threads(1)

ARCH = "deepseek-moe-16b"


def _moe_params(cfg, seed=0):
    return jmoe.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)


def _tensors(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), to_numpy(tree))


def _inputs(cfg, n=2, s=8, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, s, cfg.d_model)).astype(np.float32)


def test_init_moe_tree_shapes_and_scales():
    """The port's init has the reference's tree, shapes, dtypes and
    per-leaf scales (its draws are torch's)."""
    jcfg, tcfg = cfgs(ARCH, "fp32")
    want = to_numpy(_moe_params(jcfg))
    got = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg,
                        torch.float32)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        t = got[k].numpy()
        assert t.shape == a.shape and t.dtype == a.dtype, k
        assert abs(t.std() / a.std() - 1) < 0.2, (k, t.std(), a.std())


def test_top_k_breaks_ties_to_the_lower_index():
    """``top_k`` orders equal values lower index first, as
    ``jax.lax.top_k`` does (``torch.topk`` leaves ties unspecified)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(64, 16)).astype(np.float32) / 4
    wv, wi = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = tmoe.top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    assert (x == x.max(1, keepdims=True)).sum() > 64  # ties were met


@pytest.mark.parametrize("fl", [FLOAT32, ORDER_FREE],
                         ids=["train", "serve"])
def test_router_ids_weights_and_aux(fl):
    """``_router`` from the same weights and inputs: the same expert ids,
    weights within rtol 1e-6, the same aux term, in the training form
    (float32) and the serving one (order-free float64 sums)."""
    jcfg, tcfg = cfgs(ARCH, "fp32")
    jp = _moe_params(jcfg)
    xf = _inputs(jcfg, 4, 16).reshape(-1, jcfg.d_model)
    jw, jids, jaux = jmoe._router(jp, jnp.asarray(xf), jcfg.moe)
    tw, tids, taux = tmoe._router(_tensors(jp), torch.from_numpy(xf),
                                  tcfg.moe, fl)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xf) @ jp["router"], -1))
    srt = np.sort(probs, -1)[:, ::-1]
    k = jcfg.moe.top_k
    print(f"\nsmallest top-{k} margin (k-th minus (k+1)-th probability): "
          f"{float((srt[:, k - 1] - srt[:, k]).min()):.3g}")


@pytest.mark.parametrize("mode", ["fp32", "lns16-train"])
def test_moe_reference_forward_and_grads(mode):
    """``moe_reference`` forward and gradients (weights and input) under
    fp32 (rtol 1e-5; gradients within 1e-5 × each leaf's largest) and
    lns16-train (output and gradients within 1e-2 relative L2: the shared
    experts run the ⊞-MAC, the routed experts are float einsums of the
    quantized operands)."""
    jnum, tnum = {"fp32": ("fp32", "fp32"),
                  "lns16-train": ("lns16-train-emulate",
                                  "lns16-train-pallas")}[mode]
    jcfg, tcfg = cfgs(ARCH, jnum, tnum)
    jp = _moe_params(jcfg, seed=2)
    x = _inputs(jcfg, seed=3)
    jpol, tpol = jget_policy(jnum), tget_policy(tnum)

    def jf(p, xx):
        out, aux = jmoe.moe_reference(p, xx, jcfg, jpol)
        return jnp.sum(out * jnp.sin(out)) + aux, (out, aux)

    (jl, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    leaves, treedef = tree_flatten(_tensors(jp))
    leaves = [t.requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_reference(tree_unflatten(treedef, leaves), tx, tcfg,
                                  tpol)
    (torch.sum(out * torch.sin(out)) + aux).backward()
    grads = [t.grad for t in leaves] + [tx.grad]
    want = jax.tree.leaves(jg[0]) + [jg[1]]
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    if mode == "fp32":
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-6)
        for g, w in zip(grads, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    else:
        assert rel_l2([out], [jout])[0] <= 1e-2
        gl2 = rel_l2(grads, want)[0]
        print(f"\nmoe_reference lns16-train: output relative L2 "
              f"{rel_l2([out], [jout])[0]:.3g}, gradients {gl2:.3g}")
        assert gl2 <= 1e-2


@pytest.mark.parametrize("mode", ["fp32", "lns16-train"])
def test_moe_loss_and_grads(mode):
    """The moe family's ``loss_fn`` (CE + 0.01 · aux) and its gradients
    from the reference's parameters, at ``tests/lm_parity.py``'s tiers."""
    check_loss_and_grads(ARCH, mode)


def test_mesh_raises_naming_item_13():
    """The expert-parallel forms (ROADMAP item 13) take a DeviceMesh: any
    other mesh raises; without a mesh ``moe_block`` is the reference."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmoe.MoERuntime(mesh=object())
    assert tmoe.MoERuntime().mesh is None

"""The port's MLA attention (``repro_torch.nn.attention``: ``init_mla``,
``_mla_latents``, ``_mla_q``, ``mla_attention``) and the
``reduced(deepseek-v2-lite-16b)`` training path (MLA + MoE) against the
JAX package, from the same numpy parameters, at ``tests/lm_parity.py``'s
tiers (fp32 within rtol 1e-5; lns16-train the port's CPU lane against the
reference's emulate lane, loss within 1e-2, gradients within 0.3 relative
L2).  Also: the moe and mla parameter trees carried across both ways
(numpy and checkpoints), and the train CLI on both deepseek configs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import load_checkpoint as jload
from repro.ckpt import save_checkpoint as jsave
from repro.core.numerics import get_policy as jget_policy
from repro.nn import attention as jattn
from repro.nn import model as jmodel
from repro_torch.ckpt import load_checkpoint as tload
from repro_torch.ckpt import save_checkpoint as tsave
from repro_torch.core.numerics import get_policy as tget_policy
from repro_torch.nn import attention as tattn
from repro_torch.nn import model as tmodel
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

from lm_parity import cfgs, check_loss_and_grads, leaf_paths, rel_l2, \
    to_numpy

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"
MODES = {"fp32": ("fp32", "fp32"),
         "lns16-train": ("lns16-train-emulate", "lns16-train-pallas")}


def _tensors(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), to_numpy(tree))


def test_init_mla_tree_shapes_and_scales():
    jcfg, tcfg = cfgs(ARCH, "fp32")
    want = to_numpy(jattn.init_mla(jax.random.PRNGKey(0), jcfg,
                                   jnp.float32))
    got = tattn.init_mla(torch.Generator().manual_seed(0), tcfg,
                         torch.float32)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        t = got[k].numpy()
        assert t.shape == a.shape and t.dtype == a.dtype, k
        if a.std():
            assert abs(t.std() / a.std() - 1) < 0.2, k
        else:
            np.testing.assert_array_equal(t, a)


@pytest.mark.parametrize("mode", list(MODES))
def test_mla_attention_forward_and_grads(mode):
    """``mla_attention`` (latents, query, up-projection through
    ``pol.linear``, banded SDPA) forward, returned latents and gradients:
    fp32 within rtol 1e-5 (gradients within 1e-5 × each leaf's largest);
    lns16-train within 1e-2 relative L2 (every product a ⊞-MAC)."""
    jnum, tnum = MODES[mode]
    jcfg, tcfg = cfgs(ARCH, jnum, tnum)
    jp = jattn.init_mla(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(2)
    b, s = 2, 16
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    jpol, tpol = jget_policy(jnum), tget_policy(tnum)

    def jf(p, xx):
        out, cache = jattn.mla_attention(p, xx, jcfg, jpol, jnp.asarray(pos))
        return jnp.sum(out * jnp.cos(out)), (out, cache)

    (_, (jout, jcache)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    leaves, treedef = tree_flatten(_tensors(jp))
    leaves = [t.requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    out, cache = tattn.mla_attention(tree_unflatten(treedef, leaves), tx,
                                     tcfg, tpol, torch.from_numpy(pos))
    torch.sum(out * torch.cos(out)).backward()
    grads = [t.grad for t in leaves] + [tx.grad]
    want = jax.tree.leaves(jg[0]) + [jg[1]]
    got_c = [cache.k.detach(), cache.v.detach()]
    if mode == "fp32":
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-6)
        for g, w in zip(got_c, jcache):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)
        for g, w in zip(grads, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    else:
        gaps = (rel_l2([out], [jout])[0], rel_l2(got_c, list(jcache))[0],
                rel_l2(grads, want)[0])
        print(f"\nmla_attention lns16-train relative L2: output {gaps[0]:.3g}"
              f", latents {gaps[1]:.3g}, gradients {gaps[2]:.3g}")
        assert max(gaps) <= 1e-2


@pytest.mark.parametrize("mode", list(MODES))
def test_mla_moe_loss_and_grads(mode):
    """``loss_fn`` of ``reduced(deepseek-v2-lite-16b)`` (one dense MLA
    layer, two MoE MLA layers) and its gradients, at the tiers."""
    check_loss_and_grads(ARCH, mode)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", ARCH])
def test_moe_and_mla_trees_cross_load(arch, tmp_path):
    """The reference's moe/mla parameter tree (``dense_layers``, stacked
    ``layers.moe.*``, ``attn.w_dkv`` / ``kv_norm`` / ``w_ukv``) carries
    across 1:1 by path, the port's init has the same paths and shapes,
    and checkpoints written by either package load in the other."""
    jcfg, tcfg = cfgs(arch, "fp32")
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmodel.params_from_numpy(to_numpy(jp), "cpu")
    own = tmodel.init_params(0, tcfg, device="cpu")
    assert leaf_paths(jax.tree.map(np.asarray, jp)) == leaf_paths(
        tmodel.params_to_numpy(own))
    for a, t in zip(jax.tree.leaves(jp), tree_flatten(own)[0]):
        assert tuple(a.shape) == tuple(t.shape)
    tsave(str(tmp_path / "t"), 3, tp, numerics=tcfg.numerics)
    back = jload(str(tmp_path / "t"), 3, jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jsave(str(tmp_path / "j"), 5, jp)
    again = tload(str(tmp_path / "j"), 5, own, device="cpu")
    for a, b in zip(tree_flatten(again)[0], jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", ARCH])
def test_train_cli_runs_deepseek(arch):
    """The train CLI trains both deepseek configs on the CPU lane with no
    change of its own."""
    from repro_torch.launch import train as train_cli
    losses = train_cli.main(["--arch", arch, "--steps", "2", "--device",
                             "cpu", "--numerics", "lns16-train-pallas",
                             "--batch", "2", "--seq", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))

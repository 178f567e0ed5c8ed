"""The hybrid family (``reduced(zamba2-7b)``: 5 Mamba2 layers in 2 groups
of 2, the one shared attention block after each group, a tail of 1) in
the port against the JAX package, from the reference's parameters, and
the decode-cache converters of every family.

Tiers (``tests/lm_parity.py``): ``loss_fn`` under fp32 within rtol 1e-5,
every gradient (the shared block's, summed over the groups, among them)
within 1e-5 × its leaf's largest magnitude; ``prefill`` and
``decode_step`` (each step from the reference's caches) under fp32
within 1e-5 × the largest magnitude of each output.

Under lns16-train the loss within 1e-2 and the gradients within 0.6
relative L2 over the tree (the dense families' tier is 0.3).  The cause
is ROADMAP queue 3 item 7: a float32 ulp of a norm or of the attention
moves an ``encode`` by a code, and the ⊞-MACs carry it on; seven blocks
carry it further than the dense configs' two.  Teacher-forced block by
block from the reference's input, the Mamba2 blocks before the shared
block give the reference's codes, and the shared block moves 65 of 2048
output codes; over six seeds (``python tests/lm_parity_sweep.py
families``) the whole model's gradients read 0.232-0.463 (the bound
leaves 1.3 times the largest) and its loss gaps up to 3.7e-3.  A mixed
plan (``layers.mamba`` on lns16-train, the
shared block on fp32) is held at the same bounds.  The products
themselves are bit-exact (``test_torch_ssm.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lm_parity import B, S, cfgs, check_loss_and_grads, close, \
    leaf_paths, to_numpy
from repro import configs as jconfigs
from repro.nn import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.nn import model as tmodel

torch.set_num_threads(1)

ARCH = "zamba2-7b"
LNS_RULE = "delta:lut20,fmt:lns16,quantize:params+acts+grads"
MIXED = (f"fp32;layers.mamba={LNS_RULE}",
         f"fp32;layers.mamba=backend:pallas,{LNS_RULE}")
#: lns16-train gradients, relative L2 over the tree (see above)
GRAD_RTOL = 0.6


@pytest.mark.parametrize("arch,kw", [
    ("mamba2-370m", {}), ("zamba2-7b", {}), ("zamba2-7b", {"n_layers": 1}),
    ("zamba2-7b", {"n_layers": 4}), ("seamless-m4t-medium", {}),
    ("seamless-m4t-medium", {"family": "encdec", "frontend": None})])
def test_init_params_tree_like_reference(arch, kw):
    """``init_params`` of the ssm, hybrid (with and without a tail, and
    shallower than a group) and enc-dec families: the reference's tree,
    shapes and dtypes (the leaves' laws: ``init_mamba2`` in
    ``test_torch_ssm.py``, the rest are the dense family's)."""
    from repro_torch.pytree import tree_flatten, treedef_str
    jcfg, tcfg = cfgs(arch, "fp32", **kw)
    jp = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    leaves, treedef = tree_flatten(tmodel.params_to_numpy(
        tmodel.init_params(0, tcfg, device="cpu")))
    jl, jdef = jax.tree_util.tree_flatten(jp)
    assert treedef_str(treedef) == str(jdef)
    for a, b in zip(jl, leaves):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("mode", ["fp32", "lns16-train"])
def test_loss_and_grads(mode):
    grads = check_loss_and_grads(ARCH, mode, grad_rtol=GRAD_RTOL)
    assert any("shared_attn" in p for p in grads)


def test_loss_and_grads_mixed_plan():
    """Mamba2 layers on lns16-train, the shared block and the tail's
    paths on fp32: each branch casts back to the residual's dtype."""
    jcfg, tcfg = cfgs(ARCH, *MIXED)
    plan = tmodel._model_plan(tcfg)
    assert plan.resolve("layers.mamba").delta_spec is not None
    assert plan.resolve("shared_attn.attn").delta_spec is None
    check_loss_and_grads(ARCH, "lns16-train", nums=MIXED,
                         grad_rtol=GRAD_RTOL)


def test_shallower_than_a_group():
    """``layers < attn_every``: no group runs, the whole stack is the
    tail; the stacked layer and the shared block get zero gradients, as
    in the reference; prefill's group caches are empty stacks of the
    reference's shapes."""
    grads = check_loss_and_grads(ARCH, "fp32", n_layers=1)
    for path, g in grads.items():
        if path.startswith("['layers']") or path.startswith(
                "['shared_attn']"):
            assert not g.any(), path
    jcfg, tcfg = cfgs(ARCH, "fp32", n_layers=1)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.arange(B * S, dtype=np.int32).reshape(B, S) % 200
    _, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    _, tc = tmodel.prefill(tmodel.params_from_numpy(to_numpy(jp), "cpu"),
                           {"tokens": torch.from_numpy(toks)}, tcfg)
    assert sorted(tc) == sorted(jc)
    for got, want in zip(jax.tree.leaves(tmodel.caches_to_numpy(tc)),
                         jax.tree.leaves(jc)):
        assert got.shape == np.asarray(want).shape


def _cache_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_prefill_and_decode_teacher_forced():
    """``prefill`` (logits; the groups' Mamba2 caches stacked as (groups,
    attn_every, ...), the shared block's KV per group, the tail's), then
    three ``decode_step`` calls on the flat decode caches, each from the
    reference's caches before it."""
    jcfg, tcfg = cfgs(ARCH, "fp32")
    jp = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    tp = tmodel.params_from_numpy(to_numpy(jp), "cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jc = jax.jit(lambda pp, t: jmodel.prefill(pp, {"tokens": t}, jcfg))(
        jp, jnp.asarray(toks))
    tl, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    print("\nhybrid prefill:")
    close(tl.numpy(), jl, 1e-5, "logits")
    for (path, want), got in zip(_cache_leaves(jc), jax.tree.leaves(
            tmodel.caches_to_numpy(tc))):
        close(got, want, 1e-5, jax.tree_util.keystr(path))
    assert tc["layers"].state.shape[:2] == (2, 2)
    step = jax.jit(lambda pp, t, c, pos: jmodel.decode_step(pp, t, c, pos,
                                                            jcfg))
    # The reference steps on the port's caches carried back
    # (``caches_to_numpy``), the port on the reference's carried across.
    caches = tmodel.caches_to_numpy(tmodel.init_decode_caches(
        tcfg, B, 8, torch.float32, device="cpu"))
    print("hybrid decode:")
    for i in range(3):
        tok = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = np.full((B,), i, np.int32)
        jl, jn = step(jp, jnp.asarray(tok), caches, jnp.asarray(pos))
        tl, tn = tmodel.decode_step(
            tp, torch.from_numpy(tok),
            tmodel.caches_from_numpy(to_numpy(caches), "cpu"),
            torch.from_numpy(pos), tcfg)
        close(tl.numpy(), jl, 1e-5, f"step {i} logits")
        for (path, want), got in zip(_cache_leaves(jn), jax.tree.leaves(
                tmodel.caches_to_numpy(tn))):
            close(got, want, 1e-5, f"step {i} {jax.tree_util.keystr(path)}")
        caches = tmodel.caches_to_numpy(tmodel.caches_from_numpy(
            to_numpy(jn), "cpu"))


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_decode_caches_round_trip(arch):
    """``caches_from_numpy`` of the reference's ``init_decode_caches`` is
    the port's, leaf by leaf (the same paths, shapes, dtypes and values:
    ``SSMCache`` and ``KVCache`` namedtuples, the hybrid's three stacks,
    the enc-dec ``(self KV, cross KV)`` pair and ``enc_out``), and
    ``caches_to_numpy`` carries it back to the reference's tree."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    want = to_numpy(jmodel.init_decode_caches(jcfg, 2, 8, jnp.float32,
                                              enc_len=6))
    mine = tmodel.init_decode_caches(tcfg, 2, 8, torch.float32, enc_len=6,
                                     device="cpu")
    carried = tmodel.caches_from_numpy(want, "cpu")
    back = tmodel.caches_to_numpy(carried)
    for tree in (carried, mine):
        assert leaf_paths(tmodel.caches_to_numpy(tree)) == leaf_paths(want)
        for (path, w), t in zip(_cache_leaves(want),
                                jax.tree.leaves(tmodel.caches_to_numpy(
                                    tree))):
            assert t.shape == w.shape and t.dtype == w.dtype, path
            np.testing.assert_array_equal(t, w)
    assert str(jax.tree.structure(back)) == str(jax.tree.structure(want))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)

"""The port's LM stack (``nn/config.py``, ``configs/``, ``nn/layers.py``,
``nn/attention.py``, ``nn/model.py``) against the JAX package, piece by
piece.

Configs and layer paths are data: equal field for field.  The layers take
the same numpy inputs in both packages; their float results agree within
rtol 1e-5 (RoPE 2e-5), atol 1e-6.  The whole model is held in
``test_torch_lm_model.py`` and ``test_torch_lm_lns_model.py``.  Every test
runs on the CPU lane, at ``reduced()`` sizes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lm_parity import B, DENSE, S, batch as _batch, cfgs as _cfgs, \
    leaf_paths as _leaf_paths, to_numpy as _np
from repro import configs as jconfigs
from repro.core.numerics import get_policy as jpolicy
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.core.numerics import get_policy
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tlayers
from repro_torch.nn import model as tmodel
from repro_torch.pytree import tree_flatten, tree_leaves, tree_map

torch.set_num_threads(1)


# ------------------------------------------------------------ configs ---
@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_config_registry_equals_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jr, tr = jconfigs.reduced(j), tconfigs.reduced(t)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.padded_vocab, t.layers, t.sub_quadratic) \
        == (j.padded_vocab, j.layers, j.sub_quadratic)
    assert tmodel.known_layer_paths(tr) == jmodel.known_layer_paths(jr)
    assert str(tr.numerics_plan) == str(jr.numerics_plan)


def test_shape_cells_equal_reference():
    from repro.nn.config import SHAPE_CELLS as J
    from repro_torch.nn.config import SHAPE_CELLS as T
    assert {k: dataclasses.asdict(v) for k, v in T.items()} \
        == {k: dataclasses.asdict(v) for k, v in J.items()}
    assert {k: v.tokens_per_step for k, v in T.items()} \
        == {k: v.tokens_per_step for k, v in J.items()}


# -------------------------------------------------------------- init ----
@pytest.mark.parametrize("arch", DENSE)
def test_init_params_in_law(arch):
    """The tree, shapes and dtypes are the reference's; each leaf's
    standard deviation is the reference's law (its own draw's std within
    10%, both from one seed each: the values are not matched)."""
    jcfg, tcfg = _cfgs(arch, "fp32")
    jp = _np(jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    tp = tmodel.params_to_numpy(tmodel.init_params(0, tcfg, device="cpu"))
    jl, jdef = jax.tree_util.tree_flatten(jp)
    tl, tdef = tree_flatten(tp)
    from repro_torch.pytree import treedef_str
    assert treedef_str(tdef) == str(jdef)
    for path, a, b in zip(_leaf_paths(jp), jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.std() == 0:
            np.testing.assert_array_equal(a, b)   # ones / zeros
        else:
            assert abs(b.std() / a.std() - 1) < 0.1, path
            assert abs(b.mean()) < 4 * a.std() / np.sqrt(a.size), path
    again = tmodel.params_to_numpy(tmodel.init_params(0, tcfg, "cpu"))
    assert all(np.array_equal(x, y) for x, y in
               zip(tl, tree_leaves(again)))


def test_params_numpy_roundtrip_and_device_rule():
    jcfg, tcfg = _cfgs("qwen3-1.7b", "fp32")
    jp = _np(jmodel.init_params(jax.random.PRNGKey(1), jcfg))
    tp = tmodel.params_from_numpy(jp, "cpu")
    back = tmodel.params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            tmodel.init_params(0, tcfg)
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            tmodel.params_from_numpy(jp)


def test_unported_paths_raise():
    """The ssm, hybrid and encdec/audio families build and their decode
    caches are made (no ``NotImplementedError`` naming ROADMAP queue 1
    item 11 is left); the paged entry points and the engine refuse them
    as the reference does; a mesh that is not a DeviceMesh raises; a
    typo'd plan pattern fails."""
    from repro_torch.serve import ServeConfig, ServingEngine
    for arch in ("mamba2-370m", "zamba2-7b", "seamless-m4t-medium"):
        cfg = tconfigs.reduced(tconfigs.get_config(arch))
        params = tmodel.init_params(0, cfg, device="cpu")
        assert params["layers"]
        caches = tmodel.init_decode_caches(cfg, 1, 4, device="cpu")
        assert caches["layers"]
        with pytest.raises(ValueError, match="no paged KV cache"):
            tmodel.init_paged_caches(cfg, 4, 4, device="cpu")
        with pytest.raises(ValueError, match="unsupported family"):
            tmodel.decode_step_paged({}, None, {}, None, None, None, cfg)
        with pytest.raises(ValueError, match="unsupported family"):
            tmodel.prefill_chunk({}, None, {}, None, 0, 1, cfg)
        with pytest.raises(ValueError, match="reference_generate"):
            ServingEngine(cfg, params, ServeConfig())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmodel.Runtime(mesh=object())
    cfg = tconfigs.reduced(tconfigs.get_config("olmo-1b")).with_(
        numerics="fp32;layers.mpl=fmt:lns12")
    with pytest.raises(ValueError, match="match no layer path"):
        tmodel.loss_fn({}, {}, cfg)


# ------------------------------------------------------------ layers ----
def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("norm_kind", ["rmsnorm", "layernorm",
                                       "nonparam_ln"])
def test_norms_equal_reference(norm_kind):
    jcfg, tcfg = _cfgs("olmo-1b", "fp32", norm_kind=norm_kind)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32) * 3 + 1
    p = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in jlayers.init_norm(jcfg, jnp.float32).items()}
    want = jlayers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jcfg)
    got = tlayers.apply_norm(tree_map(torch.tensor, p), torch.tensor(x),
                             tcfg)
    _close(got, want)
    scale = rng.normal(size=(16,)).astype(np.float32)
    _close(tlayers.rms_head_norm(torch.tensor(x[..., :16]),
                                 torch.tensor(scale)),
           jlayers.rms_head_norm(jnp.asarray(x[..., :16]),
                                 jnp.asarray(scale)))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_equals_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None] + 100, (B, S)).astype(np.int32)
    _close(tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("mlp", [("glu", "silu"), ("mlp", "gelu")])
def test_mlp_equals_reference(mlp):
    jcfg, tcfg = _cfgs("yi-6b", "fp32", mlp_kind=mlp[0], act=mlp[1])
    jp = _np(jlayers.init_mlp(jax.random.PRNGKey(2), jcfg, jcfg.d_ff,
                              jnp.float32))
    x = np.random.default_rng(2).normal(size=(B, S, jcfg.d_model)
                                        ).astype(np.float32)
    _close(tlayers.apply_mlp(tree_map(torch.tensor, jp), torch.tensor(x),
                             tcfg, get_policy("fp32")),
           jlayers.apply_mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                             jcfg, jpolicy("fp32")))


@pytest.mark.parametrize("tied", [False, True])
def test_embed_logits_and_chunked_ce_equal_reference(tied):
    """The gather, the head (tied: the table's transposed view), the
    padded vocabulary's mask (vocab 250 padded to 256) and a CE over
    several chunks."""
    jcfg, tcfg = _cfgs("olmo-1b", "fp32", tie_embeddings=tied,
                       vocab_size=250, ce_chunk=4)
    assert jcfg.padded_vocab == 256
    jp = _np(jlayers.init_embeddings(jax.random.PRNGKey(3), jcfg,
                                     jnp.float32))
    tp = tree_map(torch.tensor, jp)
    b = _batch(jcfg)
    x = np.random.default_rng(3).normal(size=(B, S, jcfg.d_model)
                                        ).astype(np.float32)
    pol, jpol = get_policy("fp32"), jpolicy("fp32")
    _close(tlayers.embed_tokens(tp, torch.tensor(b["tokens"]), pol),
           jlayers.embed_tokens(jp, jnp.asarray(b["tokens"]), jpol))
    got = tlayers.lm_logits(tp, torch.tensor(x), pol, tcfg)
    want = jlayers.lm_logits(jp, jnp.asarray(x), jpol, jcfg)
    assert float(got[..., 250:].max()) == float(np.float32(-1e30))
    _close(got, want)
    _close(tlayers.chunked_ce_loss(torch.tensor(x), tp,
                                   torch.tensor(b["labels"]), pol, tcfg),
           jlayers.chunked_ce_loss(jnp.asarray(x), jp,
                                   jnp.asarray(b["labels"]), jpol, jcfg))


@pytest.mark.parametrize("case", [
    ("olmo-1b", {"q_chunk": 4}),                 # 4 bands of 4 chunks
    ("qwen3-1.7b", {"q_chunk": 16}),             # qk-norm, one band
    ("yi-6b", {"q_chunk": 4, "causal": False}),  # one band, no mask
])
def test_gqa_attention_equals_reference(case):
    arch, kw = case
    jcfg, tcfg = _cfgs(arch, "fp32", **kw)
    jp = _np(jattn.init_gqa(jax.random.PRNGKey(4), jcfg, jnp.float32))
    x = np.random.default_rng(4).normal(size=(B, S, jcfg.d_model)
                                        ).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want, jkv = jattn.gqa_attention(jp, jnp.asarray(x), jcfg,
                                    jpolicy("fp32"), jnp.asarray(pos))
    got, tkv = tattn.gqa_attention(tree_map(torch.tensor, jp),
                                   torch.tensor(x), tcfg, get_policy("fp32"),
                                   torch.tensor(pos))
    _close(got, want)
    _close(tkv.k, jkv.k)
    _close(tkv.v, jkv.v)


def test_remat_block_changes_nothing():
    """``remat="block"`` recomputes each block in backward: under the
    deterministic ⊞-MAC the loss and gradients equal ``remat="none"``'s."""
    _, tcfg = _cfgs("qwen3-1.7b", "lns16-train-pallas")
    params = tmodel.init_params(5, tcfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 5).items()}
    out = []
    for remat in ("none", "block"):
        leaves, treedef = tree_flatten(params)
        live = [t.detach().requires_grad_() for t in leaves]
        from repro_torch.pytree import tree_unflatten
        loss = tmodel.loss_fn(tree_unflatten(treedef, live), b,
                              tcfg.with_(remat=remat))
        out.append((loss, torch.autograd.grad(loss, live)))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        assert torch.equal(a, c)

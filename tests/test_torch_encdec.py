"""The enc-dec families in the port against the JAX package:
``reduced(seamless-m4t-medium)`` (audio: the stub frontend's frame
embeddings through ``frontend_proj`` into a non-causal encoder; 2 encoder
and 2 decoder layers, layernorm, gelu MLP) and its ``encdec`` variant
without a frontend, whose encoder reads ``enc_tokens``; from the
reference's parameters, batch 2 × 16 tokens over 16 frames.

Tiers (``tests/lm_parity.py``): ``loss_fn`` under fp32 within rtol 1e-5
and every gradient within 1e-5 × its leaf's largest magnitude; under
lns16-train the loss within 2e-2 and the gradients within 0.5 relative
L2 over the tree (the dense families' tier: 1e-2 and 0.3).  The cause is
ROADMAP queue 3 item 7 (float32 ulps of the norms and attention move
codes that the ⊞-MACs carry on), over four attention blocks and a head
of 256 256 rows here; over six seeds of each variant (``python
tests/lm_parity_sweep.py families``) the loss gaps read up to 1.48e-2
and the gradients 0.12-0.36.  ``prefill`` and
``decode_step`` (each step from the reference's caches) under fp32 within
1e-5 × each output's largest magnitude; ``decode_step`` under lns16-train
within 0.3 relative L2 (the serving tier, queue 3 item 11).  The
cross-attention teacher-forced under lns16-train from inputs on the lns16
grid: its K and V (the ``wk`` / ``wv`` products over the frames) with
the reference's codes, its output within 1e-6 relative L2 (the float
attention between ``wq`` and ``wo`` parts by ulps, as
``test_torch_serve_layers.py`` holds attention).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lm_parity import B, NUMERICS, S, batch, cfgs, check_loss_and_grads, \
    close, code_diff, grid, rel_l2, to_numpy
from repro.nn import model as jmodel
from repro_torch.nn import model as tmodel

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
#: variant → config overrides of ``reduced(seamless-m4t-medium)``
VARIANTS = {"audio": {}, "encdec": {"family": "encdec", "frontend": None}}
#: lns16-train loss_fn bounds (see above)
LOSS_RTOL, GRAD_RTOL = 2e-2, 0.5


@pytest.mark.parametrize("mode", ["fp32", "lns16-train"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads(variant, mode):
    bounds = {} if mode == "fp32" else dict(loss_rtol=LOSS_RTOL,
                                            grad_rtol=GRAD_RTOL)
    grads = check_loss_and_grads(ARCH, mode, **bounds, **VARIANTS[variant])
    assert any("enc_layers" in p for p in grads)
    assert any("xattn" in p for p in grads)
    assert ("['frontend_proj']" in grads) == (variant == "audio")


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _model(variant, mode="fp32", seed=0):
    jcfg, tcfg = cfgs(ARCH, *NUMERICS[mode], **VARIANTS[variant])
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, tmodel.params_from_numpy(to_numpy(jp), "cpu")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_teacher_forced(variant):
    """``prefill`` (logits, the decoder's (self KV, cross KV) stacks and
    ``enc_out``), then three ``decode_step`` calls from the reference's
    caches (its ``init_decode_caches`` over 16 frames, ``enc_out`` set to
    its prefill's): logits, self caches, the cross caches and ``enc_out``
    passed through."""
    jcfg, tcfg, jp, tp = _model(variant)
    b = batch(jcfg, seed=3)
    jl, jc = jax.jit(lambda pp, bb: jmodel.prefill(pp, bb, jcfg))(
        jp, jax.tree.map(jnp.asarray, b))
    tl, tc = tmodel.prefill(tp, {k: torch.from_numpy(v) for k, v in
                                 b.items()}, tcfg)
    print(f"\n{variant} prefill:")
    close(tl, jl, 1e-5, "logits")
    assert sorted(tc) == ["enc_out", "layers"]
    for (path, want), got in zip(_leaves(jc), jax.tree.leaves(
            tmodel.caches_to_numpy(tc))):
        close(got, want, 1e-5, jax.tree_util.keystr(path))
    caches = jmodel.init_decode_caches(jcfg, B, 8, jnp.float32, enc_len=S)
    caches["enc_out"] = jc["enc_out"]
    step = jax.jit(lambda pp, t, c, pos: jmodel.decode_step(pp, t, c, pos,
                                                            jcfg))
    rng = np.random.default_rng(4)
    print(f"{variant} decode:")
    for i in range(3):
        tok = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = np.full((B,), i, np.int32)
        jl, jn = step(jp, jnp.asarray(tok), caches, jnp.asarray(pos))
        tl, tn = tmodel.decode_step(
            tp, torch.from_numpy(tok),
            tmodel.caches_from_numpy(to_numpy(caches), "cpu"),
            torch.from_numpy(pos), tcfg)
        close(tl, jl, 1e-5, f"step {i} logits")
        for (path, want), got in zip(_leaves(jn), jax.tree.leaves(
                tmodel.caches_to_numpy(tn))):
            close(got, want, 1e-5, f"step {i} {jax.tree_util.keystr(path)}")
        assert tn["enc_out"] is not None
        np.testing.assert_array_equal(tn["layers"][1].k.numpy(),
                                      np.asarray(caches["layers"][1].k))
        caches = jn


def test_decode_lns_train_teacher_forced():
    """Audio, lns16-train: three ``decode_step`` calls from the
    reference's caches, logits and self caches within 0.3 relative L2."""
    jcfg, tcfg, jp, tp = _model("audio", "lns16-train")
    b = batch(jcfg, seed=5)
    caches = jmodel.init_decode_caches(jcfg, B, 8, jnp.float32, enc_len=S)
    caches["enc_out"] = jnp.asarray(
        np.random.default_rng(6).normal(size=(B, S, jcfg.d_model)),
        jnp.float32)
    step = jax.jit(lambda pp, t, c, pos: jmodel.decode_step(pp, t, c, pos,
                                                            jcfg))
    gaps = []
    for i in range(3):
        tok = b["tokens"][:, i:i + 1]
        pos = np.full((B,), i, np.int32)
        jl, jn = step(jp, jnp.asarray(tok), caches, jnp.asarray(pos))
        tl, tn = tmodel.decode_step(
            tp, torch.from_numpy(tok),
            tmodel.caches_from_numpy(to_numpy(caches), "cpu"),
            torch.from_numpy(pos), tcfg)
        gaps.append((rel_l2([tl], [jl])[0],
                     rel_l2(jax.tree.leaves(tmodel.caches_to_numpy(tn)),
                            jax.tree.leaves(jn))[0]))
        caches = jn
    print(f"\naudio lns16-train decode (logits, caches) relative L2: {gaps}")
    assert max(max(g) for g in gaps) <= 0.3


@pytest.mark.parametrize("frames", [S, 2 * S])
@pytest.mark.parametrize("mode", ["fp32", "lns16-train"])
def test_cross_attention_teacher_forced(mode, frames):
    """``_cross_attention`` from the same queries' input, encoder memory
    and weights (all on the lns16 grid): K and V over the
    frames, the output.  With more frames than queries, the one band's
    keys are the first S frames in both packages."""
    jcfg, tcfg, jp, tp = _model("audio", mode)
    jpol = jmodel._model_plan(jcfg).runtime_for("layers.xattn")
    tpol = tmodel._model_plan(tcfg).runtime_for("layers.xattn")
    rng = np.random.default_rng(7)
    lp = {k: grid(rng, np.shape(v)[1:], lo=-4.0, hi=-1.0)
          for k, v in jp["layers"]["xattn"].items()}
    q_in = grid(rng, (B, S, jcfg.d_model))
    enc = grid(rng, (B, frames, jcfg.d_model))
    jo, jkv = jax.jit(lambda pp, q, e: jmodel._cross_attention(
        pp, q, e, jcfg, jpol))(jax.tree.map(jnp.asarray, lp),
                               jnp.asarray(q_in), jnp.asarray(enc))
    to, tkv = tmodel._cross_attention(
        tmodel.params_from_numpy(lp, "cpu"), torch.from_numpy(q_in),
        torch.from_numpy(enc), tcfg, tpol)
    assert tkv.k.shape == (B, frames, jcfg.n_kv_heads, jcfg.d_head)
    gap = rel_l2([to], [jo])[0]
    print(f"\ncross-attention {mode}, {frames} frames: output relative L2 "
          f"{gap:.3g}")
    if mode == "fp32":
        close(to, jo, 1e-5, "output")
        close(tkv.k, jkv.k, 1e-5, "K")
        close(tkv.v, jkv.v, 1e-5, "V")
    else:
        for what, got, want in (("K", tkv.k, jkv.k), ("V", tkv.v, jkv.v)):
            assert code_diff(got, want)[0] == 0, what
        assert gap <= 1e-6

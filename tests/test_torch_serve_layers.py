"""The serving path's layers under lns16-train against the JAX package,
teacher-forced one layer at a time: each layer of the port's serving
view (``nn/model.py: _ServePol``: ``linear_infer``, the order-free float
reductions) and of the reference's (``_InferPol``) gets the same input,
the reference's float32 norm output, and the same cache pages.

The whole-model serving tests (``test_torch_serve_model.py``,
``test_torch_serve_paged.py``) hold lns16-train logits within 0.3
relative L2: one ulp of a norm moves a ⊞-MAC input code, and the next
layers carry it (ROADMAP queue 3 item 11).  At that bound a float head
or unquantized routed experts pass.  Here, with a layer's inputs equal,
only the float ops inside the layer part the two packages: the head is
one ⊞-MAC of equal input codes (decoded floats within one ulp), the MLP
and the attention steps are held within ``TIER``, the MoE block within
``TIER_MOE``, also with its shared experts cut, so that its routed
experts' float einsums of the quantized operands stand alone.  The
serving steps are held whole on parameters whose blocks add zero, which
leaves the embedding, the final norm, the head and every layer's cache
lines to compare.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import model as jmodel
from repro.nn import moe as jmoe
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tlayers
from repro_torch.nn import model as tmodel
from repro_torch.nn import moe as tmoe
from repro_torch.nn.attention import KVCache
from repro_torch.pytree import tree_map

from lm_parity import rel_l2, to_numpy
from test_torch_serve_model import ARCHS, Pair, _t

torch.set_num_threads(1)

#: Relative L2 of a layer's output (and its cache pages) from the
#: reference's, teacher-forced, under lns16-train: the attention and MLP
#: layers', and the MoE block's, whose quantized expert weights are a
#: code apart in the two packages at a few places (their float32
#: ``log2`` at a rounding boundary).
TIER, TIER_MOE = 1e-6, 1e-4

#: (family, layer stack, component) of every layer kind the serving
#: path runs: the dense layers' attention and MLP, the MoE layers'
#: attention and MoE block, GQA and MLA.
CASES = [("dense", "layers", "attn"), ("dense", "layers", "mlp"),
         ("moe-gqa", "dense_layers", "mlp"), ("moe-gqa", "layers", "attn"),
         ("moe-gqa", "layers", "moe"), ("moe-mla", "layers", "attn"),
         ("moe-mla", "layers", "moe")]


@functools.lru_cache(maxsize=None)
def _pair(family):
    return Pair(family, "lns16-train")


def _pols(pr, path):
    """The reference's and the port's serving views of ``path``'s
    runtime."""
    return (jmodel._InferPol(jmodel._model_plan(pr.jcfg).runtime_for(path)),
            tmodel._ServePol(tmodel._model_plan(pr.tcfg).runtime_for(path),
                             True))


def _layer(pr, stack):
    """Layer 0 of ``stack`` in both packages."""
    return (jax.tree.map(lambda t: t[0], pr.jp[stack]),
            tree_map(lambda t: t[0], pr.tp[stack]))


def _normed(pr, norm_params, shape, seed):
    """The reference's float32 norm output of a seeded hidden state, as
    an array and as a tensor."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    h = np.asarray(jlayers.apply_norm(norm_params, jnp.asarray(x), pr.jcfg))
    return jnp.asarray(h), torch.from_numpy(h.copy())


def _gap(what, tout, jout):
    gap = rel_l2([tout], [np.asarray(jout)])[0]
    print(f"  {what}: relative L2 {gap:.3g}")
    return gap


def test_head_teacher_forced():
    """The head from the reference's final norm output: one ⊞-MAC of
    equal input codes, so the logits' decoded floats within one ulp."""
    pr = _pair("dense")
    jpol, tpol = _pols(pr, "head")
    jh, th = _normed(pr, pr.jp["final_norm"], (3, 1, pr.jcfg.d_model), 1)
    j = jax.jit(lambda p, h: jlayers.lm_logits(p, h, jpol, pr.jcfg))(
        pr.jp["emb"], jh)
    with torch.no_grad():
        t = tlayers.lm_logits(pr.tp["emb"], th, tpol, pr.tcfg)
    np.testing.assert_array_max_ulp(t.numpy(), np.asarray(j), maxulp=1)


def _run_mlp(pr, stack, jlp, tlp, jh, th):
    jpol, tpol = _pols(pr, f"{stack}.mlp")
    j = jax.jit(lambda p, h: jlayers.apply_mlp(p, h, pr.jcfg, jpol))(
        jlp["mlp"], jh)
    t = tlayers.apply_mlp(tlp["mlp"], th, pr.tcfg, tpol)
    return [(t, j)]


def _run_moe(pr, stack, jlp, tlp, jh, th):
    out = []
    for cut in (False, True):
        jcfg, tcfg = pr.jcfg, pr.tcfg
        if cut:   # the routed experts alone
            jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, n_shared=0))
            tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe, n_shared=0))
        jpol, tpol = _pols(pr, f"{stack}.moe")
        j = jax.jit(lambda p, h: jmoe.moe_block(p, h, jcfg, jpol)[0])(
            jlp["moe"], jh)
        t = tmoe.moe_block(tlp["moe"], th, tcfg, tpol)[0]
        out.append((t, j))
    return out


def _pages(pr, seed):
    """Seeded cache pages (9 blocks of 4 lines) in both packages."""
    c = jmodel.init_paged_caches(pr.jcfg, 9, 4, jnp.float32)["layers"]
    rng = np.random.default_rng(seed)
    planes = [rng.normal(size=p.shape[1:]).astype(np.float32) for p in c]
    return (jattn.KVCache(*map(jnp.asarray, planes)),
            KVCache(*(torch.from_numpy(p.copy()) for p in planes)))


def _run_attn(pr, stack, jlp, tlp, jh, th):
    """A batched paged decode over three slots (the middle one inactive)
    and a chunk of 4 with 2 valid spliced into slot 1, each from the same
    pages."""
    jpol, tpol = _pols(pr, f"{stack}.attn")
    mla = pr.jcfg.attn_kind == "mla"
    jdec = jattn.mla_decode_paged if mla else jattn.gqa_decode_paged
    tdec = tattn.mla_decode_paged if mla else tattn.gqa_decode_paged
    jpre = jattn.mla_prefill_paged if mla else jattn.gqa_prefill_paged
    tpre = tattn.mla_prefill_paged if mla else tattn.gqa_prefill_paged
    bt = np.array([[3, 8, 1], [6, 2, 5], [4, 7, 0]], np.int32)
    pos = np.array([2, 6, 9], np.int32)
    active = np.array([True, False, True])
    jc, tc = _pages(pr, 4)
    j, jnew = jax.jit(lambda p, h, c: jdec(
        p, h, pr.jcfg, jpol, c, jnp.asarray(bt), jnp.asarray(pos),
        jnp.asarray(active)))(jlp["attn"], jh[:3, :1], jc)
    t, tnew = tdec(tlp["attn"], th[:3, :1], pr.tcfg, tpol, tc,
                   torch.from_numpy(bt), torch.from_numpy(pos),
                   torch.from_numpy(active))
    out = [(t[active], np.asarray(j)[active])]
    out += list(zip(tnew, jnew))
    j, jnew = jax.jit(lambda p, h, c: jpre(
        p, h, pr.jcfg, jpol, c, jnp.asarray(bt[1]), jnp.int32(4),
        jnp.int32(2)))(jlp["attn"], jh[:1], jc)
    t, tnew = tpre(tlp["attn"], th[:1], pr.tcfg, tpol, tc,
                   torch.from_numpy(bt[1]), 4, 2)
    out.append((t[:, :2], np.asarray(j)[:, :2]))
    out += list(zip(tnew, jnew))
    return out


@pytest.mark.parametrize("family,stack,component", CASES)
def test_layer_teacher_forced(family, stack, component):
    """One layer of the serving path from the reference's norm output
    (norm1 before attention, norm2 before the MLP or MoE): its outputs
    and the cache pages it writes within ``TIER`` of the reference's
    (``TIER_MOE`` for the MoE block)."""
    pr = _pair(family)
    jlp, tlp = _layer(pr, stack)
    norm = "norm1" if component == "attn" else "norm2"
    jh, th = _normed(pr, jlp[norm], (3, 4, pr.jcfg.d_model), 2)
    run = {"attn": _run_attn, "mlp": _run_mlp, "moe": _run_moe}[component]
    print(f"\n{family} {stack}.{component}")
    with torch.no_grad():
        gaps = [_gap(f"output {i}", t, j)
                for i, (t, j) in enumerate(run(pr, stack, jlp, tlp, jh, th))]
    assert max(gaps) <= (TIER_MOE if component == "moe" else TIER), gaps


def _zero_block_outputs(tree):
    """The parameter tree with every block's output projections zeroed
    (attention ``wo``, the MLP's and the experts' ``w_down``, the shared
    experts' ``shared_down``): each block then adds exactly zero, and a
    serving step's logits are the head's of the embedding rows."""
    zero = {"wo", "w_down", "shared_down"}

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return np.zeros_like(t) if key in zero else t
    return {k: (walk(v) if k in ("layers", "dense_layers") else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("family", list(ARCHS))
def test_serving_steps_with_blocks_zeroed(family):
    """``decode_step_paged`` and ``prefill_chunk`` whole, on parameters
    whose blocks add exactly zero: the embedding, final norm and head
    around the layer stacks, and every layer's cache lines, from the
    same caches in both packages: the logits within ``TIER_MOE`` (the
    embedding's quantized rows may be a code apart at a few places, as
    the experts' weights are), the pages within ``TIER``."""
    pr = _pair(family)
    np_params = _zero_block_outputs(to_numpy(pr.jp))
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = tmodel.params_from_numpy(np_params, "cpu")
    caches = jmodel.init_paged_caches(pr.jcfg, 9, 4, jnp.float32)
    bt = np.array([[3, 8, 1], [6, 2, 5], [4, 7, 0]], np.int32)
    rng = np.random.default_rng(3)
    gaps = []
    print(f"\n{family}")
    toks = rng.integers(3, pr.jcfg.vocab_size, size=(1, 4)).astype(np.int32)
    args = (jnp.asarray(bt[1]), jnp.int32(0), jnp.int32(3))
    jl, jc = jax.jit(functools.partial(jmodel.prefill_chunk, cfg=pr.jcfg))(
        jp, jnp.asarray(toks), caches, *args)
    with torch.no_grad():
        tl, tc = tmodel.prefill_chunk(
            tp, torch.from_numpy(toks), _t(caches), torch.from_numpy(bt[1]),
            0, 3, pr.tcfg)
    gaps.append(("chunk logits", _gap("chunk logits", tl, jl), TIER_MOE))
    pages = [(k, p, t, j) for k in jc for p, t, j in zip("kv", tc[k], jc[k])]
    toks = rng.integers(3, pr.jcfg.vocab_size, size=(3, 1)).astype(np.int32)
    pos = np.array([3, 6, 9], np.int32)
    active = np.array([True, False, True])
    jl, jc = jax.jit(functools.partial(jmodel.decode_step_paged,
                                       cfg=pr.jcfg))(
        jp, jnp.asarray(toks), jc, jnp.asarray(bt), jnp.asarray(pos),
        jnp.asarray(active))
    with torch.no_grad():
        tl, tc = tmodel.decode_step_paged(
            tp, torch.from_numpy(toks), tc, torch.from_numpy(bt),
            torch.from_numpy(pos), torch.from_numpy(active), pr.tcfg)
    gaps.append(("decode logits", _gap("decode logits", tl[active],
                                       np.asarray(jl)[active]), TIER_MOE))
    pages += [(k, p, t, j) for k in jc for p, t, j in zip("kv", tc[k], jc[k])]
    for k, p, t, j in pages:
        gaps.append((f"{k}.{p}", _gap(f"pages {k}.{p}", t, j), TIER))
    assert all(g <= tier for _, g, tier in gaps), gaps

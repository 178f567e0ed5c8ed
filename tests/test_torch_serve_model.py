"""The model side of serving against the JAX package, dense-cache half:
``prefill`` and ``decode_step`` for the dense, moe-GQA and moe-MLA
families (``reduced()`` olmo-1b, deepseek-moe-16b, deepseek-v2-lite-16b),
teacher-forced: every call gets the same parameters, tokens, caches and
positions in both packages (the reference's caches carried across before
each call).  ``test_torch_serve_paged.py`` holds the paged half.

Tiers: fp32 logits and cache lines within rtol 1e-5; lns16-train (the
port's CPU lane against the reference's emulate lane) logits and cache
lines within 0.3 relative L2, ``tests/lm_parity.py``'s bound for
lns16-train tensors (``GRAD_RTOL``), with the products of
``lns_dot_fused`` bit-exact
(``test_lns_dot_fused_products``).  The lns16-train gap is ROADMAP queue 3
item 7's: a float32 ulp in a norm moves an input code by one, and a ⊞-MAC
whose running sum nearly cancels carries that into an output code moved
by hundreds (``-s`` prints the gaps); ``test_torch_serve_layers.py``
holds each serving layer, teacher-forced, within 1e-6 (1e-4 for the MoE
block).  The caches hold the same lines in the same places (the set of
positions written is identical).  The serving functions take their float
reductions in float64 (``layers.ORDER_FREE``), so they agree with the
reference's float32 ones within those tolerances, not bitwise.  Also:
``linear_infer``
bit-identical to ``linear``'s forward on every spec, and ``infer_path``
the reference's text.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LNS16 as JLNS16
from repro.core import encode as jencode
from repro.core.numerics import get_plan as jget_plan
from repro.core.qat import lns_dot_fused as jdot_fused
from repro.nn import model as jmodel
import repro_torch.core as T
from repro_torch.core.numerics import get_plan as tget_plan
from repro_torch.core.qat import lns_dot_fused as tdot_fused
from repro_torch.nn import model as tmodel
from repro_torch.nn.attention import KVCache

from lm_parity import cfgs, rel_l2, to_numpy

torch.set_num_threads(1)

ARCHS = {"dense": "olmo-1b", "moe-gqa": "deepseek-moe-16b",
         "moe-mla": "deepseek-v2-lite-16b"}
MODES = {"fp32": ("fp32", "fp32"),
         "lns16-train": ("lns16-train-emulate", "lns16-train-pallas")}
SPECS = ["fp32", "bf16", "lns16-qat", "lns16-exact", "lns16-exact-pallas",
         "lns16-train-emulate", "lns16-train-pallas"]


def _t(tree):
    """The reference's caches (dicts of KVCache of arrays) as the port's."""
    return {k: KVCache(torch.from_numpy(np.array(v.k)),
                       torch.from_numpy(np.array(v.v)))
            for k, v in tree.items()}


class Pair:
    """One config in both packages, its parameters carried across."""

    def __init__(self, family, mode):
        jnum, tnum = MODES[mode]
        self.mode = mode
        self.jcfg, self.tcfg = cfgs(ARCHS[family], jnum, tnum)
        self.jp = jmodel.init_params(jax.random.PRNGKey(7), self.jcfg)
        self.tp = tmodel.params_from_numpy(to_numpy(self.jp), "cpu")

    def jit(self, fn):
        return jax.jit(functools.partial(fn, cfg=self.jcfg))

    def check(self, what, tout, jout):
        """Logits (or a cache line set) within the mode's tier."""
        t = tout.detach().numpy()
        j = np.asarray(jout)
        assert t.shape == j.shape, (what, t.shape, j.shape)
        if self.mode == "fp32":
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                       err_msg=what)
        else:
            gap = rel_l2([tout], [j])[0]
            print(f"  {what}: relative L2 {gap:.3g}")
            assert gap <= 0.3, (what, gap)

    def check_caches(self, what, tc, jc, line_axes=2):
        """The same lines written in the same places (a line: the values
        of one cache position, past the first ``line_axes`` axes: layer
        and batch, or layer and block with the offset next), each within
        the tier."""
        assert sorted(tc) == sorted(jc), what
        for k in jc:
            for plane, t, j in zip("kv", tc[k], jc[k]):
                t, j = t.detach().numpy(), np.asarray(j)
                axes = tuple(range(line_axes + 1, t.ndim))
                np.testing.assert_array_equal(
                    (t != 0).any(axes), (j != 0).any(axes),
                    err_msg=f"{what} {k}.{plane}: lines written")
                self.check(f"{what} {k}.{plane}", torch.from_numpy(t), j)


def _prompt(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        3, cfg.vocab_size, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", list(ARCHS))
def test_prefill_and_decode_step(family, mode):
    """``prefill`` of a (2, 8) prompt (last logits and the stacked
    caches), then three ``decode_step``s against dense caches of 16 lines
    at ragged positions (the slots at different lengths)."""
    pr = Pair(family, mode)
    toks = _prompt(pr.jcfg, 2, 8, seed=1)
    jl, jc = pr.jit(jmodel.prefill)(pr.jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tmodel.prefill(pr.tp, {"tokens": torch.from_numpy(toks)},
                            pr.tcfg)
    print(f"\n{family} {mode}")
    pr.check("prefill logits", tl, jl)
    pr.check_caches("prefill caches", tc, jc)
    caches = jmodel.init_decode_caches(pr.jcfg, 2, 16, jnp.float32)
    step = pr.jit(jmodel.decode_step)
    pos = np.array([0, 5], np.int32)
    for i in range(3):
        tok = _prompt(pr.jcfg, 2, 1, seed=10 + i)
        jl, jnew = step(pr.jp, jnp.asarray(tok), caches, jnp.asarray(pos))
        tl, tnew = tmodel.decode_step(pr.tp, torch.from_numpy(tok),
                                      _t(caches), torch.from_numpy(pos),
                                      pr.tcfg)
        pr.check(f"decode {i} logits", tl, jl)
        pr.check_caches(f"decode {i} caches", tnew, jnew)
        caches, pos = jnew, pos + 1


def test_lns_dot_fused_products():
    """``lns_dot_fused`` (the fused ⊞-MAC with no epilogue, kernel row 1):
    the product codes equal the reference's (emulate and Pallas-interpret
    lanes) and the decoded floats agree within an ulp."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 40)).astype(np.float32)
    w = (rng.normal(size=(40, 24)) * 0.1).astype(np.float32)
    tbe = tget_plan("lns16-train-pallas").runtime().matmul
    tz = tbe.matmul_fused(T.encode(torch.from_numpy(x.reshape(6, 40)),
                                   T.LNS16),
                          T.encode(torch.from_numpy(w), T.LNS16))
    tout = tdot_fused(torch.from_numpy(x), torch.from_numpy(w), tbe)
    assert not tout.requires_grad and tout.shape == (2, 3, 24)
    for spec in ("lns16-train-emulate", "lns16-train-pallas"):
        jbe = jget_plan(spec).runtime().matmul
        jz = jbe.matmul_fused(jencode(jnp.asarray(x.reshape(6, 40)),
                                      JLNS16),
                              jencode(jnp.asarray(w), JLNS16))
        np.testing.assert_array_equal(tz.code.numpy(), np.asarray(jz.code))
        np.testing.assert_array_equal(tz.sign.numpy(),
                                      np.asarray(jz.sign).astype(np.int8))
        np.testing.assert_array_max_ulp(
            tout.numpy(), np.asarray(jdot_fused(jnp.asarray(x),
                                                jnp.asarray(w), jbe)),
            maxulp=1)


@pytest.mark.parametrize("spec", SPECS)
def test_linear_infer_matches_linear_forward(spec):
    """The serving dispatch is bit-identical to the training forward on
    every spec, and describes itself in the reference's words."""
    rt = tget_plan(spec).runtime()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    got = rt.linear_infer(x, w)
    assert not got.requires_grad
    assert torch.equal(got, rt.linear(x, w))
    assert rt.infer_path == jget_plan(spec).runtime().infer_path


def test_paged_families_and_refusals():
    """The paged families are the reference's; an unpaged family (the
    real reduced mamba2-370m) is refused as the reference refuses it, and
    its dense decode caches are the reference's shapes."""
    assert tmodel.PAGED_FAMILIES == jmodel.PAGED_FAMILIES
    jssm, ssm = cfgs("mamba2-370m", "fp32")
    for fn in (tmodel.init_paged_caches, jmodel.init_paged_caches):
        with pytest.raises(ValueError, match="no paged KV cache"):
            fn(jssm if fn is jmodel.init_paged_caches else ssm, 4, 4)
    caches = tmodel.init_decode_caches(ssm, 1, 4, device="cpu")
    want = jmodel.init_decode_caches(jssm, 1, 4)
    assert caches["layers"].conv.shape == want["layers"].conv.shape
    assert caches["layers"].state.shape == want["layers"].state.shape

"""The port's Mamba2 block (``nn/ssm.py``) and the ssm family's model
(``reduced(mamba2-370m)``: d_model 64, 8 heads of 16, d_state 16, chunk
8, d_conv 4) against the JAX package, function by function, on the same
numpy inputs.

Tolerances, each with its cause:

* The conv (``_conv_full``), ``softplus`` and the gated norm
  (``_gated_out``'s float part) compute the reference's elementwise ops in
  its order; XLA's and torch's float32 ``exp`` / ``rsqrt`` / mean may part
  by an ulp: within 2e-6 × the largest magnitude.
* The SSD scan (``_ssd_chunked``): the reference's three- and
  four-operand einsums are pairwise contractions in an order of XLA's
  choosing, the port's in a fixed one, so sums of up to 24 float32 terms
  round differently: y and the final state within 1e-5 × the largest
  magnitude, the gradients of every input within 1e-4 × the leaf's
  largest (the backward sums over the chunk and over exp(a_cs) terms that
  span 10^±7) and all finite.
* ``softplus``: the reference's formula; within 3 float32 ulps of
  ``jax.nn.softplus``, value and derivative.
* The whole block (``mamba2_forward``, ``mamba2_decode``) and the model's
  ``prefill`` / ``decode_step`` under fp32: 1e-5 × the largest magnitude;
  the conv windows, slices of ``in_proj``'s float32 product, within
  1e-6.
* lns16-train: the block's two products (``in_proj``, ``out_proj``) from
  the same input are bit-exact in their codes (the ⊞-MAC's contract).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lm_parity import B, NUMERICS, S, cfgs, close, code_diff, grid, \
    to_numpy
from repro.nn import model as jmodel
from repro.nn import ssm as jssm
from repro_torch.nn import model as tmodel
from repro_torch.nn import ssm as tssm

torch.set_num_threads(1)

ARCH = "mamba2-370m"


def _setup(mode="fp32", seed=0):
    """(jcfg, tcfg, reference runtime, port runtime, layer params as numpy)
    of one Mamba2 layer at layer path ``layers.mamba``; the zero and one
    leaves are redrawn so that every term of the block is exercised."""
    jcfg, tcfg = cfgs(ARCH, *NUMERICS[mode])
    jpol = jmodel._model_plan(jcfg).runtime_for("layers.mamba")
    tpol = tmodel._model_plan(tcfg).runtime_for("layers.mamba")
    p = to_numpy(jssm.init_mamba2(jax.random.PRNGKey(seed), jcfg,
                                  jnp.float32))
    rng = np.random.default_rng(seed)
    for k, scale in (("conv_b", 0.1), ("D", 1.0), ("dt_bias", 0.5),
                     ("norm", 1.0)):
        p[k] = (p[k] + scale * rng.normal(size=p[k].shape)).astype(
            np.float32)
    return jcfg, tcfg, jpol, tpol, p


def _t(tree):
    return tmodel.params_from_numpy(tree, "cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_init_mamba2_in_law():
    """The tree, shapes and dtypes are the reference's; the constant
    leaves equal it (A_log within an ulp: log of linspace); the drawn ones
    have its standard deviation within 10%."""
    jcfg, tcfg = cfgs(ARCH, "fp32")
    j = to_numpy(jssm.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.float32))
    t = tmodel.params_to_numpy(tssm.init_mamba2(
        torch.Generator().manual_seed(0), tcfg, torch.float32))
    assert sorted(j) == sorted(t)
    for k in j:
        assert j[k].shape == t[k].shape and j[k].dtype == t[k].dtype, k
    for k in ("conv_b", "D", "dt_bias", "norm"):
        np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_array_max_ulp(t["A_log"], j["A_log"], maxulp=1)
    for k in ("in_proj", "conv_w", "out_proj"):
        assert abs(t[k].std() / j[k].std() - 1) < 0.1, k


def _ssd_inputs(s, seed):
    """Δt up to 2 with A up to 16: a chunk's cumulative decay spans more
    than float32's exp range, so the upper triangle's exponent would
    overflow if it were not zeroed inside the exp."""
    rng = np.random.default_rng(seed)
    h, p, n = 8, 16, 16
    dt = rng.uniform(0.01, 2.0, size=(B, s, h)).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    return [rng.normal(size=(B, s, h, p)).astype(np.float32),
            (dt * a).astype(np.float32), dt,
            rng.normal(size=(B, s, h, n)).astype(np.float32),
            rng.normal(size=(B, s, h, n)).astype(np.float32)]


@pytest.mark.parametrize("nc", [1, 3])
def test_ssd_chunked_and_its_gradients(nc):
    """y and the final state, and the gradients of every input of a
    weighted sum of both (``jax.grad`` against ``torch.autograd``)."""
    chunk = 8
    ins = _ssd_inputs(chunk * nc, seed=nc)
    rng = np.random.default_rng(10 + nc)
    gy = rng.normal(size=ins[0].shape).astype(np.float32)
    gf = rng.normal(size=(B, 8, 16, 16)).astype(np.float32)

    def jloss(*xs):
        y, f = jssm._ssd_chunked(*xs, chunk)
        return jnp.sum(y * gy) + jnp.sum(f * gf), (y, f)
    (_, (jy, jf)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True))(*_j(ins))
    tin = [torch.from_numpy(a).requires_grad_() for a in ins]
    ty, tf = tssm._ssd_chunked(*tin, chunk)
    tg = torch.autograd.grad((ty * torch.from_numpy(gy)).sum()
                             + (tf * torch.from_numpy(gf)).sum(), tin)
    print(f"\nssd nc={nc}:")
    close(ty, jy, 1e-5, "y")
    close(tf, jf, 1e-5, "final state")
    for name, g, want in zip(("xh", "dt_a", "dt", "B", "C"), tg, jg):
        close(g, want, 1e-4, f"grad {name}")


def test_ssd_chunked_refuses_a_ragged_sequence():
    ins = [torch.from_numpy(a) for a in _ssd_inputs(12, seed=0)]
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm._ssd_chunked(*ins, 8)


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` (``logaddexp(x, 0)``, no threshold) and its
    derivative ``exp(x - softplus(x))`` on 24 001 points from -60 to 60,
    within 3 float32 ulps (XLA's float32 ``exp`` and ``log1p`` and
    torch's part by up to 2 here).  ``torch.nn.functional.softplus``
    (``log1p(exp(x))``, x above 20, ``z / (z + 1)`` in backward) parts
    from it by up to 8 ulps in the derivative."""
    x = np.linspace(-60, 60, 24001).astype(np.float32)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jax.nn.softplus)))(x)
    tx = torch.from_numpy(x).requires_grad_()
    tv = tssm.softplus(tx)
    tg, = torch.autograd.grad(tv.sum(), tx)
    np.testing.assert_array_max_ulp(tv.detach().numpy(), np.asarray(jv),
                                    maxulp=3)
    np.testing.assert_array_max_ulp(tg.numpy(), np.asarray(jg), maxulp=3)


def test_conv_full_and_gated_out():
    jcfg, tcfg, jpol, tpol, p = _setup()
    rng = np.random.default_rng(3)
    xbc = rng.normal(size=(B, S, p["conv_w"].shape[1])).astype(np.float32)
    print("\nconv / gated out:")
    close(tssm._conv_full(_t(p), torch.from_numpy(xbc)),
           jax.jit(jssm._conv_full)(_j(p), jnp.asarray(xbc)), 2e-6, "conv")
    y = rng.normal(size=(B, S, 128)).astype(np.float32)
    z = rng.normal(size=(B, S, 128)).astype(np.float32)
    want = jax.jit(lambda pp, a, b: jssm._gated_out(pp, a, b, jcfg, jpol))(
        _j(p), jnp.asarray(y), jnp.asarray(z))
    close(tssm._gated_out(_t(p), torch.from_numpy(y), torch.from_numpy(z),
                           tcfg, tpol), want, 1e-5, "gated out")


def test_mamba2_forward_and_decode_teacher_forced():
    """The block over a sequence of two chunks (output and cache), then
    three decode steps, each from the reference's cache before it."""
    jcfg, tcfg, jpol, tpol, p = _setup()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    jy, jc = jax.jit(lambda pp, xx: jssm.mamba2_forward(pp, xx, jcfg, jpol))(
        _j(p), jnp.asarray(x))
    ty, tc = tssm.mamba2_forward(_t(p), torch.from_numpy(x), tcfg, tpol)
    print("\nmamba2 block:")
    close(ty, jy, 1e-5, "forward")
    close(tc.conv, jc.conv, 1e-6, "conv tail")
    close(tc.state, jc.state, 1e-5, "final state")
    step = jax.jit(lambda pp, xx, c: jssm.mamba2_decode(pp, xx, jcfg, jpol,
                                                        c))
    cache = jc
    for i in range(3):
        xt = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        jy, jn = step(_j(p), jnp.asarray(xt), cache)
        ty, tn = tssm.mamba2_decode(
            _t(p), torch.from_numpy(xt), tcfg, tpol,
            tmodel.caches_from_numpy(to_numpy(cache), "cpu"))
        close(ty, jy, 1e-5, f"decode {i}")
        close(tn.conv, jn.conv, 1e-6, f"decode {i} window")
        close(tn.state, jn.state, 1e-5, f"decode {i} state")
        cache = jn


def test_lns_products_bit_exact():
    """Under lns16-train, ``in_proj`` and ``out_proj`` (the block's
    ``pol.linear``) from the same input codes give the reference's codes:
    the forward and both gradients (emulate lane against the port's plain
    ⊞-MAC), inputs, weights and cotangents on the lns16 grid."""
    jcfg, tcfg, jpol, tpol, p = _setup("lns16-train")
    rng = np.random.default_rng(5)
    for name, (k, n) in (("in_proj", p["in_proj"].shape),
                         ("out_proj", p["out_proj"].shape)):
        x = grid(rng, (B, S, k))
        w = grid(rng, (k, n), lo=-4.0, hi=0.0)
        g = grid(rng, (B, S, n), lo=-5.0, hi=-1.0)

        def both(a, b, c):
            out, vjp = jax.vjp(jpol.linear, a, b)
            return (out,) + vjp(c)
        want = jax.jit(both)(*_j([x, w, g]))
        xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
        out = tpol.linear(xt, wt)
        got = (out,) + torch.autograd.grad(out, (xt, wt),
                                           torch.from_numpy(g))
        for what, a, b in zip(("forward", "dX", "dW"), got, want):
            n_diff, m = code_diff(a, b)
            print(f"\n{name} {what}: {n_diff} of {a.numel()} codes differ "
                  f"(max {m})")
            assert n_diff == 0


def test_model_prefill_then_decode():
    """``prefill`` of the ssm family (logits and every layer's cache) and
    three ``decode_step`` calls, each from the reference's caches before
    it (teacher-forced), fp32."""
    jcfg, tcfg = cfgs(ARCH, "fp32")
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmodel.params_from_numpy(to_numpy(jp), "cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jc = jax.jit(lambda pp, t: jmodel.prefill(pp, {"tokens": t}, jcfg))(
        jp, jnp.asarray(toks))
    tl, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    print("\nssm model:")
    close(tl, jl, 1e-5, "prefill logits")
    close(tc["layers"].conv, jc["layers"].conv, 1e-5, "prefill conv tails")
    close(tc["layers"].state, jc["layers"].state, 1e-5, "prefill states")
    step = jax.jit(lambda pp, t, c, pos: jmodel.decode_step(pp, t, c, pos,
                                                            jcfg))
    caches = jc
    for i in range(3):
        tok = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = np.full((B,), S + i, np.int32)
        jl, jn = step(jp, jnp.asarray(tok), caches, jnp.asarray(pos))
        tl, tn = tmodel.decode_step(
            tp, torch.from_numpy(tok),
            tmodel.caches_from_numpy(to_numpy(caches), "cpu"),
            torch.from_numpy(pos), tcfg)
        close(tl, jl, 1e-5, f"decode {i} logits")
        close(tn["layers"].state, jn["layers"].state, 1e-5,
               f"decode {i} states")
        close(tn["layers"].conv, jn["layers"].conv, 1e-5,
               f"decode {i} windows")
        caches = jn

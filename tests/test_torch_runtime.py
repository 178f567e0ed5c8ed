"""The numerics runtime of the port (``LNSRuntime``, ``runtime_for``,
``resolve_kernel_args``, ``MLPConfig.layer_runtime``), ``core/qat.py``,
``core/numerics.py`` and ``lns_matmul_trainable`` against the JAX package.

The bit-exact tier: operands and cotangents lie on the LNS grid (decoded
codes, so ``encode`` is exact in both packages), and the codes of the
forward output and of both gradients must equal the reference's bit for
bit.  Their float readouts (``decode``) may differ by one float32 ulp: the
port takes ``exp`` in float64 rounded once, XLA's float32 ``exp`` is not
always correctly rounded.  The ⊞-MAC products
run the port's CPU lane and the reference's ``emulate`` lane (its own tests
pin that lane to its Pallas kernels).  Where a mode's gradient (or its
forward) is a float matmul, the operands are powers of two with small
exponents, so that every float product and sum is exact in any order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import numerics as jnumerics
from repro.core.formats import FORMATS as JFORMATS
from repro.core.plan import NumericsPlan as JPlan
from repro.core.spec import resolve_kernel_args as jresolve
from repro.kernels.lns_matmul.ops import \
    lns_matmul_trainable as jtrainable
from repro.paper.mlp import MLPConfig as JMLPConfig
from repro_torch.core import numerics as tnumerics
from repro_torch.core.plan import NumericsPlan
from repro_torch.core.qat import lns_quantize_ste
from repro_torch.core.spec import (LNSRuntime, NumericsSpec,
                                   resolve_kernel_args)
from repro_torch.kernels.lns_matmul import lns_matmul_trainable
from repro_torch.kernels.lns_matmul.lns_matmul import check_launch_limits
from repro_torch.paper import MLPConfig

torch.set_num_threads(1)


def _grid(rng, shape, fmt_name="lns16", *, zero_frac=0.15, lo=-3.0,
          hi=1.5):
    """Float32 values on ``fmt``'s grid (2^(code/scale) rounded once to
    float32, which both packages encode back to the code), some zero."""
    fmt = JFORMATS[fmt_name]
    code = np.round(rng.uniform(lo, hi, size=shape) * fmt.scale)
    v = np.exp2(code / fmt.scale).astype(np.float32)
    v[rng.random(shape) < 0.5] *= -1
    v[rng.random(shape) < zero_frac] = 0.0
    return v


def _pow2(rng, shape, *, zero_frac=0.15):
    """±2^e, e in [-4, 3], some zero: float products and sums of a few
    dozen of them are exact."""
    v = np.exp2(rng.integers(-4, 4, size=shape)).astype(np.float32)
    v[rng.random(shape) < 0.5] *= -1
    v[rng.random(shape) < zero_frac] = 0.0
    return v


def _jax_vjp(fn, x, w, g):
    def both(a, b, c):
        out, vjp = jax.vjp(fn, a, b)
        return (out,) + vjp(c.astype(out.dtype))
    return tuple(np.asarray(v, np.float32) for v in jax.jit(both)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)))


def _torch_vjp(fn, x, w, g):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = fn(xt, wt)
    out.backward(torch.tensor(g).to(out.dtype))
    return tuple(v.detach().float().numpy() for v in (out, xt.grad, wt.grad))


def _equal(got, want, fmt_name="lns16"):
    """Equal codes and signs; decoded floats within one ulp."""
    from repro_torch.core import FORMATS, encode
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_max_ulp(g, w, maxulp=1)
        a = encode(torch.tensor(g), FORMATS[fmt_name])
        b = encode(torch.tensor(w), FORMATS[fmt_name])
        assert torch.equal(a.code, b.code) and torch.equal(a.sign, b.sign)


# ------------------------------------------------- lns_matmul_trainable --
# (leading axes, K, N): contractions below, at and above the kernels'
# short-form threshold of 12 steps and past one 32-step tile, ragged N.
TRAINABLE_SHAPES = [((3,), 5, 7), ((2, 3), 12, 1), ((2, 2), 13, 33),
                    ((2, 2, 3), 40, 9)]


@pytest.mark.parametrize("fmt_name", ["lns16", "lns12"])
@pytest.mark.parametrize("shape", TRAINABLE_SHAPES,
                         ids=[f"{'x'.join(map(str, s[0]))}-K{s[1]}-N{s[2]}"
                              for s in TRAINABLE_SHAPES])
def test_trainable_bit_exact(shape, fmt_name):
    lead, k, n = shape
    rng = np.random.default_rng(k * 100 + n)
    x = _grid(rng, lead + (k,), fmt_name)
    w = _grid(rng, (k, n), fmt_name, lo=-4.0, hi=0.5)
    g = _grid(rng, lead + (n,), fmt_name, lo=-6.0, hi=-1.0)
    suffix = "" if fmt_name == "lns16" else f",fmt={fmt_name}"
    want = _jax_vjp(lambda a, b: jtrainable(
        a, b, numerics="lns16-train-emulate" + suffix), x, w, g)
    got = _torch_vjp(lambda a, b: lns_matmul_trainable(
        a, b, numerics="lns16-train-pallas" + suffix), x, w, g)
    _equal(got, want, fmt_name)


def test_trainable_plan_layer_and_explicit_pieces():
    """``numerics=<plan>, layer=`` resolves the layer's format; explicit
    ``fmt``/``spec`` win over the spec, as in the reference."""
    rng = np.random.default_rng(7)
    x, w = _grid(rng, (4, 9), "lns12"), _grid(rng, (9, 6), "lns12")
    g = _grid(rng, (4, 6), "lns12", lo=-5.0, hi=-1.0)
    plan = "lns16-train-emulate;hidden=fmt:lns12"
    want = _jax_vjp(lambda a, b: jtrainable(a, b, numerics=plan,
                                            layer="hidden"), x, w, g)
    got = _torch_vjp(lambda a, b: lns_matmul_trainable(
        a, b, numerics=plan.replace("emulate", "pallas"), layer="hidden"),
        x, w, g)
    _equal(got, want, "lns12")
    from repro_torch.core import DELTA_DEFAULT, LNS12
    got2 = _torch_vjp(lambda a, b: lns_matmul_trainable(
        a, b, fmt=LNS12, spec=DELTA_DEFAULT, numerics="lns16-train-pallas"),
        x, w, g)
    _equal(got2, want, "lns12")
    with pytest.raises(ValueError, match="needs fmt"):
        lns_matmul_trainable(torch.zeros(2, 3), torch.zeros(3, 2),
                             numerics="fp32")


def test_trainable_reads_a_transposed_weight():
    """The tied head passes ``tok.T``, a transposed view: the product and
    the gradient of the table equal those of a contiguous copy."""
    rng = np.random.default_rng(3)
    tok = _grid(rng, (11, 6), lo=-3.0, hi=0.0)
    x = _grid(rng, (5, 6))
    g = _grid(rng, (5, 11), lo=-5.0, hi=-1.0)
    t_view = torch.tensor(tok, requires_grad=True)
    t_copy = torch.tensor(tok.T.copy(), requires_grad=True)
    outs = []
    for w in (t_view.T, t_copy):
        xt = torch.tensor(x, requires_grad=True)
        z = lns_matmul_trainable(xt, w, numerics="lns16-train-pallas")
        z.backward(torch.tensor(g))
        outs.append((z.detach(), xt.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(t_view.grad.T, t_copy.grad)


def test_trainable_is_an_autograd_function_saving_codes():
    """The forward saves the encoded operands (int32 codes, int8 signs),
    not the floats."""
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 2, requires_grad=True)
    z = lns_matmul_trainable(x, w, numerics="lns16-train-pallas")
    node = z.grad_fn
    while type(node).__name__ != "_TrainableBackward":
        node = node.next_functions[0][0]
    saved = [t.dtype for t in node.saved_tensors]
    assert saved == [torch.int32, torch.int8, torch.int32, torch.int8]


# ------------------------------------------------------ runtime.linear --
# Modes whose gradient is a float product take power-of-two operands.
LINEAR_MODES = {
    "lns16-train-emulate": ("lns16-train-pallas", "grid"),
    "lns16-train-pallas": ("lns16-train-pallas", "grid"),
    "lns16-train-emulate,fmt=lns12,delta=bitshift":
        ("lns16-train-pallas,fmt=lns12,delta=bitshift", "grid"),
    "lns16-exact-pallas": ("lns16-exact-pallas", "pow2"),
    "lns16-exact": ("lns16-exact", "pow2"),
    "lns16-qat": ("lns16-qat", "pow2"),
    "lns16-w-only": ("lns16-w-only", "pow2"),
    "fp32": ("fp32", "pow2"),
}


@pytest.mark.parametrize("ref_spec", list(LINEAR_MODES))
def test_linear_bit_exact(ref_spec):
    spec, kind = LINEAR_MODES[ref_spec]
    rng = np.random.default_rng(len(ref_spec))
    fmt = "lns12" if "lns12" in ref_spec else "lns16"
    make = (lambda shape, **kw: _grid(rng, shape, fmt, **kw)) \
        if kind == "grid" else (lambda shape, **kw: _pow2(rng, shape))
    x = make((2, 3, 14))
    w = make((14, 5), lo=-4.0, hi=0.0)
    g = make((2, 3, 5), lo=-5.0, hi=-1.0)
    jrt = jnumerics.get_policy(ref_spec)
    trt = tnumerics.get_policy(spec)
    want = _jax_vjp(jrt.linear, x, w, g)
    got = _torch_vjp(trt.linear, x, w, g)
    _equal(got, want, fmt)   # bf16 modes: their values, in float32
    assert trt.matmul_path.split()[0] == jrt.matmul_path.split()[0]


def test_quantize_ste_equals_reference():
    """The STE snaps to the grid (the same codes on grid values and on a
    grid value's neighbours one float32 ulp away) and passes the cotangent
    through."""
    rng = np.random.default_rng(0)
    v = _grid(rng, (64,), zero_frac=0.1)
    v = np.concatenate([v, np.nextafter(v, np.float32(np.inf)),
                        np.nextafter(v, np.float32(-np.inf))])
    fmt = JFORMATS["lns16"]
    want = np.asarray(jax.vjp(
        lambda a: __import__("repro.core.qat", fromlist=["x"])
        .lns_quantize_ste(a, fmt), jnp.asarray(v))[0])
    from repro_torch.core import LNS16
    vt = torch.tensor(v, requires_grad=True)
    got = lns_quantize_ste(vt, LNS16)
    _equal([got.detach().numpy()], [want])
    got.backward(torch.arange(v.size, dtype=torch.float32))
    np.testing.assert_array_equal(vt.grad.numpy(),
                                  np.arange(v.size, dtype=np.float32))


# ------------------------------------------------ spec / plan / runtime --
SPECS = ["lns16-train-pallas", "lns16-train-emulate,blocks=8x16x32",
         "lns16-exact", "lns16-qat", "bf16", "fp32,metrics=off",
         "lns16-train-pallas;layers.mlp=fmt:lns12,delta:bitshift"]


@pytest.mark.parametrize("text", SPECS)
def test_runtime_resolution_like_reference(text):
    plan, jplan = NumericsPlan.parse(text), JPlan.parse(text)
    for path in ("layers.attn", "layers.mlp", "head"):
        rt, jrt = plan.runtime_for(path), jplan.runtime_for(path)
        assert isinstance(rt, LNSRuntime)
        assert rt.name == jrt.name and str(rt.spec) == str(jrt.spec)
        assert rt.compute_dtype == jrt.compute_dtype
        assert str(rt.dtype).split(".")[-1] == jrt.dtype.name
        assert repr(rt.param_lns) == repr(jrt.param_lns)
        assert repr(rt.act_lns) == repr(jrt.act_lns)
        assert repr(rt.exact_spec) == repr(jrt.exact_spec)
        assert rt.lns_grad == jrt.lns_grad
        assert rt.matmul_backend == jrt.matmul_backend
        if rt.spec.delta_spec is not None:
            assert repr(rt.matmul.fmt) == repr(jrt.matmul.fmt)
            assert repr(rt.matmul.spec) == repr(jrt.matmul.spec)
            assert repr(rt.delta_engine.fmt) == repr(jrt.delta_engine.fmt)
            assert rt.lane_on("cpu") == "cpu"
            assert rt.lane_on("cuda") == "cuda"
        else:
            assert rt.lane == jrt.lane == f"float-{rt.compute_dtype}"
    # Equal resolved specs share one cached runtime.
    assert plan.runtime_for("layers.attn") is plan.runtime_for("head")
    assert plan.runtime() is plan.default.runtime()
    assert plan.default.runtime() is NumericsSpec.parse(
        str(plan.default)).runtime()
    assert plan.runtime(block_m=64) is not plan.runtime()


@pytest.mark.parametrize("case", [
    ("lns16-train-pallas", {}, None),
    ("lns16-train-emulate;hidden=fmt:lns12", {}, "hidden"),
    ("lns16-train-pallas,blocks=auto", {"backend": "emulate"}, None),
    ("lns16-qat,delta=bitshift", {"interpret": True}, None),
])
def test_resolve_kernel_args_like_reference(case):
    text, kw, layer = case
    want = jresolve(text, op="t", layer=layer, **kw)
    got = resolve_kernel_args(text, op="t", layer=layer, **kw)
    assert repr(got[:2]) == repr(want[:2])
    assert got[2:] == want[2:]
    with pytest.raises(ValueError, match="t needs fmt"):
        resolve_kernel_args("fp32", op="t")


def test_numerics_registry_and_mlp_runtimes():
    assert sorted(tnumerics.POLICIES) == sorted(jnumerics.POLICIES)
    assert tnumerics.NumericsPolicy is LNSRuntime
    for name in tnumerics.POLICIES:
        assert tnumerics.get_policy(name).name \
            == jnumerics.get_policy(name).name
    with pytest.raises(ValueError, match="lns16-qat"):
        tnumerics.get_policy("lns17-qat")
    text = "lns16-train-pallas;hidden=fmt:lns12"
    cfg, jcfg = MLPConfig(spec=text), JMLPConfig(spec=text)
    for path in ("hidden", "out"):
        assert str(cfg.layer_runtime(path).spec) \
            == str(jcfg.layer_runtime(path).spec)
    assert str(cfg.runtime().spec) == str(jcfg.runtime().spec)
    assert cfg.layer_runtime("hidden").block_m == cfg.matmul_block
    dp = cfg.runtime().dp_config(num_devices=2)
    assert dp.num_devices == 2 and dp.reduce == cfg.runtime().spec.reduce


def test_linear_tap_under_scope_only():
    """``linear`` taps its float output only under a live collector and an
    ambient scope, and never changes the result."""
    from repro_torch import obs
    rt = tnumerics.get_policy("lns16-train-pallas")
    x, w = torch.randn(3, 5), torch.randn(5, 4)
    plain = rt.linear(x, w)
    with obs.collecting() as col:
        assert torch.equal(rt.linear(x, w), plain)
        assert col.taps() == {}
        with obs.scope("layers.mlp"):
            assert torch.equal(rt.linear(x, w), plain)
    taps = obs.host_taps(col.taps())
    assert taps["layers.mlp/linear/elems"] == 12
    # metrics=off: no linear tap (the encodes inside still tap their
    # quantization under the scope, as in the reference).
    off = tnumerics.get_policy("lns16-train-pallas,metrics=off")
    with obs.collecting() as col, obs.scope("layers.mlp"):
        off.linear(x, w)
    assert not [k for k in col.taps() if "/linear/" in k]


# ------------------------------------------------------ launcher limits --
def test_launch_limits():
    """Every olmo-1b product fits the launcher; a shape outside it raises
    before anything is launched, and nothing wraps."""
    ok = [(256, 2048, 2048, 1, (2048, 2048)),      # forward
          (256, 50432, 2048, 1, (2048, 50432)),    # head forward
          (256, 2048, 50432, 1, (50432, 50432)),   # head dX
          (2048, 50432, 256, 1, (2048, 50432)),    # head dW
          (262140, 7, 13, 1, (13, 7)),             # once 65535 row tiles
          (262149, 8, 40, 1, (40, 8)),             # past them, one launch
          (256 * 4096, 2048, 2048, 1, (2048, 2048)),   # the train cell
          (4 * (2**31 - 1), 32, 13, 1, (13, 32))]  # the last tile count
    for r, c, ct, s, strides in ok:
        check_launch_limits(r, c, ct, s, strides, 12)
    with pytest.raises(ValueError, match="grid x"):
        check_launch_limits(4 * (2**31 - 1) + 1, 32, 13, 1, (13, 32), 12)
    with pytest.raises(ValueError, match="grid x"):
        check_launch_limits(4 * (2**30), 64, 13, 1, (13, 64), 12)
    check_launch_limits(262141, 7, 12, 1, (12, 7), 12)   # short form
    with pytest.raises(ValueError, match="2\\^26"):
        check_launch_limits(4, 4, 1 << 26, 1, (1 << 26, 4), 12)
    with pytest.raises(ValueError, match="segments"):
        check_launch_limits(2, 2, 65536, 65536, (2, 2), 12)
    with pytest.raises(ValueError, match="short"):
        check_launch_limits(1 << 16, 1 << 15, 12, 1, (12, 1 << 15), 12)


def test_runtime_is_frozen_and_hashable():
    rt = tnumerics.get_policy("lns16-qat")
    assert hash(rt) == hash(dataclasses.replace(rt))
    with pytest.raises(dataclasses.FrozenInstanceError):
        rt.block_m = 1

"""The rest of the numerics core and of spec / plan in the port, against
the JAX package: ``lns_matmul``'s default order and leading axes,
``boxdiv``, ``lns_affine``, both conversion modes, the float Δ evaluation,
the fixed-point formats, every spec alias and key, and the plan's diff.

Inputs are made with numpy from a seed and fed to both packages; integer
results must be equal code for code, float results as stated.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as J
import repro.core.plan as JP
import repro.core.spec as JS
import repro_torch.core as T
import repro_torch.core.plan as TP
import repro_torch.core.spec as TS

# One intra-op thread a process: see tests/test_torch_core.py.
torch.set_num_threads(1)

FMTS = ("lns16", "lns12")
DELTAS = {"lut": (J.DELTA_DEFAULT, T.DELTA_DEFAULT),
          "lut640": (J.DELTA_SOFTMAX, T.DELTA_SOFTMAX),
          "bitshift": (J.DELTA_BITSHIFT, T.DELTA_BITSHIFT),
          "exact": (J.DELTA_EXACT, T.DELTA_EXACT)}


def _pair(rng, shape, fmt, *, scale=1.0, zero_frac=0.2):
    """The same random LNS operand in both packages."""
    v = (rng.normal(size=shape) * scale).astype(np.float32)
    v[rng.random(size=shape) < zero_frac] = 0.0
    j = J.encode(v, J.FORMATS[fmt])
    c, s = np.asarray(j.code), np.asarray(j.sign)
    return j, T.LNSArray(torch.as_tensor(c.copy()), torch.as_tensor(s.copy()))


def _eq(j, t, msg=""):
    np.testing.assert_array_equal(t.code.numpy(), np.asarray(j.code),
                                  err_msg=f"{msg} code")
    np.testing.assert_array_equal(t.sign.numpy(), np.asarray(j.sign),
                                  err_msg=f"{msg} sign")
    assert t.code.dtype == torch.int32 and t.sign.dtype == torch.int8


def _engines(kind, fmt):
    js, ts = DELTAS[kind]
    return J.DeltaEngine(js, J.FORMATS[fmt]), T.DeltaEngine(ts, T.FORMATS[fmt])


# ------------------------------------------------------------ arithmetic --

@pytest.mark.parametrize("kind", ["lut", "bitshift"])
def test_lns_matmul_default_order(kind):
    """Both packages called with their defaults (the pairwise tree): equal
    codes.  Before the port took the reference's default it folded
    sequentially, and 53 of these 54 codes differed."""
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng, (6, 40), "lns16", zero_frac=0.5)
    jw, tw = _pair(rng, (40, 9), "lns16", scale=0.1)
    je, te = _engines(kind, "lns16")
    _eq(J.lns_matmul(jx, jw, je), T.lns_matmul(tx, tw, te))


@pytest.mark.parametrize("order", ["pairwise", "sequential"])
@pytest.mark.parametrize("fmt", FMTS)
def test_lns_matmul_leading_axes(order, fmt):
    """x of shape (..., M, K): the leading axes broadcast as in the
    reference, in either order."""
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng, (2, 3, 4, 13), fmt, zero_frac=0.3)
    jw, tw = _pair(rng, (13, 5), fmt, scale=0.3)
    je, te = _engines("lut", fmt)
    t = T.lns_matmul(tx, tw, te, order=order)
    assert t.shape == (2, 3, 4, 5)
    _eq(J.lns_matmul(jx, jw, je, order=order), t)


@pytest.mark.parametrize("fmt", FMTS)
def test_boxdiv(fmt):
    rng = np.random.default_rng(7)
    ja, ta = _pair(rng, (500,), fmt, scale=30.0)
    jb, tb = _pair(rng, (500,), fmt, scale=1e-3, zero_frac=0.0)
    _eq(J.boxdiv(ja, jb, J.FORMATS[fmt]), T.boxdiv(ta, tb, T.FORMATS[fmt]))


@pytest.mark.parametrize("order", ["pairwise", "sequential"])
@pytest.mark.parametrize("kind", ["lut", "exact"])
def test_lns_affine(order, kind):
    rng = np.random.default_rng(8)
    jx, tx = _pair(rng, (5, 24), "lns12", zero_frac=0.4)
    jw, tw = _pair(rng, (24, 7), "lns12", scale=0.2)
    jb, tb = _pair(rng, (7,), "lns12", scale=0.1)
    je, te = _engines(kind, "lns12")
    _eq(J.lns_affine(jx, jw, jb, je, order=order),
        T.lns_affine(tx, tw, tb, te, order=order))


# ----------------------------------------------------------- conversions --

def _all_codes(fmt):
    f = J.FORMATS[fmt]
    return np.arange(f.zero_code, f.code_max + 1, dtype=np.int32)


@pytest.mark.parametrize("mode", ["exact", "mitchell"])
@pytest.mark.parametrize("fmt", FMTS)
def test_lns_value_to_code_every_code(mode, fmt):
    codes = _all_codes(fmt)
    for s in (0, 1):
        sign = np.full(codes.shape, s, np.int8)
        j = J.lns_value_to_code(J.LNSArray(jnp.asarray(codes),
                                           jnp.asarray(sign)),
                                J.FORMATS[fmt], mode)
        t = T.lns_value_to_code(T.LNSArray(torch.as_tensor(codes),
                                           torch.as_tensor(sign)),
                                T.FORMATS[fmt], mode)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=s)


@pytest.mark.parametrize("mode", ["exact", "mitchell"])
@pytest.mark.parametrize("fmt", FMTS)
def test_code_to_lns_every_code(mode, fmt):
    """Every signed value code of the format (what ``lns_value_to_code``
    gives).  ``mitchell`` and lns12 agree exactly.  The exact lns16
    conversion takes XLA's float32 log in the reference and the port's
    (float64, rounded once): they differ by an ulp now and then, which
    moves a code by one where (log2|v| - qf)·2^qf lies at a half-integer
    (6 of 32767 values; ROADMAP queue 3 records it with ``encode``).
    Signs, zeros and every other code agree exactly."""
    jf, tf = J.FORMATS[fmt], T.FORMATS[fmt]
    vals = np.arange(-jf.code_max, jf.code_max + 1, dtype=np.int32)
    j = J.code_to_lns(jnp.asarray(vals), jf, mode)
    t = T.code_to_lns(torch.as_tensor(vals), tf, mode)
    assert t.code.dtype == torch.int32 and t.sign.dtype == torch.int8
    np.testing.assert_array_equal(t.sign.numpy(), np.asarray(j.sign))
    diff = t.code.numpy().astype(np.int64) - np.asarray(j.code)
    off = np.nonzero(diff)[0]
    if mode == "mitchell" or fmt == "lns12":
        assert off.size == 0, vals[off]
        return
    assert off.size <= 6 and np.abs(diff).max() <= 1
    x = (np.log2(np.abs(vals[off]).astype(np.float64)) - tf.qf) * tf.scale
    np.testing.assert_array_less(np.abs(x - np.floor(x) - 0.5), 2e-3)


# ----------------------------------------------------- Δ on floats, Fig. 1

@pytest.mark.parametrize("kind", list(DELTAS))
@pytest.mark.parametrize("fmt", FMTS)
def test_delta_float_every_kind(kind, fmt):
    je, te = _engines(kind, fmt)
    d = np.linspace(0.0, 12.0, 2401)
    np.testing.assert_array_equal(te.plus_float(d), je.plus_float(d))
    pos = d[d > 0]
    np.testing.assert_array_equal(te.minus_float(pos), je.minus_float(pos))
    np.testing.assert_array_equal(T.delta_plus_float(d),
                                  J.delta_plus_float(d))
    np.testing.assert_array_equal(T.delta_minus_float(pos),
                                  J.delta_minus_float(pos))


# --------------------------------------------------------------- formats --

def test_fixed_point_formats():
    for name in ("fxp16", "fxp12"):
        jf, tf = J.FORMATS[name], T.FORMATS[name]
        for attr in ("bi", "bf", "name", "total_bits", "scale", "code_max",
                     "code_min", "max_value", "resolution"):
            assert getattr(tf, attr) == getattr(jf, attr), (name, attr)
        assert T.required_log_width(tf) == J.required_log_width(jf)
    assert (T.FXP16, T.FXP12) == (T.FORMATS["fxp16"], T.FORMATS["fxp12"])
    assert T.FORMATS.keys() == J.FORMATS.keys()


# --------------------------------------------------------- spec and plan --

@pytest.mark.parametrize("alias", list(JS.ALIASES))
def test_every_alias_prints_like_reference(alias):
    t, j = T.NumericsSpec.parse(alias), JS.NumericsSpec.parse(alias)
    assert list(T.ALIASES) == list(JS.ALIASES)
    assert str(t) == str(j) == alias
    assert t._flat() == j._flat()
    for prop in ("quantize_params", "quantize_acts", "quantize_grads",
                 "lns_grad", "interpret_flag"):
        assert getattr(t, prop) == getattr(j, prop), prop
    # A non-training alias prints; the MLP completes its fmt and Δ.
    from repro.paper.mlp import MLPConfig as JConfig
    from repro_torch.paper import MLPConfig
    jc, tc = JConfig(spec=alias), MLPConfig(spec=alias)
    assert str(tc.spec) == str(jc.spec)
    assert tc.plan().default._flat() == jc.plan().default._flat()


NEW_KEYS = [f"interpret={v}" for v in JS.INTERPRET_MODES] + [
    f"metrics={v}" for v in JS.METRICS_MODES] + [
    "blocks=default", "blocks=auto", "blocks=8x16x32", "blocks=128x128x128"]


@pytest.mark.parametrize("kv", NEW_KEYS)
@pytest.mark.parametrize("base", ["lns16-train-pallas", "fp32", "lns12-qat",
                                  "lns16-exact,delta=bitshift"])
def test_new_keys_print_like_reference(kv, base):
    text = f"{base},{kv}"
    t, j = T.NumericsSpec.parse(text), JS.NumericsSpec.parse(text)
    assert str(t) == str(j)
    assert str(T.NumericsSpec.parse(str(t))) == str(t)
    assert t._flat() == j._flat()
    assert T.NumericsSpec.explicit_keys(text) == \
        JS.NumericsSpec.explicit_keys(text)
    assert T.NumericsSpec.explicit_keys(t) == JS.NumericsSpec.explicit_keys(j)
    plan = f"lns16-train-pallas;hidden={kv.replace('=', ':')}"
    assert str(T.NumericsPlan.parse(plan)) == str(JP.NumericsPlan.parse(plan))


@pytest.mark.parametrize("text", [
    "lns16-train-pallas,fmt=fxp16", "fmt=fxp12", "lns16-qat,fmt=fxp16",
    "lns16-train-pallas;hidden=fmt:fxp16",
    "lns16-train-pallas,blocks=8x8", "lns16-train-pallas,blocks=0x8x8",
    "lns16-train-pallas,metrics=on", "lns16-train-pallas,interpret=yes"])
def test_refused_like_reference(text):
    """``fmt=fxp16`` names a linear format: refused by both packages, as are
    bad values of the new keys."""
    for parse in (JP.NumericsPlan.parse, T.NumericsPlan.parse):
        with pytest.raises(ValueError, match="valid values"):
            parse(text)


def test_blocks_helpers_like_reference():
    for text in ("8x16x32", "1x1x1"):
        assert TS.parse_blocks(text) == JS.parse_blocks(text)
    for blocks in ("default", "auto", "16x8x4"):
        assert TS.resolve_blocks_arg(blocks, 32, 64, 128) == \
            JS.resolve_blocks_arg(blocks, 32, 64, 128)
    assert TS.BLOCK_MODES == JS.BLOCK_MODES
    assert TS.INTERPRET_MODES == JS.INTERPRET_MODES
    assert TS.METRICS_MODES == JS.METRICS_MODES
    spec = T.NumericsSpec.parse("lns16-train-pallas")
    assert spec.exact_spec == spec.delta_spec == T.DELTA_DEFAULT
    with pytest.raises(ValueError, match="override key"):
        spec.with_(colour="red")


PLANS = [
    ("lns16-train-pallas", "lns16-train-pallas"),
    ("lns16-train-pallas;hidden=fmt:lns12",
     "lns16-train-emulate;out=delta:bitshift"),
    ("lns16-train-pallas;*=delta:bitshift;out=fmt:lns12",
     "lns16-train-pallas,interpret=on;out=fmt:lns12,metrics:full"),
    ("lns16-train-pallas;hidden=fmt:lns12;hidden=delta:exact",
     "lns16-train-pallas,reduce.grad_segments=5;hidden=fmt:lns12"),
]


@pytest.mark.parametrize("a,b", PLANS)
def test_plan_diff_like_reference(a, b):
    ta, tb = T.NumericsPlan.parse(a), T.NumericsPlan.parse(b)
    ja, jb = JP.NumericsPlan.parse(a), JP.NumericsPlan.parse(b)
    paths = ("hidden", "out")
    assert ta.diff(tb) == ja.diff(jb)
    assert ta.diff(b, paths=paths) == ja.diff(b, paths=paths)
    assert T.plan_diff(a, b) == JP.plan_diff(a, b)
    assert T.plan_diff(a, b, paths=paths, labels=("x", "y")) == \
        JP.plan_diff(a, b, paths=paths, labels=("x", "y"))
    assert ta.is_uniform == ja.is_uniform
    assert {p: s._flat() for p, s in ta.resolve_layers(paths).items()} == \
        {p: s._flat() for p, s in ja.resolve_layers(paths).items()}
    for prop in ("quantize", "compute_dtype", "backend", "interpret",
                 "quantize_params", "quantize_acts", "quantize_grads",
                 "lns_grad"):
        assert getattr(ta, prop) == getattr(ja, prop), prop
    assert str(T.get_plan(a)) == str(JP.get_plan(a))


def test_plan_with_rule_like_reference():
    for kv in (dict(fmt="lns12"), dict(delta="bitshift", metrics="off"),
               {"quantize": "grads+params+acts", "blocks": "8x8x8"}):
        t = T.NumericsPlan.parse("lns16-train-pallas").with_rule("hid*", **kv)
        j = JP.NumericsPlan.parse("lns16-train-pallas").with_rule("hid*",
                                                                  **kv)
        assert str(t) == str(j)
        assert t.resolve("hidden")._flat() == j.resolve("hidden")._flat()
    for bad in (dict(fmt="fxp16"), {"reduce.grad_segments": 4}):
        with pytest.raises(ValueError):
            T.NumericsPlan.parse("lns16-train-pallas").with_rule("out", **bad)
    with pytest.raises(ValueError, match="more than once"):
        TP.PlanRule("out", (("fmt", "lns12"), ("fmt", "lns16")))

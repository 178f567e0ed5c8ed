"""Spec and plan strings in the port (``repro_torch.core.spec`` /
``.plan``) against the JAX package: the strings the paper MLP takes parse
to the same arithmetic and print the same canonical text."""
import pytest

import repro.core.plan as JP
import repro.core.spec as JS
import repro_torch.core as T
from repro.paper.mlp import LAYER_PATHS, MLPConfig as JConfig
from repro_torch.paper import MLPConfig

STRINGS = [
    "lns16-train-pallas",
    "lns16-train-emulate",
    "lns16-train-emulate,backend=pallas",
    "lns16-train-pallas,delta=bitshift",
    "lns16-train-pallas,delta=exact",
    "lns16-train-pallas,fmt=lns12",
    "lns16-train-pallas,fmt=lns12,delta=bitshift",
    "lns16-train-pallas, delta = lut:10.0:0.25",
    "fmt=lns16,delta=lut20,quantize=grads+params+acts,compute_dtype=float32",
    "lns16-train-pallas;hidden=fmt:lns12",
    "lns16-train-emulate;hidden=fmt:lns12,delta:bitshift;out=delta:exact",
    "lns16-train-pallas;*=delta:bitshift;out=fmt:lns12",
    "lns16-train-pallas,fmt=lns12;hidden=fmt:lns16",
    "lns16-train-pallas,reduce.grad_segments=4",
    "lns16-train-pallas,reduce.grad_segments=5,reduce.schedule=tree",
    "lns16-train-emulate,reduce.mode=float-psum,reduce.grad_segments=4",
    "lns16-train-pallas,reduce.grad_segments=4;hidden=fmt:lns12",
]


def _arith(spec):
    """The arithmetic a spec selects: (format fields, Δ spec fields)."""
    f, d = spec.fmt, spec.delta_spec
    r = spec.reduce
    return ((f.qi, f.qf, f.name) if f else None,
            (d.kind, d.d_max, d.r) if d else None, spec.quantize,
            spec.compute_dtype, spec.backend,
            (r.mode, r.grad_segments, r.schedule))


@pytest.mark.parametrize("text", STRINGS)
def test_plan_strings_round_trip_like_reference(text):
    jp, tp = JP.NumericsPlan.parse(text), T.NumericsPlan.parse(text)
    assert str(tp) == str(jp)
    assert str(T.NumericsPlan.parse(str(tp))) == str(tp)
    for path in LAYER_PATHS:
        assert _arith(tp.resolve(path)) == _arith(jp.resolve(path)), path


@pytest.mark.parametrize("text", STRINGS)
def test_mlp_config_resolves_like_reference(text):
    jc, tc = JConfig(spec=text), MLPConfig(spec=text)
    assert str(tc.spec) == str(jc.spec)
    for path in LAYER_PATHS:
        assert _arith(tc.plan().resolve(path)) == _arith(
            jc.plan().resolve(path))


@pytest.mark.parametrize("bits,approx", [(16, "lut"), (12, "bitshift"),
                                         (16, "exact")])
def test_default_spec_from_bits(bits, approx):
    jc = JConfig(bits=bits, approx=approx)
    tc = MLPConfig(bits=bits, approx=approx)
    assert str(tc.spec) == str(jc.spec)
    assert _arith(tc.plan().default) == _arith(jc.plan().default)


def test_spec_aliases_match_reference():
    for name, spec in T.ALIASES.items():
        assert _arith(spec) == _arith(JS.ALIASES[name])
        assert str(spec) == name


@pytest.mark.parametrize("text,err", [
    ("lns16-train-pallas,interpret=maybe", ValueError),
    ("lns16-train-pallas,blocks=8x0x8", ValueError),
    ("lns16-train-pallas;hidden=metrics:loud", ValueError),
    ("lns16-train-pallas,backend=cuda", ValueError),
    ("lns16-train-pallas,fmt=lns9", ValueError),
    ("lns16-train-pallas,delta=lut:x:y", ValueError),
    ("lns16-train-pallas,colour=red", ValueError),
    ("lns16-qat8", ValueError),
    ("lns16-train-pallas;hidden", ValueError),
    ("lns16-train-pallas;hid:den=fmt:lns12", ValueError),
    ("lns16-train-pallas;hidden=fmt:lns12,fmt:lns16", ValueError),
    ("lns16-train-pallas;hidden=reduce.grad_segments:4", ValueError),
    ("lns16-train-pallas,reduce.mode=ring", ValueError),
    ("lns16-train-pallas,reduce.schedule=ring", ValueError),
    ("lns16-train-pallas,reduce.grad_segments=-1", ValueError),
    ("lns16-train-pallas,reduce.grad_segments=two", ValueError),
    ("", ValueError),
])
def test_bad_strings_raise(text, err):
    with pytest.raises(err):
        T.NumericsPlan.parse(text)


def test_reduce_spec_like_reference():
    """``ReduceSpec`` and the nested ``reduce.*`` overrides of ``with_``
    behave as the reference's."""
    t = T.NumericsSpec.parse("lns16-train-pallas")
    j = JS.NumericsSpec.parse("lns16-train-pallas")
    kw = {"reduce.mode": "float-psum", "reduce.grad_segments": 8}
    assert _arith(t.with_(**kw)) == _arith(j.with_(**kw))
    assert str(t.with_(**kw)) == str(j.with_(**kw))
    assert T.ReduceSpec() == T.ReduceSpec("boxplus", 0, "sequential")
    assert (T.NumericsPlan.parse("lns16-train-pallas;hidden=fmt:lns12")
            .with_(**kw).reduce == T.ReduceSpec("float-psum", 8))
    for bad in ({"reduce.colour": 1}, {"reduce.grad_segments": -2}):
        with pytest.raises(ValueError):
            t.with_(**bad)
        with pytest.raises(ValueError):
            j.with_(**bad)

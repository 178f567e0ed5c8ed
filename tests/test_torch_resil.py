"""The port's fault injection (``repro_torch.resil.inject``) against the
JAX package: the plan language, the no-op contract, faulted train steps
bit for bit (the fault sites draw the reference's threefry bits), and the
Δ-table fault's copy of a shared engine.  The data-parallel faults are in
``test_torch_segments.py``, the guardrails and drills in
``test_torch_guard.py``.

Full-width steps (784–100–10, batch 5, synthetic ``mnist``) hold the
port's CPU lane against the reference's ``emulate`` lane.  Both packages
start from the JAX package's initial weights, carried as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.paper import datasets as jds
from repro.paper.mlp import MLPConfig as JConfig, make_mlp as jmake
from repro.resil import FaultPlan as JPlan
from repro.resil import inject as jinj
import repro_torch.core as T
from repro_torch.core.delta import cached_engine
from repro_torch.obs import host_taps
from repro_torch.paper import (MLPConfig, make_mlp, params_from_numpy,
                               params_to_numpy)
from repro_torch.resil import (FAULT_KINDS, FaultPlan, corrupt_engine,
                               fault_plan, inject_codes, inject_param_codes,
                               inject_segment_partials, injecting,
                               serve_faults)
from repro_torch.resil import inject as tinj

torch.set_num_threads(1)

PLAN = ("seed=3,start=2,stop=4;hidden=flip_w:0.01,flip_act:0.01,"
        "sat_lanes:2;out=lut:3")
BATCH = 5


@pytest.fixture(scope="module")
def mnist():
    x, y, _, _, _ = jds.load("mnist", "data", 0)
    return x, y


def _np(tree):
    return {k: (np.asarray(v.code), np.asarray(v.sign))
            for k, v in tree.items()}


def _same(got, want, msg=""):
    assert sorted(got) == sorted(want), msg
    for k in want:
        for plane, g, w in zip(("code", "sign"), got[k], want[k]):
            assert g.dtype == w.dtype, (msg, k, plane)
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {k} {plane}")


# ------------------------------------------------------------ plan language --
ROUNDTRIP = [
    "seed=42,start=3,stop=5;hidden=flip_w:0.001,sat_lanes:2;out=lut:3;"
    "serve=hang_step:7,slow_req:2",
    "seed=1;hidden=flip_w:1e-3",
    "seed=0;hidden=lut:1",
    "seed=0;*=flip_w:0.5;hidden=flip_w:0.25",
    "seed=9;hidden=drop_seg:2;out=dup_seg:0",
    PLAN,
]
MALFORMED = [
    "seed=0;hidden=nosuch:1",
    "seed=0;hidden=flip_w:0.1,flip_w:0.2",
    "seed=0;hidden=flip_w:2.0",
    "seed=0;hidden=sat_lanes:0",
    "seed=0;hidden=",
    "bogus;hidden=lut:1",
    "seed=0,seed=1;hidden=lut:1",
    "seed=0,start=5,stop=3;hidden=lut:1",
]


@pytest.mark.parametrize("text", ROUNDTRIP)
def test_plan_parses_and_prints_as_reference(text):
    got, want = FaultPlan.parse(text), JPlan.parse(text)
    assert str(got) == str(want)
    assert FaultPlan.parse(str(got)) == got
    assert (got.seed, got.start, got.stop) == (want.seed, want.start,
                                               want.stop)
    for path in ("hidden", "out", "serve", "other"):
        assert got.resolve(path) == want.resolve(path), path
    assert serve_faults(got) == jinj.serve_faults(want)


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_plans_raise_as_reference(text):
    with pytest.raises(ValueError) as want:
        JPlan.parse(text)
    with pytest.raises(ValueError) as got:
        FaultPlan.parse(text)
    assert str(got.value) == str(want.value)


def test_plan_surface():
    assert list(FAULT_KINDS) == list(jinj.FAULT_KINDS)
    assert FaultPlan.parse(None) is None and FaultPlan.parse("") is None
    p = FaultPlan.parse("seed=1;hidden=lut:1")
    assert FaultPlan.parse(p) is p
    assert (FaultPlan.parse("seed=1;hidden=flip_w:1e-3")
            == FaultPlan.parse("seed=1;hidden=flip_w:0.001"))
    assert fault_plan({"hidden": "drop_seg:2"}, seed=9).resolve(
        "hidden") == {"drop_seg": 2}
    with pytest.raises(ValueError, match="match no layer path"):
        FaultPlan.parse("seed=0;hiden=flip_w:0.1").validate_paths(
            ("hidden", "out", "serve"))
    with pytest.raises(ValueError, match="match no layer path"):
        make_mlp("lns", MLPConfig(n_in=6, n_hidden=4, n_out=3,
                                  faults="seed=0;hiden=flip_w:0.1"), "cpu")
    assert MLPConfig(faults=PLAN).faults == FaultPlan.parse(PLAN)


# ------------------------------------------------------------ no-op contract --
def test_inactive_helpers_return_their_input():
    a = T.encode(torch.linspace(-1, 1, 8).reshape(2, 4), T.LNS16)
    params = {"w1": a, "b1": a}
    fmts = {"w1": T.LNS16, "b1": T.LNS16}
    layer = {"w1": "hidden", "b1": "hidden"}
    eng = T.DeltaEngine(T.DELTA_DEFAULT, T.LNS16)
    assert inject_codes(a, T.LNS16, layer="hidden") is a
    assert inject_param_codes(params, param_fmts=fmts,
                              param_layer=layer) is params
    assert inject_segment_partials(params, param_fmts=fmts,
                                   param_layer=layer, segs_local=2) is params
    assert corrupt_engine(eng, None, "hidden") is eng
    with injecting(None, 3):
        assert inject_codes(a, T.LNS16, layer="hidden") is a
    with injecting(FaultPlan.parse("seed=0;out=sat_lanes:1;out=lut:2"), 0):
        assert inject_codes(a, T.LNS16, layer="hidden") is a
        assert inject_param_codes(params, param_fmts=fmts,
                                  param_layer=layer) is params
        assert inject_segment_partials(params, param_fmts=fmts,
                                       param_layer=layer,
                                       segs_local=2) is params
        assert corrupt_engine(eng, tinj.active_plan(), "hidden") is eng
        with tinj.suspended():
            assert tinj.active_plan() is None
    bitshift = T.DeltaEngine(T.DELTA_BITSHIFT, T.LNS16)
    assert corrupt_engine(bitshift, FaultPlan.parse("seed=0;hidden=lut:3"),
                          "hidden") is bitshift
    assert tinj._ACTIVE == []


def test_no_plan_faults_step_equals_train_step(mnist):
    x, y = mnist
    m = make_mlp("lns", MLPConfig(spec="lns16-train-pallas;hidden=fmt:lns12",
                                  momentum=0.9), "cpu")
    p0 = m.init(torch.Generator().manual_seed(0))
    a = b = p0
    ma = mb = m.init_momentum(p0)
    for i in range(2):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        a, ma, la = m.train_step(a, x[sl], y[sl], ma)
        b, mb, lb = m.train_step_faults(b, x[sl], y[sl], i, mb)
    _same(params_to_numpy(b), params_to_numpy(a))
    _same(params_to_numpy(mb), params_to_numpy(ma))
    assert float(la) == float(lb)


# ------------------------------------------------------- faulted train steps --
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_faulted_steps_equal_reference(fused, mnist):
    """6 steps at full width under ``PLAN`` (bit flips and stuck lanes in
    the window [2, 4), a corrupted Δ table in the output layer): codes
    equal the reference's after every step, through
    ``train_step_faults`` (the step an int, or a tensor) and, on the
    reference's side, ``train_step_faults_metrics``, whose taps the port's
    metrics step equals at a step inside the window."""
    x, y = mnist
    kw = dict(momentum=0.9, fused=fused)
    jm = jmake("lns", JConfig(spec="lns16-train-emulate", faults=PLAN, **kw))
    tm = make_mlp("lns", MLPConfig(spec="lns16-train-pallas", faults=PLAN,
                                   **kw), "cpu")
    jp = jm.init(jax.random.PRNGKey(3))
    jmom = jm.init_momentum(jp)
    tp = params_from_numpy(_np(jp), "cpu")
    tmom = params_from_numpy(_np(jmom), "cpu")
    clean = params_to_numpy(make_mlp("lns", MLPConfig(**kw), "cpu").train_step(
        tp, x[:BATCH], y[:BATCH], tmom)[0])
    for i in range(6):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        (jp, jmom, jl), jt = jm.train_step_faults_metrics(
            jp, x[sl], y[sl], jnp.int32(i), jmom)
        if i == 3:
            (tp, tmom, tl), tt = tm.train_step_faults_metrics(
                tp, x[sl], y[sl], i, tmom)
            jt = {k: np.asarray(v) for k, v in jax.device_get(jt).items()}
            tt = host_taps(tt)
            assert sorted(tt) == sorted(jt)
            for k in jt:
                np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
            assert int(tt["hidden/act/sat"]) >= 2 * BATCH  # stuck lanes
        else:
            step = torch.tensor(i, dtype=torch.int32) if i % 2 else i
            tp, tmom, tl = tm.train_step_faults(tp, x[sl], y[sl], step,
                                                tmom)
        _same(params_to_numpy(tp), _np(jp), f"step {i}")
        _same(params_to_numpy(tmom), _np(jmom), f"momentum step {i}")
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        if i == 0:
            # Outside the window only the Δ-table fault acts, and it moved
            # the output layer's update.
            got = params_to_numpy(tp)
            assert any(not np.array_equal(got[k][0], clean[k][0])
                       for k in ("w2", "b2"))


def test_bit_flips_and_stuck_lanes_equal_reference():
    """The sites alone, on one tensor: flips keyed by an int and by a
    tensor step, the window, and the host-static stuck lanes."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(5, 100)).astype(np.float32)
    from repro.core import LNS16 as JLNS16, encode as jencode
    ja, ta = jencode(v, JLNS16), T.encode(torch.from_numpy(v), T.LNS16)
    plan = "seed=7,start=1,stop=3;hidden=flip_act:0.2,sat_lanes:3"
    for step in range(4):
        with jinj.injecting(JPlan.parse(plan), jnp.int32(step)):
            want = jinj.inject_codes(ja, JLNS16, layer="hidden")
        for s in (step, torch.tensor(step)):
            with injecting(FaultPlan.parse(plan), s):
                got = inject_codes(ta, T.LNS16, layer="hidden")
            np.testing.assert_array_equal(got.code.numpy(),
                                          np.asarray(want.code))
            np.testing.assert_array_equal(got.sign.numpy(),
                                          np.asarray(want.sign))
        changed = not np.array_equal(np.asarray(want.code), np.asarray(ja.code))
        assert changed == (1 <= step < 3)


# ------------------------------------------------- the shared engine cache --
def test_lut_fault_leaves_shared_engine_clean(mnist):
    """A model with ``hidden=lut:3`` corrupts a copy of the cached engine:
    the copy has tables and a device cache of its own.  A shallow copy
    would share the cache, serve the clean tables already cached or write
    its corrupted ones into the engine every later fault-free model uses.
    Faulted, clean and faulted models in turn each equal the reference."""
    x, y = mnist
    cached_engine.cache_clear()
    xb, yb = x[:BATCH], y[:BATCH]
    jp = jmake("lns", JConfig()).init(jax.random.PRNGKey(3))
    tp = params_from_numpy(_np(jp), "cpu")
    wants = {f: jmake("lns", JConfig(spec="lns16-train-emulate", fused=False,
                                     faults=f)).train_step(jp, xb, yb)[0]
             for f in ("seed=3;hidden=lut:3", None)}
    for faults in ("seed=3;hidden=lut:3", None, "seed=3;hidden=lut:3"):
        kw = dict(fused=False, faults=faults)
        want = wants[faults]
        tm = make_mlp("lns", MLPConfig(**kw), "cpu")
        got, _ = tm.train_step(tp, xb, yb)
        _same(params_to_numpy(got), _np(want), str(faults))
        shared = cached_engine(T.DELTA_DEFAULT, T.LNS16)
        if faults is not None:
            eng = tm.engs["hidden"]
            assert eng is not shared
            assert eng._device_tables is not shared._device_tables
            assert not np.array_equal(eng._tab_plus, shared._tab_plus)
            assert not torch.equal(eng.tables("cpu")[0],
                                   shared.tables("cpu")[0])
        assert np.array_equal(shared.tables("cpu")[0].numpy(),
                              T.DeltaEngine(T.DELTA_DEFAULT,
                                            T.LNS16)._tab_plus)


def test_corrupt_engine_equals_reference():
    from repro.core import DELTA_DEFAULT as JD, LNS12 as JL12, DeltaEngine
    plan = "seed=11;hidden=lut:3"
    for jfmt, tfmt in ((JL12, T.LNS12),):
        want = jinj.corrupt_engine(DeltaEngine(JD, jfmt),
                                   JPlan.parse(plan), "hidden")
        eng = T.DeltaEngine(T.DELTA_DEFAULT, tfmt)
        got = corrupt_engine(eng, FaultPlan.parse(plan), "hidden")
        np.testing.assert_array_equal(got._tab_plus, want._tab_plus)
        np.testing.assert_array_equal(got._tab_minus, want._tab_minus)
        assert got._tab_minus[0] == eng._tab_minus[0]  # flush sentinel
        assert got.spec == eng.spec and got.fmt == eng.fmt

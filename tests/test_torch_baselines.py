"""The paper's Table 1 baselines in the port (``repro_torch.paper``)
against the JAX package: the linear fixed-point MLP (``FxpMLP``) with and
without stochastic rounding, the float32 MLP (``FloatMLP``), their
``run_experiment`` and the deprecated loose keywords.

The port runs its CPU lane.  Both packages start from the JAX package's
initial weights, carried across as numpy, and see the same batches of the
synthetic ``mnist`` preset at the full 784–100–10 width; threefry cannot be
matched in torch, so the port's own draws (init, rounding bits) are held in
law and the reference's rounding bits are handed to the port's update.
"""
import math
import warnings

import numpy as np
import pytest
import torch

import jax

import repro.core as J
import repro.core.linear_fixed as JL
import repro.paper.training as jtraining
from repro.distributed.lns_dp import DPConfig as JDPConfig
from repro.paper import datasets as jds
from repro.paper.mlp import MLPConfig as JConfig, make_mlp as jmake
import repro_torch.core as T
import repro_torch.core.linear_fixed as TL
import repro_torch.paper.training as ttraining
from repro_torch.benchmarks import (fig1_delta_approx, fig2_learning_curves,
                                    table1_accuracy)
from repro_torch.distributed import DPConfig
from repro_torch.paper import (FloatMLP, FxpMLP, MLPConfig, make_mlp,
                               params_from_numpy, params_to_numpy,
                               run_experiment)
from repro_torch.paper.mlp import sr_update

# One intra-op thread a process: see tests/test_torch_core.py.
torch.set_num_threads(1)

STEPS, BATCH = 20, 5
KEYS = ("w1", "b1", "w2", "b2")


@pytest.fixture(scope="module")
def mnist():
    x, y, _, _, _ = jds.load("mnist", "data", 0)
    return jds.train_val_split(x, y, 5, 0)


def _np(jparams):
    return {k: np.asarray(v) for k, v in jparams.items()}


def _assert_equal(tp, jp, msg):
    got, want = params_to_numpy(tp), _np(jp)
    for k in want:
        assert got[k].dtype == want[k].dtype, (msg, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg} {k}")


# ------------------------------------------------------------ linear_fixed --

@pytest.mark.parametrize("fmt", ["fxp16", "fxp12"])
def test_linear_fixed_ops(fmt):
    jf, tf = J.FORMATS[fmt], T.FORMATS[fmt]
    rng = np.random.default_rng(11)
    v = (rng.normal(size=(6, 30)) * 4.0).astype(np.float32)
    v[0, :4] = [0.5 / tf.scale, -0.5 / tf.scale, 1.5 / tf.scale, 40.0]
    a = np.asarray(JL.fxp_encode(v, jf))
    ta = TL.fxp_encode(torch.as_tensor(v), tf)
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), a)
    np.testing.assert_array_equal(TL.fxp_decode(ta, tf).numpy(),
                                  np.asarray(JL.fxp_decode(a, jf)))
    w = np.asarray(JL.fxp_encode(rng.normal(size=(30, 7)).astype(np.float32),
                                 jf))
    b = np.asarray(JL.fxp_encode(rng.normal(size=(7,)).astype(np.float32),
                                 jf))
    tw, tb = torch.as_tensor(w.copy()), torch.as_tensor(b.copy())
    alpha = int(JL.fxp_encode(np.float32(0.01), jf))
    pairs = [
        (JL.fxp_add(a, a, jf), TL.fxp_add(ta, ta, tf)),
        (JL.fxp_mul(a, a, jf), TL.fxp_mul(ta, ta, tf)),
        (JL.fxp_matmul(a, w, jf), TL.fxp_matmul(ta, tw, tf)),
        (JL.fxp_matmul(a.reshape(2, 3, 30), w, jf),
         TL.fxp_matmul(ta.reshape(2, 3, 30), tw, tf)),
        (JL.fxp_affine(a, w, b, jf), TL.fxp_affine(ta, tw, tb, tf)),
        (JL.fxp_leaky_relu(a, alpha, jf), TL.fxp_leaky_relu(ta, alpha, tf)),
        (JL.fxp_leaky_relu_grad(a, alpha, jf),
         TL.fxp_leaky_relu_grad(ta, alpha, tf)),
    ]
    for i, (j, t) in enumerate(pairs):
        assert t.dtype == torch.int32, i
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=i)


# ----------------------------------------------------------------- FxpMLP --

def _reference_bits(key, jparams, fmt):
    """The rounding bits the reference's SR update draws from ``key``."""
    keys = jax.random.split(key, 4)
    return {k: torch.as_tensor(np.array(jax.random.randint(
        kk, jparams[k].shape, 0, fmt.scale)))
        for k, kk in zip(KEYS, keys)}


@pytest.mark.parametrize("sr", [False, True], ids=["nearest", "sr"])
@pytest.mark.parametrize("bits", [16, 12])
def test_fxp_steps_equal_reference(bits, sr, mnist):
    """20 full-width steps of batch 5, the periodic decay after step 16:
    int32 codes equal to the reference's after every step.  With SR the
    port's update takes the reference's own rounding bits."""
    x_tr, y_tr, x_val, _ = mnist
    kw = dict(bits=bits, stochastic_round=sr, weight_decay=0.3)
    jm, tm = jmake("fxp", JConfig(**kw)), make_mlp("fxp", MLPConfig(**kw),
                                                    device="cpu")
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(_np(jp), "cpu")
    _assert_equal(tp, jp, "init")
    for step in range(STEPS):
        sl = slice(step * BATCH, (step + 1) * BATCH)
        if sr:
            key = jax.random.PRNGKey(1000 + step)
            r = _reference_bits(key, jp, JConfig(**kw).fxp_fmt)
            jp, jloss = jm.train_step(jp, x_tr[sl], y_tr[sl], key)
            grads, tloss = tm.gradients(tp, x_tr[sl], y_tr[sl])
            tp = tm.update(tp, grads, r)
        else:
            jp, jloss = jm.train_step(jp, x_tr[sl], y_tr[sl])
            tp, tloss = tm.train_step(tp, x_tr[sl], y_tr[sl])
        if (step + 1) % 16 == 0:
            jp, tp = jm.apply_decay(jp, 16), tm.apply_decay(tp, 16)
        _assert_equal(tp, jp, f"after step {step}")
        # Float readout of the decoded logits: another summation order.
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(tm.predict(tp, x_val[:200]).numpy(),
                                  np.asarray(jm.predict(jp, x_val[:200])))


@pytest.mark.parametrize("bits", [16, 12])
def test_rounding_bits_in_law(bits):
    """The port's own rounding bits: int32, uniform on [0, 2^bf) (a
    chi-square test at the 0.1% level), a fresh draw per generator seed,
    the same on every call with one seed."""
    tm = make_mlp("fxp", MLPConfig(bits=bits, stochastic_round=True),
                  device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    r = tm.rounding_bits(params, torch.Generator().manual_seed(5))
    assert list(r) == list(KEYS)
    for k in KEYS:
        assert r[k].dtype == torch.int32 and r[k].shape == params[k].shape
    again = tm.rounding_bits(params, torch.Generator().manual_seed(5))
    other = tm.rounding_bits(params, torch.Generator().manual_seed(6))
    assert all(torch.equal(r[k], again[k]) for k in KEYS)
    assert not torch.equal(r["w1"], other["w1"])
    scale = tm.fmt.scale
    allbits = torch.cat([r[k].flatten() for k in KEYS]).numpy()
    assert allbits.min() >= 0 and allbits.max() < scale
    counts = np.bincount(allbits, minlength=scale)
    expect = allbits.size / scale
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    df = scale - 1
    assert chi2 < df + 3.1 * math.sqrt(2 * df), chi2


def test_sr_update_rounds_in_expectation():
    """``sr_update`` of a sub-resolution step: the low bits round up with
    probability low / 2^bf, so the mean step is lr·g / 2^bf."""
    f = T.FXP12
    g = torch.full((20000,), 45, dtype=torch.int32)   # lr·g = 45 < 2^7
    w = torch.zeros_like(g)
    r = torch.randint(0, f.scale, g.shape, generator=torch.Generator(
        ).manual_seed(0), dtype=torch.int32)
    new = sr_update(w, g, 1, r, f)
    assert set(new.unique().tolist()) <= {0, -1}
    assert abs(float(-new.double().mean()) - 45 / 128) < 0.02
    nearest = TL.fxp_sat(w - TL.fxp_mul(1, g, f), f)
    assert int(nearest.abs().max()) == 0


# --------------------------------------------------------------- FloatMLP --

def test_float_steps_match_reference(mnist):
    """20 full-width float32 steps: weights within rtol 1e-5, atol 1e-6 of
    the reference's (float sums in another order); predictions equal."""
    x_tr, y_tr, x_val, _ = mnist
    jm = jmake("float", JConfig(weight_decay=0.01))
    tm = make_mlp("float", MLPConfig(weight_decay=0.01), device="cpu")
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(_np(jp), "cpu")
    for step in range(STEPS):
        sl = slice(step * BATCH, (step + 1) * BATCH)
        jp, jloss = jm.train_step(jp, x_tr[sl], y_tr[sl])
        tp, tloss = tm.train_step(tp, x_tr[sl], y_tr[sl])
        got = params_to_numpy(tp)
        for k, w in _np(jp).items():
            assert got[k].dtype == w.dtype == np.float32
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} after step {step}")
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(tm.predict(tp, x_val[:200]).numpy(),
                                  np.asarray(jm.predict(jp, x_val[:200])))


def _normal_ks(values, sigma, step=None):
    """KS distance of ``values`` from N(0, sigma^2); ``step`` is the grid
    they were rounded to (rounding to nearest), if any."""
    v, counts = np.unique(np.asarray(values, np.float64), return_counts=True)
    edge = v + (step / 2 if step else 0.0)
    model = 0.5 * (1 + np.vectorize(math.erf)(edge / (sigma * math.sqrt(2))))
    return np.max(np.abs(np.cumsum(counts) / counts.sum() - model))


@pytest.mark.parametrize("backend", ["float", "fxp"])
def test_init_in_law(backend):
    """He-normal init: w1 ~ N(0, 2/784), w2 ~ N(0, 2/100) (the fixed-point
    codes on their grid), KS at the 1% level; biases zero; dtypes as the
    reference's."""
    tm = make_mlp(backend, MLPConfig(), device="cpu")
    p = tm.init(torch.Generator().manual_seed(0))
    jp = jmake(backend, JConfig()).init(jax.random.PRNGKey(0))
    for k in KEYS:
        assert p[k].dtype == {"float": torch.float32,
                              "fxp": torch.int32}[backend]
        assert np.asarray(jp[k]).dtype == p[k].numpy().dtype
        assert p[k].shape == np.asarray(jp[k]).shape
    for k, fan_in in (("w1", 784), ("w2", 100)):
        w = p[k].numpy().ravel()
        step = None
        if backend == "fxp":
            w, step = w / T.FXP16.scale, 1.0 / T.FXP16.scale
        d = _normal_ks(w, T.he_sigma(fan_in), step)
        assert d < 1.63 / math.sqrt(w.size), (k, d)
    assert not p["b1"].any() and not p["b2"].any()


def test_linear_init_helpers_in_law():
    gen = torch.Generator().manual_seed(1)
    w = T.linear_normal_init(gen, (200, 100), 0.3)
    assert w.dtype == torch.float32
    assert _normal_ks(w.numpy().ravel(), 0.3) < 1.63 / math.sqrt(w.numel())
    a = T.encode_init(torch.Generator().manual_seed(2), (50, 40), 0.3,
                      T.LNS16)
    b = T.encode(T.linear_normal_init(torch.Generator().manual_seed(2),
                                      (50, 40), 0.3), T.LNS16)
    assert torch.equal(a.code, b.code) and torch.equal(a.sign, b.sign)


# --------------------------------------------------------- run_experiment --

def test_run_experiment_fxp_equals_reference(monkeypatch):
    """``run_experiment("fxp")`` without SR over 20 steps (the decay after
    step 16): the port started from the reference's initial weights gives
    its final codes, learning curve and test accuracy."""
    kw = dict(bits=12, epochs=1, max_steps_per_epoch=20)
    init = _np(jmake("fxp", JConfig(bits=12)).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(FxpMLP, "init",
                        lambda self, gen: params_from_numpy(init, "cpu"))
    seen = []
    real = jtraining.evaluate

    def evaluate(model, params, x, y, batch=500):
        seen.append(_np(params))
        return real(model, params, x, y, batch)
    monkeypatch.setattr(jtraining, "evaluate", evaluate)
    j = jtraining.run_experiment("fxp", "mnist", **kw)
    t = run_experiment("fxp", "mnist", device="cpu", **kw)
    assert (t.val_curve, t.test_acc) == (j.val_curve, j.test_acc)
    for k, w in seen[-1].items():
        assert t.params[k].dtype == w.dtype
        np.testing.assert_array_equal(t.params[k], w, err_msg=k)


def test_run_experiment_sr_seeds_per_step(monkeypatch):
    """With ``stochastic_round`` each step draws its bits from a CPU
    generator seeded ``seed * 1_000_003 + step``, the step counted across
    epochs; ``apply_decay`` follows every 16th step of an epoch."""
    calls = []
    step = FxpMLP.train_step
    decay = FxpMLP.apply_decay

    def train_step(self, params, xb, yb, gen=None):
        calls.append(("step", int(gen.initial_seed())))
        return step(self, params, xb, yb, gen)

    def apply_decay(self, params, every):
        calls.append(("decay", every))
        return decay(self, params, every)
    monkeypatch.setattr(FxpMLP, "train_step", train_step)
    monkeypatch.setattr(FxpMLP, "apply_decay", apply_decay)
    monkeypatch.setattr(ttraining, "evaluate", lambda *a, **k: 0.0)
    run_experiment("fxp", "mnist", seed=7, epochs=2, max_steps_per_epoch=17,
                   stochastic_round=True, device="cpu")
    steps = [s for c, s in calls if c == "step"]
    assert steps == [7 * 1_000_003 + g for g in range(34)]
    decays = [i for i, (c, _) in enumerate(calls) if c == "decay"]
    assert decays == [16, 34] and calls[16] == ("decay", 16)


def test_fxp12_underflow_without_sr():
    """The port's twin of the JAX package's test, at its budget: linear-12
    with nearest rounding cannot train, because lr·g underflows bf = 7 and
    most weights never move; with SR they move and the run learns more.

    The reference asserts a margin of 0.1 in validation accuracy.  That
    margin belongs to its own random draws, not to the arithmetic: given
    the reference's weights and bits the port's update is the reference's
    bit for bit (``test_fxp_steps_equal_reference``), while its own init
    and rounding bits are held in law, and at seed 0 its margin is 0.092.
    So the twin holds the cause: the share of w1 codes a run moves
    (0.10 nearest, 0.60 with SR, at seed 0), and that SR learns more."""
    kw = dict(bits=12, epochs=1, max_steps_per_epoch=100, device="cpu")
    init = make_mlp("fxp", MLPConfig(bits=12), device="cpu").init(
        torch.Generator().manual_seed(0))["w1"].numpy()
    r_plain = run_experiment("fxp", "mnist", **kw)
    r_sr = run_experiment("fxp", "mnist", stochastic_round=True, **kw)
    moved_plain = float((r_plain.params["w1"] != init).mean())
    moved_sr = float((r_sr.params["w1"] != init).mean())
    assert moved_sr > 4 * moved_plain, (moved_plain, moved_sr)
    assert r_sr.val_curve[-1] > r_plain.val_curve[-1]


def test_run_experiment_float_and_params():
    r = run_experiment("float", "mnist", epochs=1, max_steps_per_epoch=3,
                       device="cpu")
    assert r.params["w1"].dtype == np.float32
    assert r.params["w1"].shape == (784, 100)
    assert r.backend == "float" and 0.0 <= r.test_acc <= 1.0
    back = params_to_numpy(params_from_numpy(r.params, "cpu"))
    for k in KEYS:
        np.testing.assert_array_equal(back[k], r.params[k])


@pytest.mark.parametrize("backend", ["float", "fxp"])
def test_momentum_refused(backend):
    for run in (jtraining.run_experiment, run_experiment):
        with pytest.raises(ValueError, match="momentum"):
            run(backend, "mnist", momentum=0.9, epochs=1,
                max_steps_per_epoch=1)


def test_float_refuses_tf32_on_card(monkeypatch):
    """The float baseline is float32: TF32 on the card is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32|allow_tf32"):
        FloatMLP(MLPConfig(), device="cuda")


# ------------------------------------------------------ deprecated knobs --

@pytest.mark.parametrize("kw,warns", [
    (dict(matmul_backend="pallas"), 1),
    (dict(matmul_backend="emulate"), 0),          # what the spec says
    (dict(reduce_mode="float-psum"), 1),
    (dict(grad_segments=5, matmul_backend="pallas"), 1),
])
def test_mlp_config_loose_keywords(kw, warns):
    """The loose keywords fold into the spec with the reference's warning
    text; a value the spec already has stays silent, and so does
    ``dataclasses.replace``."""
    import dataclasses
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jc = JConfig(**kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tc = MLPConfig(**kw)
    jmsg = [str(w.message) for w in jw if w.category is DeprecationWarning]
    tmsg = [str(w.message) for w in tw if w.category is DeprecationWarning]
    assert tmsg == jmsg and len(tmsg) == warns
    assert str(tc.spec) == str(jc.spec)
    for name in ("matmul_backend", "reduce_mode", "grad_segments"):
        assert getattr(tc, name) == getattr(jc, name)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert str(dataclasses.replace(tc, lr=0.5).spec) == str(tc.spec)
        MLPConfig(spec=str(jc.spec), **kw)
    assert (tc.fxp_fmt, MLPConfig(bits=12).fxp_fmt) == (T.FXP16, T.FXP12)
    assert tc.softmax_spec == T.DELTA_SOFTMAX
    assert MLPConfig(approx="exact").softmax_spec == T.DELTA_EXACT


def test_dp_config_loose_keywords():
    kw = dict(reduce_mode="float-psum", grad_segments=4,
              reduce_schedule="tree")
    j, t = JDPConfig(num_devices=2, **kw), DPConfig(num_devices=2, **kw)
    assert (t.reduce.mode, t.reduce.grad_segments, t.reduce.schedule) == (
        j.reduce.mode, j.reduce.grad_segments, j.reduce.schedule)
    for name in kw:
        assert getattr(t, name) == getattr(j, name) == kw[name]
    with pytest.raises(ValueError, match="reduce.mode"):
        DPConfig(reduce_mode="ring")


def test_invariance_check_loose_keywords():
    """``run_device_count_invariance_check(grad_segments=, ...)`` folds
    into ``numerics`` with a DeprecationWarning and still holds (one gloo
    rank)."""
    from repro_torch.distributed import run_device_count_invariance_check
    with pytest.warns(DeprecationWarning, match="numerics="):
        ok, runs = run_device_count_invariance_check(
            (1,), steps=1, batch=4, grad_segments=2,
            matmul_backend="emulate", device="cpu", timeout=120)
    assert ok and runs[1]["matches_reference"]


# -------------------------------------------------------- the benchmarks --

def test_table1_and_fig2_twins(monkeypatch, tmp_path):
    """The Table 1 twin trains every config of the reference's grid once
    (tags as the reference's), caches it with the device's name, and the
    Fig. 2 twin reads the curves back; ``run_experiment`` is stubbed."""
    import benchmarks.table1_accuracy as jtable1
    assert table1_accuracy.CONFIGS == jtable1.CONFIGS
    assert (table1_accuracy.QUICK, table1_accuracy.FULL) == (jtable1.QUICK,
                                                             jtable1.FULL)
    calls = []

    def fake(backend, ds, **kw):
        calls.append((backend, kw))
        return ttraining.RunResult(backend, ds, kw.get("bits", 16), "lut",
                                   [0.5, 0.6], 0.7, 1.0, {})
    monkeypatch.setattr(table1_accuracy, "run_experiment", fake)
    monkeypatch.setattr(table1_accuracy, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(fig2_learning_curves, "RESULTS_DIR", str(tmp_path))
    rows = table1_accuracy.run(mode="quick", device="cpu")
    assert len(rows) == len(calls) == 8
    assert all(kw["device"] == "cpu" and kw["epochs"] == 4 for _, kw in calls)
    assert rows[1][0] == "table1/mnist_fxp_bits=16_stochastic_round=True"
    assert rows[0][2:] == ("test_acc=0.7000", "cpu")
    assert table1_accuracy.run(mode="quick", device="cpu") == rows
    assert len(calls) == 8                                # cached
    fig2 = fig2_learning_curves.run("quick")
    assert len(fig2) == 8 and fig2[0][2] == "curve=0.500;0.600"
    assert fig2_learning_curves.run("full")[0][0] == "fig2/missing"


def test_fig1_twin_like_reference():
    import benchmarks.fig1_delta_approx as jfig1
    want = [(r[0], r[2]) for r in jfig1.run()]
    assert [(r[0], r[2]) for r in fig1_delta_approx.run()] == want

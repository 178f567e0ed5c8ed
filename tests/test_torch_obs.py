"""The port's telemetry (``repro_torch.obs``) against the JAX package.

The metrics entry points of the paper MLP at the full 784–100–10 width,
batch 5, on synthetic ``mnist``: the fused, unfused and segmented steps
(``train_step_metrics``) give exactly ``train_step``'s codes, the
reference's codes, and the reference's taps key for key and value for
value, ``metrics=full`` (the Δ-table occupancy replay) included.  Both
start from the JAX package's initial weights, carried as numpy; the port
runs its CPU lane, the reference its ``emulate`` lane.  Then the
registry, the sink, the step timer and the profiler session, and the
no-op contract of the helpers.
"""
import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import LNS12 as JLNS12, LNS16 as JLNS16
from repro.core import DELTA_DEFAULT as JDELTA, DeltaEngine as JEngine
from repro.core import encode as jencode
from repro.core.arithmetic import matmul_dhist as jdhist
from repro.obs import MetricsRegistry as JRegistry
from repro.paper import datasets as jds
from repro.paper.mlp import MLPConfig as JConfig, make_mlp as jmake
import repro_torch.core as T
from repro_torch.obs import (DHIST_EDGES, JsonlSink, MetricsRegistry,
                             StepTimer, TRACE_DIR_ENV, host_taps,
                             maybe_profile, phase_scope, read_jsonl,
                             read_jsonl_tolerant)
from repro_torch.obs import metrics as obs
from repro_torch.paper import (MLPConfig, make_mlp, params_from_numpy,
                               params_to_numpy)

torch.set_num_threads(1)

STEPS, BATCH = 5, 5

# (reference spec, port spec, MLPConfig keywords); the mixed-plan cases
# run 3 steps.
CASES = {
    "fused": ("lns16-train-emulate", "lns16-train-pallas", {}),
    "unfused": ("lns16-train-emulate", "lns16-train-pallas",
                {"fused": False}),
    "segmented": ("lns16-train-emulate,reduce.grad_segments=5",
                  "lns16-train-pallas,reduce.grad_segments=5", {}),
    "fused-full-mixed": (
        "lns16-train-emulate;hidden=fmt:lns12,metrics:full",
        "lns16-train-pallas;hidden=fmt:lns12,metrics:full",
        {"momentum": 0.9, "weight_decay": 0.01}),
    "unfused-mixed-out-off": (
        "lns16-train-emulate;hidden=fmt:lns12;out=metrics:off",
        "lns16-train-pallas;hidden=fmt:lns12;out=metrics:off",
        {"fused": False}),
}


@pytest.fixture(scope="module")
def mnist():
    x, y, _, _, _ = jds.load("mnist", "data", 0)
    return x, y


def _np(tree):
    return {k: (np.asarray(v.code), np.asarray(v.sign))
            for k, v in tree.items()}


def _same(got, want, msg):
    for k in want:
        for plane, g, w in zip(("code", "sign"), got[k], want[k]):
            assert g.dtype == w.dtype, (msg, k, plane)
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {k} {plane}")


@pytest.mark.parametrize("case", list(CASES))
def test_metrics_steps_equal_plain_and_reference(case, mnist):
    """``STEPS`` metrics steps (3 for the mixed plans): codes equal the
    port's ``train_step`` and the reference's after every step, the loss
    within the MLP tests' rtol, the taps equal the reference's."""
    jspec, tspec, kw = CASES[case]
    steps = STEPS if case in ("fused", "unfused", "segmented") else 3
    x, y = mnist
    jm = jmake("lns", JConfig(spec=jspec, **kw))
    tm = make_mlp("lns", MLPConfig(spec=tspec, **kw), device="cpu")
    jp = (jm.inner if hasattr(jm, "inner") else jm).init(
        jax.random.PRNGKey(3))
    jmom = jm.init_momentum(jp)
    tp = params_from_numpy(_np(jp), "cpu")
    tmom = tm.init_momentum(tp)
    plain_p, plain_m = tp, tmom
    for step in range(steps):
        sl = slice(step * BATCH, (step + 1) * BATCH)
        jout, jtaps = jm.train_step_metrics(jp, x[sl], y[sl], jmom)
        tout, ttaps = tm.train_step_metrics(tp, x[sl], y[sl], tmom)
        pout = tm.train_step(plain_p, x[sl], y[sl], plain_m)
        jp, jloss = jout[0], jout[-1]
        tp, tloss = tout[0], tout[-1]
        plain_p = pout[0]
        if jmom is not None:
            jmom, tmom, plain_m = jout[1], tout[1], pout[1]
            _same(params_to_numpy(tmom), _np(jmom), f"{case} m step {step}")
            _same(params_to_numpy(tmom), params_to_numpy(plain_m),
                  f"{case} m vs plain step {step}")
        _same(params_to_numpy(tp), _np(jp), f"{case} step {step}")
        _same(params_to_numpy(tp), params_to_numpy(plain_p),
              f"{case} vs plain step {step}")
        assert float(tloss) == float(pout[-1])
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
        jtaps = {k: np.asarray(v) for k, v in jax.device_get(jtaps).items()}
        got = host_taps(ttaps)
        assert list(got) == sorted(jtaps), case
        for k, v in jtaps.items():
            assert all(t.dtype == torch.int32 for t in ttaps.values())
            np.testing.assert_array_equal(got[k], v, err_msg=f"{case} {k}")
    if "full" in case:
        assert got["hidden/fwd/dhist"].shape == (len(DHIST_EDGES) + 1,)
        assert got["hidden/fwd/dhist"].sum() > 0
        assert "hidden/dx/convert_elems" in got
    if "out-off" in case:
        assert not any(k.startswith("out/") for k in got)


def test_registry_rows_equal_reference():
    """One step's taps folded into both registries give the same rows,
    but for ``lane``: the port names the device's lane."""
    taps = {"hidden/act/elems": np.int32(500), "hidden/act/sat": np.int32(3),
            "out/fwd/dhist": np.arange(6, dtype=np.int32)}
    jreg, treg = JRegistry({"spec": "s"}), MetricsRegistry({"spec": "s"})
    jreg.merge_numerics_taps(taps, lanes={"hidden": "emulate",
                                          "out": "emulate"})
    treg.merge_numerics_taps(taps, lanes={"hidden": "cpu", "out": "cpu"})
    jrows, trows = jreg.rows(), treg.rows()
    assert [r.pop("lane") for r in trows] == ["cpu"] * 3
    for r in jrows:
        r.pop("lane")
    assert trows == jrows


def test_lanes_name_the_device():
    m = make_mlp("lns", MLPConfig(n_in=6, n_hidden=4, n_out=3), "cpu")
    assert m.lanes() == {"hidden": "cpu", "out": "cpu"}
    assert m.metrics_levels == {"hidden": "counters", "out": "counters"}


def test_matmul_dhist_equals_reference():
    rng = np.random.default_rng(0)
    for fmt, tfmt in ((JLNS16, T.LNS16), (JLNS12, T.LNS12)):
        xv = rng.normal(size=(3, 4, 17)).astype(np.float32)
        xv[rng.random(xv.shape) < 0.3] = 0.0
        wv = (0.3 * rng.normal(size=(17, 6))).astype(np.float32)
        want = np.asarray(jdhist(jencode(xv, fmt), jencode(wv, fmt),
                                 JEngine(JDELTA, fmt)))
        got = T.matmul_dhist(T.encode(torch.from_numpy(xv), tfmt),
                             T.encode(torch.from_numpy(wv), tfmt),
                             T.DeltaEngine(T.DELTA_DEFAULT, tfmt))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_helpers_do_nothing_without_collector():
    """No collector: every helper returns at once and records nothing;
    the ops tap nothing and give the same codes."""
    a = T.encode(torch.linspace(-2, 2, 12), T.LNS16)
    assert not obs.enabled() and not obs.scope_active()
    assert obs.observe_codes(a, T.LNS16) is None
    obs.tap("x", torch.tensor(1))
    with obs.scope("hidden", "encode"):
        assert not obs.scope_active()
        b = T.encode(torch.linspace(-2, 2, 12), T.LNS16)
    assert torch.equal(a.code, b.code)
    assert T.convert_format(a, T.LNS16, T.LNS16) is a
    with obs.collecting() as col:
        obs.observe_codes(a, T.LNS16, layer="l", op="o")
        with obs.suspended():
            obs.observe_codes(a, T.LNS16, layer="l", op="o")
            T.encode(torch.ones(3), T.LNS16)
        T.encode(torch.ones(3), T.LNS16)  # no scope: no q_* taps
    assert list(col.taps()) == ["l/o/elems", "l/o/sat", "l/o/zero"]
    assert int(col.taps()["l/o/elems"]) == 12
    assert obs._COLLECTORS == [] and obs._SCOPES == []


def test_host_taps_one_copy():
    taps = {"a/b/elems": torch.tensor(5, dtype=torch.int32),
            "a/fwd/dhist": torch.arange(6, dtype=torch.int32)}
    got = host_taps(taps)
    assert int(got["a/b/elems"]) == 5 and got["a/b/elems"].shape == ()
    np.testing.assert_array_equal(got["a/fwd/dhist"], np.arange(6))
    assert host_taps({}) == {}


def test_registry_sink_roundtrip(tmp_path):
    reg = MetricsRegistry(base_labels={"arch": "t"})
    reg.counter_inc("c", 2, layer="h")
    reg.counter_inc("c", 3, layer="h")
    reg.gauge_set("g", 1.5)
    reg.histogram_record("h", 10.0)
    reg.histogram_record("h", 30.0)
    reg.bucketed_record("b", [1, 2, 3], (0.5, 1.5))
    reg.bucketed_record("b", [1, 0, 1], (0.5, 1.5))
    assert reg.counter_value("c", layer="h") == 5
    rows = reg.rows(reset=True)
    by = {r["name"]: r for r in rows}
    assert by["c"]["value"] == 5 and by["c"]["arch"] == "t"
    assert by["h"]["count"] == 2 and by["b"]["counts"] == [2, 2, 4]
    with pytest.raises(ValueError):
        reg.bucketed_record("b", [1, 2], (0.5, 1.5))
    path = tmp_path / "m.jsonl"
    with JsonlSink(path) as sink:
        sink.write(rows, step=3, loss=1.25)
        assert len(read_jsonl(path)) == len(rows)  # flushed per row
    back = read_jsonl(path)
    assert all(r["step"] == 3 and r["loss"] == 1.25 for r in back)
    with open(path, "a") as f:
        f.write('{"torn": ')
    assert read_jsonl_tolerant(path) == back
    with pytest.raises(json.JSONDecodeError):
        read_jsonl(path)


def test_step_timer_and_phase_scope():
    t = StepTimer(device="cpu")
    for _ in range(3):
        with t.span("s"), phase_scope("fwd"):
            pass
    s = t.summary(skip_first=1)["s"]
    assert s["count"] == 3 and s["best_ms"] >= 0.0
    assert len(t.samples("s")) == 3 and t.last("s") == t.samples("s")[-1]
    assert t.last("none") is None
    # No range work outside a profiler session.
    assert isinstance(phase_scope("fwd"), contextlib.nullcontext)


def test_maybe_profile_writes_trace(tmp_path, monkeypatch):
    monkeypatch.delenv(TRACE_DIR_ENV, raising=False)
    with maybe_profile() as d:
        assert d is None
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "tr"))
    with maybe_profile() as d, phase_scope("fwd"):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert d == str(tmp_path / "tr") and "fwd" in names
    assert os.listdir(tmp_path / "tr") == ["trace.json"]

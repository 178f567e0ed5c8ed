"""The port's guardrails (``repro_torch.resil.guard``) and fault drills
(``repro_torch.launch.drill``) against the JAX package.

The drills run at the reference's shape (8 × 12–9–4) from the JAX
package's initial weights, carried as numpy (the port's own initial
weights are held to the reference's in law, not in bits): the guarded
trainers give the reference's alerts, actions and codes after every step,
and the drill rows equal the reference's but for ``lane``.  The port runs
its CPU lane, the reference its ``emulate`` lane.
"""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import drill as jdrill
from repro.paper.mlp import make_mlp as jmake
from repro.resil import GuardConfig as JGuard, GuardedTrainer as JTrainer
from repro.resil import detect as jdetect
import repro_torch.core as T
from repro_torch.launch import drill as tdrill
from repro_torch.paper import (MLPConfig, make_mlp, params_from_numpy,
                               params_to_numpy)
from repro_torch.resil import (GuardConfig, GuardedTrainer, SnapshotRing,
                               detect, shrink)

torch.set_num_threads(1)

SMALL = dict(n_in=12, n_hidden=9, n_out=4, lr=0.01, momentum=0.9)
#: The reference's recorded drill rows (steps 10, seed 0, emulate lane).
BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / "baselines" \
    / "fault_drill.json"


def _np(tree):
    return {k: (np.asarray(v.code), np.asarray(v.sign))
            for k, v in tree.items()}


def _same(got, want, msg=""):
    assert sorted(got) == sorted(want), msg
    for k in want:
        for plane, g, w in zip(("code", "sign"), got[k], want[k]):
            assert g.dtype == w.dtype, (msg, k, plane)
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {k} {plane}")


# ------------------------------------------------------------- the drills --
# (scenario, seed, spec, faults, guard keywords) as the drills build them.
GUARDED = {
    "bitflip": (4, "lns16-train-emulate",
                "seed=4,start=7,stop=8;hidden=flip_w:0.5",
                dict(loss_spike=2.0, widen=False)),
    "satstorm": (0, "lns16-train-emulate;hidden=fmt:lns12,metrics:full",
                 "seed=0,start=5;hidden=sat_lanes:4", dict(sat_frac=0.10)),
}


def _ref_init(spec, seed, faults=None):
    """The reference drill's initial weights, as numpy."""
    m = jmake("lns", jdrill._mlp_cfg(spec, faults))
    return _np(getattr(m, "inner", m).init(jax.random.PRNGKey(seed)))


def _baseline_row(mode):
    rows = json.loads(BASELINE.read_text())["rows"]
    return next(r for r in rows if r["mode"] == mode)


@pytest.mark.parametrize("scenario", list(GUARDED))
def test_guarded_trainer_equals_reference(scenario):
    """The drill's guarded run, step by step: the same alerts, actions,
    loss readouts, events and codes as the reference's trainer; then the
    port's drill row from the same weights equals the row the reference's
    drill makes of that run, but for ``lane``."""
    seed, spec, faults, kw = GUARDED[scenario]
    jm = jmake("lns", jdrill._mlp_cfg(spec, faults))
    jp = jm.init(jax.random.PRNGKey(seed))
    jt = JTrainer(jm, jp, jm.init_momentum(jp), guard=JGuard(**kw))
    tm = make_mlp("lns", tdrill._mlp_cfg(spec, faults), "cpu")
    tp = params_from_numpy(_np(jp), "cpu")
    tt = GuardedTrainer(tm, tp, tm.init_momentum(tp),
                        guard=GuardConfig(**kw))
    actions = []
    for xb, yb in jdrill._batches(10, seed):
        want, got = jt.step(xb, yb), tt.step(xb, yb)
        assert ([dataclasses.astuple(a) for a in got["alerts"]]
                == [dataclasses.astuple(a) for a in want["alerts"]])
        assert (got["step"], got["action"]) == (want["step"],
                                                want["action"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        _same(params_to_numpy(tt.params), _np(jt.params),
              f"{scenario} step {got['step']}")
        _same(params_to_numpy(tt.momentum), _np(jt.momentum),
              f"{scenario} momentum step {got['step']}")
        actions.append(got["action"])
    assert tt.events == jt.events
    assert tt.registry.rows() == [dict(r, lane="cpu") if "lane" in r
                                  else r for r in jt.registry.rows()]
    if scenario == "bitflip":
        assert actions.count("rollback") == 1 and actions[8] == "rollback"
        inject, injected = 7, 1
    else:
        assert actions[5] == "widen+rollback"
        assert tt.model.fmts["hidden"] == T.LNS16
        assert "hidden=fmt:lns16" in tt.events[0]["plan_after"]
        inject, injected = 5, 4
    # The reference drill's row of this run (jdrill.drill_<scenario>).
    detect = next(i for i, a in enumerate(actions) if a)
    x, y = jdrill._dataset(256, seed + 1)
    clean_m, clean_p = jdrill._clean_twin(spec, 10, seed)
    acc = (jdrill._accuracy(jt.model, jt.params, x, y)
           - jdrill._accuracy(clean_m, clean_p, x, y))
    got = tdrill.SCENARIOS[scenario](10, seed, "emulate", device="cpu",
                                     params=_np(jp))
    assert got.pop("lane") == "cpu"
    assert got["note"] == _baseline_row(scenario)["note"].replace(
        "[7,8)", f"[{inject},{inject + 1})")
    assert got == jdrill._row(
        scenario, spec, "emulate", inject_step=inject, detect_step=detect,
        faults_injected=injected, recovery_action=actions[detect],
        acc_delta_post=acc, note=got["note"])


def test_dp_drop_row_equals_reference():
    """The dp-drop drill from the reference's weights: its row equals the
    reference's recorded row but for ``lane`` (every field of that row is
    fixed once its bit-identity assertion passes)."""
    spec = "lns16-train-emulate,reduce.grad_segments=4"
    got = tdrill.drill_dp_drop(10, 0, "emulate", device="cpu",
                               params=_ref_init(spec, 0))
    assert got.pop("lane") == "cpu"
    assert got == _baseline_row("dp-drop")


def test_bitflip_drill_misses_as_reference_at_seed_0():
    """At seed 0 the reference's bitflip drill never alerts and raises;
    from the same weights the port's does the same (see ROADMAP queue 3)."""
    with pytest.raises(AssertionError, match="never detected"):
        jdrill.drill_bitflip(10, 0, "emulate")
    with pytest.raises(AssertionError, match="never detected"):
        tdrill.drill_bitflip(10, 0, "emulate", device="cpu",
                             params=_ref_init("lns16-train-emulate", 0))


def test_bitflip_drill_from_own_weights():
    """From the port's own weights a first alert before the fault is a
    false alarm and raises (seed 0: a zero-flush spike at step 6, before
    the fault at step 7).  At the drills' default seed the fault-free run
    raises no alert and the faulted one is detected at or after the fault,
    with a rollback."""
    with pytest.raises(AssertionError, match="false alarm.* at step 6, "
                                             "before the fault at step 7"):
        tdrill.drill_bitflip(10, 0, "pallas", device="cpu")
    spec, seed = "lns16-train-pallas", tdrill.SEED
    m = make_mlp("lns", tdrill._mlp_cfg(spec), "cpu")
    p = tdrill._init(m, seed, None)
    t = GuardedTrainer(m, p, m.init_momentum(p),
                       guard=GuardConfig(loss_spike=2.0, widen=False))
    assert not any(r["alerts"] for r in t.run(tdrill._batches(10, seed)))
    row = tdrill.drill_bitflip(10, seed, "pallas", device="cpu")
    assert row["detect_step"] >= row["inject_step"] == 7
    assert "rollback" in row["recovery_action"]


def test_drill_runner_and_cli(tmp_path):
    """The launcher runs the serve drill (its own ``engine`` backend
    label), refuses an unknown drill, and writes the rows of a run twice
    the same (``--selfcheck``)."""
    (row,) = tdrill.run_scenarios(["serve"], device="cpu")
    assert (row["mode"], row["backend"], row["lane"]) == ("serve", "engine",
                                                          "cpu")
    with pytest.raises(ValueError, match="unknown drill"):
        tdrill.run_scenarios(["nosuch"], device="cpu")
    out = tmp_path / "drill.json"
    rows = tdrill.main(["--scenarios", "dp-drop", "--steps", "2",
                        "--device", "cpu", "--selfcheck", "--out", str(out)])
    assert [r["mode"] for r in rows] == ["dp-drop"]
    assert rows[0]["lane"] == "cpu" and rows[0]["ms_per_step"] == 0.0
    assert out.exists()


# --------------------------------------------------------- guard pieces ---
def test_detect_equals_reference():
    cfg = dict(sat_frac=0.25, flush_frac=0.5)
    taps = {"hidden/act/sat": np.int32(30), "hidden/act/elems": np.int32(100),
            "out/act/sat": np.int32(10), "out/act/elems": np.int32(100),
            "out/q/q_flush": np.int32(60), "out/q/q_elems": np.int32(100),
            "out/fwd/dhist": np.arange(6, dtype=np.int32)}
    cases = [(taps, 1.0, [1.0, 1.1]), ({}, float("nan"), []),
             ({}, 50.0, [1.0, 1.2]), ({}, 1.3, [1.0, 1.2]),
             ({}, 2e4, [])]
    for t, loss, recent in cases:
        want = jdetect(t, loss, JGuard(**cfg), recent_losses=recent, step=7)
        got = detect(t, loss, GuardConfig(**cfg), recent_losses=recent,
                     step=7)
        assert ([dataclasses.astuple(a) for a in got]
                == [dataclasses.astuple(a) for a in want])
    assert dataclasses.asdict(GuardConfig()) == dataclasses.asdict(JGuard())


def test_snapshot_ring_copies_and_bounds():
    ring = SnapshotRing(2)
    w = T.LNSArray(torch.zeros(3, dtype=torch.int32),
                   torch.zeros(3, dtype=torch.int8))
    for i in range(5):
        w.code.fill_(i)
        ring.push(i, {"w": w, "n": np.full((2,), i)})
    assert len(ring) == 2
    step, (p, mom, rng) = ring.latest()
    assert step == 4 and mom is None and rng is None
    w.code.fill_(9)
    assert torch.equal(p["w"].code, torch.full((3,), 4, dtype=torch.int32))
    np.testing.assert_array_equal(p["n"], [4, 4])


def test_guard_mechanics():
    """All off: a metrics loop with the plain step's codes.  A loss alert
    rolls back.  Widening an lns16 layer to lns16 does nothing.
    ``shrink`` rebuilds a data-parallel model."""
    spec = "lns16-train-pallas"
    batches = tdrill._batches(3, 0)
    m = make_mlp("lns", MLPConfig(spec=spec, **SMALL), "cpu")
    p0 = m.init(torch.Generator().manual_seed(1))
    t = GuardedTrainer(m, p0, m.init_momentum(p0),
                       guard=GuardConfig(rollback=False, widen=False))
    t.run(batches)
    p, mom = p0, m.init_momentum(p0)
    for xb, yb in batches:
        p, mom, _ = m.train_step(p, xb, yb, mom)
    _same(params_to_numpy(t.params), params_to_numpy(p))
    _same(params_to_numpy(t.momentum), params_to_numpy(mom))
    assert t.events == [] and t._widen("hidden") is False
    t = GuardedTrainer(m, p0, m.init_momentum(p0),
                       guard=GuardConfig(loss_abs=0.0, widen=False,
                                         cooldown=0))
    r = t.step(*batches[0])
    assert r["action"] == "rollback"
    assert [a.kind for a in r["alerts"]] == ["loss-spike"]
    _same(params_to_numpy(t.params), params_to_numpy(p0))
    assert t.registry.counter_value("guard.rollbacks") == 1
    dp = make_mlp("lns", MLPConfig(
        spec="lns16-train-pallas,reduce.grad_segments=4", **SMALL), "cpu")
    s = shrink(dp, 1)
    assert type(s) is type(dp) and s.dp.num_devices == 1
    assert s.inner.device == dp.inner.device
    with pytest.raises(TypeError):
        shrink(m, 1)

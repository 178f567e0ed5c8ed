"""Fault drills: inject → detect → recover → score, deterministically.

Each drill runs one fault scenario end to end through the port's own
machinery — the :class:`~repro_torch.resil.inject.FaultPlan` sites inside
the train steps, the :class:`~repro_torch.resil.guard.GuardedTrainer`
detectors and recovery — and gives one row in the JAX package's drill
schema (``repro.launch.drill``), plus ``lane``: ``"cuda"`` where the
kernels ran, ``"cpu"`` where their plain versions did.  The measurement
is the detection latency in steps (carried as ``ms_per_step``, as the
reference does); rows also record the injection and detection steps, the
recovery taken and the accuracy after recovery against a fault-free twin
run.

Every drill is deterministic: faults are seed-keyed, steps are counted
and no wall-clock time enters the rows, so the same ``--seed`` writes the
same file (``--selfcheck`` runs every scenario twice and asserts it).
Scenarios, at the reference's shape (8 × 12–9–4):

* ``bitflip``  — a one-step ``flip_w`` storm in the hidden layer; the
  loss-spike detector fires and the trainer rolls back to the snapshot
  before the fault.
* ``satstorm`` — persistent stuck-at-``code_max`` lanes in an lns12
  hidden layer; the saturation-storm detector fires and the layer is
  widened to lns16 (a plan override, codes converted exactly), with a
  rollback.
* ``dp-drop``  — a dropped data-parallel segment partial (a rank lost in
  the gather); :func:`~repro_torch.resil.guard.recover_segment_partials`
  recomputes the lost slot and the recombined gradients are asserted
  bit-identical to the undamaged combine.
* ``serve``    — an injected hung engine step (``serve=hang_step:4``) on a
  tiny dense model under fp32; the step watchdog aborts the batch, the
  retry budget re-admits it, every request finishes, the block pool is
  conserved, and the greedy outputs are compared with a fault-free run.

Initial weights come from the port's generator (``torch.Generator``
seeded with ``--seed``), which is held to the JAX package's in law, not in
bits; a caller that passes ``params=`` (``params_to_numpy`` form, e.g. the
JAX package's initial weights) to a drill function gets the reference's
row bit for bit.

An alert before the fault's first step is a false alarm from plain
training, not a detection: the drill raises on it, as it does when nothing
fires.  The default seed is :data:`SEED` = 1, not the reference's 0: from
the port's own seed-0 weights the bitflip drill's guard fires a
``zero-flush-spike`` at step 6, one step before the fault at step 7, so
that drill raises at seed 0.  At seed 1 the fault-free run raises no alert
and the faulted one alerts at the fault's step.

Run on the card: ``python -m repro_torch.launch.drill --smoke``
(``--device cpu`` for the plain versions).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..resil import inject as _inj
from ..resil.guard import GuardConfig, GuardedTrainer, recover_segment_partials

B, N_IN, N_HID, N_OUT = 8, 12, 9, 4
SHAPE = f"{B}x{N_IN}x{N_HID}x{N_OUT}"
#: The default seed of the drills and of ``--smoke`` (see the docstring).
SEED = 1


# ---------------------------------------------------------------- helpers --
def _dataset(n, seed):
    """Gaussian-cluster classification data: learnable, deterministic."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=2.0, size=(N_OUT, N_IN))
    y = rng.integers(0, N_OUT, size=n)
    x = (centers[y] + rng.normal(scale=0.5, size=(n, N_IN))).astype(
        np.float32)
    return x, y


def _batches(steps, seed):
    x, y = _dataset(B * steps, seed)
    return [(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
            for i in range(steps)]


def _mlp_cfg(spec, faults=None):
    from ..paper.mlp import MLPConfig
    return MLPConfig(n_in=N_IN, n_hidden=N_HID, n_out=N_OUT, lr=0.01,
                     momentum=0.9, spec=spec, matmul_block=8, faults=faults)


def _init(model, seed, params):
    """The model's initial weights: ``params`` (numpy form) when given,
    else drawn from ``seed``."""
    from ..paper.mlp import params_from_numpy
    if params is not None:
        return params_from_numpy(params, model.device)
    return model.init(torch.Generator().manual_seed(seed))


def _accuracy(model, params, x, y):
    return float(np.mean(model.predict(params, x).cpu().numpy() == y))


def _clean_twin(spec, steps, seed, device, params):
    """Fault-free run on the same data: the accuracy yardstick."""
    from ..paper.mlp import make_mlp
    m = make_mlp("lns", _mlp_cfg(spec), device)
    p = _init(m, seed, params)
    mom = m.init_momentum(p)
    for xb, yb in _batches(steps, seed):
        p, mom, _ = m.train_step(p, xb, yb, mom)
    return m, p


def _lane(device) -> str:
    return torch.device(device).type


def _row(mode, spec, backend, *, inject_step, detect_step, faults_injected,
         recovery_action, acc_delta_post, note, lane, shape=SHAPE,
         devices=1):
    latency = (detect_step - inject_step if detect_step is not None
               else -1)
    return dict(op="fault_drill", mode=mode, shape=shape, spec=spec,
                backend=backend, devices=devices, lane=lane,
                ms_per_step=float(latency),  # detection latency in STEPS
                inject_step=inject_step, detect_step=detect_step,
                faults_injected=faults_injected,
                recovery_action=recovery_action,
                acc_delta_post=round(acc_delta_post, 6), note=note)


def _guarded(spec, faults, inj, steps, seed, device, params, guard):
    """Train under the guardrails; returns the trainer and the step and
    action of the first alert (``None`` when nothing fired).  A first
    alert before ``inj``, the fault's first step, raises: it is a false
    alarm, not a detection."""
    from ..paper.mlp import make_mlp
    m = make_mlp("lns", _mlp_cfg(spec, faults), device)
    p = _init(m, seed, params)
    t = GuardedTrainer(m, p, m.init_momentum(p), guard=guard)
    detect_step, action = None, None
    for r in t.run(_batches(steps, seed)):
        if r["alerts"] and detect_step is None:
            if r["step"] < inj:
                kinds = [a.kind for a in r["alerts"]]
                raise AssertionError(
                    f"false alarm: {kinds} at step {r['step']}, before the "
                    f"fault at step {inj}")
            detect_step, action = r["step"], r["action"]
    return t, detect_step, action


def _acc_delta(t, spec, steps, seed, device, params):
    x, y = _dataset(256, seed + 1)
    clean_m, clean_p = _clean_twin(spec, steps, seed, device, params)
    return (_accuracy(t.model, t.params, x, y)
            - _accuracy(clean_m, clean_p, x, y))


# -------------------------------------------------------------- scenarios --
def drill_bitflip(steps, seed, backend="pallas", *, device="cuda",
                  params=None):
    """One-step flip_w storm → loss-spike detect → rollback."""
    spec = f"lns16-train-{backend}"
    # Inject after the loss has settled (the spike detector is relative to
    # the recent median) but before convergence.
    inj = max(2, steps - 3)
    faults = f"seed={seed},start={inj},stop={inj + 1};hidden=flip_w:0.5"
    t, detect_step, action = _guarded(
        spec, faults, inj, steps, seed, device, params,
        GuardConfig(loss_spike=2.0, widen=False))
    if detect_step is None:
        raise AssertionError("bitflip storm was never detected")
    if "rollback" not in (action or ""):
        raise AssertionError(f"expected rollback, got {action}")
    return _row("bitflip", spec, backend, inject_step=inj,
                detect_step=detect_step, faults_injected=1,
                recovery_action=action,
                acc_delta_post=_acc_delta(t, spec, steps, seed, device,
                                          params),
                note=f"flip_w:0.5 window [{inj},{inj + 1}), loss-spike "
                     f"detector, snapshot rollback", lane=_lane(device))


def drill_satstorm(steps, seed, backend="pallas", *, device="cuda",
                   params=None):
    """Persistent stuck-at-saturation lanes → widen lns12 → lns16."""
    spec = f"lns16-train-{backend};hidden=fmt:lns12,metrics:full"
    inj = max(2, steps // 2)
    faults = f"seed={seed},start={inj};hidden=sat_lanes:4"
    t, detect_step, action = _guarded(
        spec, faults, inj, steps, seed, device, params,
        GuardConfig(sat_frac=0.10))
    if detect_step is None:
        raise AssertionError("saturation storm was never detected")
    widened = [e for e in t.events if e["action"] == "widen"]
    if not widened:
        raise AssertionError("expected a widen event")
    if "hidden=fmt:lns16" not in widened[0]["plan_after"]:
        raise AssertionError(f"widened to {widened[0]['plan_after']!r}")
    return _row("satstorm", spec, backend, inject_step=inj,
                detect_step=detect_step, faults_injected=4,
                recovery_action=action,
                acc_delta_post=_acc_delta(t, spec, steps, seed, device,
                                          params),
                note="sat_lanes:4 on lns12 hidden, saturation-storm "
                     "detector, widened to lns16 via plan override",
                lane=_lane(device))


def drill_dp_drop(steps, seed, backend="pallas", *, device="cuda",
                  params=None):
    """Dropped segment partial → recompute + splice, bit-identical."""
    from ..distributed.lns_reduce import combine_partials_many
    from ..paper.mlp import PARAM_LAYER, make_mlp
    segs = 4
    spec = f"lns16-train-{backend},reduce.grad_segments={segs}"
    inner = make_mlp("lns", _mlp_cfg(spec), device).inner
    p = _init(inner, seed, params)
    xb, yb = _batches(1, seed)[0]
    x, y = inner._inputs(xb, yb)
    parts, _ = inner.per_segment_grads(p, x, y, segs)
    # Drop slot 2 through the step's own injection hook, then recover.
    lost = [2]
    plan = _inj.fault_plan({"hidden": f"drop_seg:{lost[0]}",
                            "out": f"drop_seg:{lost[0]}"}, seed=seed)
    with _inj.injecting(plan, None):
        bad = _inj.inject_segment_partials(
            parts, param_fmts=inner.param_fmts, param_layer=PARAM_LAYER,
            segs_local=segs)
    if all(torch.equal(bad[k].code, parts[k].code) for k in parts):
        raise AssertionError("drop_seg fault did not alter any partial")
    recovered = recover_segment_partials(
        inner, p, x, y, bad, grad_segments=segs, lost=lost)
    reference = combine_partials_many(parts, inner.param_engines)
    for k in reference:
        if not (torch.equal(recovered[k].code, reference[k].code)
                and torch.equal(recovered[k].sign, reference[k].sign)):
            raise AssertionError(
                f"{k}: recovered combine not bit-identical")
    return _row("dp-drop", spec, backend, inject_step=0, detect_step=0,
                faults_injected=len(lost), devices=1,
                recovery_action="recompute-splice",
                acc_delta_post=0.0,  # bit-identical, asserted above
                note=f"segment {lost[0]} partial dropped; recomputed from "
                     f"its own batch rows and recombined on the fixed "
                     f"schedule — bit-identical to the undamaged combine",
                lane=_lane(device))


def _tiny_serve_cfg():
    from ..nn.config import ModelConfig
    return ModelConfig(name="tiny-drill", family="dense", n_layers=2,
                       d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                       vocab_size=64, d_head=16, vocab_pad_to=64,
                       numerics="fp32", param_dtype="float32",
                       remat="none", q_chunk=8)


def drill_serve(steps, seed, backend="engine", *, device="cuda",
                params=None):
    """Injected hung step → watchdog abort → retry → all requests done.

    ``steps`` is taken for the common signature; the drill runs the
    engine until its requests finish.  ``params``: the tiny model's
    weights in numpy form (the JAX package's, for a parity check), else
    the port's draw from seed 0."""
    from ..nn import init_params
    from ..nn.model import params_from_numpy
    from ..serve import TERMINAL, ServeConfig, ServingEngine
    tiny = _tiny_serve_cfg()
    weights = (params_from_numpy(params, device) if params is not None
               else init_params(0, tiny, device=device))
    sc = ServeConfig(max_batch=2, max_len=32, block_size=8,
                     prefill_chunk=8, retry_budget=1)
    hang_at = 4
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(3, tiny.vocab_size, size=6) for _ in range(3)]

    def drain(faults):
        eng = ServingEngine(tiny, weights, sc, faults=faults)
        rids = [eng.submit(p, max_new=8) for p in prompts]
        detect = None
        for _ in range(400):
            eng.step()
            if detect is None and any(
                    r["name"] == "serve.watchdog_fired"
                    for r in eng.registry.rows()):
                detect = eng.step_count
            if all(eng.poll(r).state in TERMINAL for r in rids):
                break
        eng.bm.check_conserved()  # raises if an abort leaked blocks
        outs = [tuple(eng.poll(r).output) for r in rids]
        states = [eng.poll(r).state for r in rids]
        retries = sum(eng.poll(r).retries for r in rids)
        return outs, states, retries, detect

    outs, states, retries, detect = drain(
        f"seed={seed};serve=hang_step:{hang_at}")
    if not all(s == "DONE" for s in states):
        raise AssertionError(f"states after drill: {states}")
    if retries == 0:
        raise AssertionError("watchdog abort never exercised the retry "
                             "budget")
    if detect is None:
        raise AssertionError("watchdog never fired")
    clean_outs, _, _, _ = drain(None)
    mismatch = sum(a != b for a, b in zip(outs, clean_outs)) / len(outs)
    return _row("serve", "fp32", backend, shape="tiny-drill",
                inject_step=hang_at, detect_step=detect,
                faults_injected=1, recovery_action="watchdog-abort+retry",
                acc_delta_post=mismatch,  # greedy outputs vs fault-free
                note=f"hang_step:{hang_at} fault; watchdog aborts the "
                     f"batch, retry budget re-admits it ({retries} "
                     f"retries), block pool conserved", lane=_lane(device))


SCENARIOS = {
    "bitflip": drill_bitflip,
    "satstorm": drill_satstorm,
    "dp-drop": drill_dp_drop,
    "serve": drill_serve,
}


def run_scenarios(names=None, *, steps=10, seed=SEED, device="cuda",
                  backend="pallas"):
    """Run the named drills (all by default); returns the rows.  The
    serve drill keeps its own backend label, ``engine``, as the
    reference's row does."""
    rows = []
    for name in names or list(SCENARIOS):
        if name not in SCENARIOS:
            raise ValueError(
                f"unknown drill {name!r}; have {sorted(SCENARIOS)}")
        rows.append(SCENARIOS[name](
            steps, seed, "engine" if name == "serve" else backend,
            device=device))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", default=None,
                    help="comma list (default: all); see SCENARIOS")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"the reference-sized run: steps=10, "
                         f"seed={SEED}, every scenario")
    ap.add_argument("--selfcheck", action="store_true",
                    help="run every drill twice and assert the rows are "
                         "byte-identical (determinism contract)")
    ap.add_argument("--out", default="BENCH_fault_drill.json")
    args = ap.parse_args(argv)
    names = args.scenarios.split(",") if args.scenarios else None
    steps, seed = (10, SEED) if args.smoke else (args.steps, args.seed)
    rows = run_scenarios(names, steps=steps, seed=seed, device=args.device)
    if args.selfcheck:
        again = run_scenarios(names, steps=steps, seed=seed,
                              device=args.device)
        a = json.dumps(rows, sort_keys=True)
        b = json.dumps(again, sort_keys=True)
        if a != b:
            raise AssertionError("drill rows are not deterministic")
        print("[drill] selfcheck OK: re-run byte-identical")
    with open(args.out, "w") as f:
        json.dump({"benchmark": "fault_drill", "rows": rows}, f, indent=1,
                  sort_keys=True)
    for r in rows:
        print(f"drill/{r['mode']}: inject@{r['inject_step']} "
              f"detect@{r['detect_step']} "
              f"latency={r['ms_per_step']:.0f} steps "
              f"action={r['recovery_action']} "
              f"acc_delta={r['acc_delta_post']:+.4f} lane={r['lane']}")
    print(f"[drill] wrote {len(rows)} rows to {args.out}")
    return rows


if __name__ == "__main__":
    main()

"""Data-parallel training in the port (``repro_torch.distributed``) against
the JAX package, on the CPU.

The segmented step (per-segment dW partials from the segment-partial
⊞-MAC, per-segment bias folds, the fixed-schedule ⊞ combine, then the
update) must give the codes of the reference's ``reference_train_step``
and of its ``make_mlp`` route at ``reduce.grad_segments``, from the same
numpy weights and batches.  Rank invariance runs the port at 1, 2 and 4
gloo ranks (one process each) and holds every rank's codes to the
reference.  ``reduce.mode=float-psum`` re-encodes summed floats, so it is
held to the tolerance of the reference's own
``test_dp_float_psum_within_tolerance``.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

import repro.core as J
from repro.distributed.lns_dp import (LNSDataParallelMLP as JDPModel,
                                      reference_train_step as jref_step)
from repro.paper.mlp import (LNSMLP as JLNSMLP, MLPConfig as JConfig,
                             make_mlp as jmake, segmented_boxsum as jsegsum)
import repro_torch.core as T
from repro_torch.distributed import (DPConfig, LNSDataParallelMLP,
                                     deterministic_boxplus_allreduce,
                                     gather_partials, group_by_arithmetic,
                                     reference_train_step,
                                     run_device_count_invariance_check)
from repro_torch.distributed import lns_reduce as TR
from repro_torch.paper import (MLPConfig, make_mlp, params_from_numpy,
                               params_to_numpy, run_experiment)
from repro_torch.paper.mlp import LNSMLP, segmented_boxsum

# The plain ⊞ versions are long chains of small tensor ops.  Under xdist
# several port test files run at once, and OpenMP pools of 8 spinning
# threads in each process oversubscribe the cores many times over: one
# intra-op thread a process keeps each file near its serial time.
torch.set_num_threads(1)

SMALL = dict(n_in=12, n_hidden=9, n_out=4)
STEPS, BATCH, SEGS = 3, 8, 4


#: The reference's one-process step, jitted once per model and schedule.
_jref = jax.jit(jref_step, static_argnums=0,
                static_argnames=("grad_segments", "reduce_schedule"))


def _np(jtree):
    return {k: (np.array(v.code), np.array(v.sign)) for k, v in jtree.items()}


def _equal(got: dict, want: dict, msg=""):
    for k in want:
        for plane, g, w in zip(("code", "sign"), got[k], want[k]):
            np.testing.assert_array_equal(g, w, err_msg=f"{msg} {k} {plane}")


def _data(seed=0, batch=BATCH, n_in=12, n_out=4):
    rng = np.random.default_rng(seed)
    xb = rng.uniform(0, 1, size=(batch, n_in)).astype(np.float32)
    return xb, rng.integers(0, n_out, size=(batch,))


def _steps(step, params, mom, xb, yb, n=STEPS):
    """``n`` calls of ``step``; yields (params, momentum) after each."""
    for _ in range(n):
        out = step(params, xb, yb, mom)
        params = out[0]
        mom = out[1] if mom is not None else None
        yield params, mom


# (spec suffix after the alias and reduce keys, plan rules, MLPConfig kw)
CASES = {
    "lut": ("", "", {}),
    "bitshift-lns12": (",fmt=lns12,delta=bitshift", "", {}),
    "exact": (",delta=exact", "", {}),
    "tree": (",reduce.schedule=tree", "", {}),
    "hidden-lns12": ("", ";hidden=fmt:lns12", {}),
    "momentum+decay": ("", "", dict(momentum=0.9, weight_decay=0.01)),
    "unfused-momentum": ("", "", dict(momentum=0.9, fused=False)),
    # Segments of 4 rows: the per-segment bias folds are sequential, not
    # the pairwise tree (which agrees with them on 1 or 2 rows).
    "segments-2": ("", "", {}),
}
SEGMENTS = {"segments-2": 2}


def _specs(case, segs=SEGS):
    """(port spec with grad_segments, reference spec without, schedule)."""
    suffix, rules, _ = CASES[case]
    tspec = f"lns16-train-pallas,reduce.grad_segments={segs}{suffix}{rules}"
    jspec = f"lns16-train-emulate{suffix}{rules}"
    return tspec, jspec, "tree" if "tree" in suffix else "sequential"


@pytest.mark.parametrize("case", list(CASES))
def test_segmented_step_equals_reference(case):
    """The port's segmented model at one rank (no process group) and its
    ``reference_train_step`` equal the reference's
    ``reference_train_step`` after every step."""
    segs = SEGMENTS.get(case, SEGS)
    tspec, jspec, sched = _specs(case, segs)
    kw = CASES[case][2]
    xb, yb = _data()
    jinner = JLNSMLP(JConfig(spec=jspec, matmul_block=8, **SMALL, **kw))
    jp = jinner.init(jax.random.PRNGKey(5))
    init = _np(jp)
    model = make_mlp("lns", MLPConfig(spec=tspec, **SMALL, **kw),
                     device="cpu")
    assert isinstance(model, LNSDataParallelMLP)
    tinner = LNSMLP(MLPConfig(spec=jspec.replace("emulate", "pallas"),
                              **SMALL, **kw), "cpu")
    tp = tp_ref = params_from_numpy(init, "cpu")
    jmom = jinner.init_momentum(jp)
    tmom = tmom_ref = model.init_momentum(tp)
    for step in range(STEPS):
        out = _jref(jinner, jp, xb, yb, grad_segments=segs,
                    reduce_schedule=sched, momentum=jmom)
        jp, jmom = out[0], (out[1] if jmom is not None else None)
        out = model.train_step(tp, xb, yb, tmom)
        tp, tmom = out[0], (out[1] if tmom is not None else None)
        out = reference_train_step(tinner, tp_ref, xb, yb,
                                   grad_segments=segs, reduce_schedule=sched,
                                   momentum=tmom_ref)
        tp_ref = out[0]
        tmom_ref = out[1] if tmom_ref is not None else None
        want = _np(jp)
        _equal(params_to_numpy(tp), want, f"{case} model @{step}")
        _equal(params_to_numpy(tp_ref), want, f"{case} reference @{step}")
        if jmom is not None:
            _equal(params_to_numpy(tmom), _np(jmom), f"{case} m @{step}")


def test_make_mlp_route_equals_reference_route():
    """``make_mlp`` at ``reduce.grad_segments=4`` in both packages: the
    reference's route runs its Pallas kernels in interpret mode and its
    ⊞-reduce kernel for the combine."""
    xb, yb = _data(1)
    jm = jmake("lns", JConfig(
        spec="lns16-train-pallas,reduce.grad_segments=4", matmul_block=8,
        **SMALL))
    assert isinstance(jm, JDPModel)
    tm = make_mlp("lns", MLPConfig(
        spec="lns16-train-pallas,reduce.grad_segments=4", **SMALL), "cpu")
    jp = jm.init(jax.random.PRNGKey(2))
    tp = params_from_numpy(_np(jp), "cpu")
    for step in range(2):
        jp, jloss = jm.train_step(jp, xb, yb)
        tp, tloss = tm.train_step(tp, xb, yb)
        _equal(params_to_numpy(tp), _np(jp), f"@{step}")
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    np.testing.assert_array_equal(tm.predict(tp, xb).numpy(),
                                  np.asarray(jm.predict(jp, xb)))


def test_segmented_full_width_equals_reference_route():
    """784–100–10, batch 5 in 5 one-row segments, the synthetic mnist
    batches: the chip run's segmented path, against the reference."""
    from repro.paper import datasets as jds
    x, y, _, _, _ = jds.load("mnist", "data", 0)
    spec = "lns16-train-{},reduce.grad_segments=5"
    jm = jmake("lns", JConfig(spec=spec.format("emulate")))
    tm = make_mlp("lns", MLPConfig(spec=spec.format("pallas")), "cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(_np(jp), "cpu")
    for step in range(3):
        sl = slice(5 * step, 5 * step + 5)
        jp, _ = jm.train_step(jp, x[sl], y[sl])
        tp, _ = tm.train_step(tp, x[sl], y[sl])
        _equal(params_to_numpy(tp), _np(jp), f"@{step}")


#: (spec suffix, the parameters the grouped combine reduces together).
GROUP_PLANS = {
    "default": ("", [["w1", "b1", "w2", "b2"]]),
    "fmt-lns12": (",fmt=lns12", [["w1", "b1", "w2", "b2"]]),
    "hidden-lns12": (";hidden=fmt:lns12", [["w1", "b1"], ["w2", "b2"]]),
    "out-bitshift": (";out=delta:bitshift", [["w1", "b1"], ["w2", "b2"]]),
}


@pytest.mark.parametrize("plan", list(GROUP_PLANS))
def test_segmented_step_combines_once_per_arithmetic(plan, monkeypatch):
    """The segmented step (and ``reference_train_step``) combines every
    parameter that shares a format and Δ engine in one grouped ⊞-reduce:
    one for the whole model under a uniform plan, one per layer where the
    layers' arithmetic differs; each group in its own arithmetic."""
    suffix, groups = GROUP_PLANS[plan]
    model = make_mlp("lns", MLPConfig(
        spec=f"lns16-train-pallas,reduce.grad_segments={SEGS}{suffix}",
        **SMALL), "cpu")
    engs = model.inner.param_engines
    assert group_by_arithmetic(engs) == groups
    calls = []
    many = TR.lns_boxsum_many

    def spy(sets, *, fmt, spec):
        calls.append((len(sets), fmt, spec))
        return many(sets, fmt=fmt, spec=spec)
    monkeypatch.setattr(TR, "lns_boxsum_many", spy)
    xb, yb = _data(7)
    p = model.init(torch.Generator().manual_seed(0))
    model.train_step(p, xb, yb)
    reference_train_step(model.inner, p, xb, yb, grad_segments=SEGS)
    want = [(len(g), engs[g[0]].fmt, engs[g[0]].spec) for g in groups]
    assert calls == want * 2


def test_segmented_boxsum_equals_reference():
    rng = np.random.default_rng(3)
    a = J.encode(rng.normal(size=(16, 7)).astype(np.float32), J.LNS12)
    jeng = J.DeltaEngine(J.DELTA_BITSHIFT, J.LNS12)
    teng = T.cached_engine(T.DELTA_BITSHIFT, T.LNS12)
    want = jsegsum(a, 4, jeng)
    got = segmented_boxsum(T.LNSArray(torch.as_tensor(np.array(a.code)),
                                      torch.as_tensor(np.array(a.sign))),
                           4, teng)
    assert tuple(got.shape) == (4, 7)
    _equal({"b": (got.code.numpy(), got.sign.numpy())},
           {"b": (np.asarray(want.code), np.asarray(want.sign))})


def test_float_psum_within_reference_tolerance():
    """float-psum decodes, sums and re-encodes: within the tolerance of
    the reference's own test, against the reference's float-psum and the
    port's ⊞ schedule."""
    xb, yb = _data(4)
    jm = jmake("lns", JConfig(
        spec="lns16-train-emulate,reduce.grad_segments=4,"
             "reduce.mode=float-psum", matmul_block=8, **SMALL))
    jp = jm.init(jax.random.PRNGKey(0))
    init = _np(jp)
    ps = {}
    for mode in ("boxplus", "float-psum"):
        tm = make_mlp("lns", MLPConfig(
            spec=f"lns16-train-pallas,reduce.grad_segments=4,"
                 f"reduce.mode={mode}", **SMALL), "cpu")
        p = params_from_numpy(init, "cpu")
        for _ in range(2):
            p, _ = tm.train_step(p, xb, yb)
        ps[mode] = p
    for _ in range(2):
        jp, _ = jm.train_step(jp, xb, yb)
    for k in ps["boxplus"]:
        got = T.decode(ps["float-psum"][k], T.LNS16).numpy()
        np.testing.assert_allclose(
            got, np.asarray(J.decode(jp[k], J.LNS16)), rtol=0.1, atol=0.05,
            err_msg=k)
        np.testing.assert_allclose(
            got, T.decode(ps["boxplus"][k], T.LNS16).numpy(), rtol=0.1,
            atol=0.05, err_msg=k)


def test_dpconfig_like_reference():
    """``DPConfig`` on the ported surface (``num_devices``, ``reduce``,
    ``from_spec``, ``segments``, the loose legacy keywords) against the
    reference's; ``reduce_with_kernel`` routes nothing, so any value but
    ``None`` raises."""
    from repro.distributed.lns_dp import DPConfig as JDPConfig
    with pytest.raises(ValueError):
        T.ReduceSpec(mode="ring-allreduce")
    for cls in (DPConfig, JDPConfig):
        with pytest.raises(ValueError):
            cls(num_devices=0)
    for n, segs, batch in ((2, 3, 12), (2, 4, 10)):
        for cls, spec in ((DPConfig, T.ReduceSpec), (JDPConfig,
                                                     J.ReduceSpec)):
            with pytest.raises(ValueError):
                cls(num_devices=n,
                    reduce=spec(grad_segments=segs)).segments(batch)
    for n, segs, batch in ((2, 4, 8), (2, 0, 8), (3, 6, 12), (1, 0, 5)):
        assert (DPConfig(num_devices=n, reduce=T.ReduceSpec(
            grad_segments=segs)).segments(batch)
                == JDPConfig(num_devices=n, reduce=J.ReduceSpec(
                    grad_segments=segs)).segments(batch))
    spec = "lns16-train-pallas,reduce.grad_segments=6,reduce.schedule=tree"
    dp, jdp = (DPConfig.from_spec(spec, num_devices=3),
               JDPConfig.from_spec(spec, num_devices=3))
    assert dp.num_devices == jdp.num_devices == 3
    assert ((dp.reduce.mode, dp.reduce.grad_segments, dp.reduce.schedule)
            == (jdp.reduce.mode, jdp.reduce.grad_segments,
                jdp.reduce.schedule) == ("boxplus", 6, "tree"))
    assert DPConfig(reduce_with_kernel=None).reduce == T.ReduceSpec()
    for flag in (True, False):
        with pytest.raises(NotImplementedError, match="reduce_with_kernel"):
            DPConfig(reduce_with_kernel=flag)
    # The loose keywords fold into ``reduce`` as in the reference.
    assert DPConfig(reduce_mode="float-psum").reduce == T.ReduceSpec(
        "float-psum") and JDPConfig(reduce_mode="float-psum").reduce_mode \
        == DPConfig(reduce_mode="float-psum").reduce_mode == "float-psum"


def test_missing_or_smaller_group_raises():
    """A multi-rank config with no process group (or a smaller one) raises;
    nothing runs single-rank silently."""
    assert not dist.is_initialized()
    parts = T.zeros((2, 3), T.LNS16)
    assert gather_partials(parts) is parts
    with pytest.raises(RuntimeError, match="process group"):
        gather_partials(parts, num_ranks=2)
    eng = T.cached_engine(T.DELTA_DEFAULT, T.LNS16)
    with pytest.raises(RuntimeError, match="process group"):
        deterministic_boxplus_allreduce(parts, eng, num_ranks=4)
    cfg = MLPConfig(spec="lns16-train-pallas", data_parallel=2, **SMALL)
    with pytest.raises(RuntimeError, match="process group"):
        make_mlp("lns", cfg, "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        LNSDataParallelMLP(cfg, DPConfig(num_devices=2), "cpu")
    with pytest.raises(ValueError, match="data_parallel"):
        make_mlp("float", cfg, "cpu")


def test_invariance_check_defaults_to_the_card():
    """The invariance check runs NCCL ranks on the cards unless asked for
    the CPU: without as many cards as ranks it raises before it spawns
    anything."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="NCCL ranks need as many cards"):
        run_device_count_invariance_check((cards + 1,))
    with pytest.raises(ValueError, match="device"):
        run_device_count_invariance_check((1,), device="mps")


def test_one_rank_group_runs_the_collectives(tmp_path):
    """Inside a one-rank gloo group the gather and the loss mean run as
    collectives and give the codes of the run without a group."""
    xb, yb = _data(6)
    cfg = MLPConfig(spec="lns16-train-pallas,reduce.grad_segments=4",
                    **SMALL)
    model = make_mlp("lns", cfg, "cpu")
    p0 = model.init(torch.Generator().manual_seed(0))
    free = [out for out in _steps(lambda p, x, y, m: model.train_step(
        p, x, y), p0, None, xb, yb, 2)][-1][0]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        model = make_mlp("lns", cfg, "cpu")
        grouped = [out for out in _steps(lambda p, x, y, m: model.train_step(
            p, x, y), p0, None, xb, yb, 2)][-1][0]
    finally:
        dist.destroy_process_group()
    _equal(params_to_numpy(grouped), params_to_numpy(free))


def test_run_experiment_segmented_cpu_lane():
    """The harness drives the segmented model: the same weights as its
    own step loop from the same seed."""
    spec = "lns16-train-pallas,reduce.grad_segments=5"
    r = run_experiment("lns", "mnist", epochs=1, max_steps_per_epoch=2,
                       numerics=spec, device="cpu")
    from repro_torch.paper import datasets
    tm = make_mlp("lns", MLPConfig(spec=spec, weight_decay=0.01), "cpu")
    p = tm.init(torch.Generator().manual_seed(0))
    x, y, _, _, _ = datasets.load("mnist", "data", 0)
    x_tr, y_tr, _, _ = datasets.train_val_split(x, y, 5, 0)
    order = np.random.default_rng(0).permutation(len(x_tr))
    for s in range(2):
        sl = order[5 * s:5 * s + 5]
        p, _ = tm.train_step(p, x_tr[sl], y_tr[sl])
    _equal(r.params, params_to_numpy(p))


# (numerics, momentum, fused, rank counts): the reference's invariance grid.
RANK_CASES = {
    "uniform": ("lns16-train-{},reduce.grad_segments=4", 0.0, True,
                (1, 2, 4)),
    "momentum-mixed-plan": (
        "lns16-train-{},reduce.grad_segments=4;hidden=fmt:lns12", 0.9, True,
        (2, 4)),
    "unfused-momentum": ("lns16-train-{},reduce.grad_segments=4", 0.9,
                         False, (2, 4)),
}


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_rank_invariance_gloo(case):
    """Every rank's weight codes after 3 steps at 1, 2 and 4 gloo ranks
    equal the reference's ``reference_train_step`` at the same
    segmentation, with and without ⊞-momentum; so do the momentum codes,
    which carry the combined gradients themselves."""
    numerics, momentum, fused, counts = RANK_CASES[case]
    xb, yb = _data(0)
    jinner = JLNSMLP(JConfig(spec=numerics.format("emulate").replace(
        "reduce.grad_segments=4", "reduce.grad_segments=0"),
        momentum=momentum, fused=fused, matmul_block=8, **SMALL))
    jp = jinner.init(jax.random.PRNGKey(0))
    init = _np(jp)
    jmom = jinner.init_momentum(jp)
    for _ in range(STEPS):
        out = _jref(jinner, jp, xb, yb, grad_segments=SEGS, momentum=jmom)
        jp, jmom = out[0], (out[1] if jmom is not None else None)
    ok, runs = run_device_count_invariance_check(
        counts, steps=STEPS, batch=BATCH, numerics=numerics.format("pallas"),
        momentum=momentum, fused=fused, init_params=init, device="cpu",
        timeout=240, **SMALL)
    assert ok, {d: (r["matches_reference"], r["replicas_agree"])
                for d, r in runs.items()}
    for d in counts:
        assert runs[d]["replicas_agree"], d
        _equal(runs[d]["params"], _np(jp), f"{case} ranks={d}")
        if jmom is None:
            assert runs[d]["momentum"] is None
        else:
            _equal(runs[d]["momentum"], _np(jmom), f"{case} m ranks={d}")

"""The paper MLP's log-domain train steps, predict and evaluate in the
port (``repro_torch.paper``) against the JAX package: the fused step, and
the unfused step (``fused=False``, and its fallback at ``lr = 0``).

Both start from the JAX package's initial weights, carried across as numpy
(threefry cannot be matched in torch), and see the same batches of the
synthetic ``mnist`` preset at the full 784–100–10 width.  The port runs its
CPU lane; the reference runs its ``emulate`` lane, which the JAX package's
own tests pin to its Pallas kernels bit for bit.
"""
import numpy as np
import pytest
import torch

import jax

from repro.paper import datasets as jds
from repro.paper.mlp import MLPConfig as JConfig, make_mlp as jmake
from repro.paper.training import evaluate as jevaluate
from repro_torch.paper import datasets as tds
from repro_torch.paper import (MLPConfig, evaluate, make_mlp,
                               params_from_numpy, params_to_numpy,
                               run_experiment)

# The plain ⊞ versions are long chains of small tensor ops.  Under xdist
# several port test files run at once, and OpenMP pools of 8 spinning
# threads in each process oversubscribe the cores many times over: one
# intra-op thread a process keeps each file near its serial time.
torch.set_num_threads(1)

STEPS, BATCH = 20, 5

# (reference spec, port spec, MLPConfig keywords)
CASES = {
    "lut-lns16": ("lns16-train-emulate", "lns16-train-pallas", {}),
    "bitshift-lns16": ("lns16-train-emulate,delta=bitshift",
                       "lns16-train-pallas,delta=bitshift", {}),
    "lut-lns12": ("lns16-train-emulate,fmt=lns12",
                  "lns16-train-pallas,fmt=lns12", {"weight_decay": 0.3}),
    "bitshift-lns12": ("lns16-train-emulate,fmt=lns12,delta=bitshift",
                       "lns16-train-pallas,fmt=lns12,delta=bitshift", {}),
    "hidden-lns12": ("lns16-train-emulate;hidden=fmt:lns12",
                     "lns16-train-pallas;hidden=fmt:lns12", {}),
    "momentum+decay": ("lns16-train-emulate", "lns16-train-pallas",
                       {"momentum": 0.9, "weight_decay": 0.01}),
}


@pytest.fixture(scope="module")
def mnist():
    x, y, _, _, _ = jds.load("mnist", "data", 0)
    return jds.train_val_split(x, y, 5, 0)


def _to_numpy(jparams):
    return {k: (np.asarray(v.code), np.asarray(v.sign))
            for k, v in jparams.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_equal_reference(case, mnist):
    """20 fused steps of batch 5: the port's weight (and momentum) codes
    and signs equal the reference's after every step; then predict and
    evaluate on the validation split agree."""
    _check_steps(CASES[case], case, mnist, evaluate_all=case in EVALUATE)


# The unfused step: the plain forward / dW kernels' plain versions, the
# bias ⊞ and llReLU as passes of their own, the ⊞-SGD as tensor ops.
UNFUSED_CASES = {
    name: (jspec, tspec, dict(kw, fused=False))
    for name, (jspec, tspec, kw) in CASES.items()}
# lr = 0 has no update scalar code: the fused config falls back to the
# unfused update (and trains nothing but the momentum).
UNFUSED_CASES["lr0-momentum"] = ("lns16-train-emulate", "lns16-train-pallas",
                                 {"lr": 0.0, "momentum": 0.9})


@pytest.mark.parametrize("case", list(UNFUSED_CASES))
def test_unfused_train_steps_equal_reference(case, mnist):
    """20 unfused steps of batch 5 at full width equal the reference's
    ``LNSMLP(fused=False)`` after every step; predict agrees."""
    _check_steps(UNFUSED_CASES[case], case, mnist,
                 evaluate_all=case == "lut-lns16")


def _check_steps(spec_case, case, mnist, *, evaluate_all):
    jspec, tspec, kw = spec_case
    x_tr, y_tr, x_val, y_val = mnist
    jm = jmake("lns", JConfig(spec=jspec, **kw))
    tm = make_mlp("lns", MLPConfig(spec=tspec, **kw), device="cpu")
    jp = jm.init(jax.random.PRNGKey(3))
    jmom = jm.init_momentum(jp)
    tp = params_from_numpy(_to_numpy(jp), "cpu")
    tmom = tm.init_momentum(tp)
    for step in range(STEPS):
        sl = slice(step * BATCH, (step + 1) * BATCH)
        if jmom is None:
            jp, jloss = jm.train_step(jp, x_tr[sl], y_tr[sl])
            tp, tloss = tm.train_step(tp, x_tr[sl], y_tr[sl])
        else:
            jp, jmom, jloss = jm.train_step(jp, x_tr[sl], y_tr[sl], jmom)
            tp, tmom, tloss = tm.train_step(tp, x_tr[sl], y_tr[sl], tmom)
        got, want = params_to_numpy(tp), _to_numpy(jp)
        if jmom is not None:
            got.update({"m_" + k: v for k, v in params_to_numpy(tmom).items()})
            want.update({"m_" + k: v for k, v in _to_numpy(jmom).items()})
        for k in want:
            for plane, g, w in zip(("code", "sign"), got[k], want[k]):
                assert g.dtype == w.dtype, (k, plane)
                np.testing.assert_array_equal(
                    g, w, err_msg=f"{case}: {k} {plane} after step {step}")
        # Float readout: the batch mean is summed in another order.
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    pred = tm.predict(tp, x_val[:PRED]).numpy()
    np.testing.assert_array_equal(pred, np.asarray(jm.predict(jp,
                                                              x_val[:PRED])))
    if evaluate_all:
        assert evaluate(tm, tp, x_val, y_val) == jevaluate(jm, jp, x_val,
                                                           y_val)


# predict on a 100-row slice in every case; evaluate the whole validation
# split (666 rows, batches of 500) where the formats differ.
PRED = 100
EVALUATE = ("lut-lns16", "hidden-lns12")


def test_datasets_byte_equal():
    for name in ("mnist", "emnistl"):
        spec = jds.PRESETS[name]
        small = jds.DatasetSpec(name, spec.n_classes, spec.separation,
                                n_train=300, n_test=100)
        tsmall = tds.DatasetSpec(name, spec.n_classes, spec.separation,
                                 n_train=300, n_test=100)
        for a, b in zip(jds.synthetic(small, 7), tds.synthetic(tsmall, 7)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    x, y, _, _, _ = jds.load("mnist", "data", 0)
    tx, ty, _, _, _ = tds.load("mnist", "data", 0)
    assert x.tobytes() == tx.tobytes() and y.tobytes() == ty.tobytes()
    for a, b in zip(jds.train_val_split(x, y, 5, 0),
                    tds.train_val_split(tx, ty, 5, 0)):
        assert a.tobytes() == b.tobytes()
    assert {k: (v.n_classes, v.separation) for k, v in tds.PRESETS.items()} \
        == {k: (v.n_classes, v.separation) for k, v in jds.PRESETS.items()}


def test_params_numpy_round_trip():
    tm = make_mlp("lns", MLPConfig(), device="cpu")
    p = tm.init(torch.Generator().manual_seed(0))
    back = params_from_numpy(params_to_numpy(p), "cpu")
    for k in p:
        assert torch.equal(back[k].code, p[k].code)
        assert torch.equal(back[k].sign, p[k].sign)
        assert back[k].code.dtype == torch.int32
        assert back[k].sign.dtype == torch.int8
    assert p["w1"].shape == (784, 100) and p["b2"].shape == (10,)


def test_run_experiment_cpu_lane():
    """The harness end to end on the CPU lane: a seeded, reproducible
    init, the step loop, and evaluation."""
    kw = dict(epochs=1, max_steps_per_epoch=3, numerics="lns16-train-pallas",
              device="cpu")
    r = run_experiment("lns", "mnist", **kw)
    assert len(r.val_curve) == 1 and 0.0 <= r.test_acc <= 1.0
    assert set(r.params) == {"w1", "b1", "w2", "b2"}
    assert r.params["w1"][0].shape == (784, 100)
    # The same seed gives the same weights as a fresh init plus 3 steps.
    tm = make_mlp("lns", MLPConfig(spec="lns16-train-pallas",
                                   weight_decay=0.01), device="cpu")
    p0 = tm.init(torch.Generator().manual_seed(0))
    x, y, _, _, _ = tds.load("mnist", "data", 0)
    x_tr, y_tr, _, _ = tds.train_val_split(x, y, 5, 0)
    order = np.random.default_rng(0).permutation(len(x_tr))
    for s in range(3):
        sl = order[s * BATCH:(s + 1) * BATCH]
        p0, _ = tm.train_step(p0, x_tr[sl], y_tr[sl])
    for k, (c, s) in params_to_numpy(p0).items():
        np.testing.assert_array_equal(r.params[k][0], c)
        np.testing.assert_array_equal(r.params[k][1], s)


def test_unported_paths_raise():
    """What the slices ported constructs: fault plans (a malformed one
    raises as in the reference), the float and fixed-point models, and the
    spec keys that route nothing here."""
    with pytest.raises(ValueError, match="head token"):
        MLPConfig(faults="bitflip")
    assert str(MLPConfig(faults="seed=1;hidden=flip_w:0.5").faults) \
        == "seed=1;hidden=flip_w:0.5"
    for kw in (dict(spec="lns16-train-pallas,interpret=on"),
               dict(spec="lns16-train-pallas;hidden=metrics:full")):
        MLPConfig(**kw)
    for backend in ("fxp", "float"):
        make_mlp(backend, MLPConfig(), device="cpu")
    with pytest.raises(ValueError, match="data_parallel"):
        make_mlp("fxp", MLPConfig(data_parallel=2), device="cpu")
    # What the second slice ported constructs.
    for kw in (dict(fused=False), dict(lr=0.0), dict(data_parallel=2)):
        MLPConfig(**kw)
    with pytest.raises(ValueError, match="match no layer"):
        make_mlp("lns", MLPConfig(spec="lns16-train-pallas;hiden=fmt:lns12"),
                 device="cpu")


def test_cuda_device_raises_without_a_card():
    """``device="cuda"`` (every entry point's default) on a host without a
    card raises; nothing falls back to the CPU lane."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        make_mlp("lns", MLPConfig())
    with pytest.raises(RuntimeError, match="CUDA card"):
        params_from_numpy({"b": (np.zeros(3, np.int32),
                                 np.zeros(3, np.int8))})
    with pytest.raises(RuntimeError, match="CUDA card"):
        run_experiment("lns", "mnist", epochs=1, max_steps_per_epoch=1)

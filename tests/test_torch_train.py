"""The port's optimizers, gradient compression, data pipeline, train step,
checkpoints and train CLI (``optim/``, ``data/``, ``train/``, ``ckpt/``,
``launch/train.py``) against the JAX package, with the port's twins of the
reference's substrate tests (``tests/test_substrate.py``), of the dense
train-step smoke tests (``tests/test_models_smoke.py``) and of the train
half of its launcher drills (``tests/test_launchers.py``).

Bit-exact: the data batches, the int8 log compression's codes and the
checkpoint round trips (each package reads the other's checkpoints).  The
optimizers, fed the same parameters, gradients and state, agree within two
float32 ulps (the bias corrections' ``pow`` is XLA's in one, torch's in
the other).  Every run is on the CPU lane at ``reduced()`` sizes (batch
2, seq ≤ 32).
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.nn import init_params as jinit
from repro.nn.config import ShapeCell as JCell
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as jinit_state
from repro.train import make_train_step as jmake_step
from repro.train.step import resolve_numerics as jresolve
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import train as train_cli
from repro_torch.nn import Runtime, init_params, loss_fn, params_from_numpy
from repro_torch.nn.config import ShapeCell
from repro_torch.optim import (compress_int8_log, decompress_int8_log,
                               fake_compress_roundtrip)
from repro_torch.optim.optimizers import (AdamWConfig, SGDConfig,
                                          make_optimizer)
from repro_torch.pytree import tree_flatten, tree_leaves, tree_map
from repro_torch.train import (TrainConfig, init_train_state,
                               make_train_step, resolve_numerics)

torch.set_num_threads(1)

CELL = ShapeCell("t", seq_len=32, global_batch=2, kind="train")


def _setup(arch="olmo-1b", numerics="fp32"):
    cfg = reduced(get_config(arch)).with_(numerics=numerics, remat="none")
    return cfg, init_params(0, cfg, device="cpu")


def _batch(ds, step):
    return ds.batch_on(step, "cpu")


# ---------------------------------------------------------- optimizers ---
def _tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}


@pytest.mark.parametrize("opt", [
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
    ("adamw", {"lr": 3e-4, "b2": 0.999, "eps": 1e-6}),
    ("sgd", {"lr": 0.1, "momentum": 0.9, "weight_decay": 0.01}),
    ("sgd", {"lr": 0.05}),
])
def test_optimizer_updates_equal_reference(opt):
    """Three updates from the same parameters and gradients."""
    kind, kw = opt
    tcfg = (AdamWConfig if kind == "adamw" else SGDConfig)(**kw)
    jcfg = (jopt.AdamWConfig if kind == "adamw" else jopt.SGDConfig)(**kw)
    rng = np.random.default_rng(0)
    p = _tree(rng)
    jinit_, jupd = jopt.make_optimizer(jcfg)
    tinit, tupd = make_optimizer(tcfg)
    jp, js = jax.tree.map(jnp.asarray, p), None
    tp = tree_map(torch.tensor, p)
    js, ts = jinit_(jp), tinit(tp)
    for t in range(3):
        g = _tree(rng)
        jp, js = jupd(jp, jax.tree.map(jnp.asarray, g), js, jnp.int32(t))
        tp, ts = tupd(tp, tree_map(torch.tensor, g), ts,
                      torch.tensor(t, dtype=torch.int32))
    for a, b in zip(jax.tree.leaves((jp, js)), tree_leaves((tp, ts))):
        np.testing.assert_array_max_ulp(b.numpy(), np.asarray(a), maxulp=2)


def test_adamw_reduces_loss_quadratic():
    init, update = make_optimizer(AdamWConfig(lr=0.1, weight_decay=0.0))
    p = {"w": torch.tensor([5.0, -3.0])}
    s = init(p)
    for t in range(200):
        p, s = update(p, {"w": 2 * p["w"]}, s, torch.tensor(t))
    assert float(p["w"].abs().max()) < 0.05


def test_sgd_momentum_state_shapes():
    init, update = make_optimizer(SGDConfig(lr=0.1, momentum=0.9))
    p = {"a": torch.ones(3, 2), "b": torch.zeros(4)}
    s = init(p)
    p2, s2 = update(p, tree_map(torch.ones_like, p), s, torch.tensor(0))
    assert s2["m"]["a"].shape == (3, 2)
    assert float(p2["a"][0, 0]) < 1.0


# --------------------------------------------------------- compression ---
def test_log_int8_compression_equals_reference(rng):
    """The int8 codes and the scale are the reference's bit for bit; the
    decompressed values within two float32 ulps (``exp2``: the port's is
    float64 rounded once, XLA's float32 one is not always correctly
    rounded), in ``fake_compress_roundtrip`` with a residual too."""
    g = (rng.normal(size=(1000,)) * 0.01).astype(np.float32)
    g[::17] = 0.0
    codes, s = compress_int8_log(torch.tensor(g))
    jcodes, js = jcomp.compress_int8_log(jnp.asarray(g))
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert float(s) == float(js)
    out = decompress_int8_log(codes, s).numpy()
    np.testing.assert_array_max_ulp(
        out, np.asarray(jcomp.decompress_int8_log(jcodes, js)), maxulp=2)
    rel = np.abs(out - g) / (np.abs(g) + 1e-12)
    mask = np.abs(g) > float(s) * 2 ** -60
    assert np.median(rel[mask]) < 0.03
    tree = {"g": g, "h": (rng.normal(size=(7, 3)) * 1e-3).astype(np.float32)}
    res = tree_map(lambda a: torch.tensor(a * 0.1), tree)
    got = fake_compress_roundtrip(tree_map(torch.tensor, tree), res)
    want = jcomp.fake_compress_roundtrip(
        jax.tree.map(jnp.asarray, tree),
        jax.tree.map(lambda a: jnp.asarray(a * 0.1), tree))
    (ghat, new_res), (jghat, jres) = got, want
    for a, b, c in zip(jax.tree.leaves(jghat), tree_leaves(ghat),
                       jax.tree.leaves(tree)):
        np.testing.assert_array_max_ulp(b.numpy(), np.asarray(a), maxulp=2)
    for a, b, c in zip(jax.tree.leaves(jres), tree_leaves(new_res),
                       jax.tree.leaves(tree)):
        # residual = (g + r) - ghat: two ulps of ghat, absolute
        assert np.all(np.abs(b.numpy() - np.asarray(a))
                      <= 2.4e-7 * 1.1 * np.abs(c) + 1e-30)


def test_error_feedback_reduces_bias(rng):
    g = torch.tensor(rng.normal(size=(512,)), dtype=torch.float32) * 1e-3
    total_plain = torch.zeros(512)
    total_ef = torch.zeros(512)
    res = None
    for _ in range(50):
        gh_plain, _ = fake_compress_roundtrip({"g": g})
        gh_ef, res = fake_compress_roundtrip({"g": g}, res)
        total_plain += gh_plain["g"]
        total_ef += gh_ef["g"]
    ref = g * 50
    assert (total_ef - ref).abs().mean() \
        <= (total_plain - ref).abs().mean() * 1.05


# ---------------------------------------------------------------- data ---
@pytest.mark.parametrize("case", [
    ("olmo-1b", 32, 2, {}),
    ("qwen3-1.7b", 16, 4, {"seed": 7, "shard_index": 1, "shard_count": 2}),
    ("internvl2-76b", 16, 2, {"seed": 3}),        # vision stub
    ("seamless-m4t-medium", 16, 2, {"seed": 5}),  # audio stub
    ("mamba2-370m", 40, 2, {"repeat_prob": 1.0}),  # repeated n-grams
])
def test_data_batches_equal_reference(case):
    arch, seq, batch, dc = case
    cfg = reduced(get_config(arch))
    ds = SyntheticLMDataset(cfg, ShapeCell("t", seq, batch, "train"),
                            DataConfig(**dc))
    jds = JDataset(jconfigs.reduced(jconfigs.get_config(arch)),
                   JCell("t", seq, batch, "train"), JDataConfig(**dc))
    for step in (0, 1, 17):
        got, want = ds.batch_at(step), jds.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        on = ds.batch_on(step, "cpu")
        for k in want:
            np.testing.assert_array_equal(on[k].numpy(), want[k])


def test_data_deterministic_by_step():
    cfg, _ = _setup()
    ds1 = SyntheticLMDataset(cfg, CELL, DataConfig(seed=7))
    ds2 = SyntheticLMDataset(cfg, CELL, DataConfig(seed=7))
    for t in (0, 3, 17):
        np.testing.assert_array_equal(ds1.batch_at(t)["tokens"],
                                      ds2.batch_at(t)["tokens"])
    assert not np.array_equal(ds1.batch_at(0)["tokens"],
                              ds1.batch_at(1)["tokens"])


def test_data_host_sharding_partitions_batch():
    cfg, _ = _setup()
    cell = ShapeCell("t", 16, 8, "train")
    sh = [SyntheticLMDataset(cfg, cell,
                             DataConfig(seed=3, shard_index=i,
                                        shard_count=2)).batch_at(0)
          for i in range(2)]
    assert sh[0]["tokens"].shape[0] == 4
    assert not np.array_equal(sh[0]["tokens"], sh[1]["tokens"])
    with pytest.raises(ValueError, match="shards"):
        SyntheticLMDataset(cfg, cell, DataConfig(shard_count=3))


# ----------------------------------------------------------- training ----
def test_train_step_reduces_loss():
    cfg, params = _setup()
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), Runtime(),
                           TrainConfig())
    state = init_train_state(params, AdamWConfig(lr=1e-3))
    ds = SyntheticLMDataset(cfg, CELL, DataConfig(seed=0))
    losses = []
    for t in range(30):
        state, m = step(state, _batch(ds, t % 3))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[:3] + losses[-3:]
    assert int(state["step"]) == 30


def test_microbatched_grads_match_full_batch():
    cfg, params = _setup()
    ds = SyntheticLMDataset(cfg, CELL, DataConfig(seed=1))
    batch = _batch(ds, 0)
    opt = SGDConfig(lr=1e-2)
    o1, m1 = make_train_step(cfg, opt, Runtime(), TrainConfig())(
        init_train_state(params, opt), batch)
    o2, m2 = make_train_step(cfg, opt, Runtime(),
                             TrainConfig(microbatches=2))(
        init_train_state(params, opt), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=0.05)
    for a, b in zip(tree_leaves(o1["params"]), tree_leaves(o2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.2, atol=5e-3)


def test_grad_clip_caps_norm():
    cfg, params = _setup()
    tc = TrainConfig(grad_clip=1e-6)
    step = make_train_step(cfg, SGDConfig(lr=1.0), Runtime(), tc)
    state = init_train_state(params, SGDConfig(lr=1.0), tc)
    ds = SyntheticLMDataset(cfg, CELL, DataConfig())
    new, m = step(state, _batch(ds, 0))
    assert float(m["grad_norm"]) > 1e-6
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(new["params"])):
        assert float((a - b).abs().max()) < 1e-4


def test_nan_guard_skips_the_update():
    cfg, params = _setup()
    params["layers"]["attn"]["wq"][0, 0, 0] = float("nan")
    opt = AdamWConfig(lr=1e-3)
    ds = SyntheticLMDataset(cfg, CELL, DataConfig())
    state = init_train_state(params, opt)
    new, m = make_train_step(cfg, opt, Runtime(),
                             TrainConfig(nan_guard=True))(state,
                                                          _batch(ds, 0))
    assert int(m["update_skipped"]) == 1 and int(new["step"]) == 1
    for a, b in zip(tree_leaves((state["params"], state["opt"])),
                    tree_leaves((new["params"], new["opt"]))):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    _, fine = _setup()
    _, m = make_train_step(cfg, opt, Runtime(), TrainConfig(nan_guard=True))(
        init_train_state(fine, opt), _batch(ds, 0))
    assert int(m["update_skipped"]) == 0


def test_nan_guard_with_compression_skips_and_keeps_the_residual():
    """With ``compress_grads`` the guard reads the gradients before the
    int8 log code, which would turn a NaN into zeros: a NaN gradient skips
    the update and keeps the params, the optimizer state and the residual;
    the next, finite step updates."""
    from unittest import mock
    cfg, params = _setup()
    opt = AdamWConfig(lr=1e-3)
    tc = TrainConfig(compress_grads=True, nan_guard=True)
    ds = SyntheticLMDataset(cfg, CELL, DataConfig())
    step = make_train_step(cfg, opt, Runtime(), tc)
    state, _ = step(init_train_state(params, opt, tc), _batch(ds, 0))
    orig = torch.autograd.grad

    def nan_grad(*a, **k):
        out = list(orig(*a, **k))
        out[0] = torch.full_like(out[0], float("nan"))
        return tuple(out)
    with mock.patch.object(torch.autograd, "grad", nan_grad):
        new, m = step(state, _batch(ds, 1))
    assert int(m["update_skipped"]) == 1 and int(new["step"]) == 2
    for a, b in zip(tree_leaves((state["params"], state["opt"],
                                 state["residual"])),
                    tree_leaves((new["params"], new["opt"],
                                 new["residual"]))):
        assert torch.equal(a, b)
    after, m = step(new, _batch(ds, 2))
    assert int(m["update_skipped"]) == 0
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves((after["params"], after["residual"])))
    assert not torch.equal(tree_leaves(after["params"])[0],
                           tree_leaves(new["params"])[0])


def test_compressed_step():
    """One fp32 step with the log-int8 round trip from the reference's
    parameters: the loss (taken before the compression) within rtol 1e-5
    of the reference's, and the step's update is SGD on the decompressed
    gradient, whose error the residual carries.  (The parameters are not
    compared: a float32 ulp in a gradient moves its 4-bit-fraction log code
    by one at a half-code boundary, a 4% step.)"""
    cfg, _ = _setup("qwen3-1.7b")
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen3-1.7b")).with_(
        numerics="fp32", remat="none")
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    b = JDataset(jcfg, JCell("t", 16, 2, "train"), JDataConfig()).batch_at(0)
    jtc, tc = JTrainConfig(compress_grads=True), TrainConfig(
        compress_grads=True)
    _, jm = jax.jit(jmake_step(jcfg, jopt.SGDConfig(lr=0.1), tc=jtc))(
        jinit_state(jp, jopt.SGDConfig(lr=0.1), jtc),
        jax.tree.map(jnp.asarray, b))
    state = init_train_state(params_from_numpy(jax.tree.map(np.asarray, jp),
                                               "cpu"), SGDConfig(lr=0.1), tc)
    assert all(torch.equal(r, torch.zeros_like(r))
               for r in tree_leaves(state["residual"]))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    ts, tm = make_train_step(cfg, SGDConfig(lr=0.1), tc=tc)(state, tb)
    assert abs(float(tm["loss"]) / float(jm["loss"]) - 1) <= 1e-5
    leaves, treedef = tree_flatten(state["params"])
    live = [t.detach().requires_grad_() for t in leaves]
    from repro_torch.pytree import tree_unflatten
    grads = torch.autograd.grad(
        loss_fn(tree_unflatten(treedef, live), tb, cfg), live)
    ghat, res = fake_compress_roundtrip(tree_unflatten(treedef, list(grads)))
    for p0, p1, gh, r, rr in zip(leaves, tree_leaves(ts["params"]),
                                 tree_leaves(ghat), tree_leaves(res),
                                 tree_leaves(ts["residual"])):
        assert torch.equal(p1, p0 - 0.1 * (gh + 0.0 * p0))
        assert torch.equal(rr, r)


def test_train_state_and_numerics_like_reference():
    cfg, params = _setup("yi-6b")
    jcfg = jconfigs.reduced(jconfigs.get_config("yi-6b")).with_(
        numerics="fp32", remat="none")
    for opt, jo in ((AdamWConfig(), jopt.AdamWConfig()),
                    (SGDConfig(momentum=0.9), jopt.SGDConfig(momentum=0.9)),
                    (SGDConfig(), jopt.SGDConfig())):
        tc = TrainConfig(compress_grads=True)
        st = init_train_state(params, opt, tc)
        jst = jax.eval_shape(lambda: jinit_state(
            jinit(jax.random.PRNGKey(0), jcfg), jo, JTrainConfig(
                compress_grads=True)))
        from repro_torch.pytree import treedef_str
        assert treedef_str(tree_flatten(st)[1]) \
            == str(jax.tree_util.tree_structure(jst))
        for a, b in zip(jax.tree.leaves(jst), tree_leaves(st)):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).split(".")[-1]
    for text, kw in (("lns16-train-emulate", {"matmul_backend": "pallas"}),
                     ("bf16", {"reduce_mode": "float-psum"}),
                     ("lns16-qat;layers.mlp=fmt:lns12", {})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tc, jtc = TrainConfig(**kw), JTrainConfig(**kw)
        assert bool(kw) == any(issubclass(x.category, DeprecationWarning)
                               for x in w)
        got, want = resolve_numerics(cfg.with_(numerics=text), tc), \
            jresolve(jcfg.with_(numerics=text), jtc)
        assert got[0].numerics == want[0].numerics
        assert str(got[1]) == str(want[1])
    with pytest.raises(ValueError, match="end-to-end"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            resolve_numerics(cfg, TrainConfig(matmul_backend="pallas"))
    with pytest.raises(NotImplementedError, match="boxplus"):
        make_train_step(cfg.with_(numerics="fp32,reduce.mode=boxplus"),
                        SGDConfig(), tc=TrainConfig(data_parallel=2))
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_train_step(cfg, SGDConfig(), tc=TrainConfig(data_parallel=2))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-1.7b", "yi-6b",
                                  "command-r-35b", "internvl2-76b"])
def test_train_step_smoke(arch):
    """One loss + gradient at fp32: finite, and one SGD step moves the
    parameters (the dense twins of ``test_models_smoke.py``)."""
    cfg, params = _setup(arch)
    ds = SyntheticLMDataset(cfg, ShapeCell("s", 32, 2, "train"),
                            DataConfig())
    state = init_train_state(params, SGDConfig(lr=0.01))
    new, m = make_train_step(cfg, SGDConfig(lr=0.01))(state, _batch(ds, 0))
    assert np.isfinite(float(m["loss"]))
    assert any(float((a - b).abs().max()) > 0 for a, b in
               zip(tree_leaves(params), tree_leaves(new["params"])))


@pytest.mark.parametrize("numerics", ["lns16-qat", "lns16-train-pallas"])
def test_lns_numerics_mode(numerics):
    """The paper's technique as a numerics mode on a real architecture:
    finite loss and gradients."""
    cfg, params = _setup("qwen3-1.7b", numerics)
    ds = SyntheticLMDataset(cfg, ShapeCell("s", 16, 2, "train"),
                            DataConfig())
    leaves, treedef = tree_flatten(params)
    live = [t.requires_grad_() for t in leaves]
    from repro_torch.pytree import tree_unflatten
    loss = loss_fn(tree_unflatten(treedef, live), _batch(ds, 0), cfg)
    grads = torch.autograd.grad(loss, live)
    assert np.isfinite(float(loss.detach()))
    assert all(torch.isfinite(g).all() for g in grads)


# --------------------------------------------------------- checkpoints ---
def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg, params = _setup()
    state = init_train_state(params, AdamWConfig(lr=1e-3))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, state, blocking=True)
    mgr.save(10, state, blocking=False)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 10
    restored, step = mgr.restore_latest(state)
    assert step == 10
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keep_k_gc(tmp_path):
    _, params = _setup()
    state = init_train_state(params, SGDConfig())
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]


def test_checkpoint_atomic_tmp_cleanup_and_torn(tmp_path):
    _, params = _setup()
    state = init_train_state(params, SGDConfig())
    os.makedirs(tmp_path / "step_00000099.tmp")   # a crashed writer
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, state, blocking=True)
    assert latest_step(str(tmp_path)) == 1
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    os.makedirs(tmp_path / "step_00000007")       # torn: no manifest
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(ValueError, match="torn"):
        load_checkpoint(str(tmp_path), 7, state)
    os.remove(tmp_path / "step_00000001" / "leaf_0.npy")
    with pytest.raises(ValueError, match="torn"):
        load_checkpoint(str(tmp_path), 1, state)


def test_checkpoints_cross_load_with_reference(tmp_path):
    """Each package reads the other's checkpoint of the same state, bit for
    bit; their manifests have the same tree and leaves; a different
    numerics stamp raises unless allowed."""
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen3-1.7b")).with_(
        numerics="fp32", remat="none")
    jst = jinit_state(jinit(jax.random.PRNGKey(0), jcfg),
                      jopt.AdamWConfig())
    tst = init_train_state(params_from_numpy(jax.tree.map(
        np.asarray, jst["params"]), "cpu"), AdamWConfig())
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_checkpoint(jdir, 3, jst, numerics="lns16-qat")
    save_checkpoint(tdir, 3, tst, numerics="lns16-qat")
    mj = json.load(open(os.path.join(jdir, "step_00000003",
                                     "manifest.json")))
    mt = json.load(open(os.path.join(tdir, "step_00000003",
                                     "manifest.json")))
    for k in ("step", "treedef", "n_leaves", "leaves", "numerics"):
        assert mt[k] == mj[k], k
    got = load_checkpoint(jdir, 3, tst, numerics="lns16-qat")
    want = jckpt.load_checkpoint(tdir, 3, jax.eval_shape(lambda: jst),
                                 numerics="lns16-qat")
    for a, b, c in zip(jax.tree.leaves(jst), tree_leaves(got),
                       jax.tree.leaves(want)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(np.asarray(c), np.asarray(a))
    with pytest.raises(ValueError, match="allow_numerics_mismatch"):
        load_checkpoint(jdir, 3, tst, numerics="lns16-train-pallas")
    load_checkpoint(jdir, 3, tst, numerics="lns16-train-pallas",
                    allow_numerics_mismatch=True)


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-medium"])
def test_family_checkpoints_cross_load_and_continue(arch, tmp_path):
    """The hybrid's and the audio model's train states cross the package
    boundary through checkpoints: the port reads the reference's bit for
    bit and takes the next step as the reference does (fp32, loss within
    rtol 1e-5); the reference reads the port's stepped state bit for bit
    and both take one more step alike."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).with_(
        numerics="fp32", remat="none")
    cfg = reduced(get_config(arch)).with_(numerics="fp32", remat="none")
    jst = jinit_state(jinit(jax.random.PRNGKey(0), jcfg),
                      jopt.AdamWConfig())
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_checkpoint(jdir, 1, jst, numerics="fp32")
    template = init_train_state(init_params(1, cfg, device="cpu"),
                                AdamWConfig())
    tst = load_checkpoint(jdir, 1, template, numerics="fp32")
    for a, b in zip(jax.tree.leaves(jst), tree_leaves(tst)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ds = JDataset(jcfg, JCell("t", 16, 2, "train"), JDataConfig(seed=0))
    jstep = jax.jit(jmake_step(jcfg, jopt.AdamWConfig()))
    tstep = make_train_step(cfg, AdamWConfig())
    losses = []
    for i in range(2):
        b = ds.batch_at(i)
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, b))
        tst, tm = tstep(tst, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append((float(tm["loss"]), float(jm["loss"])))
        if i == 0:
            save_checkpoint(tdir, 2, tst, numerics="fp32")
            jst = jckpt.load_checkpoint(tdir, 2, jax.eval_shape(lambda: jst),
                                        numerics="fp32")
            for a, b in zip(jax.tree.leaves(jst), tree_leaves(tst)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for got, want in losses:
        assert abs(got - want) <= 1e-5 * abs(want), losses


# ---------------------------------------------------------------- CLI ----
def test_train_resume_drill(tmp_path, capsys):
    """Train 6 steps (checkpoint every 3), "crash", relaunch to 10: the
    second run resumes from step 6 at the exact batch, and gives the losses
    of an uninterrupted 10-step run."""
    common = ["--arch", "olmo-1b", "--batch", "2", "--seq", "32",
              "--ckpt-every", "3", "--numerics", "fp32", "--log-every",
              "100", "--device", "cpu"]
    losses1 = train_cli.main(["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "a")] + common)
    assert len(losses1) == 6
    losses2 = train_cli.main(["--steps", "10", "--ckpt-dir",
                              str(tmp_path / "a")] + common)
    assert len(losses2) == 4, "resume must continue from the checkpoint"
    assert "[train] resumed from step 6" in capsys.readouterr().out
    whole = train_cli.main(["--steps", "10"] + common)
    assert losses1 + losses2 == whole


def test_train_cli_numerics_stamped_checkpoints(tmp_path):
    common = ["--arch", "olmo-1b", "--batch", "2", "--seq", "16",
              "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
              "--log-every", "100", "--device", "cpu"]
    train_cli.main(["--steps", "2", "--numerics", "fp32"] + common)
    with pytest.raises(ValueError, match="allow_numerics_mismatch"):
        train_cli.main(["--steps", "4", "--numerics", "bf16"] + common)
    losses = train_cli.main(["--steps", "4", "--numerics", "bf16",
                             "--allow-numerics-mismatch"] + common)
    assert len(losses) == 2


def test_train_cli_numerics_alias_and_override(capsys):
    common = ["--arch", "olmo-1b", "--steps", "2", "--batch", "2",
              "--seq", "16", "--log-every", "100", "--device", "cpu"]
    losses = train_cli.main(
        common + ["--numerics", "lns16-qat,compute_dtype=float32"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "numerics spec: lns16-qat,compute_dtype=float32" in out
    with pytest.raises(ValueError, match="lns16-qat"):
        train_cli.main(common + ["--numerics", "lns17-qat"])
    with pytest.raises(ValueError, match="emulate, pallas"):
        train_cli.main(common + ["--numerics", "bf16,backend=cuda"])
    with pytest.raises(SystemExit, match="not divisible"):
        train_cli.main(common + ["--batch", "3", "--data-parallel", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            train_cli.main(common[:-2])


def test_train_cli_metrics_rows_like_reference(tmp_path):
    """``--metrics`` writes the reference's JSONL rows: the same keys, the
    same counters of the updated parameters, and the summary row."""
    from repro.launch import train as jtrain_cli
    common = ["--arch", "qwen3-1.7b", "--steps", "2", "--batch", "2",
              "--seq", "16", "--log-every", "100", "--numerics",
              "lns16-qat,compute_dtype=float32"]
    train_cli.main(common + ["--device", "cpu", "--metrics",
                             str(tmp_path / "t.jsonl")])
    jtrain_cli.main(common + ["--metrics", str(tmp_path / "j.jsonl")])
    rows = [json.loads(x) for x in open(tmp_path / "t.jsonl")]
    jrows = [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    assert len(rows) == len(jrows)
    for r, j in zip(rows, jrows):
        assert sorted(r) == sorted(j)
        assert (r["kind"], r["name"], r.get("layer"), r.get("op")) \
            == (j["kind"], j["name"], j.get("layer"), j.get("op"))
        if r["kind"] == "counter" and r["name"] == "numerics.elems":
            assert r["value"] == j["value"]
        if "lane" in r:   # the float lane's name, or the device's
            assert r["lane"] == (j["lane"] if j["lane"].startswith("float")
                                 else "cpu")

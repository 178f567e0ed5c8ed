"""The LM train step on several ranks (reduced olmo-1b, ``fp32``, AdamW
lr 1e-3, grad_clip 1.0, three steps of batch 4 × seq 32, from the same
parameters; ``tests/test_torch_mesh_parity.py``).

* ``TrainConfig(data_parallel=N)`` on the N gloo ranks of the default
  group (each its block of the batch, the gradients all-reduced to their
  mean) against the reference's step jitted on a 1-D ``data`` mesh of N
  host devices (the state replicated, the batch split), N = 2 and 4: every
  step's loss within rtol 1e-5, the parameters at the fp32 AdamW tier of
  ``tests/test_torch_lm_steps.py``.
* ``Runtime(mesh=(data=2, model=2))`` on the sharded state against the
  port's one-device steps, at the same tiers.  With ``compress_grads``
  (the int8 log code's per-leaf scale is the largest magnitude over the
  leaf's shards) one step's error-feedback residual and compressed
  gradient against the one-device step's; and ``nan_guard`` skips a step
  on every rank when one rank's gradient is NaN.  The same mesh steps
  with ``donate=True`` (the state written into its local shards) equal
  the functional ones bit for bit.
* ``python -m repro_torch.launch.train --data-parallel 2 --device cpu``
  (its own two ranks) gives the one-rank run's losses; a batch that the
  ranks do not divide exits with the reference's message.
* A checkpoint of the sharded state saved at (2, 2) restores at (1, 4)
  and on one device with ``shardings=``, equal; the reference's
  ``load_checkpoint`` reads it, and the port restores the reference's at
  (1, 4).
"""
import numpy as np
import pytest
import torch

import test_torch_mesh_parity as mp
from repro_torch.pytree import tree_leaves

torch.set_num_threads(1)

ARCH = "olmo-1b"
B, S, STEPS = 4, 32, 3


def _batches(cfg):
    return [mp.lm_batch(cfg, B, S, 100 + i) for i in range(STEPS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.ckpt import save_checkpoint as jsave
    from repro.optim.optimizers import AdamWConfig as JAdamW
    from repro.train import TrainConfig as JTC
    from repro.train import init_train_state as jinit_state
    from repro_torch.nn import Runtime, params_to_numpy
    from repro_torch.optim.optimizers import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step
    tmp = tmp_path_factory.mktemp("mesh_train")
    params = mp.numpy_params(ARCH)
    cfg = mp._tcfg(ARCH, "fp32")
    batches = _batches(cfg)
    tasks = [dict(kind="train_dp", arch=ARCH, dp=dp, params=params,
                  batches=batches) for dp in (2, 4)]
    procs = mp.start_reference(tasks, str(tmp / "ref.pkl"))
    ref_state = jax.tree.map(np.asarray, jinit_state(
        jax.tree.map(jnp.asarray, params), JAdamW(lr=1e-3), JTC()))
    jsave(str(tmp / "ref_ckpt"), 3, ref_state)
    job = dict(arch=ARCH, params=params, batches=batches,
               ckpt_dir=str(tmp / "ckpt"), ref_dir=str(tmp / "ref_ckpt"),
               ref_state=ref_state)
    four = mp.on_ranks(mp.rank_train_mesh_and_ckpt, job)
    from repro_torch.distributed.lns_dp import run_on_ranks
    two = run_on_ranks(2, mp.rank_train_dp, job, device="cpu", timeout=300)
    opt, tc = AdamWConfig(lr=1e-3), TrainConfig(grad_clip=1.0)
    one_losses, one = mp._steps(make_train_step(cfg, opt, Runtime(), tc),
                                mp._state(ARCH, params, opt, tc), batches)
    tc = TrainConfig(grad_clip=1.0, compress_grads=True, nan_guard=True)
    cl, comp = mp._steps(make_train_step(cfg, opt, Runtime(), tc),
                         mp._state(ARCH, params, opt, tc), batches[:1])
    return dict(ref=mp.finish_reference(procs), two=two, four=four,
                one=(one_losses, params_to_numpy(one["params"])),
                one_compressed=(cl[0], params_to_numpy(comp["params"]),
                                params_to_numpy(comp["residual"]),
                                params_to_numpy(comp["opt"]["mu"])),
                dir=str(tmp), ref_state=ref_state)


@pytest.mark.parametrize("dp", [2, 4])
def test_data_parallel_steps_equal_reference_data_mesh(runs, dp):
    ranks = runs["two"] if dp == 2 else [r[0] for r in runs["four"]]
    losses, params = ranks[0]
    jlosses, jparams, jgrads = runs["ref"][(2, 4).index(dp)]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, jlosses)]
    ratio = mp.adamw_ratio(jparams, jgrads, tree_leaves(params))
    print(f"\ndata_parallel={dp}: loss gaps {gaps}; AdamW max |diff| / "
          f"tolerance {ratio:.3g}")
    assert all(r[0] == losses for r in ranks)
    for r in ranks:
        assert all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(r[1]), tree_leaves(params)))
    assert max(gaps) <= 1e-5
    assert ratio <= 1.0


def test_mesh_steps_equal_one_device(runs):
    losses, params = runs["four"][0][1]
    one_losses, one = runs["one"]
    # The one-device run's accumulated gradients, read from the
    # reference's data-parallel run (the same steps, within the tier).
    jgrads = runs["ref"][0][2]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, one_losses)]
    ratio = mp.adamw_ratio(tree_leaves(one), jgrads, tree_leaves(params))
    print(f"\nmesh (2, 2): loss gaps to one device {gaps}; AdamW max "
          f"|diff| / tolerance {ratio:.3g}")
    assert all(r[1][0] == losses for r in runs["four"])
    assert max(gaps) <= 1e-5
    assert ratio <= 1.0


def test_mesh_step_compressed_equals_one_device(runs):
    """The compressed step's loss within rtol 1e-5; its residual and
    compressed gradient (AdamW's first moment after one step, (1 - b1)·ĝ)
    within 1e-3 relative L2 of the one-device step's (a float ulp moves a
    log code by one at a rounding edge, 2^(1/16) of that element); the
    parameters at the fp32 AdamW tier."""
    loss, params, res, mu = runs["four"][0][3][0]
    oloss, oparams, ores, omu = runs["one_compressed"]
    gap = abs(loss - oloss) / abs(oloss)
    rres = mp.rel_l2_tree(tree_leaves(res), tree_leaves(ores))
    rmu = mp.rel_l2_tree(tree_leaves(mu), tree_leaves(omu))
    ratio = mp.adamw_ratio(tree_leaves(oparams),
                           [[m / 0.1 for m in tree_leaves(omu)]],
                           tree_leaves(params))
    print(f"\nmesh (2, 2) compressed step: loss gap {gap:.3g}; residual "
          f"relative L2 {rres:.3g}, compressed gradient {rmu:.3g}; AdamW "
          f"max |diff| / tolerance {ratio:.3g}")
    assert all(r[3][0][0] == loss for r in runs["four"])
    assert gap <= 1e-5
    assert rres <= 1e-3 and rmu <= 1e-3
    assert ratio <= 1.0


@pytest.mark.parametrize("i", [1, 2], ids=["compressed", "guard-only"])
def test_mesh_nan_guard_skips_on_every_rank(runs, i):
    """One rank's NaN gradient skips the update on all four ranks: each
    reports ``update_skipped`` 1 and keeps its parameters and optimizer
    state bit for bit; the step counter advances."""
    assert [r[3][i] for r in runs["four"]] == [(1, True)] * 4


def test_mesh_donated_steps_equal_functional(runs):
    """``make_train_step(..., donate=True)`` under the (2, 2) mesh: the
    three steps' losses and the gathered state equal the functional mesh
    steps' bit for bit on every rank, and each rank's returned state holds
    the local shards it was given."""
    assert [r[4] for r in runs["four"]] == [(True, True)] * 4


def test_checkpoint_restores_across_meshes_and_packages(runs):
    import jax
    from repro.ckpt import load_checkpoint as jload
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.nn import params_from_numpy
    assert all(r[2] == {"port": True, "reference": True}
               for r in runs["four"])
    ckpt = runs["dir"] + "/ckpt"
    like = params_from_numpy(runs["ref_state"], "cpu")
    one = load_checkpoint(ckpt, 3, like)
    jone = jload(ckpt, 3, runs["ref_state"])
    assert int(one["step"]) == 3
    for a, b in zip(tree_leaves(one["params"]),
                    tree_leaves(runs["four"][0][1][1])):
        assert np.array_equal(a.numpy(), b)
    for a, b in zip(tree_leaves(one), jax.tree.leaves(jone)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_train_cli_data_parallel(tmp_path):
    from repro_torch.launch import train
    argv = ["--arch", ARCH, "--steps", "3", "--batch", "4", "--seq", "32",
            "--numerics", "fp32", "--device", "cpu", "--log-every", "1"]
    one = train.main(argv)
    two = train.main(argv + ["--data-parallel", "2"])
    print(f"\ntrain CLI losses: one rank {one}; two ranks {two}")
    assert len(two) == 3
    assert max(abs(a - b) / abs(a) for a, b in zip(one, two)) <= 1e-5
    with pytest.raises(SystemExit, match="not divisible"):
        train.main(argv + ["--batch", "3", "--data-parallel", "2"])


def test_step_raises_without_a_group_and_for_boxplus():
    from repro_torch.optim.optimizers import SGDConfig
    from repro_torch.train import TrainConfig, make_train_step
    cfg = mp._tcfg(ARCH, "fp32")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_train_step(cfg, SGDConfig(), tc=TrainConfig(data_parallel=2))
    with pytest.raises(NotImplementedError, match="boxplus"):
        make_train_step(cfg.with_(numerics="fp32,reduce.mode=boxplus"),
                        SGDConfig(), tc=TrainConfig(data_parallel=2))

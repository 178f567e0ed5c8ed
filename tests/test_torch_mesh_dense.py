"""Sharded execution of the dense LM stack (reduced olmo-1b) on four gloo
ranks against the JAX package on the same meshes, (data=2, model=2) and
(data=1, model=4), from the same parameters
(``tests/test_torch_mesh_parity.py``).

* ``fp32``: the loss within rtol 1e-5 of the reference's mesh loss, and
  every gradient within 1e-5 × its leaf's largest magnitude (the fp32
  tier of ``tests/lm_parity.py``).  Also at seq 6, which the (1, 4) mesh
  cannot split over ``model``: the embedding all-reduces and the stream
  stays replicated over ``model``.
* ``lns16-train``: the sharded forward keeps every ⊞-MAC's contraction
  whole on one rank, so each linear's output and the loss equal the
  port's one-device forward bit for bit; the gradients' floats are summed
  in another order, and they are held to the dense family's lns16-train
  tier against the reference's mesh gradients (0.3 relative L2 over the
  tree; the reference's own mesh-to-one-device gap reads 1.58e-2 to
  9.47e-2 per leaf).
"""
import pytest
import torch

import test_torch_mesh_parity as mp

torch.set_num_threads(1)

FP32 = [("olmo-1b", (2, 2), 32), ("olmo-1b", (1, 4), 32),
        ("olmo-1b", (1, 4), 6)]
LNS = [("olmo-1b", (2, 2))]
LNS_GRAD_RTOL = 0.3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mp.loss_grad_runs(tmp_path_factory.mktemp("mesh_dense"), FP32,
                             LNS)


@pytest.mark.parametrize("i", range(len(FP32)),
                         ids=[f"{a}-{m[0]}x{m[1]}-seq{s}" for a, m, s in FP32])
def test_fp32_loss_and_grads_equal_reference_mesh(runs, i):
    mp.check_fp32(runs["fp32"][i], FP32[i])


@pytest.mark.parametrize("mesh", mp.MESHES, ids=["2x2", "1x4"])
def test_lns_forward_bit_equal_to_one_device(runs, mesh):
    mp.check_lns_forward(runs["lns"][0], mesh)


@pytest.mark.parametrize("mesh", mp.MESHES, ids=["2x2", "1x4"])
def test_lns_grads_within_tier_of_reference_mesh(runs, mesh):
    mp.check_lns_grads(runs["lns"][0], mesh, LNS_GRAD_RTOL)

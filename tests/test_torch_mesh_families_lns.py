"""lns16-train sharded execution of the ssm (reduced mamba2-370m), hybrid
(zamba2-7b) and enc-dec/audio (seamless-m4t-medium) families on four gloo
ranks, (data=2, model=2) and (data=1, model=4), from the same parameters
(``tests/test_torch_mesh_parity.py``).

* The sharded forward keeps every ⊞-MAC's contraction whole on one rank:
  the Mamba2 blocks over the gathered sequence with their caches cut per
  rank, the hybrid's shared attention block, and the encoder's and the
  decoder's streams.  So each linear's output and the loss equal the
  port's one-device forward bit for bit.
* The gradients' floats are summed in another order; they are held to
  each family's lns16-train gradient tier (``TIERS`` of
  ``tests/test_torch_lm_families_lns_steps.py``) as relative L2 over the
  tree against the reference's gradients on the (2, 2) mesh.
"""
import pytest
import torch

import test_torch_mesh_parity as mp
from test_torch_lm_families_lns_steps import TIERS

torch.set_num_threads(1)

ARCHS = sorted(TIERS)
LNS = [(a, (2, 2)) for a in ARCHS]
CASES = [(i, m) for i in range(len(ARCHS)) for m in mp.MESHES]
IDS = [f"{ARCHS[i]}-{m[0]}x{m[1]}" for i, m in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mp.loss_grad_runs(tmp_path_factory.mktemp("mesh_families_lns"),
                             (), LNS)


@pytest.mark.parametrize("i,mesh", CASES, ids=IDS)
def test_lns_forward_bit_equal_to_one_device(runs, i, mesh):
    mp.check_lns_forward(runs["lns"][i], mesh)


@pytest.mark.parametrize("i,mesh", CASES, ids=IDS)
def test_lns_grads_within_tier_of_reference_mesh(runs, i, mesh):
    mp.check_lns_grads(runs["lns"][i], mesh, TIERS[ARCHS[i]][1])

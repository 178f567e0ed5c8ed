"""Sharded execution of the ssm (reduced mamba2-370m), hybrid (zamba2-7b)
and enc-dec/audio (seamless-m4t-medium) families on four gloo ranks
against the JAX package on the same meshes, (data=2, model=2) and (data=1,
model=4), under ``fp32``, from the same parameters
(``tests/test_torch_mesh_parity.py``): the loss within rtol 1e-5 of the
reference's mesh loss, every gradient within 1e-5 × its leaf's largest
magnitude (the fp32 tier of ``tests/lm_parity.py``; zamba2-7b's come
nearest it, 8.43e-6 at (2, 2), as its gradients come near it between the
packages on one device).  The Mamba2 blocks run over the
whole sequence on every rank of a model group, the attention blocks with
their heads split over ``model``; the encoder's frames and the decoder's
tokens are two streams, each split over the sequence.
"""
import pytest
import torch

import test_torch_mesh_parity as mp

torch.set_num_threads(1)

FP32 = [(a, m, 32) for a in ("mamba2-370m", "zamba2-7b",
                             "seamless-m4t-medium") for m in mp.MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mp.loss_grad_runs(tmp_path_factory.mktemp("mesh_families"), FP32)


@pytest.mark.parametrize("i", range(len(FP32)),
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m, _ in FP32])
def test_fp32_loss_and_grads_equal_reference_mesh(runs, i):
    mp.check_fp32(runs["fp32"][i], FP32[i])

"""The four ``reduced()`` dense configs in the port against the JAX
package under ``lns16-qat`` (STE-quantized operands, bf16 products), from
the reference's parameters: ``loss_fn`` within rtol 1e-3 and its
gradients within a relative L2 distance of 3e-2 over the whole tree
(0.010-0.016 measured; the printout: how many codes of the head's input
activations and of the gradients differ), and three AdamW train steps (microbatches=2, grad_clip=1.0, on
the reference's batches; the runner is ``run`` of
``tests/lm_parity.py``), the loss of every step within rtol 1e-3.  SGD's
steps are in ``test_torch_lm_sgd_steps.py``.
"""
import pytest
import torch

from lm_parity import DENSE, check_loss_and_grads, rel_gaps, run

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_equal_reference(arch):
    check_loss_and_grads(arch, "lns16-qat")


@pytest.mark.parametrize("arch", DENSE)
def test_qat_steps_equal_reference(arch):
    jl, tl, _, _ = run(arch, "lns16-qat", "lns16-qat", "adamw")
    gaps = rel_gaps(jl, tl)
    print(f"\n{arch} adamw lns16-qat: loss gaps {gaps}")
    assert max(gaps) <= 1e-3

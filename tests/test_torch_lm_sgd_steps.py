"""Three SGD-with-momentum train steps of the four ``reduced()`` dense
configs in the port against the JAX package under ``bf16`` and
``lns16-qat`` (AdamW's are in ``test_torch_lm_steps.py`` and
``test_torch_lm_qat.py``; fp32's both in ``test_torch_lm_steps.py``): the
runner is ``run`` of ``tests/lm_parity.py`` (microbatches=2,
grad_clip=1.0, the reference's parameters and batches).  The loss of
every step lies within rtol 2e-2 under bf16 and 1e-3 under lns16-qat.
"""
import pytest
import torch

from lm_parity import DENSE, rel_gaps, run

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", [("bf16", 2e-2), ("lns16-qat", 1e-3)],
                         ids=["bf16", "lns16-qat"])
@pytest.mark.parametrize("arch", DENSE)
def test_sgd_steps_equal_reference(arch, mode):
    numerics, rtol = mode
    jl, tl, _, _ = run(arch, numerics, numerics, "sgd")
    gaps = rel_gaps(jl, tl)
    print(f"\n{arch} sgd {numerics}: loss gaps {gaps}")
    assert max(gaps) <= rtol

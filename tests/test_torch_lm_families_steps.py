"""Three ``make_train_step`` steps of the ssm, hybrid and enc-dec families
(``reduced()`` mamba2-370m, zamba2-7b and seamless-m4t-medium) in the
port against the JAX package (the runner is ``run`` of
``tests/lm_parity.py``: AdamW, microbatches=2, grad_clip=1.0, the
reference's batches), and the port's ``reference_generate`` for each.

* ``fp32``, free-running: the loss of every step within rtol 1e-5.
* ``lns16-train``: in ``tests/test_torch_lm_families_lns_steps.py``.
* ``reference_generate`` on the CPU lane, greedy: two runs give the same
  tokens, and the first is the argmax of the port's own ``prefill`` of
  the prompt (the audio model's prompt over frames of zeros, the memory
  ``reference_generate`` decodes against: its encoder maps zeros to
  zeros).
"""
import numpy as np
import pytest
import torch

from lm_parity import rel_gaps, run
from repro_torch.configs import get_config, reduced
from repro_torch.nn import init_params, prefill
from repro_torch.serve import reference_generate

torch.set_num_threads(1)

ARCHS = ["mamba2-370m", "zamba2-7b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_steps_equal_reference(arch):
    jl, tl, _, _ = run(arch, "fp32", "fp32", "adamw")
    gaps = rel_gaps(jl, tl)
    print(f"\n{arch} adamw fp32: loss gaps {gaps}")
    assert max(gaps) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_generate(arch):
    cfg = reduced(get_config(arch)).with_(numerics="fp32", remat="none")
    params = init_params(0, cfg, device="cpu")
    prompt = np.random.default_rng(1).integers(3, cfg.vocab_size, size=7)
    first = reference_generate(cfg, params, prompt, 6, max_len=16)
    assert first == reference_generate(cfg, params, prompt, 6, max_len=16)
    assert 1 <= len(first) <= 6
    batch = {"tokens": torch.from_numpy(prompt[None].astype(np.int32))}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.zeros((1, 16, cfg.d_model))
    with torch.no_grad():
        logits, _ = prefill(params, batch, cfg)
    assert first[0] == int(logits[0, -1].argmax())

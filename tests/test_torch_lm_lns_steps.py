"""Three AdamW train steps of olmo-1b and qwen3-1.7b (``reduced()``; the
other two dense configs are in ``test_torch_lm_lns_steps_yi_cmdr.py``)
in the port against the JAX package under ``lns16-train`` (the runner is
``run`` of ``tests/lm_parity.py``): microbatches=2, grad_clip=1.0, on the
reference's batches, teacher-forced: each port step starts from the
reference's parameters and AdamW state before it, so that every step is
held at the first step's tier.  Free-running, the two trajectories part
after the first update: float32 ulps around the ⊞-MACs flip codes, the Δ
table amplifies them, and AdamW turns a gradient whose sign flipped into
a ±lr step (ROADMAP queue 3 item 7).

Each step's loss lies within rtol 1e-2 (the bound of ``loss_fn`` in
``test_torch_lm_lns_model.py``); its clipped, accumulated gradient (read
from AdamW's first moment) within a relative L2 distance of 0.3 over
the whole tree, and its parameter update within 0.5 (an update of AdamW
is about ±lr an element, so a gradient's flipped sign moves it by 2·lr).
A step whose update were skipped, or whose gradients reached the
optimizer wrongly wired, would be off by 1 or more.  SGD's runs are not
repeated here.
"""
import pytest
import torch

from lm_parity import DENSE, LOSS_RTOL, OPTS, forced_step_gaps, rel_gaps, \
    run

torch.set_num_threads(1)

GRAD_RTOL, UPDATE_RTOL = 0.3, 0.5


@pytest.mark.parametrize("arch", DENSE[:2])
def test_lns_train_steps_against_reference(arch):
    jl, tl, jstates, tstates = run(arch, "lns16-train-emulate",
                                   "lns16-train-pallas", "adamw", forced=True)
    gaps = rel_gaps(jl, tl)
    steps = forced_step_gaps(jstates, tstates, OPTS["adamw"][1].b1)
    print(f"\n{arch} adamw lns16-train, teacher-forced: loss gaps {gaps}; "
          f"(gradient, update) relative L2 {steps}")
    assert max(gaps) <= LOSS_RTOL["lns16-train"]
    assert max(g for g, _ in steps) <= GRAD_RTOL
    assert max(u for _, u in steps) <= UPDATE_RTOL

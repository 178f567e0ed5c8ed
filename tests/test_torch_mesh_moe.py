"""Expert parallelism on four gloo ranks against the JAX package on the
same meshes (``tests/test_torch_mesh_parity.py``), under ``fp32``: the
reduced deepseek-moe-16b (GQA) and deepseek-v2-lite-16b (MLA), 8 experts top-2,
the model axis tp = 2 ((data=2, model=2)) and tp = 4 ((data=1, model=4)).

* ``moe_ep`` (tokens split over the sequence, an all-to-all over
  ``model`` and back) and ``moe_ep_replicated`` (tokens replicated over
  ``model``, the routed outputs summed over it) on the same block of the
  same input: outputs within 1e-5 × their largest magnitude, ``aux``
  within 1e-6, and the dropped (token, k) assignments equal as sets (read
  from each output: the subset of a token's top-k contributions, computed
  here in float64, that its output holds).  A second input sends every
  token to one expert first, so that the per-shard capacity drops
  assignments.
* The whole-model loss on (2, 2) within rtol 1e-5 of the reference's mesh
  loss (under a mesh the MoE drops what overflows a shard's capacity: the
  reference's own mesh loss parts from its one-device loss by 6.1e-4 and
  2.9e-3).
* ``decode_step_paged`` at seq 1 (``moe_ep_replicated``, the embedding
  all-reduced) on (2, 2): two steps' logits within 1e-5 × their largest
  magnitude (the fp32 tier).
"""
import numpy as np
import pytest
import torch

import test_torch_mesh_parity as mp

torch.set_num_threads(1)

ARCHS = ("deepseek-moe-16b", "deepseek-v2-lite-16b")
UNIT = "deepseek-moe-16b"
B, S = 2, 8
CASES = [(tp, form, skew) for tp in (2, 4) for form in ("ep", "replicated")
         for skew in (False, True)]
DECODE = dict(arch="deepseek-v2-lite-16b", mesh=(2, 2), block_size=4,
              num_blocks=1 + B * 2)


def _moe_inputs(p, skew, seed):
    """A (B, S, d) input; ``skew`` makes expert 0 every token's first
    choice (positive tokens, a large positive router column 0)."""
    rng = np.random.default_rng(seed)
    d = p["router"].shape[0]
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    if skew:
        p = dict(p, router=p["router"].copy())
        p["router"][:, 0] = 1.0
        x = np.abs(x) + 0.5
    return x, p


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_moe") / "ref.pkl")
    params = {a: mp.numpy_params(a) for a in ARCHS}
    layer = {k: v[0] for k, v in params[UNIT]["layers"]["moe"].items()}
    units = [dict(kind="moe", arch=UNIT, tp=tp, form=form,
                  **dict(zip(("x", "p"), _moe_inputs(layer, skew, tp))))
             for tp, form, skew in CASES]
    batches = {a: mp.lm_batch(mp._tcfg(a, "fp32"), B, 32, len(a))
               for a in ARCHS}
    losses = [dict(kind="loss_grads", arch=a, numerics="fp32", mesh=(2, 2),
                   batch=batches[a], params=params[a]) for a in ARCHS]
    rng = np.random.default_rng(1)
    dec = dict(DECODE, kind="decode_paged", params=params[DECODE["arch"]],
               toks=[rng.integers(0, 256, size=(B, 1)).astype(np.int32)
                     for _ in range(2)],
               pos=[np.full((B,), i, np.int32) for i in range(2)],
               bt=(1 + np.arange(B * 2, dtype=np.int32)).reshape(B, 2))
    procs = mp.start_reference(units + losses + [dec], path)
    ports = mp.on_ranks(mp.rank_moe_jobs, dict(
        units=units, losses=[(a, "fp32", (2, 2), False, batches[a])
                             for a in ARCHS], params=params, decode=dec))
    ref = mp.finish_reference(procs)
    return dict(units=units, ref=ref, port=ports)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"tp{tp}-{form}-{'skewed' if skew else 'random'}"
                              for tp, form, skew in CASES])
def test_moe_ep_forms_equal_reference(runs, i):
    tp, form, skew = CASES[i]
    unit = runs["units"][i]
    out, aux = runs["port"][0]["units"][i]
    jout, jaux = runs["ref"][i]
    cfg = mp._tcfg(UNIT, "fp32")
    n = B * S
    drops = mp.inferred_drops(out.reshape(n, -1), unit["x"].reshape(n, -1),
                              unit["p"], cfg)
    jdrops = mp.inferred_drops(jout.reshape(n, -1),
                               unit["x"].reshape(n, -1), unit["p"], cfg)
    err = float(np.abs(out - jout).max())
    scale = float(np.abs(jout).max())
    print(f"\n{UNIT} {form} tp {tp} {'skewed' if skew else 'random'}: "
          f"max |diff| {err:.3g} of {scale:.3g}; aux {aux:.7f} vs "
          f"{jaux:.7f}; {len(drops)} assignments dropped (reference "
          f"{len(jdrops)})")
    assert all(r["units"][i][1] == aux for r in runs["port"])
    assert err <= 1e-5 * scale
    assert abs(aux - jaux) <= 1e-6
    assert drops == jdrops
    if skew:
        assert drops


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_model_loss_equals_reference_mesh(runs, arch):
    i = ARCHS.index(arch)
    loss = runs["port"][0]["losses"][i]
    jloss = runs["ref"][len(CASES) + i][0]
    rel = abs(loss - jloss) / abs(jloss)
    print(f"\n{arch} fp32 (2, 2): loss {loss:.7f} vs the reference's mesh "
          f"loss {jloss:.7f} (rel {rel:.3g})")
    assert {r["losses"][i] for r in runs["port"]} == {loss}
    assert rel <= 1e-5


def test_decode_step_paged_seq1_equals_reference_mesh(runs):
    got, want = runs["port"][0]["decode"], runs["ref"][-1]
    for step, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        print(f"\n{DECODE['arch']} decode_step_paged step {step}: max "
              f"|diff| {err:.3g} of {scale:.3g}")
        assert err <= 1e-5 * scale

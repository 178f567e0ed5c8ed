"""Sharded decoding of the dense (reduced olmo-1b), ssm (mamba2-370m),
hybrid (zamba2-7b) and enc-dec/audio (seamless-m4t-medium) families on
four gloo ranks, (data=2, model=2) and (data=1, model=4), against the
port's one-device decode from the same parameters, ``fp32``
(``tests/test_torch_mesh_parity.py``).

Six ``decode_step`` steps teacher-forced through the same tokens (batch
2, caches of 8 positions and, for the enc-dec family, 8 frames), and for
olmo-1b ``decode_step_paged`` over a pool of 4-line blocks: the caches
come and go in the ``cache_specs`` layout, and each layer's cache is
gathered over ``model`` only around its own step.  Every step's logits
and every final cache leaf, gathered whole, within 1e-5 × the largest
magnitude of the one-device run's (the fp32 tier of
``tests/lm_parity.py``; the heads split over ``model`` sum their floats
in the same order, so these read 0 or a few ulps).
"""
import numpy as np
import pytest
import torch

import test_torch_mesh_parity as mp

torch.set_num_threads(1)

ARCHS = ("olmo-1b", "mamba2-370m", "zamba2-7b", "seamless-m4t-medium")
CASES = [(a, m, False) for a in ARCHS for m in mp.MESHES] + \
    [("olmo-1b", m, True) for m in mp.MESHES]
STEPS, B = 6, 2


@pytest.fixture(scope="module")
def runs():
    params = {a: mp.numpy_params(a) for a in ARCHS}
    rng = np.random.default_rng(7)
    toks = {a: rng.integers(0, mp._tcfg(a, "fp32").vocab_size,
                            size=(STEPS, B, 1)).astype(np.int32)
            for a in ARCHS}
    ranks = mp.on_ranks(mp.rank_decode, dict(cases=CASES, params=params,
                                             toks=toks))
    one = {(a, paged): mp.decode_run(a, params[a], toks[a], paged=paged)
           for a, _, paged in CASES}
    return ranks, one


@pytest.mark.parametrize("i", range(len(CASES)), ids=[
    f"{a}-{m[0]}x{m[1]}" + ("-paged" if p else "") for a, m, p in CASES])
def test_decode_equals_one_device(runs, i):
    ranks, one = runs
    arch, mesh, paged = CASES[i]
    logits, caches = ranks[0][i]
    want_logits, want_caches = one[arch, paged]
    worst = mp.leaf_rel_max(logits, want_logits)
    cworst = mp.leaf_rel_max(caches, want_caches)
    print(f"\n{arch} {mesh}{' paged' if paged else ''}: logits max |diff| "
          f"/ max {worst:.3g} over {STEPS} steps; caches {cworst:.3g}")
    assert all(np.array_equal(a, b) for r in ranks[1:]
               for a, b in zip(r[i][0], logits))
    assert [c.shape for c in caches] == [c.shape for c in want_caches]
    assert worst <= 1e-5 and cworst <= 1e-5

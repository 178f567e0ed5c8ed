"""Sharded decoding of the dense (reduced olmo-1b), ssm (mamba2-370m),
hybrid (zamba2-7b) and enc-dec/audio (seamless-m4t-medium) families on
four gloo ranks, (data=2, model=2) and (data=1, model=4), against the
port's one-device decode from the same parameters, ``fp32``
(``tests/test_torch_mesh_parity.py``).

Six ``decode_step`` steps teacher-forced through the same tokens (batch
2, caches of 8 positions and, for the enc-dec family, 8 frames), and for
olmo-1b ``decode_step_paged`` over a pool of 4-line blocks: the caches
come and go in the ``cache_specs`` layout and no leaf is gathered over
``model``: each rank steps its own block of every KV cache, Mamba2 cache
and ``enc_out``.  Four of the cases run
again with ``donate=True`` and equal the functional mesh run bit for
bit.  Every step's logits
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
#: The cases run again with ``donate=True``.
DONATED = [CASES.index(c) for c in (
    ("olmo-1b", (2, 2), False), ("olmo-1b", (2, 2), True),
    ("zamba2-7b", (2, 2), False), ("seamless-m4t-medium", (1, 4), False))]


@pytest.fixture(scope="module")
def runs():
    params = {a: mp.numpy_params(a) for a in ARCHS}
    rng = np.random.default_rng(7)
    toks = {a: rng.integers(0, mp._tcfg(a, "fp32").vocab_size,
                            size=(STEPS, B, 1)).astype(np.int32)
            for a in ARCHS}
    ranks = mp.on_ranks(mp.rank_decode, dict(cases=CASES, params=params,
                                             toks=toks, donated=DONATED))
    one = {(a, paged): mp.decode_run(a, params[a], toks[a], paged=paged)
           for a, _, paged in CASES}
    return ranks, one


@pytest.mark.parametrize("j", range(len(DONATED)), ids=[
    f"{CASES[i][0]}-{CASES[i][1][0]}x{CASES[i][1][1]}"
    + ("-paged" if CASES[i][2] else "") for i in DONATED])
def test_donated_decode_equals_functional_on_the_mesh(runs, j):
    """The donating steps write each layer's new cache into the rank's
    local slice of the stacked caches and return them (checked on the
    ranks); every step's logits and the final caches equal the
    functional mesh run's bit for bit on every rank."""
    ranks, _ = runs
    for r in ranks:
        logits, caches = r["donated"][j]
        want_logits, want_caches = r["runs"][DONATED[j]]
        assert all(np.array_equal(a, b) for a, b in zip(logits,
                                                        want_logits))
        assert all(np.array_equal(a, b) for a, b in zip(caches,
                                                        want_caches))


@pytest.mark.parametrize("i", range(len(CASES)), ids=[
    f"{a}-{m[0]}x{m[1]}" + ("-paged" if p else "") for a, m, p in CASES])
def test_decode_equals_one_device(runs, i):
    ranks, one = runs
    ranks = [r["runs"] for r in ranks]
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


def test_collective_counter_fake_world_equals_gloo(runs):
    """``count_collectives`` on a fake (2, 2) world of ``meta`` tensors
    counts, call by call and kind by kind, the bytes it counts on the
    four gloo ranks for the same ``loss_fn`` with its gradients and the
    same paged decode step (the dry run's counts are the real mesh's)."""
    from repro_torch.launch.dryrun import fake_world
    ranks, _ = runs
    with fake_world((2, 2), mp.AXES) as mesh:
        fake = mp.counted_calls(mesh, "meta")
    print()
    for call, tally in fake.items():
        print(f"{call}: " + ", ".join(f"{k} {v:.0f} B"
                                      for k, v in sorted(tally.items())))
    assert set(fake) == {"olmo-1b loss_fn", "deepseek-v2-lite-16b loss_fn",
                         "olmo-1b decode_step_paged"}
    assert all(fake[c] for c in fake)
    assert "all-to-all" in fake["deepseek-v2-lite-16b loss_fn"]
    assert "reduce-scatter" in fake["olmo-1b loss_fn"]
    for r in ranks:
        assert r["counts"] == fake

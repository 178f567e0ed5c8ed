"""The serve engine's sampler (``repro_torch.resil.prng``: ``gumbel``
and ``categorical`` on the port's threefry) against ``jax.random``.

``categorical`` gives ``jax.random.categorical``'s token on 1200 (key,
logits) draws, the keys folded as the engine folds them
(``fold_in(fold_in(key(seed), rid), token_index)``).  The Gumbel noise is
within 2 float32 ulps of JAX's, an ulp taken at ``max(|g|, 1)``: each
``log`` is within an ulp of XLA's, and the outer ``log`` of a value near 1
keeps the inner one's absolute error, not its relative one.  A draw whose
token differed would fail with the noise gap that caused it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.resil import prng

torch.set_num_threads(1)


def _keys(seed, rid, idx):
    j = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), rid),
                           idx)
    t = prng.fold_in(prng.fold_in(prng.prng_key(seed), rid), idx)
    return j, t


def _ulps_at_scale(got, want):
    want = np.asarray(want, np.float64)
    scale = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    return np.abs(np.asarray(got, np.float64) - want) / scale


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_categorical_draws_jax_tokens(seed):
    """400 draws per seed over logits of 2, 10, 64 or 257 classes at
    temperatures 0.3 to 2: the token equals
    ``jax.random.categorical``'s."""
    rng = np.random.default_rng(seed)
    flips = []
    for rid in range(20):
        for idx in range(20):
            n = int(rng.choice([2, 10, 64, 257]))
            t = float(rng.choice([0.3, 0.8, 2.0]))
            logits = (rng.normal(size=n) * 3).astype(np.float32) / \
                np.float32(t)
            jk, tk = _keys(seed, rid, idx)
            want = int(jax.random.categorical(jk, jnp.asarray(logits)))
            got = int(prng.categorical(tk, torch.from_numpy(logits)))
            if got != want:
                gap = _ulps_at_scale(prng.gumbel(tk, (n,)).numpy(),
                                     jax.random.gumbel(jk, (n,))).max()
                flips.append((rid, idx, got, want, gap))
    assert not flips, f"draws that differ (rid, idx, port, jax, ulps): " \
                      f"{flips}"


def test_gumbel_noise_within_2_ulps():
    """The noise of 200 keys × 512 draws within 2 ulps (at max(|g|, 1)) of
    ``jax.random.gumbel``'s, and bit-equal in most draws."""
    worst, equal, total = 0.0, 0, 0
    for rid in range(200):
        jk, tk = _keys(3, rid, rid % 7)
        want = np.asarray(jax.random.gumbel(jk, (512,)))
        got = prng.gumbel(tk, (512,)).numpy()
        assert got.dtype == want.dtype == np.float32
        worst = max(worst, float(_ulps_at_scale(got, want).max()))
        equal += int((got == want).sum())
        total += want.size
    print(f"\ngumbel: worst {worst:.3g} ulps at max(|g|, 1); "
          f"{equal / total:.4f} of draws bit-equal")
    assert worst <= 2.0
    assert equal / total > 0.5


def test_gumbel_floor_and_device_free():
    """The uniform floor is float32's tiny, as JAX's ``uniform(minval=
    tiny)``: a zero draw gives a finite noise; the noise is computed in
    float64 logs, so it is the same on any device."""
    g = prng.gumbel(prng.prng_key(0), (4096,))
    assert torch.isfinite(g).all()
    u = torch.zeros(3)
    tiny = torch.tensor(prng.F32_TINY)
    floor = torch.maximum(u * (1.0 - tiny) + tiny, tiny)
    assert torch.equal(floor, torch.full((3,), prng.F32_TINY))

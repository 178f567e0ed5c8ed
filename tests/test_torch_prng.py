"""The port's threefry (``repro_torch.resil.prng``) against ``jax.random``
bit for bit: ``PRNGKey``, ``fold_in`` (with a Python int and with an int32
tensor step, as the fault sites key it), ``split``, ``uniform`` and
``randint``, over several seeds and the shapes the fault sites draw at
(the paper MLP's weights, biases and activations, and an odd shape)."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.resil import prng

torch.set_num_threads(1)

SEEDS = [0, 3, 42, 2**31 - 1, -5]
SHAPES = [(784, 100), (100,), (100, 10), (5, 100), (7, 13, 3)]
SITE = zlib.crc32(b"hidden/w.w1/flip_w") & 0x7FFFFFFF


def _words(key):
    """A JAX key (typed or raw uint32 pair) as a tuple of ints."""
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return tuple(int(v) for v in np.asarray(key))


def _ints(key):
    return tuple(int(v) for v in key)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert _words(jk) == _ints(tk)
    for data in (0, 1, 7, SITE, 2**31 - 1):
        jf = jax.random.fold_in(jk, data)
        assert _words(jf) == _ints(prng.fold_in(tk, data)), data
        for step in range(21):
            want = _words(jax.random.fold_in(jf, jnp.int32(step)))
            tf = prng.fold_in(tk, data)
            assert _ints(prng.fold_in(tf, step)) == want, (data, step)
            got = prng.fold_in(tf, torch.tensor(step, dtype=torch.int32))
            assert _ints(got) == want, (data, step)
    for num in (2, 3):
        assert ([_words(k) for k in jax.random.split(jk, num)]
                == [_ints(k) for k in prng.split(tk, num)])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform(seed, shape):
    for step in (0, 13):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        tk = prng.fold_in(prng.prng_key(seed), step)
        want = np.asarray(jax.random.uniform(jk, shape))
        got = prng.uniform(tk, shape).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_randint(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for span in range(1, 17):
        want = np.asarray(jax.random.randint(jk, shape, 0, span))
        got = prng.randint(tk, shape, 0, span).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"span {span}")
    want = np.asarray(jax.random.randint(jk, shape, -3, 9))
    np.testing.assert_array_equal(prng.randint(tk, shape, -3, 9).numpy(),
                                  want)


def test_tensor_keys_stay_on_their_device():
    """A tensor step keeps the key and the draws on its device (here the
    CPU): no host value is read."""
    k = prng.fold_in(prng.prng_key(3), torch.tensor(5, dtype=torch.int32))
    assert all(isinstance(w, torch.Tensor) and w.dtype == torch.int64
               for w in k)
    u = prng.uniform(k, (4, 6))
    assert u.dtype == torch.float32 and u.device.type == "cpu"
    want = prng.uniform(prng.fold_in(prng.prng_key(3), 5), (4, 6))
    assert torch.equal(u, want)

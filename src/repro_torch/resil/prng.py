"""JAX's default random generator (threefry2x32) in torch integer ops.

The fault injector (``resil/inject.py``) keys every stochastic fault with
``jax.random`` in the JAX package: ``PRNGKey``, ``fold_in``, ``split``,
``uniform`` and ``randint``.  A faulted run of the port is bit-exact with
the reference only if it draws the same bits, and the card's machine has
no JAX, so this module computes those five functions itself:

* the Threefry-2x32 hash (20 rounds, the key schedule of Salmon et al.
  2011 as ``jax/_src/prng.py`` writes it);
* the **partitionable** scheme (``jax_threefry_partitionable = True``,
  the default of JAX 0.9): ``split`` and ``random_bits`` hash the 64-bit
  index of each output as the counter pair ``(hi, lo)``, and 32-bit bits
  are the xor of the hash's two words.  The scheme is fixed here: a run
  of the JAX package with the flag off draws other bits;
* ``uniform`` maps 32 bits to float32 as JAX does: the top 23 bits as
  the mantissa of a float in [1, 2), minus 1.0;
* ``randint`` draws twice (the key split in two) and combines the draws
  with JAX's span and multiplier, so that the same keys give the same
  integers;
* ``gumbel`` and ``categorical`` as ``jax.random`` draws them (the
  default "low" mode): uniform floats on [tiny, 1), ``-log(-log(u))``,
  and the argmax of ``logits + gumbel``.  The serve engine samples with
  them.  Each ``log`` is taken in float64 and rounded once, the same on
  every device; XLA's float32 ``log`` is within an ulp of that, so the
  noise agrees with JAX's within an ulp of ``max(|g|, 1)`` (the outer
  ``log`` of a value near 1 loses the inner one's last bits), and a draw
  follows JAX's unless two noised logits tie that closely.

A key is a pair ``(k1, k2)`` of uint32 words, each a Python int or a 0-d
int64 tensor.  uint32 arithmetic is carried in int64 and masked after
every add, so the same code runs on Python ints (keys from host
constants), on CPU tensors and on CUDA tensors (a step held on the card:
no host sync).  ``PRNGKey(seed)`` takes the seed's low 32 bits, as JAX
does without 64-bit mode.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter pair ``(x1, x2)`` under the
    key ``(k1, k2)``; every argument a uint32 word (Python int or int64
    tensor, broadcast together).  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def _word(v):
    """A uint32 word from a Python int or an integer tensor (two's
    complement: a negative int32 step becomes 2^32 + step, as JAX's cast
    to uint32 does)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK
    return int(v) & MASK


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: ``(0, seed mod
    2^32)``."""
    return 0, int(seed) & MASK


def fold_in(key: tuple, data) -> tuple:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``
    (``data`` a Python int or a 0-d integer tensor, taken as uint32)."""
    return threefry2x32(key[0], key[1], 0, _word(data))


def split(key: tuple, num: int = 2) -> list:
    """``jax.random.split(key, num)`` (partitionable): key i is the hash
    of the counter pair ``(0, i)``."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key: tuple, shape, device=None) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 holding uint32):
    element n (row-major) is the xor of the hash of ``(n >> 32, n)``."""
    n = math.prod(shape)
    k1, k2 = key
    if device is None:
        device = next((k.device for k in key
                       if isinstance(k, torch.Tensor)), "cpu")
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(shape)


def uniform(key: tuple, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus 1.0."""
    bits = random_bits(key, shape, device)
    one = (bits >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0


def randint(key: tuple, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32 (JAX
    without 64-bit mode): two draws of 32 bits from the key split in two,
    reduced into ``[minval, maxval)`` with JAX's span and multiplier."""
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    offset = (((hi % span) * mult) & MASK) + (lo % span)
    offset = (offset & MASK) % span
    return (offset + minval).to(torch.int32)


#: float32's smallest normal number: the floor of the uniform draws of
#: :func:`gumbel`, as ``jax.random.gumbel`` takes ``finfo.tiny``.
F32_TINY = torch.finfo(torch.float32).tiny


def gumbel(key: tuple, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32 (mode "low"): uniform
    floats on [tiny, 1) — ``max(tiny, u · (1 - tiny) + tiny)`` in float32,
    as JAX's ``uniform(minval=tiny, maxval=1)`` forms them — then
    ``-log(-log(u))``."""
    u = uniform(key, shape, device)
    tiny = torch.tensor(F32_TINY, dtype=torch.float32, device=u.device)
    u = torch.maximum(u * (1.0 - tiny) + tiny, tiny)
    return -_log(-_log(u))


def _log(x):
    """float32 ``log`` taken in float64 and rounded once (torch's float32
    ``log`` strays by up to ~1500 ulps near 1 on the CPU)."""
    return torch.log(x.double()).to(x.dtype)


def categorical(key: tuple, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax (first index on ties) of ``logits + gumbel(key, logits.shape)``
    — the Gumbel-max trick, the noise drawn as ``jax.random`` draws it."""
    g = gumbel(key, tuple(logits.shape), logits.device).to(logits.dtype)
    return torch.argmax(g + logits, dim=-1)

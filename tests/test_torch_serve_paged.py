"""The paged half of serving against the JAX package: ``prefill_chunk``
and ``decode_step_paged`` for the dense, moe-GQA and moe-MLA families,
teacher-forced, at the tiers of ``test_torch_serve_model.py`` (which
holds the dense-cache half); the paged tensor ops bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import model as jmodel
from repro.nn import paged as jpaged
from repro_torch.nn import model as tmodel
from repro_torch.nn import paged as tpaged

from test_torch_serve_model import ARCHS, MODES, Pair, _prompt, _t

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", list(ARCHS))
def test_prefill_chunk_and_decode_step_paged(family, mode):
    """Paged caches of 9 blocks of 4 lines: a 6-token prompt spliced into
    slot 1's scrambled blocks in chunks of 4 (the second padded), then
    two batched ``decode_step_paged`` over three slots, the middle one
    inactive (its line goes to the null block)."""
    pr = Pair(family, mode)
    print(f"\n{family} {mode}")
    nb, bs, w = 9, 4, 3
    caches = jmodel.init_paged_caches(pr.jcfg, nb, bs, jnp.float32)
    bt = np.array([[3, 8, 1], [6, 2, 5], [4, 7, 0]], np.int32)
    prompt = _prompt(pr.jcfg, 1, 6, seed=3)[0]
    chunk = pr.jit(jmodel.prefill_chunk)
    for base in (0, 4):
        part = prompt[base:base + 4]
        toks = np.zeros((1, 4), np.int32)
        toks[0, :len(part)] = part
        args = (jnp.asarray(bt[1]), jnp.int32(base), jnp.int32(len(part)))
        jl, jnew = chunk(pr.jp, jnp.asarray(toks), caches, *args)
        tl, tnew = tmodel.prefill_chunk(
            pr.tp, torch.from_numpy(toks), _t(caches),
            torch.from_numpy(bt[1]), base, len(part), pr.tcfg)
        pr.check(f"chunk @{base} logits", tl, jl)
        pr.check_caches(f"chunk @{base} pages", tnew, jnew)
        caches = jnew
    dec = pr.jit(jmodel.decode_step_paged)
    pos = np.array([2, 6, 9], np.int32)
    active = np.array([True, False, True])
    for i in range(2):
        tok = _prompt(pr.jcfg, 3, 1, seed=20 + i)
        jl, jnew = dec(pr.jp, jnp.asarray(tok), caches, jnp.asarray(bt),
                       jnp.asarray(pos), jnp.asarray(active))
        tl, tnew = tmodel.decode_step_paged(
            pr.tp, torch.from_numpy(tok), _t(caches), torch.from_numpy(bt),
            torch.from_numpy(pos), torch.from_numpy(active), pr.tcfg)
        for s in np.flatnonzero(active):
            pr.check(f"paged decode {i} slot {s} logits", tl[s], jl[s])
        pr.check_caches(f"paged decode {i} pages", tnew, jnew)
        caches, pos = jnew, pos + 1


def test_paged_ops_equal_reference():
    """Token and chunk writes through a scrambled block table (a chunk
    crossing a block boundary, padding, an inactive slot, a position
    past the table) and the gathered view: the reference's pages, value
    for value."""
    rng = np.random.default_rng(0)
    nb, bs, kv, hd = 7, 4, 2, 3
    pages = rng.normal(size=(nb, bs, kv, hd)).astype(np.float32)
    bt = np.array([[5, 1, 4], [2, 6, 3]], np.int32)
    vals = rng.normal(size=(8, kv, hd)).astype(np.float32)
    j = jpaged.paged_write_chunk(jnp.asarray(pages), jnp.asarray(bt[0]),
                                 jnp.int32(2), jnp.asarray(vals),
                                 jnp.int32(6))
    t = tpaged.paged_write_chunk(torch.from_numpy(pages),
                                 torch.from_numpy(bt[0]), 2,
                                 torch.from_numpy(vals), 6)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    pos = np.array([9, 13], np.int32)
    for active in ([True, True], [True, False]):
        tok = rng.normal(size=(2, kv, hd)).astype(np.float32)
        j = jpaged.paged_write_token(j, jnp.asarray(bt), jnp.asarray(pos),
                                     jnp.asarray(tok), jnp.asarray(active))
        t = tpaged.paged_write_token(t, torch.from_numpy(bt),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(tok),
                                     torch.tensor(active))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        tpaged.paged_gather(t, torch.from_numpy(bt)).numpy(),
        np.asarray(jpaged.paged_gather(j, jnp.asarray(bt))))
    assert tpaged.NULL_BLOCK == jpaged.NULL_BLOCK

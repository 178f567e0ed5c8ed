"""The Mamba2 decode step and the enc-dec cross-attention over caches
split over the model axis, against the whole caches, in one process.

Under a mesh each rank holds its block of a Mamba2 conv cache's channels
and of its state's heads, and its block of ``enc_out``'s frames
(``cache_specs``).  ``ssm.mamba2_decode`` steps its own channels and
heads, joining the conv outputs and ``y`` by two gathers over the ranks;
``_cross_attention`` projects K and V over its own frames and combines
its softmax with the other ranks' (``attention.combine_softmax``).  Here
R ∈ {2, 4} ranks are threads of this process
(``test_torch_kv_split.Ranks``):

* ``mamba2_decode`` of a reduced mamba2-370m and zamba2-7b layer, three
  steps in a row: every rank's output within 1e-5 × the whole step's
  largest magnitude (the fp32 tier of ``tests/lm_parity.py``; in
  practice bit for bit), and the ranks' conv and state blocks put
  together equal to the whole step's bit for bit (the activations, Δt
  and the decay are taken on whole tensors, the rest per element);
* ``_cross_attention`` at S = 1 (only rank 0 holds an unmasked frame)
  and at an S whose band crosses a block edge;
* the whole ``decode_step`` of reduced mamba2-370m, zamba2-7b and
  seamless-m4t-medium, functional and donating, each thread handed its
  share through ``nn/model.py: _kv_split``: logits within the tier, the
  caches put together equal to the one-device step's, bit for bit for
  the ssm family and within the tier where a layer's input has been
  through a combined softmax (bit for bit too, in practice).
"""
import threading

import numpy as np
import pytest
import torch
from test_torch_kv_split import TIER, Ranks, _close, _gap

from repro_torch import configs as tconfigs
from repro_torch.configs import reduced
from repro_torch.core.numerics import get_policy
from repro_torch.distributed.sharding import (_entry_axes, cache_specs,
                                              map_with_path)
from repro_torch.nn import decode_step, init_decode_caches, init_params
from repro_torch.nn import model as M
from repro_torch.nn import ssm as S

torch.set_num_threads(1)

SSM_ARCHS = ("mamba2-370m", "zamba2-7b")


def _cfg(arch):
    return reduced(tconfigs.get_config(arch)).with_(numerics="fp32")


def _pol():
    return M._ServePol(get_policy("fp32"), False)


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("n", [2, 4])
def test_mamba2_decode_split_equals_whole(arch, n):
    """Three steps from a random cache; the reduced layers have 160 conv
    channels and 8 heads of 16, so at R = 2 a rank's channel block (80)
    does not line up with its heads' 64 channels of ``x``."""
    cfg, pol = _cfg(arch), _pol()
    rng = np.random.default_rng(11)
    b = 3
    p = M._unstack(init_params(0, cfg, device="cpu")["layers"])[0]["mamba"]
    cache = S.SSMCache(*(_t(rng, *t.shape) for t in
                         S.make_ssm_cache(cfg, b, torch.float32)))
    xs = [_t(rng, b, 1, cfg.d_model) for _ in range(3)]
    want, whole = [], cache
    for x in xs:
        o, whole = S.mamba2_decode(p, x, cfg, pol, whole)
        want.append(o)
    ranks = Ranks(n)

    def rank(r):
        c = S.SSMCache(cache.conv.chunk(n, 2)[r].clone(),
                       cache.state.chunk(n, 1)[r].clone())
        outs = []
        for x in xs:
            o, c = S.mamba2_decode(p, x, cfg, pol, c, ranks.split(r))
            outs.append(o)
        return outs, c
    res = ranks.run(rank)
    for outs, _ in res[1:]:
        assert all(torch.equal(a, b_) for a, b_ in zip(outs, res[0][0]))
    for got, w in zip(res[0][0], want):
        assert _close(got, w), _gap(got, w)
    assert torch.equal(torch.cat([c.conv for _, c in res], 2), whole.conv)
    assert torch.equal(torch.cat([c.state for _, c in res], 1), whole.state)


@pytest.mark.parametrize("n,leaf", [(3, "conv cache's channels"),
                                    (5, "state's heads")])
def test_mamba2_decode_refuses_a_split_that_does_not_divide(n, leaf):
    """160 channels over 3 ranks, 8 heads over 5: a ValueError naming the
    leaf, never a silent cut."""
    cfg, pol = _cfg("mamba2-370m"), _pol()
    p = M._unstack(init_params(0, cfg, device="cpu")["layers"])[0]["mamba"]
    cache = S.make_ssm_cache(cfg, 2, torch.float32)
    ranks = Ranks(n)
    with pytest.raises(ValueError, match=leaf):
        S.mamba2_decode(p, torch.zeros(2, 1, cfg.d_model), cfg, pol, cache,
                        ranks.split(0))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("s", [1, 10])
def test_cross_attention_split_equals_whole(n, s):
    """16 frames: S = 1 reads frame 0 alone (every rank but 0 wholly
    masked); S = 10 reads frames 0-9, across rank 0's block edge (and at
    R = 4 into rank 2's block)."""
    cfg, pol = _cfg("seamless-m4t-medium"), _pol()
    rng = np.random.default_rng(12)
    b, t = 2, 16
    lp = M._unstack(init_params(0, cfg, device="cpu")["layers"])[0]["xattn"]
    q_in = _t(rng, b, s, cfg.d_model)
    enc_out = _t(rng, b, t, cfg.d_model)
    want, (wk, wv) = M._cross_attention(lp, q_in, enc_out, cfg, pol)
    blocks = [c.clone() for c in enc_out.chunk(n, 1)]
    ranks = Ranks(n)
    res = ranks.run(lambda r: M._cross_attention(
        lp, q_in, blocks[r], cfg, pol, split=ranks.split(r)))
    for o, _ in res[1:]:
        assert torch.equal(o, res[0][0])
    assert _close(res[0][0], want), _gap(res[0][0], want)
    for got, w in ((torch.cat([c.k for _, c in res], 1), wk),
                   (torch.cat([c.v for _, c in res], 1), wv)):
        assert _close(got, w), _gap(got, w)


# -------------------------------------------------- the decode steps -----
def _model_dims(leaf_spec):
    return [d for d, e in enumerate(leaf_spec) if "model" in _entry_axes(e)]


def _cut(caches, r, n):
    """Rank r's share of whole caches in the ``cache_specs`` layout."""
    return map_with_path(
        lambda _p, t, sp: t.chunk(n, _model_dims(sp)[0])[r].clone()
        if _model_dims(sp) else t.clone(), caches,
        cache_specs(caches, (), "model"))


def _joined(shares, like):
    """The ranks' shares put together along their model dims."""
    return map_with_path(
        lambda _p, t, sp, *rest: torch.cat((t,) + rest, _model_dims(sp)[0])
        if _model_dims(sp) else t, shares[0], cache_specs(like, (), "model"),
        *shares[1:])


def _leaves(tree):
    out = []
    map_with_path(lambda p, t: out.append((p, t)), tree)
    return out


STEPS, B, MAX_LEN = 3, 2, 8


def _decode_run(cfg, params, caches, donate=False):
    """``STEPS`` decode steps of ``B`` slots from positions 3 and 5:
    every step's logits and the final caches."""
    rng = np.random.default_rng(13)
    pos = torch.tensor([3, 5], dtype=torch.int32)
    logits = []
    for _ in range(STEPS):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, 1))
                               .astype(np.int32))
        given = [t for _, t in _leaves(caches)]
        lg, caches = decode_step(params, tok, caches, pos, cfg,
                                 donate=donate)
        if donate:
            assert all(a is b for (_, a), b in zip(_leaves(caches), given))
        logits.append(lg)
        pos = pos + 1
    return logits, caches


@pytest.mark.parametrize("arch", SSM_ARCHS + ("seamless-m4t-medium",))
@pytest.mark.parametrize("n", [2, 4])
def test_decode_step_split_equals_one_device(arch, n, monkeypatch):
    cfg = _cfg(arch)
    params = init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(14)
    start = map_with_path(
        lambda _p, t: _t(rng, *t.shape),
        init_decode_caches(cfg, B, MAX_LEN, torch.float32, enc_len=MAX_LEN,
                           device="cpu"))
    with torch.no_grad():
        want_logits, want = _decode_run(cfg, params, map_with_path(
            lambda _p, t: t.clone(), start))
    ranks = Ranks(n)
    local = threading.local()
    monkeypatch.setattr(M, "_kv_split", lambda rt: local.split)

    def rank(r, donate):
        local.split = ranks.split(r)
        with torch.no_grad():
            return _decode_run(cfg, params, _cut(start, r, n), donate)
    # The ssm family's step is the Mamba2 steps' and replicated ops alone;
    # elsewhere a layer's input has been through a combined softmax,
    # whose float64 sums run in another order.
    exact = cfg.family == "ssm"
    for donate in (False, True):
        outs = ranks.run(lambda r: rank(r, donate))
        worst = max(_gap(g, w) for g, w in zip(outs[0][0], want_logits))
        print(f"\n{arch} split over {n} (donate={donate}): logits max "
              f"|diff| / max {worst:.3g}")
        for logits, _ in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(logits, outs[0][0]))
        assert worst <= TIER
        joined = _joined([c for _, c in outs], want)
        for (path, got), (_, w) in zip(_leaves(joined), _leaves(want)):
            assert torch.equal(got, w) if exact else _close(got, w), (
                path, _gap(got, w))

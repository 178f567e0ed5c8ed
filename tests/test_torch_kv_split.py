"""Decode attention over caches split over the model axis, against the
whole cache, in one process.

Under a mesh each rank holds a contiguous block of a dense cache's
sequence, or of each paged block's lines (``cache_specs``), writes only
the lines it holds and combines its softmax with the other ranks'
(``nn/attention.py: KVSplit``, ``combine_softmax``).  Here R ∈ {2, 4}
ranks are threads of this process whose reductions stack the ranks'
tensors in rank order (:class:`Ranks`):

* each serving attention function (GQA and MLA; dense decode, paged
  decode, a paged prefill chunk) on every rank's share equals the whole
  cache's output within 1e-5 × its largest magnitude (the fp32 tier of
  ``tests/lm_parity.py``; in practice bit for bit), and the ranks' shares
  written put together are the whole cache written, bit for bit.  The
  positions put a new line on a rank's first line and on a block's, and
  leave some ranks' blocks wholly masked;
* the same for the whole serving steps (``prefill_chunk``, then
  ``decode_step_paged``, functional and donating) of reduced olmo-1b and
  deepseek-v2-lite-16b (MLA, the moe family's dense stack), each thread
  handed its share through ``nn/model.py: _kv_split``;
* R blocks stacked on a leading axis in one call, as ``chip_smoke.py``
  14f runs them on the card;
* on a fake (2, 2) world a small ``decode_32k`` cell of olmo-1b,
  mamba2-370m and seamless-m4t-medium gathers no cache line, no Mamba2
  cache and no ``enc_out``: its all-gathers are the parameters', the
  paged slots' inputs over the data axis and the Mamba2 layers'
  activations, its all-reduces the embedding's and each attention's max
  and float64 sums.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs import reduced
from repro_torch.core.numerics import get_policy
from repro_torch.distributed.sharding import _entry_axes, param_specs
from repro_torch.distributed.spmd import wire_bytes
from repro_torch.launch import dryrun as D
from repro_torch.nn import (decode_step_paged, init_paged_caches,
                            init_params, prefill_chunk)
from repro_torch.nn import attention as A
from repro_torch.nn import model as M
from repro_torch.nn.config import ShapeCell
from repro_torch.nn.layers import ORDER_FREE
from repro_torch.nn.paged import paged_gather, paged_positions

torch.set_num_threads(1)

TIER = 1e-5


class Ranks:
    """``n`` ranks as threads of this process; ``split(r)`` is rank r's
    share, its reductions and its gather over the ranks' tensors stacked
    in rank order."""

    def __init__(self, n):
        self.n = n
        self.bar = threading.Barrier(n, timeout=120)
        self.slot = [None] * n

    def _reduce(self, rank, t, fn):
        self.slot[rank] = t
        self.bar.wait()
        out = fn(torch.stack(self.slot))
        self.bar.wait()
        return out

    def split(self, rank):
        return A.KVSplit(rank, self.n,
                         lambda t: self._reduce(rank, t,
                                                lambda s: s.amax(0)),
                         lambda t: self._reduce(rank, t,
                                                lambda s: s.sum(0)),
                         lambda t, dim: self._reduce(
                             rank, t, lambda s: torch.cat(list(s), dim)))

    def run(self, fn):
        """``fn(rank)`` on every rank at once; the results in rank
        order."""
        out, err = [None] * self.n, []

        def go(r):
            try:
                out[r] = fn(r)
            except BaseException as e:        # noqa: BLE001
                err.append(e)
                self.bar.abort()
        ts = [threading.Thread(target=go, args=(r,)) for r in range(self.n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in ts)
        if err:
            raise err[0]
        return out


def _cfg(arch):
    return reduced(tconfigs.get_config(arch)).with_(numerics="fp32")


def _pol():
    return M._ServePol(get_policy("fp32"), False)


def _attn_params(cfg, seed=0):
    return M._unstack(init_params(seed, cfg, device="cpu")["layers"])[0][
        "attn"]


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _close(got, want):
    return (got - want).abs().max().item() <= \
        TIER * want.abs().max().item()


def _gap(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


def _shares(t, dim, n):
    return [c.clone() for c in t.chunk(n, dim)]


def _hold(outs, whole, paged=False):
    """Every rank's output (``outs[r]``: output, cache share) within the
    tier of the whole cache's, the ranks' outputs equal, and the shares
    written put together equal to the whole cache written; in a pool
    (``paged``) but for the null block, which takes the padding's and
    the inactive slots' lines in any order and is never read."""
    o, c = whole
    for got in outs:
        assert torch.equal(got[0], outs[0][0])
    assert _close(outs[0][0], o), _gap(outs[0][0], o)
    lo = 1 if paged else 0
    for i in range(2):
        joined = torch.cat([out[1][i] for out in outs], 1)
        assert torch.equal(joined[lo:], c[i][lo:])


def _mla(cfg):
    return cfg.attn_kind == "mla"


def _cache_dims(cfg):
    if _mla(cfg):
        return ((cfg.mla.kv_lora_rank,), (cfg.mla.rope_head_dim,))
    return ((cfg.n_kv_heads, cfg.d_head),) * 2


#: (arch, R, positions): a line on rank 0 only (the others masked), on a
#: rank's first line, on the last line.
DENSE = [(a, r) for a in ("qwen3-1.7b", "deepseek-v2-lite-16b")
         for r in (2, 4)]


@pytest.mark.parametrize("arch,n", DENSE)
@pytest.mark.parametrize("inplace", [False, True])
def test_dense_decode_split_equals_whole(arch, n, inplace):
    cfg, pol = _cfg(arch), _pol()
    rng = np.random.default_rng(1)
    b, s = 4, 16
    p = _attn_params(cfg)
    x = _t(rng, b, 1, cfg.d_model)
    kv = [_t(rng, b, s, *d) for d in _cache_dims(cfg)]
    sl = s // n
    # Row 0: every rank but 0 masked; row 1: the first line of rank 1's
    # block; row 2: inside; row 3: the last line of the cache.
    pos = torch.tensor([1, sl, s - sl - 2, s - 1], dtype=torch.int32)
    fn = A.mla_decode if _mla(cfg) else A.gqa_decode
    whole = fn(p, x, cfg, pol, A.KVCache(*(t.clone() for t in kv)), pos)
    shares = list(zip(*(_shares(t, 1, n) for t in kv)))
    ranks = Ranks(n)

    def rank(r):
        c = A.KVCache(*shares[r])
        o, c2 = fn(p, x, cfg, pol, c, pos, ranks.split(r), inplace)
        assert all((a is b) == inplace for a, b in zip(c2, c))
        return o, c2
    outs = ranks.run(rank)
    _hold(outs, whole)


def test_dense_decode_every_row_on_rank_zero():
    """Every row's line on rank 0: the other ranks' blocks are masked
    for the whole batch, and they write nothing."""
    cfg, pol = _cfg("qwen3-1.7b"), _pol()
    rng = np.random.default_rng(2)
    b, s, n = 3, 16, 4
    p = _attn_params(cfg)
    x = _t(rng, b, 1, cfg.d_model)
    kv = [_t(rng, b, s, *d) for d in _cache_dims(cfg)]
    pos = torch.tensor([0, 2, 3], dtype=torch.int32)
    whole = A.gqa_decode(p, x, cfg, pol, A.KVCache(*(t.clone() for t in kv)),
                         pos)
    shares = list(zip(*(_shares(t, 1, n) for t in kv)))
    ranks = Ranks(n)
    outs = ranks.run(lambda r: A.gqa_decode(
        p, x, cfg, pol, A.KVCache(*shares[r]), pos, ranks.split(r)))
    _hold(outs, whole)
    for r in range(1, n):
        assert all(torch.equal(outs[r][1][i], shares[r][i])
                   for i in range(2))


def _pool(rng, cfg, nb, bs):
    return [_t(rng, nb, bs, *d) for d in _cache_dims(cfg)]


PAGED = [(a, r) for a in ("qwen3-1.7b", "deepseek-v2-lite-16b")
         for r in (2, 4)]


@pytest.mark.parametrize("arch,n", PAGED)
def test_paged_decode_split_equals_whole(arch, n):
    """Five slots of four 8-line blocks; slot 4 inactive (its line goes
    to the null block).  New lines on a block's first line, on rank
    n-1's first line, in the middle, and early (only rank 0 holds an
    unmasked line)."""
    cfg, pol = _cfg(arch), _pol()
    rng = np.random.default_rng(3)
    b, w, bs = 5, 4, 8
    p = _attn_params(cfg)
    x = _t(rng, b, 1, cfg.d_model)
    pool = _pool(rng, cfg, 1 + b * w, bs)
    bt = torch.from_numpy(1 + rng.permutation(b * w).reshape(b, w)
                          .astype(np.int32))
    bsl = bs // n
    pos = torch.tensor([2 * bs, bs + (n - 1) * bsl, 3 * bs - 3, 1, 9],
                       dtype=torch.int32)
    active = torch.tensor([True, True, True, True, False])
    fn = A.mla_decode_paged if _mla(cfg) else A.gqa_decode_paged
    whole = fn(p, x, cfg, pol, A.KVCache(*(t.clone() for t in pool)), bt,
               pos, active)
    shares = list(zip(*(_shares(t, 1, n) for t in pool)))
    ranks = Ranks(n)
    outs = ranks.run(lambda r: fn(p, x, cfg, pol, A.KVCache(*shares[r]),
                                  bt, pos, active, None, ranks.split(r)))
    _hold(outs, whole, paged=True)


@pytest.mark.parametrize("arch,n", PAGED)
def test_paged_prefill_chunk_split_equals_whole(arch, n):
    """A chunk of C = 12 queries from position 5, 10 valid: it crosses
    block and rank boundaries, and its padding goes to the null block."""
    cfg, pol = _cfg(arch), _pol()
    rng = np.random.default_rng(4)
    w, bs, c = 4, 8, 12
    p = _attn_params(cfg)
    x = _t(rng, 1, c, cfg.d_model)
    pool = _pool(rng, cfg, 1 + 2 * w, bs)
    bt_row = torch.tensor([3, 7, 1, 5], dtype=torch.int32)
    fn = A.mla_prefill_paged if _mla(cfg) else A.gqa_prefill_paged
    whole = fn(p, x, cfg, pol, A.KVCache(*(t.clone() for t in pool)),
               bt_row, 5, 10)
    shares = list(zip(*(_shares(t, 1, n) for t in pool)))
    ranks = Ranks(n)
    outs = ranks.run(lambda r: fn(p, x, cfg, pol, A.KVCache(*shares[r]),
                                  bt_row, 5, 10, ranks.split(r)))
    _hold(outs, whole, paged=True)


@pytest.mark.parametrize("n", [2, 4])
def test_stacked_blocks_in_one_call_equal_whole(n):
    """R ranks' blocks of a paged view stacked on a leading axis, the
    reductions over that axis: one ``_sdpa_split`` call (``chip_smoke.py``
    14f) against ``_sdpa_block`` over the whole view."""
    rng = np.random.default_rng(5)
    b, w, bs, kv, g, hd = 3, 4, 8, 2, 2, 16
    pages = [_t(rng, 1 + b * w, bs, kv, hd) for _ in range(2)]
    bt = torch.from_numpy(1 + rng.permutation(b * w).reshape(b, w)
                          .astype(np.int32))
    pos = torch.tensor([0, 13, 31], dtype=torch.int32)
    q = _t(rng, b, 1, kv, g, hd)
    k, v = (paged_gather(t, bt) for t in pages)
    kpos = paged_positions(w, bs)
    mask = (kpos[None, :] <= pos[:, None])[:, None, None, None, :]
    want = A._sdpa_block(q, k, v, hd ** -0.5, mask, ORDER_FREE)
    bsl = bs // n
    ks, vs = (torch.stack([paged_gather(t[:, r * bsl:(r + 1) * bsl], bt)
                           for r in range(n)]) for t in pages)
    kpos = torch.stack([paged_positions(w, bsl, r, n) for r in range(n)])
    mask = (kpos[:, None, :] <= pos[None, :, None])[:, :, None, None, None]
    got = A._sdpa_split(q, ks, vs, hd ** -0.5, mask, ORDER_FREE,
                        lambda t: t.amax(0, keepdim=True),
                        lambda t: t.sum(0, keepdim=True))[0]
    assert got.shape == want.shape
    assert _close(got, want), _gap(got, want)


# ------------------------------------------------- the serving steps -----
def _serve_run(cfg, params, share=None, ranks=None, donate=False):
    """``prefill_chunk`` of two prompts (7 and 5 tokens, chunks of 4) into
    slots of three 4-line blocks, then three ``decode_step_paged`` steps
    of both slots: every call's logits and the final pool.  With
    ``ranks``, thread ``share``'s pool is its share of each block."""
    rng = np.random.default_rng(6)
    bs, w, n = 4, 3, 1 if ranks is None else ranks.n
    caches = init_paged_caches(cfg, 1 + 2 * w, bs, torch.float32,
                               device="cpu")
    if ranks is not None:
        caches = {k: A.KVCache(*(t.chunk(n, 2)[share].clone() for t in c))
                  for k, c in caches.items()}
    bt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    prompts = [rng.integers(0, cfg.vocab_size, size=m) for m in (7, 5)]
    logits = []
    for slot, prompt in enumerate(prompts):
        for base in range(0, len(prompt), 4):
            chunk = np.zeros(4, np.int32)
            valid = min(4, len(prompt) - base)
            chunk[:valid] = prompt[base:base + valid]
            lg, caches = prefill_chunk(params, torch.from_numpy(chunk)[None],
                                       caches, bt[slot], base, valid, cfg)
            logits.append(lg)
    pos = torch.tensor([7, 5], dtype=torch.int32)
    for _ in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 1))
                               .astype(np.int32))
        lg, caches = decode_step_paged(params, tok, caches, bt, pos,
                                       torch.ones(2, dtype=torch.bool), cfg,
                                       donate=donate)
        logits.append(lg)
        pos = pos + 1
    return logits, caches


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b"])
def test_serving_steps_split_equal_one_device(arch, monkeypatch):
    cfg = _cfg(arch)
    params = init_params(0, cfg, device="cpu")
    with torch.no_grad():
        want_logits, want = _serve_run(cfg, params)
    n = 2
    ranks = Ranks(n)
    local = threading.local()
    monkeypatch.setattr(M, "_kv_split", lambda rt: local.split)

    def rank(r, donate):
        local.split = ranks.split(r)
        with torch.no_grad():
            return _serve_run(cfg, params, r, ranks, donate)
    for donate in (False, True):
        outs = ranks.run(lambda r: rank(r, donate))
        worst = max(_gap(g, w_) for g, w_ in zip(outs[0][0], want_logits))
        print(f"\n{arch} split over {n} (donate={donate}): logits max "
              f"|diff| / max {worst:.3g}")
        for logits, _ in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(logits, outs[0][0]))
        assert worst <= TIER
        for key, c in want.items():           # the null block aside
            for i in range(2):
                joined = torch.cat([o[1][key][i] for o in outs], 2)[:, 1:]
                assert _close(joined, c[i][:, 1:]), _gap(joined,
                                                         c[i][:, 1:])


# -------------------------------------------------- the fake world -------
def _gather_wire(local_bytes, sizes):
    """Bytes on the wire of gathering a leaf of ``local_bytes`` over axes
    of ``sizes``, one after another."""
    out, wire = local_bytes, 0.0
    for g in sizes:
        out *= g
        wire += wire_bytes("all-gather", out, g)
    return wire


def _param_wire(scfg, sizes):
    """Bytes on the wire of gathering every parameter a decode step of
    ``scfg`` reads but the token table, which the vocab-parallel lookup
    reads in place (the encoder's are not read: ``enc_out`` is given)."""
    params = init_params(0, scfg, device="meta")
    want = 0.0

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                yield from leaves(v, path)
            else:
                yield path, v
    specs = dict(leaves(param_specs(params)))
    for path, t in leaves(params):
        if path == "emb/tok" and not scfg.tie_embeddings or \
                path.startswith(("enc_layers/", "frontend_proj")):
            continue
        axes = [a for e in specs[path] for a in reversed(_entry_axes(e))]
        n = 1
        for a in axes:
            n *= sizes[a]
        want += _gather_wire(t.numel() * t.element_size() / n,
                             [sizes[a] for a in axes])
    return want


def _combine_wire(bl, h, hd):
    """One attention's combine over 2 ranks: its max (float32) and its
    two float64 sums."""
    return wire_bytes("all-reduce", bl * h * 4, 2) + wire_bytes(
        "all-reduce", bl * h * 8, 2) + wire_bytes("all-reduce",
                                                  bl * h * hd * 8, 2)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m",
                                  "seamless-m4t-medium"])
def test_fake_world_decode_gathers_no_cache(arch):
    """A small ``decode_32k`` cell on a fake (2, 2) world gathers no
    cache leaf and no ``enc_out``.  The all-gathers are the parameters'
    and, by family: olmo-1b's paged step the slots' tables, positions,
    active flags and new K/V lines over ``data`` (the pool's replicas);
    mamba2-370m's dense step, a layer, its conv outputs and its ``y``
    over ``model``; seamless-m4t-medium's nothing more.  The all-reduces
    are the embedding's and each self- and cross-attention's combine."""
    cfg = _cfg(arch).with_(numerics=tconfigs.get_config(arch).numerics)
    cell = ShapeCell("decode_32k", 256, 4, "decode")
    with D.fake_world((2, 2), ("data", "model")) as mesh:
        rec = D.run_cell(cfg, cell, mesh)
    assert rec["ok"]
    scfg = cfg.with_(param_dtype="bfloat16")
    want = _param_wire(scfg, {"data": 2, "model": 2})
    b, bl = cell.global_batch, cell.global_batch // 2
    h, hd = scfg.n_heads, scfg.d_head
    reduce = wire_bytes("all-reduce", bl * scfg.d_model * 2, 2)
    if scfg.family == "dense":
        w = -(-cell.seq_len // 128)
        lines = b * scfg.n_kv_heads * scfg.d_head * 2
        want += sum(wire_bytes("all-gather", nb, 2) for nb in (
            b * w * 4, b * 4, b * 4)) + scfg.layers * 2 * wire_bytes(
                "all-gather", lines, 2)
        reduce += scfg.layers * _combine_wire(bl, h, hd)
    elif scfg.family == "ssm":
        s = scfg.ssm
        d_in = s.expand * scfg.d_model
        conv = d_in + 2 * s.n_groups * s.d_state
        want += scfg.layers * sum(wire_bytes("all-gather", bl * c * 2, 2)
                                  for c in (conv, d_in))
    else:
        reduce += scfg.encdec.n_dec_layers * 2 * _combine_wire(bl, h, hd)
    coll = rec["collectives"]
    print(f"\nall-gather {coll['all-gather']:.0f} B (expected {want:.0f}), "
          f"all-reduce {coll['all-reduce']:.0f} B (expected {reduce:.0f})")
    assert coll["all-gather"] == want
    assert coll["all-reduce"] == reduce

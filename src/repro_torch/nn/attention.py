"""Attention: GQA (query-chunked, causal-exact) and MLA (DeepSeek-V2).

Training/prefill attention is query-chunked: a loop over key bands, each
with a loop over query chunks, chunk ``i`` of band ``j`` attending only to
keys ``[0, end of band j)``, so only one (c × band end) score block is live
at a time.  Scores and softmax are float32, in plain tensor ops (no fused
attention), as the JAX package computes them in jnp, so that the float
results stay close to the reference's.

Decode uses a fixed-capacity KV cache written at each slot's position
with a length mask, or a paged cache (``nn/paged.py``); chunked prefill
splices a chunk's lines into a slot's pages and attends causally over
them.  MLA decode is *absorbed* (q projected into the latent space).
Under a mesh the decode caches stay split over the model axis
(:class:`KVSplit`): each rank writes only the lines it holds, scores its
own keys, and :func:`combine_softmax` joins the ranks' softmax and value
sums with two reductions over the axis (flash-decoding).  A whole cache
is one rank's share (:data:`WHOLE`), so every decode and prefill
function runs the one combine.

Every function takes its float reductions (norms, score and value
contractions, softmax) from its numerics runtime (``layers.float_ops``):
float32 for training, and the order-free float64 form when the serving
paths hand in their view, so that a token's output does not depend on how
many queries, slots or keys share its call.  A float32 matmul's order, and
so its rounding, changes with the shape on both the CPU and the card;
under the LNS modes an ulp can move a code, and the ⊞-MAC carries it on.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.numerics import NumericsPolicy
from .config import ModelConfig
from .layers import _normal, apply_rope, float_ops, rms_head_norm
from .paged import (paged_gather, paged_positions, paged_write_chunk,
                    paged_write_token)


class KVCache(NamedTuple):
    k: torch.Tensor          # GQA: (B, S, KV, hd) | MLA: (B, S, lora)
    v: torch.Tensor          # GQA: (B, S, KV, hd) | MLA: (B, S, rope)


class KVSplit(NamedTuple):
    """This rank's share of a decode cache split over ``n`` ranks, as
    ``distributed.sharding.cache_specs`` lays it out: the ``rank``-th
    contiguous block of the sequence (dense KV caches, ``enc_out``), of
    each block's lines (the paged pool), of the channels (a Mamba2 conv
    cache) or of the heads (a Mamba2 state).  ``pmax`` / ``psum`` reduce
    a tensor elementwise over the ranks (max, sum), each rank getting the
    result; ``gather(t, dim)`` joins the ranks' ``t`` along ``dim`` in
    rank order.  Under a mesh they are the model group's collectives; a
    test or a single card can stand in ``n`` threads for them.  A whole
    cache is :data:`WHOLE`, one rank's."""
    rank: int
    n: int
    pmax: Callable
    psum: Callable
    gather: Callable


def _same(t, *_):
    return t


#: The whole cache: one rank, the collectives over it the identity.
WHOLE = KVSplit(0, 1, _same, _same, _same)


# ------------------------------------------------------------- GQA -------
def init_gqa(gen, cfg: ModelConfig, dtype):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = d ** -0.5
    p = {"wq": _normal(gen, (d, h * hd), dtype, s),
         "wk": _normal(gen, (d, kv * hd), dtype, s),
         "wv": _normal(gen, (d, kv * hd), dtype, s),
         "wo": _normal(gen, (h * hd, d), dtype, (h * hd) ** -0.5)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


_NEG = -1e30


def _masked(sc, mask):
    return torch.where(mask, sc, torch.tensor(_NEG, dtype=torch.float32,
                                              device=sc.device))


def _sdpa_block(q, k, v, scale, mask, fl):
    """q: (B,c,KV,G,hd), k/v: (B,t,KV,hd) → (B,c,KV,G,hd); fp32 softmax,
    the reductions taken by ``fl``."""
    sc = fl.einsum("bckgh,btkh->bkgct", q, k).to(torch.float32) * scale
    if mask is not None:
        sc = _masked(sc, mask)
    return fl.einsum("bkgct,btkh->bckgh", fl.softmax(sc).to(v.dtype), v)


def _wide_einsum(eq: str, *ops):
    """An einsum in float64, not rounded: one rank's share of a sum that
    a reduction over the ranks completes."""
    return torch.einsum(eq, *(o.to(torch.float64) for o in ops))


def combine_softmax(sc, pv, pmax, psum):
    """``softmax(sc) · V`` when the keys, the last axis of the float32
    scores ``sc`` (masked), are split in blocks over ranks, each holding
    its block's scores and values.  ``pmax`` / ``psum`` reduce over the
    ranks; ``pv(p)`` is the rank's share of the value product for its
    float32 probabilities ``p``, in float64 and not rounded.

    Forms the same float64 values as ``ORDER_FREE.softmax`` over the
    whole row: the global maximum, ``exp(s - max)``, their sum (the
    denominator) and each probability rounded to float32.  Only the
    order of the float64 sums differs.  Returns the summed value product
    in float64; the caller rounds it once."""
    m = pmax(sc.amax(-1, keepdim=True))
    e = torch.exp(sc.to(torch.float64) - m.to(torch.float64))
    p = (e / psum(e.sum(-1, keepdim=True))).to(sc.dtype)
    return psum(pv(p))


def _sdpa_split(q, k, v, scale, mask, fl, pmax, psum):
    """:func:`_sdpa_block` of ``q`` against one block of the keys, the
    softmax and the value sum combined over the blocks
    (:func:`combine_softmax`).  Leading dims beyond the batch broadcast,
    so ``n`` blocks stacked on a leading axis run in one call with
    reductions over that axis."""
    sc = fl.einsum("...ckgh,...tkh->...kgct", q, k).to(torch.float32) \
        * scale
    if mask is not None:
        sc = _masked(sc, mask)
    o = combine_softmax(sc, lambda p: _wide_einsum(
        "...kgct,...tkh->...ckgh", p.to(v.dtype), v), pmax, psum)
    return o.to(v.dtype)


def _write_lines(t, lpos, vals, inplace):
    """Each row ``b`` of a dense cache ``t`` (B, S, ...) takes its new
    line ``vals[b]`` at position ``lpos[b]`` where that lies in ``[0,
    S)``, and writes nothing elsewhere (it puts back the line it holds).
    ``inplace`` writes into ``t`` (no copy of the cache)."""
    s = t.shape[1]
    at = lpos.clamp(0, s - 1).long()
    rows = torch.arange(t.shape[0], device=t.device)
    own = ((lpos >= 0) & (lpos < s)).reshape((-1,) + (1,) * (t.ndim - 2))
    new = torch.where(own, vals.to(t.dtype), t[rows, at])
    out = t if inplace else t.clone()
    out[rows, at] = new
    return out


def _dense_share(cache_t, split):
    """The first logical position of this rank's block of a dense
    cache's sequence, and the logical positions of its lines."""
    s = cache_t.shape[1]
    lo = split.rank * s
    return lo, lo + torch.arange(s, device=cache_t.device)


def gqa_qkv(p, x, cfg: ModelConfig, pol: NumericsPolicy, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = pol.linear(x, p["wq"]).reshape(b, s, h, hd)
    k = pol.linear(x, p["wk"]).reshape(b, s, kv, hd)
    v = pol.linear(x, p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"], fl=float_ops(pol))
        k = rms_head_norm(k, p["k_norm"], fl=float_ops(pol))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _banded_causal(qg, k, v, scale, cfg: ModelConfig, fl):
    """Banded-causal SDPA: ``attn_bands`` bands of queries, band ``j``
    against the keys up to its end (exact FLOPs at band granularity), a
    loop over query chunks of ``q_chunk`` inside each band."""
    b, s, kvh, g, hd = qg.shape
    c = min(cfg.q_chunk, s)
    nb = max(min(cfg.attn_bands, s // c), 1) if cfg.causal else 1
    per_band = s // nb
    if per_band % c and per_band:
        raise ValueError(f"band of {per_band} queries is not a multiple of "
                         f"the query chunk {c} (seq {s}, {nb} bands)")
    outs = []
    for j in range(nb):
        lo, hi = j * per_band, ((j + 1) * per_band if cfg.causal else s)
        kj, vj = k[:, :hi], v[:, :hi]
        for off in range(lo, lo + per_band, c):
            mask = None
            if cfg.causal:
                qpos = off + torch.arange(c, device=qg.device)
                mask = (qpos[:, None] >= torch.arange(hi, device=qg.device
                                                      )[None, :])
                mask = mask[None, None, None]
            outs.append(_sdpa_block(qg[:, off:off + c], kj, vj, scale, mask,
                                    fl))
    return torch.cat(outs, dim=1)


def _head_sharded(x, rt, heads_axis=2):
    """This rank's block of the heads over the model axis under a mesh
    (``rt`` the stream layout, ``distributed.spmd.Sharded``); ``x``
    itself without one, or when the heads do not divide the axis."""
    if rt is None or getattr(rt, "mesh", None) is None:
        return x
    return rt.own_heads(x, heads_axis)


def _sdpa(q, k, v, scale, cfg: ModelConfig, fl, rt=None, kv_rt=None):
    """The banded SDPA with one group per head: q (B,S,H,dq), k/v
    (B,T,H,·) → (B,S,H,dv).  Under a mesh the tensors are the rank's
    tokens (``rt`` the queries' stream layout, ``kv_rt`` the keys', by
    default the same): the whole sequences are gathered, each rank attends
    with its block of the heads, and the outputs go back to the queries'
    layout (an all-to-all over the model axis)."""
    h = q.shape[2]
    if rt is not None and getattr(rt, "mesh", None) is not None:
        kv_rt = kv_rt or rt
        q = _head_sharded(rt.gather_seq(q), rt)
        k = _head_sharded(kv_rt.gather_seq(k), rt)
        v = _head_sharded(kv_rt.gather_seq(v), rt)
    b, s, hl, dq = q.shape
    o = _banded_causal(q.reshape(b, s, hl, 1, dq), k, v, scale, cfg, fl)
    o = o.reshape(b, s, hl, o.shape[-1])
    if rt is not None and getattr(rt, "mesh", None) is not None:
        o = rt.heads_back(o, h)
    return o


def gqa_attention(p, x, cfg: ModelConfig, pol: NumericsPolicy,
                  positions, rt=None) -> "tuple[torch.Tensor, KVCache]":
    """Causal self-attention over a full sequence (train / prefill); K/V
    repeated to the full head count.  Under a mesh (``rt`` the stream
    layout) ``x`` and ``positions`` are the rank's tokens, and so is the
    cache returned."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = gqa_qkv(p, x, cfg, pol, positions)
    kr = torch.repeat_interleave(k, h // kv, dim=2)
    vr = torch.repeat_interleave(v, h // kv, dim=2)
    o = _sdpa(q, kr, vr, hd ** -0.5, cfg, float_ops(pol), rt)
    o = o.reshape(b, s, h * hd)
    return pol.linear(o, p["wo"]), KVCache(k, v)


def gqa_decode(p, x, cfg: ModelConfig, pol: NumericsPolicy, cache: KVCache,
               pos, split: KVSplit = WHOLE, inplace: bool = False
               ) -> "tuple[torch.Tensor, KVCache]":
    """One-token decode against a fixed-capacity cache.

    x: (B, 1, d); pos: (B,) current positions; cache tensors (B, S, KV,
    hd): the whole cache, or with ``split`` this rank's block of the
    sequence, whose owner alone writes the new line.  ``inplace`` writes
    the line into ``cache`` and returns its tensors.
    """
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k_new, v_new = gqa_qkv(p, x, cfg, pol, pos[:, None])
    lo, kpos = _dense_share(cache.k, split)
    k = _write_lines(cache.k, pos - lo, k_new[:, 0], inplace)
    v = _write_lines(cache.v, pos - lo, v_new[:, 0], inplace)
    qg = q.reshape(b, 1, kv, h // kv, hd)
    mask = (kpos[None, :] <= pos[:, None])[:, None, None, None, :]
    o = _sdpa_split(qg, k, v, hd ** -0.5, mask, float_ops(pol),
                    split.pmax, split.psum).reshape(b, 1, h * hd)
    return pol.linear(o, p["wo"]), KVCache(k, v)


# --------------------------------------------------------- paged GQA -----
def token_writer(bt, pos, active, split: KVSplit = WHOLE,
                 inplace: bool = False, gather=None):
    """``write(pages, vals)``: the slots' new lines into the pool, or
    into ``split``'s share of it (:func:`paged_write_token`); ``inplace``
    writes into ``pages``.  Under a mesh ``gather`` takes a tensor of
    this data rank's slots to every data rank's (the pool's replicas
    take them all)."""
    if gather is not None:
        bt, pos = gather(bt), gather(pos)
        active = gather(active.to(torch.int32)).bool()
    return lambda pages, vals: paged_write_token(
        pages, bt, pos, vals if gather is None else gather(vals), active,
        inplace, split)


def _view_positions(pages, bt, split):
    """The logical position of each line of :func:`paged_gather`'s view
    of ``pages`` through the tables ``bt`` (W blocks a slot)."""
    return paged_positions(bt.shape[-1], pages.shape[1], split.rank,
                           split.n, pages.device)


def gqa_decode_paged(p, x, cfg: ModelConfig, pol: NumericsPolicy,
                     cache: KVCache, bt, pos, active, write=None,
                     split: KVSplit = WHOLE
                     ) -> "tuple[torch.Tensor, KVCache]":
    """One-token batched decode against a paged (block) KV cache.

    cache tensors: (NB, bs, KV, hd) shared page pool; bt: (B, W) block
    tables; pos: (B,) logical positions; active: (B,) bool — inactive
    slots write to the null block and their outputs carry no meaning.
    Attention runs over the gathered (B, W·bs) logical view with the same
    length mask as the dense path, so unallocated pages contribute
    exactly-zero softmax weight.  ``write(pages, new lines)`` replaces the
    write of this batch's lines (under a mesh: every data rank's).  With
    ``split`` the pool holds this rank's lines of every block, and the
    view its (B, W·bs/n) lines, masked by their logical positions.
    """
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k_new, v_new = gqa_qkv(p, x, cfg, pol, pos[:, None])
    write = write or token_writer(bt, pos, active, split)
    k_pages = write(cache.k, k_new[:, 0])
    v_pages = write(cache.v, v_new[:, 0])
    k = paged_gather(k_pages, bt)                   # (B, W·bs, KV, hd)
    v = paged_gather(v_pages, bt)
    kpos = _view_positions(k_pages, bt, split)
    mask = (kpos[None, :] <= pos[:, None])[:, None, None, None, :]
    qg = q.reshape(b, 1, kv, h // kv, hd)
    o = _sdpa_split(qg, k, v, hd ** -0.5, mask, float_ops(pol),
                    split.pmax, split.psum).reshape(b, 1, h * hd)
    return pol.linear(o, p["wo"]), KVCache(k_pages, v_pages)


def gqa_prefill_paged(p, x, cfg: ModelConfig, pol: NumericsPolicy,
                      cache: KVCache, bt_row, pos_base, n_valid,
                      split: KVSplit = WHOLE
                      ) -> "tuple[torch.Tensor, KVCache]":
    """Chunked-prefill attention for ONE slot: splice then attend.

    x: (1, C, d) — a prompt chunk at logical positions ``pos_base +
    arange(C)`` (entries ≥ ``n_valid`` are padding).  The chunk's K/V
    lines are written directly into the slot's pages, then the C queries
    attend causally over the gathered logical view — which already holds
    every previous chunk's lines, so cross-chunk attention needs no extra
    state.  ``split``: as in :func:`gqa_decode_paged`.
    """
    c = x.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    lpos = pos_base + torch.arange(c, device=x.device)
    q, k_new, v_new = gqa_qkv(p, x, cfg, pol, lpos[None])
    k_pages = paged_write_chunk(cache.k, bt_row, pos_base, k_new[0], n_valid,
                                split)
    v_pages = paged_write_chunk(cache.v, bt_row, pos_base, v_new[0], n_valid,
                                split)
    k = paged_gather(k_pages, bt_row[None])         # (1, W·bs, KV, hd)
    v = paged_gather(v_pages, bt_row[None])
    kpos = _view_positions(k_pages, bt_row, split)
    mask = (kpos[None, :] <= lpos[:, None])[None, None, None]
    qg = q.reshape(1, c, kv, h // kv, hd)
    o = _sdpa_split(qg, k, v, hd ** -0.5, mask, float_ops(pol),
                    split.pmax, split.psum).reshape(1, c, h * hd)
    return pol.linear(o, p["wo"]), KVCache(k_pages, v_pages)


# ------------------------------------------------------------- MLA -------
def init_mla(gen, cfg: ModelConfig, dtype):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    s = d ** -0.5
    return {
        "wq": _normal(gen, (d, h * (m.nope_head_dim + m.rope_head_dim)),
                      dtype, s),
        "w_dkv": _normal(gen, (d, m.kv_lora_rank + m.rope_head_dim), dtype,
                         s),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype,
                              device=gen.device),
        "w_ukv": _normal(gen, (m.kv_lora_rank,
                               h * (m.nope_head_dim + m.v_head_dim)), dtype,
                         m.kv_lora_rank ** -0.5),
        "wo": _normal(gen, (h * m.v_head_dim, d), dtype,
                      (h * m.v_head_dim) ** -0.5),
    }


def _mla_latents(p, x, cfg, pol, positions):
    """Compressed KV latents + positional key: (B,S,lora), (B,S,rope)."""
    m = cfg.mla
    dkv = pol.linear(x, p["w_dkv"])
    c_kv = rms_head_norm(dkv[..., :m.kv_lora_rank], p["kv_norm"],
                         fl=float_ops(pol))
    k_pe = dkv[..., m.kv_lora_rank:][:, :, None, :]   # single rope head
    k_pe = apply_rope(k_pe, positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def _mla_q(p, x, cfg, pol, positions):
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q = pol.linear(x, p["wq"]).reshape(
        b, s, h, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_pe = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    return q_nope, q_pe


def mla_attention(p, x, cfg: ModelConfig, pol: NumericsPolicy,
                  positions, rt=None) -> "tuple[torch.Tensor, KVCache]":
    """Full-sequence MLA (train / prefill): up-project the latents through
    ``pol.linear`` (a ⊞-MAC under the LNS train modes), then the banded
    SDPA with one group per head (under a mesh as :func:`gqa_attention`)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    c_kv, k_pe = _mla_latents(p, x, cfg, pol, positions)
    ukv = pol.linear(c_kv, p["w_ukv"]).reshape(
        b, s, h, m.nope_head_dim + m.v_head_dim)
    k_nope, v = ukv[..., :m.nope_head_dim], ukv[..., m.nope_head_dim:]
    q_nope, q_pe = _mla_q(p, x, cfg, pol, positions)
    k_pe_b = k_pe[:, :, None, :].expand(b, s, h, m.rope_head_dim)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe_b], -1)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    o = _sdpa(q, k, v, scale, cfg, float_ops(pol), rt)
    o = o.reshape(b, s, h * m.v_head_dim)
    return pol.linear(o, p["wo"]), KVCache(c_kv, k_pe)


def _mla_absorbed(p, x, cfg: ModelConfig, pol: NumericsPolicy, ck, kpe,
                  positions, mask, split: KVSplit):
    """Absorbed MLA attention of (B, Q, d) queries over latent caches.

    ck: (B, S, lora) compressed latents; kpe: (B, S, rope) positional
    keys; mask: bool broadcastable to (B, H, Q, S).  ``w_ukv`` enters as
    float einsums of ``pol.q_param(w_ukv)``, not as a ⊞-MAC, so its
    logits differ from :func:`mla_attention`'s under LNS, as the JAX
    package's do.  Shared by one-token decode (Q=1, length mask) and
    chunked prefill (Q=C, causal mask).  With ``split`` the latents are
    this rank's lines: the latent context ``p·ck`` is combined over the
    ranks (:func:`combine_softmax`) before ``w_uv``.
    """
    m = cfg.mla
    b, qn = x.shape[0], x.shape[1]
    h = cfg.n_heads
    q_nope, q_pe = _mla_q(p, x, cfg, pol, positions)
    w_ukv = pol.q_param(p["w_ukv"]).reshape(
        m.kv_lora_rank, h, m.nope_head_dim + m.v_head_dim)
    w_uk = w_ukv[..., :m.nope_head_dim]             # (lora, H, nope)
    w_uv = w_ukv[..., m.nope_head_dim:]             # (lora, H, v)
    fl = float_ops(pol)
    q_lat = fl.einsum("bqhn,lhn->bqhl", q_nope, w_uk)
    sc = fl.einsum("bqhl,bsl->bhqs", q_lat, ck)
    sc = sc + fl.einsum("bqhr,bsr->bhqs", q_pe, kpe)
    sc = sc.to(torch.float32) * (m.nope_head_dim + m.rope_head_dim) ** -0.5
    ctx = combine_softmax(_masked(sc, mask), lambda pr: _wide_einsum(
        "bhqs,bsl->bqhl", pr.to(x.dtype), ck), split.pmax,
        split.psum).to(torch.promote_types(x.dtype, ck.dtype))
    o = fl.einsum("bqhl,lhv->bqhv", ctx, w_uv).reshape(b, qn, -1)
    return pol.linear(o, p["wo"])


def mla_decode(p, x, cfg: ModelConfig, pol: NumericsPolicy, cache: KVCache,
               pos, split: KVSplit = WHOLE, inplace: bool = False
               ) -> "tuple[torch.Tensor, KVCache]":
    """Absorbed one-token MLA decode on the latent cache.

    cache.k: (B, S, lora) compressed latents; cache.v: (B, S, rope) k_pe;
    ``split`` and ``inplace`` as in :func:`gqa_decode`.
    """
    c_new, pe_new = _mla_latents(p, x, cfg, pol, pos[:, None])
    lo, kpos = _dense_share(cache.k, split)
    ck = _write_lines(cache.k, pos - lo, c_new[:, 0], inplace)
    kpe = _write_lines(cache.v, pos - lo, pe_new[:, 0], inplace)
    mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]
    o = _mla_absorbed(p, x, cfg, pol, ck, kpe, pos[:, None], mask, split)
    return o, KVCache(ck, kpe)


def mla_decode_paged(p, x, cfg: ModelConfig, pol: NumericsPolicy,
                     cache: KVCache, bt, pos, active, write=None,
                     split: KVSplit = WHOLE
                     ) -> "tuple[torch.Tensor, KVCache]":
    """Absorbed one-token MLA decode on paged latent caches.

    cache.k: (NB, bs, lora) latent pages; cache.v: (NB, bs, rope) k_pe
    pages; bt/pos/active/write/split as in :func:`gqa_decode_paged`.
    """
    c_new, pe_new = _mla_latents(p, x, cfg, pol, pos[:, None])
    write = write or token_writer(bt, pos, active, split)
    ck_pages = write(cache.k, c_new[:, 0])
    pe_pages = write(cache.v, pe_new[:, 0])
    ck = paged_gather(ck_pages, bt)                 # (B, W·bs, lora)
    kpe = paged_gather(pe_pages, bt)
    kpos = _view_positions(ck_pages, bt, split)
    mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]
    o = _mla_absorbed(p, x, cfg, pol, ck, kpe, pos[:, None], mask, split)
    return o, KVCache(ck_pages, pe_pages)


def mla_prefill_paged(p, x, cfg: ModelConfig, pol: NumericsPolicy,
                      cache: KVCache, bt_row, pos_base, n_valid,
                      split: KVSplit = WHOLE
                      ) -> "tuple[torch.Tensor, KVCache]":
    """Chunked-prefill MLA for one slot: splice latents, attend absorbed.

    Same contract as :func:`gqa_prefill_paged`; the chunk's compressed
    latents + positional keys are written straight into the slot's pages
    and the C queries run the absorbed attention causally over them.
    """
    c = x.shape[1]
    lpos = pos_base + torch.arange(c, device=x.device)
    c_new, pe_new = _mla_latents(p, x, cfg, pol, lpos[None])
    ck_pages = paged_write_chunk(cache.k, bt_row, pos_base, c_new[0],
                                 n_valid, split)
    pe_pages = paged_write_chunk(cache.v, bt_row, pos_base, pe_new[0],
                                 n_valid, split)
    ck = paged_gather(ck_pages, bt_row[None])       # (1, W·bs, lora)
    kpe = paged_gather(pe_pages, bt_row[None])
    kpos = _view_positions(ck_pages, bt_row, split)
    mask = (kpos[None, :] <= lpos[:, None])[None, None]
    o = _mla_absorbed(p, x, cfg, pol, ck, kpe, lpos[None], mask, split)
    return o, KVCache(ck_pages, pe_pages)


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device="cpu"):
    """Empty per-layer KV cache (dense, fixed capacity)."""
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return KVCache(_zeros((batch, max_len, m.kv_lora_rank), dtype,
                              device),
                       _zeros((batch, max_len, m.rope_head_dim), dtype,
                              device))
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return KVCache(_zeros(shape, dtype, device), _zeros(shape, dtype, device))


def make_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype, device="cpu"):
    """Empty per-layer *paged* KV cache: a shared pool of KV blocks.

    Capacity is a token budget (``num_blocks · block_size`` lines, block 0
    reserved as the null sink) rather than a dense (B, max_len)
    allocation; slots map into it via block tables (see ``nn/paged.py``).
    """
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return KVCache(
            _zeros((num_blocks, block_size, m.kv_lora_rank), dtype, device),
            _zeros((num_blocks, block_size, m.rope_head_dim), dtype, device))
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.d_head)
    return KVCache(_zeros(shape, dtype, device), _zeros(shape, dtype, device))

"""Paged (block) KV-cache tensor ops: the serving data plane's memory.

A paged cache stores KV lines in fixed-size *blocks* of ``block_size``
token positions each; a per-slot *block table* maps logical block index →
physical block id.  ``max_len`` thereby becomes a **token budget** over a
shared pool of ``num_blocks`` blocks instead of a dense per-slot
allocation: a slot only holds pages for the tokens it actually has.

Layout per layer (GQA): ``(num_blocks, block_size, KV, hd)``; MLA latents:
``(num_blocks, block_size, lora)`` / ``(num_blocks, block_size, rope)``.
Block tables are ``(B, W)`` int32 with ``W = ceil(max_len / block_size)``.

Physical block **0 is reserved as the null sink**: inactive slots and
padded chunk positions direct their writes there, so a batched decode step
can always scatter ``B`` lines unconditionally — garbage lands in a block
no active slot's table references, and the attention mask (``key pos ≤
slot pos``) guarantees it is never read.  The free list of
:class:`repro_torch.serve.paged_cache.BlockManager` therefore hands out
blocks ``1..num_blocks-1`` only.

The functions are pure: each returns new pages and leaves its inputs as
they were, unless a write is asked to work ``inplace`` (a donating decode
step, ``decode_step_paged(..., donate=True)``), which writes the given
pages and returns them.  Allocation policy is host control plane and lives in
``repro_torch/serve/paged_cache.py``.
"""
from __future__ import annotations

import torch

#: Physical block id reserved as the write sink for masked-out lines.
NULL_BLOCK = 0


def _scatter(pages, phys, off, vals, inplace=False):
    out = pages if inplace else pages.clone()
    out[phys.long(), off.long()] = vals.to(pages.dtype)
    return out


def paged_write_token(pages, bt, pos, vals, active, inplace=False):
    """Scatter one KV line per slot into its physical page.

    pages: ``(NB, bs, ...)``; bt: ``(B, W)`` int32; pos: ``(B,)`` int32
    logical positions; vals: ``(B, ...)``; active: ``(B,)`` bool.  Slots
    with ``active=False`` (or a position beyond their table) write to the
    null block instead — their line is never attended.  ``inplace``
    writes into ``pages`` (no copy of the pool).
    """
    bs = pages.shape[1]
    w = bt.shape[1]
    blk = torch.clamp(pos // bs, 0, w - 1)
    phys = torch.gather(bt, 1, blk[:, None].long())[:, 0]
    phys = torch.where(active & (pos // bs < w), phys,
                       torch.full_like(phys, NULL_BLOCK))
    return _scatter(pages, phys, pos % bs, vals, inplace)


def paged_write_chunk(pages, bt_row, pos_base, vals, n_valid):
    """Splice a prefill chunk's KV lines directly into one slot's pages.

    pages: ``(NB, bs, ...)``; bt_row: ``(W,)`` int32 — ONE slot's block
    table; vals: ``(C, ...)`` lines for logical positions ``pos_base +
    arange(C)``; entries ``i >= n_valid`` (chunk padding) go to the null
    block.  This is the cache-splice half of chunked prefill: no
    per-token decode loop ever runs for prompt tokens.
    """
    c = vals.shape[0]
    bs = pages.shape[1]
    w = bt_row.shape[0]
    ar = torch.arange(c, device=pages.device)
    lpos = pos_base + ar
    blk = torch.clamp(lpos // bs, 0, w - 1)
    ok = (ar < n_valid) & (lpos // bs < w)
    phys = torch.where(ok, bt_row[blk.long()],
                       torch.full_like(bt_row[blk.long()], NULL_BLOCK))
    return _scatter(pages, phys, lpos % bs, vals)


def paged_gather(pages, bt):
    """Materialize the logical ``(B, W·bs, ...)`` view of slots' pages.

    pages: ``(NB, bs, ...)``; bt: ``(B, W)``.  Unallocated table entries
    point at the null block; its contents are masked out by the caller's
    length mask (``key pos ≤ slot pos``), so whatever lives there never
    reaches a softmax with nonzero weight.
    """
    g = pages[bt.long()]                            # (B, W, bs, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])

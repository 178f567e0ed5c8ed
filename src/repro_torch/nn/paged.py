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

Under a mesh each rank holds its share of the pool: the ``rank``-th of
``ranks`` contiguous runs of every block's lines (``cache_specs(...,
paged=True)`` splits ``block_size`` over the model axis).  A write then
lands only on the rank that holds the line (the others write nothing),
and :func:`paged_positions` gives the logical positions of a rank's view.

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


def _scatter(pages, phys, off, vals, inplace=False, own=None):
    """``vals`` into lines ``(phys, off)``; where ``own`` is False the
    line is another rank's, and its write goes to the null block and
    puts back what that holds there (a write of nothing)."""
    out = pages if inplace else pages.clone()
    phys, off, vals = phys.long(), off.long(), vals.to(pages.dtype)
    if own is not None:
        phys = torch.where(own, phys, torch.full_like(phys, NULL_BLOCK))
        vals = torch.where(own.reshape((-1,) + (1,) * (vals.ndim - 1)),
                           vals, out[phys, off])
    out[phys, off] = vals
    return out


def _line(pages, pos, split):
    """The logical block, the offset in this rank's share of the block
    and whether this rank holds the line, of logical positions ``pos``
    (``pages``: the share of ``split``, ``bs / split.n`` lines a block;
    the whole pool when ``split`` is None)."""
    rank, ranks = (0, 1) if split is None else (split.rank, split.n)
    bsl = pages.shape[1]
    off = pos % (bsl * ranks)
    own = None if ranks == 1 else off // bsl == rank
    return pos // (bsl * ranks), off % bsl, own


def paged_write_token(pages, bt, pos, vals, active, inplace=False,
                      split=None):
    """Scatter one KV line per slot into its physical page.

    pages: ``(NB, bs, ...)``; bt: ``(B, W)`` int32; pos: ``(B,)`` int32
    logical positions; vals: ``(B, ...)``; active: ``(B,)`` bool.  Slots
    with ``active=False`` (or a position beyond their table) write to the
    null block instead — their line is never attended.  ``inplace``
    writes into ``pages`` (no copy of the pool).  ``split`` (an
    ``attention.KVSplit``): ``pages`` is that rank's share of the pool,
    which takes only the lines it holds.
    """
    w = bt.shape[1]
    blk, off, own = _line(pages, pos, split)
    phys = torch.gather(bt, 1, torch.clamp(blk, 0, w - 1)[:, None].long()
                        )[:, 0]
    phys = torch.where(active & (blk < w), phys,
                       torch.full_like(phys, NULL_BLOCK))
    return _scatter(pages, phys, off, vals, inplace, own)


def paged_write_chunk(pages, bt_row, pos_base, vals, n_valid,
                      split=None):
    """Splice a prefill chunk's KV lines directly into one slot's pages.

    pages: ``(NB, bs, ...)``; bt_row: ``(W,)`` int32 — ONE slot's block
    table; vals: ``(C, ...)`` lines for logical positions ``pos_base +
    arange(C)``; entries ``i >= n_valid`` (chunk padding) go to the null
    block.  This is the cache-splice half of chunked prefill: no
    per-token decode loop ever runs for prompt tokens.  ``split`` as in
    :func:`paged_write_token`.
    """
    c = vals.shape[0]
    w = bt_row.shape[0]
    ar = torch.arange(c, device=pages.device)
    blk, off, own = _line(pages, pos_base + ar, split)
    phys = bt_row[torch.clamp(blk, 0, w - 1).long()]
    phys = torch.where((ar < n_valid) & (blk < w), phys,
                       torch.full_like(phys, NULL_BLOCK))
    return _scatter(pages, phys, off, vals, own=own)


def paged_positions(w: int, bs_local: int, rank: int = 0, ranks: int = 1,
                    device=None):
    """The logical position of each line of :func:`paged_gather`'s view
    through W-block tables of rank ``rank``'s share of a pool of
    ``ranks · bs_local``-line blocks: block ``i``'s line ``j`` sits at
    ``i · bs + rank · bs_local + j``."""
    blk = torch.arange(w, device=device)[:, None] * (bs_local * ranks)
    return (blk + rank * bs_local
            + torch.arange(bs_local, device=device)[None, :]).reshape(-1)


def paged_gather(pages, bt):
    """Materialize the logical ``(B, W·bs, ...)`` view of slots' pages.

    pages: ``(NB, bs, ...)``; bt: ``(B, W)``.  Unallocated table entries
    point at the null block; its contents are masked out by the caller's
    length mask (``key pos ≤ slot pos``), so whatever lives there never
    reaches a softmax with nonzero weight.
    """
    g = pages[bt.long()]                            # (B, W, bs, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])

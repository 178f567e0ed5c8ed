"""Host-side allocation control plane for the paged KV cache.

The device side (page pools, block tables, splice/gather ops) lives in
``repro_torch.nn.paged``; this module owns the **free list**.  A
:class:`BlockManager` hands out physical block ids from a fixed pool,
turning ``max_len`` from a dense per-slot allocation into a shared *token
budget*: a request only holds pages for tokens it will actually write, and
admission control can answer "will this request ever fit?" before any
device work happens.

Block ``0`` (``NULL_BLOCK``) is reserved as the write sink for masked-out
lines and is never handed out — the allocatable pool is ``1 ..
num_blocks-1``.
"""
from __future__ import annotations

import math
from typing import Optional

from ..nn.paged import (NULL_BLOCK, paged_gather, paged_write_chunk,
                        paged_write_token)

__all__ = ["BlockManager", "NULL_BLOCK", "paged_gather",
           "paged_write_chunk", "paged_write_token"]


class BlockManager:
    """Free-list allocator over a pool of fixed-size KV blocks.

    Allocation is all-or-nothing: :meth:`alloc` returns ``n`` block ids or
    ``None`` (caller keeps the request queued / rejects it) — never a
    partial grant, so a request admitted with its full reservation can
    never hit OOM mid-flight and no preemption path is needed.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null sink)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO free list over 1..num_blocks-1 (block 0 reserved).
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._out: set[int] = set()

    # ---------------------------------------------------- budget math ---
    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the null block)."""
        return self.num_blocks - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def outstanding(self) -> int:
        return len(self._out)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` KV lines."""
        return max(1, math.ceil(tokens / self.block_size))

    def fits_ever(self, tokens: int) -> bool:
        """Could ``tokens`` lines ever fit, even with the pool drained?"""
        return self.blocks_for(tokens) <= self.capacity

    # ----------------------------------------------------- alloc/free ---
    def alloc(self, n: int) -> Optional[list]:
        if n <= 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._out.update(blocks)
        return blocks

    def free(self, blocks) -> None:
        for b in blocks:
            if b not in self._out:
                raise ValueError(f"double free / foreign block {b}")
            self._out.remove(b)
            self._free.append(b)

    # -------------------------------------------------- conservation ---
    def check_conserved(self) -> None:
        """Assert free ∪ outstanding is exactly the pool, no dup/leak."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate ids on the free list")
        if free & self._out:
            raise AssertionError("block both free and outstanding")
        if NULL_BLOCK in free or NULL_BLOCK in self._out:
            raise AssertionError("null block entered circulation")
        pool = set(range(1, self.num_blocks))
        if free | self._out != pool:
            raise AssertionError(
                f"leaked blocks: {sorted(pool - free - self._out)}")

"""Synthetic LM data pipeline, the JAX package's in numpy bit for bit.

Batches are generated, not read: Zipfian token streams with per-document
structure (repeated n-grams so a real model can reduce loss).  Properties
the trainer relies on:

* **Deterministic by (seed, step)** — batch ``t`` is a pure function of the
  config; restart at step ``t`` reproduces the exact remaining stream (the
  checkpoint only needs to store ``step``).
* **Host-sharded** — each process can generate only its slice
  (``shard_index/shard_count``) of the global batch.
* **Frontend stubs** — for vlm/audio archs the pipeline emits the
  precomputed embedding tensors the assignment prescribes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..nn.config import ModelConfig, ShapeCell


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2
    ngram_len: int = 8
    repeat_prob: float = 0.5
    shard_index: int = 0
    shard_count: int = 1


class SyntheticLMDataset:
    def __init__(self, cfg: ModelConfig, cell: ShapeCell,
                 dc: DataConfig = DataConfig()):
        self.cfg = cfg
        self.cell = cell
        self.dc = dc
        if cell.global_batch % dc.shard_count:
            raise ValueError(f"global batch {cell.global_batch} does not "
                             f"divide into {dc.shard_count} shards")
        self.local_batch = cell.global_batch // dc.shard_count

    def _tokens(self, rng, b, s):
        v = self.cfg.vocab_size
        # zipf over a capped vocab for numerical sanity
        base = rng.zipf(self.dc.zipf_a, size=(b, s)) % max(v - 2, 1) + 1
        # repeated n-grams: copy a window forward to create learnable
        # structure
        n = self.dc.ngram_len
        for i in range(b):
            if rng.random() < self.dc.repeat_prob and s > 4 * n:
                src = rng.integers(0, s - 2 * n)
                dst = rng.integers(src + n, s - n)
                base[i, dst:dst + n] = base[i, src:src + n]
        return base.astype(np.int32)

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step, shard) → local batch dict."""
        rng = np.random.default_rng(
            (self.dc.seed * 1_000_003 + step) * 65_537 + self.dc.shard_index)
        b, s = self.local_batch, self.cell.seq_len
        toks = self._tokens(rng, b, s + 1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family in ("encdec", "audio"):
            if self.cfg.frontend:
                out["frontend_embeds"] = rng.normal(
                    size=(b, s, self.cfg.d_model)).astype(np.float32)
            else:
                out["enc_tokens"] = self._tokens(rng, b, s)
        elif self.cfg.family == "vlm" or self.cfg.frontend:
            s_vis = int(s * self.cfg.frontend_frac)
            toks = self._tokens(rng, b, s - s_vis + 1)
            out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                   "frontend_embeds": rng.normal(
                       size=(b, s_vis, self.cfg.d_model)).astype(np.float32)}
        return out

    def batch_on(self, step: int, device) -> dict:
        """:meth:`batch_at` as tensors on ``device``: one host-to-device
        copy a tensor, no host-side copy."""
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.batch_at(step).items()}


def make_batch_iterator(cfg: ModelConfig, cell: ShapeCell,
                        dc: DataConfig = DataConfig(),
                        start_step: int = 0) -> Iterator[dict]:
    ds = SyntheticLMDataset(cfg, cell, dc)
    step = start_step
    while True:
        yield ds.batch_at(step)
        step += 1

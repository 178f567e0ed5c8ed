"""Input construction for every (arch × shape) cell.

``input_specs(cfg, cell)`` returns stand-ins on the ``meta`` device (the
shapes and dtypes, no allocation) for a dry run; ``batch_struct(...,
abstract=False)`` builds concrete tensors of the same structure (zeros
for floats, ones for integers).

Frontend-stub archs (audio/vlm): ``frontend_embeds`` carries precomputed
frame/patch embeddings in bfloat16.  For the vlm family the first
``frontend_frac·S`` positions come from the stub and the rest are text
tokens; labels cover the text span.  For enc-dec audio, the encoder sees S
frame embeddings and the decoder S tokens.
"""
from __future__ import annotations

import torch

from ..devices import resolve_device
from ..nn.config import ModelConfig, ShapeCell


def _maker(abstract: bool, device):
    if abstract:
        return lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                                device="meta")

    device = resolve_device(device)

    def mk(shape, dtype):
        fill = torch.zeros if dtype.is_floating_point else torch.ones
        return fill(shape, dtype=dtype, device=device)
    return mk


def batch_struct(cfg: ModelConfig, cell: ShapeCell, abstract: bool = True,
                 device="cuda"):
    """Training/prefill batch structure for one cell."""
    b, s = cell.global_batch, cell.seq_len
    mk = _maker(abstract, device)
    if cfg.family in ("encdec", "audio"):
        out = {"tokens": mk((b, s), torch.int32)}
        if cfg.frontend:
            out["frontend_embeds"] = mk((b, s, cfg.d_model), torch.bfloat16)
        else:
            out["enc_tokens"] = mk((b, s), torch.int32)
        if cell.kind == "train":
            out["labels"] = mk((b, s), torch.int32)
        return out
    if cfg.family == "vlm" or (cfg.family == "dense" and cfg.frontend):
        s_vis = int(s * cfg.frontend_frac)
        s_txt = s - s_vis
        out = {"tokens": mk((b, s_txt), torch.int32),
               "frontend_embeds": mk((b, s_vis, cfg.d_model),
                                     torch.bfloat16)}
        if cell.kind == "train":
            out["labels"] = mk((b, s_txt), torch.int32)
        return out
    out = {"tokens": mk((b, s), torch.int32)}
    if cell.kind == "train":
        out["labels"] = mk((b, s), torch.int32)
    return out


def decode_struct(cfg: ModelConfig, cell: ShapeCell, abstract: bool = True,
                  device="cuda"):
    """(tok, pos) for one decode step (caches built separately)."""
    b = cell.global_batch
    if abstract:
        mk = _maker(True, None)
        return {"tok": mk((b, 1), torch.int32), "pos": mk((b,), torch.int32)}
    device = resolve_device(device)
    return {"tok": torch.ones((b, 1), dtype=torch.int32, device=device),
            "pos": torch.full((b,), cell.seq_len - 1, dtype=torch.int32,
                              device=device)}


def input_specs(cfg: ModelConfig, cell: ShapeCell):
    """The dry-run entry point: abstract inputs for the cell's step kind."""
    if cell.kind == "decode":
        return decode_struct(cfg, cell, abstract=True)
    return batch_struct(cfg, cell, abstract=True)

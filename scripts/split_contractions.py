#!/usr/bin/env python3
"""Do the Mamba2 decode step's two contractions give the same values when
their channels or heads are split over ranks?

    PYTHONPATH=src python3 scripts/split_contractions.py [--device cuda]

At zamba2-7b's published widths (7296 conv channels, 112 heads of 64 ×
64 state) and 8 slots, from random float32 operands (seed 0), computes
the conv over its window (``bkc,kc->bc``) and C·h over the state
(``bhpn,bhn->bhp``) whole, and again as 16 blocks of the channels or the
heads joined in rank order, each in float32 (``torch.einsum``) and in
the serving views' order-free float64 form (``layers.ORDER_FREE``), and
prints how many values of the joined blocks differ from the whole.  A
card's batched float32 contraction may order its sums by the batch
count, so a block can round otherwise than the whole; the float64 form
rounds once.  Without ``--device`` it wants a card.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.nn.layers import ORDER_FREE

RANKS, SLOTS = 16, 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_config("zamba2-7b")
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    window, conv_w = randn(SLOTS, 4, conv_dim), randn(4, conv_dim) * 0.1
    state, cvec = randn(SLOTS, nh, s.head_dim, s.d_state), randn(
        SLOTS, nh, s.d_state)
    cl, hl = conv_dim // RANKS, nh // RANKS
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0))
    for name, einsum in (("float32", torch.einsum),
                         ("order-free float64", ORDER_FREE.einsum)):
        conv = einsum("bkc,kc->bc", window, conv_w)
        conv_split = torch.cat([einsum(
            "bkc,kc->bc", window[..., r * cl:(r + 1) * cl],
            conv_w[:, r * cl:(r + 1) * cl]) for r in range(RANKS)], 1)
        y = einsum("bhpn,bhn->bhp", state, cvec)
        y_split = torch.cat([einsum(
            "bhpn,bhn->bhp", state[:, r * hl:(r + 1) * hl],
            cvec[:, r * hl:(r + 1) * hl]) for r in range(RANKS)], 1)
        print(f"{name}: conv, {RANKS} channel blocks against whole: "
              f"{int((conv_split != conv).sum())} of {conv.numel()} differ; "
              f"C·h, {RANKS} head blocks against whole: "
              f"{int((y_split != y).sum())} of {y.numel()} differ")


if __name__ == "__main__":
    main()

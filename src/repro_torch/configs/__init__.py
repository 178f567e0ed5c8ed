"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

Each assigned architecture has its exact public-literature config in its
own module; ``reduced(cfg)`` shrinks any config to a small size
of the same family (same block wiring, tiny dims).
"""
from __future__ import annotations

import dataclasses

from ..nn.config import (EncDecConfig, HybridConfig, MLAConfig, ModelConfig,
                         MoEConfig, SSMConfig)
from .command_r_35b import CONFIG as COMMAND_R_35B
from .deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from .deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE_16B
from .internvl2_76b import CONFIG as INTERNVL2_76B
from .mamba2_370m import CONFIG as MAMBA2_370M
from .olmo_1b import CONFIG as OLMO_1B
from .qwen3_1_7b import CONFIG as QWEN3_1_7B
from .seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from .yi_6b import CONFIG as YI_6B
from .zamba2_7b import CONFIG as ZAMBA2_7B

ARCHS = {c.name: c for c in [
    MAMBA2_370M, COMMAND_R_35B, YI_6B, QWEN3_1_7B, OLMO_1B,
    DEEPSEEK_MOE_16B, DEEPSEEK_V2_LITE_16B, SEAMLESS_M4T_MEDIUM,
    ZAMBA2_7B, INTERNVL2_76B,
]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        n_layers=2, d_model=64, n_heads=4, d_head=16, vocab_size=256,
        d_ff=128 if cfg.d_ff else 0,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        q_chunk=16,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, n_shared=1, d_expert=32,
            first_dense_layers=1)
        kw["n_layers"] = 3
    if cfg.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=32, rope_head_dim=8,
                              nope_head_dim=16, v_head_dim=16)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=8, d_conv=4)
    if cfg.hybrid:
        kw["hybrid"] = HybridConfig(attn_every=2)
        kw["n_layers"] = 5   # 2 groups of 2 + tail 1
    if cfg.encdec:
        kw["encdec"] = EncDecConfig(n_enc_layers=2, n_dec_layers=2)
        kw["n_layers"] = 4
    return cfg.with_(**kw)

"""The LM substrate: configs, layers, GQA and MLA attention, MoE, the
Mamba2 block (``ssm.py``), the paged KV cache, and the training, prefill
and dense decode paths of every family (dense, vlm, moe, ssm, hybrid,
encdec, audio), numerics-policy aware (the LNS modes plug in through
``core.spec.LNSRuntime``); the paged engine's pair serves the dense, vlm
and moe families."""
from .config import (EncDecConfig, HybridConfig, MLAConfig, ModelConfig,
                     MoEConfig, SHAPE_CELLS, ShapeCell, SSMConfig)
from .model import (PAGED_FAMILIES, Runtime, caches_from_numpy,
                    caches_to_numpy, decode_step, decode_step_paged,
                    init_decode_caches, init_paged_caches, init_params,
                    loss_fn, params_from_numpy, params_to_numpy, prefill,
                    prefill_chunk)
from .ssm import SSMCache, make_ssm_cache

__all__ = ["EncDecConfig", "HybridConfig", "MLAConfig", "ModelConfig",
           "MoEConfig", "SHAPE_CELLS", "ShapeCell", "SSMConfig",
           "PAGED_FAMILIES", "Runtime", "SSMCache", "caches_from_numpy",
           "caches_to_numpy", "decode_step", "decode_step_paged",
           "init_decode_caches", "init_paged_caches", "init_params",
           "loss_fn", "make_ssm_cache", "params_from_numpy",
           "params_to_numpy", "prefill", "prefill_chunk"]

"""The LM substrate: configs, layers, GQA and MLA attention, MoE, the
paged KV cache and the dense, vlm and moe families' training and serving
paths, numerics-policy aware (the LNS modes plug in through
``core.spec.LNSRuntime``)."""
from .config import (EncDecConfig, HybridConfig, MLAConfig, ModelConfig,
                     MoEConfig, SHAPE_CELLS, ShapeCell, SSMConfig)
from .model import (PAGED_FAMILIES, Runtime, decode_step,
                    decode_step_paged, init_decode_caches, init_paged_caches,
                    init_params, loss_fn, params_from_numpy, params_to_numpy,
                    prefill, prefill_chunk)

__all__ = ["EncDecConfig", "HybridConfig", "MLAConfig", "ModelConfig",
           "MoEConfig", "SHAPE_CELLS", "ShapeCell", "SSMConfig",
           "PAGED_FAMILIES", "Runtime", "decode_step", "decode_step_paged",
           "init_decode_caches", "init_paged_caches", "init_params",
           "loss_fn", "params_from_numpy", "params_to_numpy", "prefill",
           "prefill_chunk"]

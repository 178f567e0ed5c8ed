"""The LM substrate: configs, layers, GQA attention and the dense
transformer's training path, numerics-policy aware (the LNS modes plug
in through ``core.spec.LNSRuntime``)."""
from .config import (EncDecConfig, HybridConfig, MLAConfig, ModelConfig,
                     MoEConfig, SHAPE_CELLS, ShapeCell, SSMConfig)
from .model import (Runtime, decode_step, decode_step_paged,
                    init_decode_caches, init_paged_caches, init_params,
                    loss_fn, params_from_numpy, params_to_numpy, prefill,
                    prefill_chunk)

__all__ = ["EncDecConfig", "HybridConfig", "MLAConfig", "ModelConfig",
           "MoEConfig", "SHAPE_CELLS", "ShapeCell",
           "SSMConfig", "Runtime", "decode_step", "decode_step_paged",
           "init_decode_caches", "init_paged_caches", "init_params",
           "loss_fn", "params_from_numpy", "params_to_numpy", "prefill",
           "prefill_chunk"]

"""olmo-1b — non-parametric LayerNorm, MHA (kv=16). [arXiv:2402.00838; hf]"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_head=128, d_ff=8_192, vocab_size=50_304,
    norm_kind="nonparam_ln",
)

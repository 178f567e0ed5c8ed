"""yi-6b — llama-arch GQA kv=4. [arXiv:2403.04652; hf]"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=4, d_head=128, d_ff=11_008, vocab_size=64_000,
    norm_kind="rmsnorm", rope_theta=5_000_000.0,
)

"""qwen3-1.7b — qk_norm, GQA kv=8, tied embeddings. [hf:Qwen/Qwen3-8B; hf]"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=8, d_head=128, d_ff=6_144, vocab_size=151_936,
    norm_kind="rmsnorm", qk_norm=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
)

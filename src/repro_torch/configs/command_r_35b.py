"""command-r-35b — GQA kv=8, no-bias, parallel blocks, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=22_528, vocab_size=256_000,
    norm_kind="layernorm", block_style="parallel", tie_embeddings=True,
    rope_theta=8_000_000.0,
)

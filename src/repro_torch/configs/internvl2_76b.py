"""internvl2-76b — InternLM2-76B backbone; InternViT frontend is a stub
(precomputed patch embeddings per the assignment).
[arXiv:2404.16821; unverified]"""
from ..nn.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=28_672, vocab_size=128_256,
    norm_kind="rmsnorm", rope_theta=1_000_000.0,
    frontend="vision_stub",
)

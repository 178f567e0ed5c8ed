"""zamba2-7b — Mamba2 backbone + parameter-shared attention block every 6
SSM layers.  [arXiv:2411.15242; unverified]"""
from ..nn.config import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_head=112, d_ff=14_336, vocab_size=32_000,
    norm_kind="rmsnorm",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid=HybridConfig(attn_every=6),
)

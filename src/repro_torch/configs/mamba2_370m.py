"""mamba2-370m — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from ..nn.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
    n_heads=16, n_kv_heads=16, d_head=64, d_ff=0, vocab_size=50_280,
    attn_kind="none", norm_kind="rmsnorm",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)

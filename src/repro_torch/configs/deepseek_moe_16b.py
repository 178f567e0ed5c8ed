"""deepseek-moe-16b — 2 shared + 64 routed top-6 fine-grained experts,
first layer dense.  [arXiv:2401.06066; hf]"""
from ..nn.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_head=128, d_ff=11_264, vocab_size=102_400,
    norm_kind="rmsnorm",
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  first_dense_layers=1),
)

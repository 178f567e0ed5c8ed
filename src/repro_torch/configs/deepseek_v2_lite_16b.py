"""deepseek-v2-lite-16b — MLA kv_lora=512, 2 shared + 64 routed top-6.
[arXiv:2405.04434; hf]  (Assignment header says 64e; its prose mentions the
full V2's 160 — we follow the header / real V2-Lite: 64 routed.)"""
from ..nn.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_head=128, d_ff=11_264, vocab_size=102_400,
    norm_kind="rmsnorm", attn_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  first_dense_layers=1),
)

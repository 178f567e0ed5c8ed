"""seamless-m4t-medium — enc-dec, audio frontend stub (precomputed frame
embeddings per the assignment).  [arXiv:2308.11596; hf]"""
from ..nn.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_head=64, d_ff=4_096, vocab_size=256_206,
    norm_kind="layernorm", mlp_kind="mlp", act="gelu",
    encdec=EncDecConfig(n_enc_layers=12, n_dec_layers=12),
    frontend="audio_stub",
)

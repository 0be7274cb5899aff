"""Qwen2-0.5B [arXiv:2407.10671; hf:Qwen/Qwen2-0.5B].

Dense decoder: 24L, d_model=896, 14 heads (GQA kv=2, head_dim=64),
d_ff=4864, vocab=151936. QKV bias (Qwen signature), SwiGLU, RMSNorm,
RoPE (theta=1e6), tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    head_dim=64,
    qkv_bias=True,
    mlp="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=1.0e6,
    tie_embeddings=True,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-0.5B",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab=160)

"""OLMo-1B [arXiv:2402.00838; hf:allenai/OLMo-1B].

Dense decoder: 16L, d_model=2048, 16 heads (MHA: kv=16), d_ff=8192,
vocab=50304. Non-parametric LayerNorm (no scale/bias), SwiGLU, RoPE,
tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    head_dim=128,
    mlp="swiglu",
    norm="nonparam_ln",
    rope=True,
    rope_theta=1.0e4,
    tie_embeddings=True,
    source="arXiv:2402.00838; hf:allenai/OLMo-1B",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab=128)

"""StarCoder2-7B [arXiv:2402.19173; hf:bigcode/starcoder2-7b].

Dense decoder: 32L, d_model=4608, 36 heads (GQA kv=4, head_dim=128),
d_ff=18432, vocab=49152. GELU MLP with biases, LayerNorm, RoPE
(theta=1e5), sliding window 4096.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    head_dim=128,
    qkv_bias=True,
    mlp="gelu",
    norm="layernorm",
    rope=True,
    rope_theta=1.0e5,
    sliding_window=4096,
    source="arXiv:2402.19173; hf:bigcode/starcoder2-7b",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=128, sliding_window=32)

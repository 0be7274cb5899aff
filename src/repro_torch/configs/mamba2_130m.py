"""Mamba2-130M [arXiv:2405.21060; hf:state-spaces/mamba2-130m].

Attention-free SSM: 24 Mamba2 (SSD) blocks, d_model=768, ssm_state=128,
expand=2 (d_inner=1536, 24 heads of dim 64), vocab=50280. Tied
embeddings. Sub-quadratic by construction (long_500k decode runs the
O(1)-per-token recurrence).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    head_dim=0,
    mlp="swiglu",
    norm="rmsnorm",
    rope=False,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-130m",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, vocab=128, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16)

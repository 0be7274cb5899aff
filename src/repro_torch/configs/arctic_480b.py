"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: 35L, d_model=7168, 56 heads (GQA kv=8, head_dim=128),
vocab=32000. Every layer pairs a dense residual FFN (d_ff=4864) with a
128-expert top-2 MoE (per-expert d_ff=4864) computed in parallel.
SwiGLU, RMSNorm, RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,                    # dense residual path
    vocab=32000,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=1.0e4,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    router_score="softmax",
    source="hf:Snowflake/snowflake-arctic-base",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=128, n_experts=8, top_k=2, moe_d_ff=96)

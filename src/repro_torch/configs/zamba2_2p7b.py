"""Zamba2-2.7B [arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B].

Hybrid: 54 Mamba2 blocks (d_model=2560, ssm_state=64) with a single
weight-SHARED attention+MLP block applied every `hybrid_period` Mamba
blocks, fed by the concat of the current hidden state and the original
embedding (the Zamba signature). Shared block: 32 heads (MHA over the
concat projection), d_ff=10240. vocab=32000.

Sub-quadratic: the Mamba2 backbone makes long_500k decode O(1)/token;
the shared-attention KV cache is the only attention state.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    mlp="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=1.0e4,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    hybrid_period=6,               # shared attn block every 6 mamba blocks
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    hybrid_period=2)

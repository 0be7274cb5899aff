"""DeepSeek-V3-671B [arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3].

MoE decoder: 61L (first 3 dense, d_ff=18432), d_model=7168, 128 heads,
MLA attention (q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
v_head=128), vocab=129280. MoE layers: 256 routed experts (d_ff=2048)
top-8 with sigmoid scores + normalized gates, plus 1 shared expert.
Multi-token prediction (MTP) auxiliary head.

The task line "d_ff=2048" is the per-expert FFN width (moe_d_ff); the
dense/dense-residual layers use the published 18432.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                   # dense layers 0-2
    vocab=129280,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=1.0e4,
    n_experts=256,
    top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    router_score="sigmoid",
    n_dense_layers=3,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp=True,
    source="arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3",
)

SMOKE = CONFIG.scaled(
    n_layers=3, n_dense_layers=1, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=192, vocab=128, n_experts=8, top_k=2, moe_d_ff=48,
    q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16)

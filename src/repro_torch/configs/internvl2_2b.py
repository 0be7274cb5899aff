"""InternVL2-2B [arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B].

VLM: InternViT-300M frontend + InternLM2-1.8B language backbone. Per the
task spec the modality frontend is a STUB -- `input_specs()` supplies
precomputed patch embeddings (256 tokens after pixel-shuffle, at
d_model) that are concatenated in front of the token embeddings.

Backbone: 24L, d_model=2048, 16 heads (GQA kv=8, head_dim=128),
d_ff=8192, vocab=92553. SwiGLU, RMSNorm, RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=1.0e4,
    n_patches=256,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab=128, n_patches=8)

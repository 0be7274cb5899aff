"""H2O-Danube-1.8B [arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base].

Dense decoder (llama+mistral mix): 24L, d_model=2560, 32 heads
(GQA kv=8, head_dim=80), d_ff=6912, vocab=32000. SwiGLU, RMSNorm, RoPE,
sliding-window attention (4096) -- the SWA window is what makes this
arch sub-quadratic for the long_500k decode shape.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    head_dim=80,
    mlp="swiglu",
    norm="rmsnorm",
    rope=True,
    rope_theta=1.0e4,
    sliding_window=4096,
    source="arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=80, n_heads=4, n_kv_heads=2, head_dim=20,
    d_ff=224, vocab=128, sliding_window=32)

"""HuBERT-XLarge [arXiv:2106.07447; hf:facebook/hubert-xlarge-ll60k].

Audio encoder (same transformer arch as wav2vec2): 48L, d_model=1280,
16 heads (MHA), d_ff=5120, vocab=504 (k-means cluster targets).
Encoder-only: bidirectional (causal=False), no decode shapes. The conv
waveform frontend is a STUB per the task spec -- `input_specs()` feeds
precomputed 512-dim frame features projected into the model.
GELU MLP, LayerNorm, no RoPE (conv positional embedding is part of the
stubbed frontend).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    mlp="gelu",
    norm="layernorm",
    rope=False,
    causal=False,
    frame_dim=512,
    source="arXiv:2106.07447; hf:facebook/hubert-xlarge-ll60k",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab=64, frame_dim=32)

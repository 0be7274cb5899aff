"""Architecture configuration schema + registry (copy of
`repro.configs.base`), with one module per arch of `ARCH_IDS`: every
family is ported. An unknown arch raises a `ValueError`.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encoder | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"            # swiglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | nonparam_ln | layernorm
    rope: bool = True
    rope_theta: float = 1.0e4
    sliding_window: Optional[int] = None
    causal: bool = True
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    router_score: str = "softmax"  # softmax | sigmoid
    n_dense_layers: int = 0        # leading dense layers (deepseek-v3: 3)
    # --- MLA ---
    attn_kind: str = "gqa"         # gqa | mla | none
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    hybrid_period: int = 0         # zamba2: shared attn block every k layers
    # --- extras ---
    mtp: bool = False              # multi-token prediction head (deepseek-v3)
    n_patches: int = 0             # vlm stub frontend
    frame_dim: int = 0             # audio stub frontend
    source: str = ""               # provenance note

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode (SSM/hybrid or windowed attn)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    @property
    def has_decode(self) -> bool:
        return self.causal and self.family != "encoder"

    def scaled(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)


ARCH_IDS = [
    "starcoder2_7b", "olmo_1b", "h2o_danube_1p8b", "qwen2_0p5b",
    "internvl2_2b", "deepseek_v3_671b", "arctic_480b", "hubert_xlarge",
    "zamba2_2p7b", "mamba2_130m",
]

ALIASES = {
    "starcoder2-7b": "starcoder2_7b", "olmo-1b": "olmo_1b",
    "h2o-danube-1.8b": "h2o_danube_1p8b", "qwen2-0.5b": "qwen2_0p5b",
    "internvl2-2b": "internvl2_2b", "deepseek-v3-671b": "deepseek_v3_671b",
    "arctic-480b": "arctic_480b", "hubert-xlarge": "hubert_xlarge",
    "zamba2-2.7b": "zamba2_2p7b", "mamba2-130m": "mamba2_130m",
}


PORTED_ARCHS = ARCH_IDS            # every arch of the reference


def _module(arch: str):
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE


# ---- input shapes assigned to the LM family (task spec) ----
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell, else the skip reason."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""

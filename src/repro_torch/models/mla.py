"""Multi-head Latent Attention, DeepSeek-V2/V3 (counterpart of
`repro.models.mla`).

Prefill runs the naive expansion (latent -> per-head K/V) through the
port's `flash_attention` kernel at head_dim qk_nope + qk_rope (192 at
full width: the tensor-core variant in bf16, the CUDA-core one in f32),
V zero-padded to that width and sliced back, as the reference does (the
kernel takes one head_dim for q, k and v). Decode uses the *absorbed*
form in plain PyTorch, as the reference does: queries are projected into
the KV latent space, so attention runs against the compressed cache [B,
S, kv_lora] + shared rope keys [B, S, qk_rope].
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.ops import flash_attention
from repro_torch.models import layers
from repro_torch.parallel import spmd


def init_mla(cfg, generator, device) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
    s = 1.0 / np.sqrt(d)
    return {
        "q_down": layers.normal((d, qlr), s, generator, device),
        "q_norm": {"w": torch.ones(qlr, device=device)},
        "q_up": layers.normal((qlr, H * (dn + dr)), 1.0 / np.sqrt(qlr),
                              generator, device),
        "kv_down": layers.normal((d, kvlr + dr), s, generator, device),
        "kv_norm": {"w": torch.ones(kvlr, device=device)},
        "kv_up": layers.normal((kvlr, H * (dn + dv)), 1.0 / np.sqrt(kvlr),
                               generator, device),
        "wo": layers.normal((H * dv, d), 1.0 / np.sqrt(H * dv), generator,
                            device),
    }


def _q_proj(p, x, cfg, positions):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = layers.rms_norm(layers.dense(x, p["q_down"]), p["q_norm"]["w"])
    q = layers.dense(cq, p["q_up"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _kv_latent(p, x, cfg, positions):
    kvlr = cfg.kv_lora_rank
    ckv = layers.dense(x, p["kv_down"])                 # [B,S,kvlr+dr]
    c, k_rope = ckv[..., :kvlr], ckv[..., kvlr:]
    c = layers.rms_norm(c, p["kv_norm"]["w"])
    k_rope = layers.apply_rope(k_rope[..., None, :], positions,
                               cfg.rope_theta)[..., 0, :]
    return c, k_rope


def mla_apply(p, x, cfg, *, positions=None):
    """Prefill path with naive latent expansion. Returns (output,
    (latent c [B,S,kv_lora], rope keys [B,S,qk_rope])) for the cache."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope = _q_proj(p, x, cfg, positions)
    c, k_rope = _kv_latent(p, x, cfg, positions)
    kv = layers.dense(c, p["kv_up"]).reshape(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)], dim=-1)
    # Pad V to the QK head dim so the attention kernel is reusable.
    o = flash_attention(q, k, spmd.pad_last(v, dn + dr - dv),
                        causal=True)[..., :dv]
    return layers.dense(o.reshape(B, S, H * dv), p["wo"]), (c, k_rope)


def mla_decode(p, x, cfg, cache_c, cache_kr, length):
    """Absorbed one-token decode in the compressed latent space. Writes
    the new latent and rope key at position `length` (a 0-dim integer
    tensor) of cache_c / cache_kr IN PLACE and returns (output,
    (cache_c, cache_kr))."""
    B = x.shape[0]
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    kvlr = cfg.kv_lora_rank
    dt = x.dtype
    positions = length.reshape(1, 1).expand(B, 1)
    q_nope, q_rope = _q_proj(p, x, cfg, positions)      # [B,1,H,dn/dr]
    c_new, kr_new = _kv_latent(p, x, cfg, positions)
    at = length.reshape(1).long()
    layers.cache_write(cache_c, at, c_new, H)
    layers.cache_write(cache_kr, at, kr_new, H)

    w_kv = p["kv_up"].to(dt).reshape(kvlr, H, dn + dv)
    w_uk, w_uv = w_kv[..., :dn], w_kv[..., dn:]
    q_lat = torch.einsum("bqhd,chd->bqhc", q_nope, w_uk)  # [B,1,H,kvlr]

    scale = 1.0 / math.sqrt(dn + dr)
    cc, ckr = cache_c.float(), cache_kr.float()
    s = (torch.einsum("bqhc,bsc->bhqs", q_lat.float(), cc)
         + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), ckr)) * scale
    valid = torch.arange(cc.shape[1], device=x.device) < (length + 1)
    s = torch.where(valid, s, layers.NEG_INF)
    prob = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsc->bqhc", prob, cc)
    v = torch.einsum("bqhc,chv->bqhv", ctx, w_uv.float())
    out = layers.dense(v.reshape(B, 1, H * dv).to(dt), p["wo"])
    return out, (cache_c, cache_kr)

"""Language-model assembly for the port's families (counterpart of
`repro.models.lm`): dense (uniform [attention + FFN] blocks) and ssm
(Mamba2 blocks). The MoE, MLA, hybrid, encoder, VLM and audio families
come later (ROADMAP.md, queue 1).

Entry points, as in the reference (params is an `LM` module):
  init_params(cfg, generator, device) -> LM (f32 masters)
  forward(params, cfg, batch)         -> logits        [full sequence]
  prefill(params, cfg, batch)         -> (logits, cache)
  decode_step(params, cfg, tokens, cache) -> (logits, cache) [one token]
  make_cache(cfg, B, S, device)       -> zeroed cache dict

`batch` is {"tokens": integer tensor [B, S]} on the model's device. The
cache keeps the reference's layout: dense k/v [L,B,S,KV,dh] and ssm
ssm [L,B,H,P,N] (f32) / conv [L,B,CONV_K-1,conv_dim], the activations
in COMPUTE_DTYPE, plus "len" (0-dim int32, the tokens it holds).
`decode_step` updates the cache tensors in place and returns the same
dict with "len" advanced.

Devices: `init_params` and `make_cache` run on CUDA unless given
another device (`device="cpu"`, or "meta" for shapes only).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch.core.engine import resolve_device
from repro_torch.models import layers, ssm
from repro_torch.models.layers import ParamTree

COMPUTE_DTYPE = torch.bfloat16
FAMILIES = ("dense", "ssm")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not ported yet "
                         f"(ROADMAP.md, queue 1); ported: {FAMILIES}")


class LM(nn.Module):
    """The model's parameters: `embed` (tok, ln_f) and one `ParamTree`
    per layer in `blocks`, under the reference's leaf names (the
    reference stacks the layers on a leading axis)."""

    def __init__(self, cfg, embed: dict, blocks: list):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = ParamTree(embed)
        self.blocks = nn.ModuleList(ParamTree(b) for b in blocks)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, self.cfg, {"tokens": tokens})


# ------------------------------------------------------------------ blocks
def init_dense_block(cfg, generator, device) -> dict:
    p = {"ln1": layers.init_norm(cfg.d_model, cfg.norm, device),
         "ln2": layers.init_norm(cfg.d_model, cfg.norm, device),
         "attn": layers.init_attention(cfg, generator, device)}
    p["ffn"] = layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, generator,
                               device,
                               bias=(cfg.mlp == "gelu" and cfg.qkv_bias))
    return p


def dense_block_apply(p, h, cfg):
    """Full-sequence block. Returns (h, (k, v)) for the cache."""
    hn = layers.apply_norm(h, p["ln1"], cfg.norm)
    a, kv = layers.attention_apply(p["attn"], hn, cfg)
    h = h + a
    hn = layers.apply_norm(h, p["ln2"], cfg.norm)
    return h + layers.mlp_apply(p["ffn"], hn, cfg.mlp), kv


def dense_block_decode(p, h, cfg, ck, cv, length):
    hn = layers.apply_norm(h, p["ln1"], cfg.norm)
    a, (ck, cv) = layers.attention_decode(p["attn"], hn, cfg, ck, cv, length)
    h = h + a
    hn = layers.apply_norm(h, p["ln2"], cfg.norm)
    return h + layers.mlp_apply(p["ffn"], hn, cfg.mlp), ck, cv


def init_mamba_block(cfg, generator, device) -> dict:
    return {"ln": layers.init_norm(cfg.d_model, cfg.norm, device),
            "mixer": ssm.init_mamba2(cfg, generator, device)}


def mamba_block_apply(p, h, cfg):
    """Full-sequence block. Returns (h, final ssm state, conv tail)."""
    hn = layers.apply_norm(h, p["ln"], cfg.norm)
    y, s_final = ssm.mamba2_apply(p["mixer"], hn, cfg)
    # conv tail for decode handoff: last CONV_K-1 pre-conv features.
    proj = hn @ p["mixer"]["in_proj"].to(h.dtype)
    _, xBC, _ = ssm._split_in(proj, cfg)
    conv_tail = xBC[:, -(ssm.CONV_K - 1):, :]
    return h + y, s_final, conv_tail


def mamba_block_decode(p, h, cfg, s, conv):
    hn = layers.apply_norm(h, p["ln"], cfg.norm)
    y, s_new, conv_new = ssm.mamba2_decode(p["mixer"], hn, cfg, s, conv)
    return h + y, s_new, conv_new


# --------------------------------------------------------------- embedding
def init_embed(cfg, generator, device) -> dict:
    p = {"tok": layers.normal((cfg.vocab, cfg.d_model), 0.02, generator,
                              device),
         "ln_f": layers.init_norm(cfg.d_model, cfg.norm, device)}
    if not cfg.tie_embeddings:
        p["head"] = layers.normal((cfg.d_model, cfg.vocab),
                                  1.0 / np.sqrt(cfg.d_model), generator,
                                  device)
    return p


def embed_inputs(params, cfg, batch):
    """Token embedding in COMPUTE_DTYPE (gathered, then cast: the same
    values as the reference's cast-then-gather)."""
    return params.embed["tok"][batch["tokens"].long()].to(COMPUTE_DTYPE)


def lm_head(params, cfg, h):
    p = params.embed
    h = layers.apply_norm(h, p["ln_f"], cfg.norm)
    w = (p["tok"].T if cfg.tie_embeddings else p["head"]).to(h.dtype)
    return h @ w


# ------------------------------------------------------------- init params
def init_params(cfg, generator=None, device=None) -> LM:
    """Random f32 master weights drawn from `generator` (a
    `torch.Generator` on `device`; unused on the meta device). The
    distributions are the reference's; the numbers are torch's."""
    device = resolve_device(device)
    if device.type != "meta" and generator is None:
        raise ValueError("init_params needs a torch.Generator on "
                         f"{device} (only the meta device draws nothing)")
    _check_family(cfg)
    init_block = (init_dense_block if cfg.family == "dense"
                  else init_mamba_block)
    embed = init_embed(cfg, generator, device)
    blocks = [init_block(cfg, generator, device)
              for _ in range(cfg.n_layers)]
    return LM(cfg, embed, blocks)


# ---------------------------------------------------------------- forward
def forward(params, cfg, batch):
    """Full-sequence forward. Returns logits [B, S, vocab]."""
    h = embed_inputs(params, cfg, batch)
    for blk in params.blocks:
        if cfg.family == "dense":
            h, _ = dense_block_apply(blk, h, cfg)
        else:
            h, _, _ = mamba_block_apply(blk, h, cfg)
    return lm_head(params, cfg, h)


# ------------------------------------------------------------------ cache
def make_cache(cfg, B, S, device=None) -> Dict[str, Any]:
    """Zeroed serving cache sized for S total positions."""
    _check_family(cfg)
    device = resolve_device(device)
    c: Dict[str, Any] = {"len": torch.zeros((), dtype=torch.int32,
                                            device=device)}
    L = cfg.n_layers
    if cfg.family == "dense":
        c["k"] = torch.zeros(L, B, S, cfg.n_kv_heads, cfg.head_dim,
                             dtype=COMPUTE_DTYPE, device=device)
        c["v"] = torch.zeros_like(c["k"])
    else:
        _, nheads, conv_dim = ssm.ssm_dims(cfg)
        c["ssm"] = torch.zeros(L, B, nheads, cfg.ssm_head_dim, cfg.ssm_state,
                               device=device)
        c["conv"] = torch.zeros(L, B, ssm.CONV_K - 1, conv_dim,
                                dtype=COMPUTE_DTYPE, device=device)
    return c


# ---------------------------------------------------------------- prefill
def prefill(params, cfg, batch):
    """Full-sequence forward that also builds the serving cache."""
    h = embed_inputs(params, cfg, batch)
    S = h.shape[1]
    cache: Dict[str, Any] = {"len": torch.tensor(S, dtype=torch.int32,
                                                 device=h.device)}
    parts = ([], [])
    for blk in params.blocks:
        if cfg.family == "dense":
            h, kv = dense_block_apply(blk, h, cfg)
        else:
            h, s, conv = mamba_block_apply(blk, h, cfg)
            kv = (s, conv)
        for part, t in zip(parts, kv):
            part.append(t)
    names = ("k", "v") if cfg.family == "dense" else ("ssm", "conv")
    for name, part in zip(names, parts):
        cache[name] = torch.stack(part)
    return lm_head(params, cfg, h), cache


# ----------------------------------------------------------------- decode
def decode_step(params, cfg, tokens, cache):
    """One decode step. tokens: [B, 1] integers. Returns (logits, cache);
    the cache's tensors are updated in place."""
    length = cache["len"]
    h = embed_inputs(params, cfg, {"tokens": tokens})
    for i, blk in enumerate(params.blocks):
        if cfg.family == "dense":
            h, _, _ = dense_block_decode(blk, h, cfg, cache["k"][i],
                                         cache["v"][i], length)
        else:
            h, s, conv = mamba_block_decode(blk, h, cfg, cache["ssm"][i],
                                            cache["conv"][i])
            cache["ssm"][i].copy_(s)
            cache["conv"][i].copy_(conv)
    cache["len"] = length + 1
    return lm_head(params, cfg, h), cache

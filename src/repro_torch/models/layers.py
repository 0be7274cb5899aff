"""Core neural layers shared by every family of the port (counterpart of
`repro.models.layers`).

Conventions as in the reference: activations are [batch, seq, d_model];
parameters are f32 master copies, read by the reference's leaf names
(`p["wq"]`) from `ParamTree` modules and cast to the compute dtype inside
the forward. Full-sequence attention runs the port's hand-written
`flash_attention` kernel (the reference calls its jnp
`multihead_attention`, the same algorithm); single-token decode attention
is plain PyTorch, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels.ops import flash_attention
from repro_torch.parallel import spmd

NEG_INF = -1e30


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: leaves are (frozen)
    `nn.Parameter`s, inner nodes `ParamTree`s, and both are read by name,
    `p["wq"]` or `p.wq`, so the layer functions keep the reference's
    pytree access and `named_parameters()` its leaf paths."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def normal(shape, scale, generator, device) -> torch.Tensor:
    """f32 N(0, 1) * scale drawn from `generator` (on the meta device:
    shape only)."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    # In place: a full-width expert tensor is not held twice.
    return torch.randn(shape, generator=generator, device=device).mul_(scale)


# ----------------------------------------------------------------- norms
def rms_norm(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def nonparam_layer_norm(x, eps=1e-5):
    """OLMo's non-parametric LayerNorm (no scale, no bias)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm(x, w, b, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def apply_norm(x, p, kind):
    if kind == "rmsnorm":
        return rms_norm(x, p["w"])
    if kind == "nonparam_ln":
        return nonparam_layer_norm(x)
    return layer_norm(x, p["w"], p["b"])


def init_norm(d, kind, device) -> dict:
    if kind == "rmsnorm":
        return {"w": torch.ones(d, device=device)}
    if kind == "nonparam_ln":
        return {}
    return {"w": torch.ones(d, device=device),
            "b": torch.zeros(d, device=device)}


# ------------------------------------------------------------------ rope
def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta=10000.0):
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    dh = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(dh, theta)).to(x.device)
    ang = positions[..., :, None].float() * freqs      # [..., S, Dh/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention
def decode_attention(q, k_cache, v_cache, length, *, window=None):
    """Single-token attention against a cache (plain PyTorch).

    q: [B,1,H,Dh]; k_cache/v_cache: [B,S,KV,Dh]; length: tokens valid
    (an int or a 0-dim tensor). On DTensors: `parallel.spmd`'s.
    """
    if spmd.is_dtensor(k_cache):
        return spmd.decode_attention(q, k_cache, v_cache, length,
                                     window=window)
    B, S, KV, Dh = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qs = q.reshape(B, 1, KV, G, Dh).float() * (1.0 / math.sqrt(Dh))
    s = torch.einsum("bqkgd,bskd->bkgqs", qs, k_cache.float())
    pos = torch.arange(S, device=q.device)
    valid = pos < length
    if window is not None:
        valid &= pos > (length - 1 - window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v_cache.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, Dh).to(q.dtype)


def cache_write(cache, at, new, n_heads: int):
    """cache[:, at] = new in place (at: a 1-element integer tensor; on
    DTensors `parallel.spmd`'s)."""
    if spmd.is_dtensor(cache):
        return spmd.cache_write(cache, at, new, n_heads)
    return cache.index_copy_(1, at, new.to(cache.dtype))


# ------------------------------------------------------------------- mlp
def dense(x, w):
    """x @ w with w cast to x's dtype (on DTensors
    `parallel.spmd.matmul`)."""
    w = w.to(x.dtype)
    return spmd.matmul(x, w) if spmd.is_dtensor(x) else x @ w


def mlp_apply(p, x, kind):
    dt = x.dtype
    if kind == "swiglu":
        g = dense(x, p["w_gate"])
        u = dense(x, p["w_up"])
        return dense(F.silu(g) * u, p["w_down"])
    h = dense(x, p["w_up"])
    if "b_up" in p:
        h = h + p["b_up"].to(dt)
    h = F.gelu(h, approximate="tanh")          # jax.nn.gelu's default
    out = dense(h, p["w_down"])
    if "b_down" in p:
        out = out + p["b_down"].to(dt)
    return out


def init_mlp(d_model, d_ff, kind, generator, device, bias=False) -> dict:
    s_in, s_out = 1.0 / np.sqrt(d_model), 1.0 / np.sqrt(d_ff)
    if kind == "swiglu":
        return {
            "w_gate": normal((d_model, d_ff), s_in, generator, device),
            "w_up": normal((d_model, d_ff), s_in, generator, device),
            "w_down": normal((d_ff, d_model), s_out, generator, device),
        }
    p = {"w_up": normal((d_model, d_ff), s_in, generator, device),
         "w_down": normal((d_ff, d_model), s_out, generator, device)}
    if bias:
        p["b_up"] = torch.zeros(d_ff, device=device)
        p["b_down"] = torch.zeros(d_model, device=device)
    return p


# --------------------------------------------------------- GQA attention
def init_attention(cfg, generator, device) -> dict:
    """cfg needs: d_model, n_heads, n_kv_heads, head_dim, qkv_bias."""
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    p = {
        "wq": normal((d, H * dh), s, generator, device),
        "wk": normal((d, KV * dh), s, generator, device),
        "wv": normal((d, KV * dh), s, generator, device),
        "wo": normal((H * dh, d), 1.0 / np.sqrt(H * dh), generator, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H * dh, device=device)
        p["bk"] = torch.zeros(KV * dh, device=device)
        p["bv"] = torch.zeros(KV * dh, device=device)
    return p


def attention_qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = dense(x, p["wq"])
    k = dense(x, p["wk"])
    v = dense(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = (q + p["bq"].to(dt), k + p["bk"].to(dt),
                   v + p["bv"].to(dt))
    if spmd.is_dtensor(q):
        q, k, v = (spmd.split_heads(q, H, dh), spmd.split_heads(k, KV, dh),
                   spmd.split_heads(v, KV, dh))
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, KV, dh)
    v = v.reshape(B, S, KV, dh)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(p, x, cfg, *, positions=None):
    """Full-sequence (train / prefill) GQA attention through the
    `flash_attention` kernel. Returns (output, (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = attention_qkv(p, x, cfg, positions)
    o = flash_attention(q, k, v, causal=cfg.causal,
                        window=cfg.sliding_window)
    return dense(o.reshape(B, S, -1), p["wo"]), (k, v)


def attention_decode(p, x, cfg, cache_k, cache_v, length):
    """One-token decode. `length` is a 0-dim integer tensor. Writes the
    new k/v at position `length` of cache_k/cache_v IN PLACE (the
    reference returns updated copies; the cache is the serving loop's own
    state) and returns (output, (cache_k, cache_v))."""
    B = x.shape[0]
    positions = length.reshape(1, 1).expand(B, 1)
    q, k, v = attention_qkv(p, x, cfg, positions)
    at = length.reshape(1).long()
    cache_write(cache_k, at, k, cfg.n_heads)
    cache_write(cache_v, at, v, cfg.n_heads)
    o = decode_attention(q, cache_k, cache_v, length + 1,
                         window=cfg.sliding_window)
    return dense(o.reshape(B, 1, -1), p["wo"]), (cache_k, cache_v)

"""Mixture-of-Experts layer (counterpart of `repro.models.moe`).

Capacity-based token-choice routing: positions inside each expert come
from a cumulative sum over the routing one-hots; dispatch and combine
are a scatter-add into and a gather from an [E*C + 1, D] buffer (the
last row is the drop slot), as in the reference. The expert products
are batched matrix products over groups of experts, each group's
weights cast to the compute dtype on its own (`EXPERT_GROUP_BYTES`), so
a full-width layer never holds a compute-dtype copy of all its experts.

Variants used by the assigned architectures:
  * deepseek-v3: sigmoid scores, top-8 of 256, normalized weights, plus
    one always-on shared expert (its own FFN).
  * arctic: softmax top-2 of 128 routed experts in parallel with a dense
    residual FFN.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.models import layers

# Compute-dtype weights of one group of experts (gate, up and down) are
# at most this large: 1 GiB, 12 of DeepSeek-V3's experts in bf16.
EXPERT_GROUP_BYTES = 1 << 30


def init_moe(cfg, generator, device) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    p = {
        "router": layers.normal((d, e), s_in, generator, device),
        "w_gate": layers.normal((e, d, f), s_in, generator, device),
        "w_up": layers.normal((e, d, f), s_in, generator, device),
        "w_down": layers.normal((e, f, d), s_out, generator, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(
            d, cfg.moe_d_ff * cfg.n_shared_experts, "swiglu", generator,
            device)
    if cfg.dense_residual:
        p["dense"] = layers.init_mlp(d, cfg.d_ff, cfg.mlp, generator, device)
    return p


def _route(scores, top_k):
    """The top_k scores per row and their experts, the lower index first
    among equal scores (as `jax.lax.top_k`; `torch.topk` promises no
    order, so this takes them from a stable descending sort)."""
    w, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return w[..., :top_k], idx[..., :top_k]


def _experts(p, buf):
    """The expert SwiGLU on buf [E, C, D] in buf's dtype -> [E, C, D]."""
    E, _, D = buf.shape
    dt = buf.dtype
    per_expert = 3 * D * p["w_gate"].shape[-1] * buf.element_size()
    step = max(1, EXPERT_GROUP_BYTES // per_expert)
    out = torch.empty_like(buf)
    for e0 in range(0, E, step):
        sl = slice(e0, e0 + step)
        g = torch.bmm(buf[sl], p["w_gate"][sl].to(dt))
        u = torch.bmm(buf[sl], p["w_up"][sl].to(dt))
        out[sl] = torch.bmm(F.silu(g) * u, p["w_down"][sl].to(dt))
    return out


def dispatch_slots(gate_i, E: int, C: int):
    """(keep [T*K], slot [T*K]) of each (token, k) pair of gate_i [T, K]
    in (token, k) order: its position inside its expert from the
    exclusive cumsum over the routing one-hots, kept if below the
    capacity C, at slot expert * C + position, else at the drop slot
    E * C."""
    flat_e = gate_i.reshape(-1)                                  # [TK]
    onehot = F.one_hot(flat_e, E).int()                          # [TK, E]
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]            # [TK]
    keep = pos < C
    return keep, torch.where(keep, flat_e * C + pos, E * C)


def moe_apply(p, x, cfg, *, capacity_factor=None):
    """x: [B, S, D] -> ([B, S, D], load-balance aux loss)."""
    B, S, D = x.shape
    dt = x.dtype
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, D)

    logits = (xf @ p["router"].to(dt)).float()                  # [T, E]
    if cfg.router_score == "sigmoid":                # deepseek-v3 style
        scores = torch.sigmoid(logits)
        gate_w, gate_i = _route(scores, K)
        gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True),
                                          1e-9)
    else:                                            # softmax top-k
        gate_w, gate_i = _route(logits, K)
        gate_w = torch.softmax(gate_w, dim=-1)

    cf = capacity_factor or cfg.capacity_factor
    C = max(1, int(np.ceil(T * K / E * cf)))

    keep, slot = dispatch_slots(gate_i, E, C)

    # Dispatch: scatter tokens into [E*C + 1, D].
    xk = xf.repeat_interleave(K, dim=0)                          # [TK, D]
    buf = torch.zeros(E * C + 1, D, dtype=dt, device=x.device)
    buf.index_add_(0, slot, xk)
    y = _experts(p, buf[: E * C].reshape(E, C, D))

    # Combine: gather each (token, k) result and weight it.
    y = torch.cat([y.reshape(E * C, D), y.new_zeros(1, D)])
    gathered = y[slot].reshape(T, K, D)
    out = torch.einsum("tkd,tk->td", gathered,
                       gate_w.to(dt) * keep.reshape(T, K).to(dt))

    if cfg.n_shared_experts:
        out = out + layers.mlp_apply(p["shared"], xf, "swiglu")
    if cfg.dense_residual:
        out = out + layers.mlp_apply(p["dense"], xf, cfg.mlp)

    # Router load-balance aux (returned for the train loss).
    me = torch.softmax(logits, dim=-1).mean(dim=0)               # [E]
    ce = F.one_hot(gate_i[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, D), aux

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
from repro_torch.parallel import spmd

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


def _gates(xf, router, cfg):
    """(router logits f32 [T, E], gate weights [T, K], experts [T, K])."""
    logits = (xf @ router.to(xf.dtype)).float()                 # [T, E]
    if cfg.router_score == "sigmoid":                # deepseek-v3 style
        scores = torch.sigmoid(logits)
        gate_w, gate_i = _route(scores, cfg.top_k)
        gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True),
                                          1e-9)
    else:                                            # softmax top-k
        gate_w, gate_i = _route(logits, cfg.top_k)
        gate_w = torch.softmax(gate_w, dim=-1)
    return logits, gate_w, gate_i


def _dispatch(xf, gate_i, E: int, C: int):
    """(keep, slot, buf [E*C + 1, D]): the tokens scattered to their
    experts' slots, the last row the drop slot."""
    keep, slot = dispatch_slots(gate_i, E, C)
    xk = xf.repeat_interleave(gate_i.shape[1], dim=0)            # [TK, D]
    buf = torch.zeros(E * C + 1, xf.shape[1], dtype=xf.dtype,
                      device=xf.device)
    buf.index_add_(0, slot, xk)
    return keep, slot, buf


def _combine(y, slot, gate_w, keep):
    """Each token's weighted sum of its (token, k) rows of y [E*C + 1,
    D] (the drop slot's row zero)."""
    T, K = gate_w.shape
    return torch.einsum("tkd,tk->td", y[slot].reshape(T, K, -1),
                        gate_w.to(y.dtype) * keep.reshape(T, K).to(y.dtype))


def _capacity(T: int, cfg, capacity_factor) -> int:
    cf = capacity_factor or cfg.capacity_factor
    return max(1, int(np.ceil(T * cfg.top_k / cfg.n_experts * cf)))


def moe_apply(p, x, cfg, *, capacity_factor=None):
    """x: [B, S, D] -> ([B, S, D], load-balance aux loss). On DTensors,
    `_moe_apply_sharded`."""
    if spmd.is_dtensor(x):
        return _moe_apply_sharded(p, x, cfg, capacity_factor)
    B, S, D = x.shape
    E = cfg.n_experts
    T = B * S
    xf = x.reshape(T, D)
    logits, gate_w, gate_i = _gates(xf, p["router"], cfg)
    C = _capacity(T, cfg, capacity_factor)
    keep, slot, buf = _dispatch(xf, gate_i, E, C)
    y = _experts(p, buf[: E * C].reshape(E, C, D))
    out = _combine(torch.cat([y.reshape(E * C, D), y.new_zeros(1, D)]),
                   slot, gate_w, keep)
    if cfg.n_shared_experts:
        out = out + layers.mlp_apply(p["shared"], xf, "swiglu")
    if cfg.dense_residual:
        out = out + layers.mlp_apply(p["dense"], xf, cfg.mlp)

    # Router load-balance aux (returned for the train loss).
    me = torch.softmax(logits, dim=-1).mean(dim=0)               # [E]
    ce = F.one_hot(gate_i[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, D), aux


def _moe_apply_sharded(p, x, cfg, capacity_factor):
    """`moe_apply` on DTensors, per rank on its local shards: the tokens
    stay sharded over the batch's mesh dims; the expert banks are laid
    out 2-D as the rules give them (experts over the mesh dims that shard
    dim 0 ('model'), the FFN width over those that shard it ('data'),
    replicated elsewhere, so an FSDP shard is gathered first).

    Each rank routes its own tokens (the capacity is per token shard,
    as GShard's local groups) and scatters them into its experts' slots;
    the slots are all-gathered over the FFN width's mesh dims that also
    shard the tokens, run through the rank's slice of the FFN width, and
    reduce-scattered back (all-reduced over the width's other dims); the
    combined output is partial over the experts' mesh dims and becomes a
    DTensor with `Partial` placements there, so the next op's plan
    all-reduces it. The aux loss averages the ranks' local means.

    Gradients: what a rank computes for its own experts only (the
    dispatched tokens, the combine weights) is its share of a sum over
    the experts' mesh dims, so those local copies take Partial gradient
    placements there; the aux loss's routing is computed apart, whole on
    every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    B, S, D = x.shape
    E, dt = cfg.n_experts, x.dtype
    rep = (Replicate(),) * mesh.ndim

    def part(dims, pl=rep):
        return tuple(Partial() if i in dims else q for i, q in enumerate(pl))

    xpl = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                for pl in x.placements)
    batch = spmd.mesh_dims(x, lambda pl: pl.is_shard(0))
    wg = p["w_gate"]
    e_dims = spmd.mesh_dims(wg, lambda pl: pl.is_shard(0))
    f_dims = spmd.mesh_dims(wg, lambda pl: pl.is_shard(2))
    wpl = {n: tuple(Shard(0) if i in e_dims else Shard(fd) if i in f_dims
                    else Replicate() for i in range(mesh.ndim))
           for n, fd in (("w_gate", 2), ("w_up", 2), ("w_down", 1))}
    gather = [i for i in f_dims if i in batch]

    # Routing for the aux loss (whole on every rank) and for the
    # dispatch and combine (this rank's experts' share).
    logits, _, gate_i = _gates(
        spmd.local(x, xpl).reshape(-1, D),
        spmd.local(p["router"], rep, part(batch)), cfg)
    xf = spmd.local(x, xpl, part(e_dims, xpl)).reshape(-1, D)
    _, gate_w, _ = _gates(xf, spmd.local(p["router"], rep,
                                         part(batch + e_dims)), cfg)
    C = _capacity(xf.shape[0], cfg, capacity_factor)
    keep, slot, buf = _dispatch(xf, gate_i, E, C)
    e0 = spmd.offset(tuple(wg.shape), mesh, wpl["w_gate"])[0]
    w = {n: spmd.local(p[n], pl, part([i for i in batch if i not in gather],
                                      pl)).to(dt)
         for n, pl in wpl.items()}
    El = w["w_gate"].shape[0]
    mine = buf[e0 * C:(e0 + El) * C].reshape(El, C, D)
    # All-gather the slots over the width's token-sharding dims ...
    slots = spmd.local(spmd.wrap(mine, mesh, tuple(
        Shard(1) if i in gather else Replicate() for i in range(mesh.ndim)),
        (El, C * spmd.size(mesh, gather), D)), rep, part(f_dims))
    h = F.silu(torch.bmm(slots, w["w_gate"])) * torch.bmm(slots, w["w_up"])
    y = torch.bmm(h, w["w_down"])
    # ... and reduce-scatter the width's partial sums back.
    y = spmd.wrap(y, mesh, part(f_dims), tuple(y.shape)).redistribute(
        mesh, tuple(Shard(1) if i in gather else Replicate()
                    for i in range(mesh.ndim))).to_local()
    full = torch.cat([y.new_zeros(e0 * C, D), y.reshape(El * C, D),
                      y.new_zeros((E - e0 - El) * C + 1, D)])
    out = _combine(full, slot, gate_w, keep)
    out = spmd.wrap(out, mesh, tuple(
        Shard(0) if i in batch else Partial() if i in e_dims
        else Replicate() for i in range(mesh.ndim)), (B * S, D))
    xg = x.reshape(B * S, D)
    if cfg.n_shared_experts:
        out = out + layers.mlp_apply(p["shared"], xg, "swiglu")
    if cfg.dense_residual:
        out = out + layers.mlp_apply(p["dense"], xg, cfg.mlp)
    me = spmd.reduce(torch.softmax(logits, dim=-1).mean(dim=0), mesh, batch,
                     "avg")
    ce = spmd.reduce(F.one_hot(gate_i[:, 0], E).float().mean(dim=0), mesh,
                     batch, "avg")
    aux = spmd.wrap(E * torch.sum(me * ce), mesh, rep, ())
    return out.reshape(B, S, D), aux

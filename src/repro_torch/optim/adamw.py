"""AdamW over the port's parameters (counterpart of `repro.optim.adamw`).

A parameter "tree" here is an `nn.Module` (the `LM`: its
`named_parameters()`) or a dict of tensors keyed by those names; grads
are such a dict. The optimizer states m and v are float32 dicts that
mirror the parameters leaf for leaf, under the same names.

The arithmetic is the reference's, op for op in float32: clip at
grad_clip / max(gnorm, 1e-9), bias correction with the incremented step,
decoupled weight decay on the parameter's float32 value. Unlike the
reference's pure functions, `adamw_update` advances m and v in place and
`apply_updates` adds to the parameters in place (each op rounds as the
out-of-place one does), so a full-width model holds one copy of each.

On a mesh the leaves are DTensors: each gradient is first brought to
its parameter's placements (a Partial one all-reduced, once), the
global norm is taken on the DTensors and made a plain (replicated)
tensor, and the update runs elementwise on each rank's local
shards (the updates are local tensors; the new step keeps the old one's
placements).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch
from torch import nn

from repro_torch.parallel import spmd


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor                # int32 []
    m: Dict[str, torch.Tensor]        # float32, like params
    v: Dict[str, torch.Tensor]


def named_leaves(tree) -> Dict[str, torch.Tensor]:
    """name -> tensor of a module's parameters, or a dict as it is."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def adamw_init(params) -> AdamWState:
    leaves = named_leaves(params)
    device = next(iter(leaves.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m={k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in leaves.items()},
        v={k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in leaves.items()})


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32. DTensor
    leaves give a DTensor: each leaf's sum is Partial over the mesh dims
    that shard it and replicated elsewhere, so a replicated dim counts
    once."""
    leaves = named_leaves(tree).values()
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                   for g in leaves]).sum())


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 lr_scale=1.0):
    """Returns (updates, new_state, gnorm); updates are to be ADDED to
    params. `state.m` and `state.v` are advanced in place and are the
    new state's."""
    grads = {k: spmd.placed_like(grads[k], p)
             for k, p in named_leaves(params).items()}
    gnorm = spmd.full(global_norm(grads))
    clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                       max=1.0)
    step = spmd.to_local(state.step) + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)
    updates = {}
    for k, p in named_leaves(params).items():
        g = spmd.to_local(grads[k]).float() * clip
        m, v = spmd.to_local(state.m[k]), spmd.to_local(state.v[k])
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        u = -lr * (mh / (torch.sqrt(vh) + cfg.eps)
                   + cfg.weight_decay * spmd.to_local(p).float())
        updates[k] = u.to(p.dtype)
    step = spmd.like(step, state.step)
    return updates, AdamWState(step=step, m=state.m, v=state.v), gnorm


@torch.no_grad()
def apply_updates(params, updates):
    """Adds each update to its parameter in place (a DTensor's local
    shard); returns params."""
    for k, p in named_leaves(params).items():
        spmd.to_local(p).add_(spmd.to_local(updates[k]).to(p.dtype))
    return params

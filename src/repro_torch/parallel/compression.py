"""int8 delta compression with error feedback (counterpart of
`repro.parallel.compression`).

Used around the expensive hierarchy level, the cross-pod sync in
`parallel.hierarchical`: full fidelity on the cheap local links, int8 on
the costly ones. A tree is a dict name -> tensor (the port's parameter
trees, `optim.adamw.named_leaves`). Quantization is per-tensor symmetric
int8, the reference's arithmetic op for op in float32: s = max(max |x|,
1e-12) / 127, q = clip(round(x / s), -127, 127), rounding half to even
as `jnp.round` does. Error feedback keeps each round's quantization
residual and adds it to the next round's input.
"""
from __future__ import annotations

from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def _scale(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.abs().max(), 1e-12) / 127.0


def quantize_tree(tree: Tree):
    """tree -> (q tree int8, scale tree of f32 scalars, one per leaf)."""
    f32 = {k: x.float() for k, x in tree.items()}
    scales = {k: _scale(x) for k, x in f32.items()}
    q = {k: torch.clamp(torch.round(x / scales[k]), -127, 127).to(torch.int8)
         for k, x in f32.items()}
    return q, scales


def dequantize_tree(q: Tree, scales: Tree) -> Tree:
    return {k: qq.float() * scales[k] for k, qq in q.items()}


def compress_with_feedback(delta: Tree, err: Tree):
    """(delta, err) -> ((q, scales), new_err): this round's residual is
    carried into the next round's input."""
    acc = {k: d.float() + err[k] for k, d in delta.items()}
    q, scales = quantize_tree(acc)
    deq = dequantize_tree(q, scales)
    new_err = {k: a - deq[k] for k, a in acc.items()}
    return (q, scales), new_err


def zeros_like_err(tree: Tree) -> Tree:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in tree.items()}

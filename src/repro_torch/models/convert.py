"""Parameters of the JAX reference (`repro.models.lm.init_params`) as the
port's `LM`.

The input is the reference's params pytree with every leaf a numpy
array, e.g. `jax.tree.map(np.asarray, params)`. The reference stacks
layers on leading axes (it `vmap`s its block init): `blocks` [L, ...]
(hybrid: [G, period, ...]), `dense_blocks` [n_dense_layers, ...] and
`moe_blocks` [L - n_dense_layers, ...]. The conversion keeps the group
and leaf names and splits those axes into one `ParamTree` per layer (a
list per hybrid group); `embed`, `shared`, `mtp_block` and the
`shared_in` / `mtp_proj` matrices carry no layer axis. Values are copied
as they are (f32).

`state_from_reference` carries a whole reference train state across
(params, AdamW step / m / v, step), so that both packages can continue
training from the same state; `hier_state_from_reference` does the same
for a pod-local `HierState` (every tensor with a leading pod axis).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.lm import LM, make_trainable
from repro_torch.optim import AdamWState
from repro_torch.parallel.hierarchical import HierState
from repro_torch.train.step import TrainState

STACKED = ("blocks", "dense_blocks", "moe_blocks")
UNSTACKED = ("embed", "shared", "shared_in", "mtp_proj", "mtp_block")


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(np.asarray(node))


def _leading(node):
    """The length of the leading (layer) axis of a stacked group (None
    for a group with no leaf, such as a non-parametric norm's {})."""
    if not isinstance(node, dict):
        return np.asarray(node).shape[0]
    for child in node.values():
        n = _leading(child)
        if n is not None:
            return n
    return None


def stack_depth(cfg, group: str) -> int:
    """How many leading (layer) axes the reference stacks on a parameter
    group: 2 for a hybrid's blocks [G, period, ...], 1 for the other
    stacked groups, 0 for the unstacked ones."""
    if group not in STACKED:
        return 0
    return 2 if cfg.family == "hybrid" and group == "blocks" else 1


def from_reference(np_params: dict, cfg, device=None) -> LM:
    """The reference's params (nested dict of numpy arrays) as an `LM` on
    `device` (CUDA unless given)."""
    device = resolve_device(device)
    extra = set(np_params) - set(STACKED) - set(UNSTACKED)
    if extra:
        raise ValueError(f"{cfg.name}: unknown parameter groups "
                         f"{sorted(extra)}")

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    def split(node, depth):
        """One tree per index of the leading axis, `depth` axes deep."""
        if depth == 0:
            return _tree(node, tensor)
        return [split(_tree(node, lambda a, i=i: a[i]), depth - 1)
                for i in range(_leading(node))]

    groups = {}
    for name, node in np_params.items():
        if name in STACKED:
            groups[name] = split(node, stack_depth(cfg, name))
        elif isinstance(node, dict):
            groups[name] = _tree(node, tensor)
        else:
            groups[name] = tensor(node)
    return LM(cfg, groups)


def state_from_reference(np_state, cfg, device=None):
    """The reference's `TrainState` (its `params`, `opt` = AdamW `step`
    / `m` / `v` and `step`, every leaf a numpy array) as the port's
    `train.step.TrainState` on `device`: trainable params, m and v
    under the params' names."""
    device = resolve_device(device)

    def moments(tree):
        return {k: p.detach() for k, p in
                from_reference(tree, cfg, device).named_parameters()}

    def scalar(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)

    opt = np_state.opt
    return TrainState(
        params=make_trainable(from_reference(np_state.params, cfg, device)),
        opt=AdamWState(step=scalar(opt.step), m=moments(opt.m),
                       v=moments(opt.v)),
        step=scalar(np_state.step))


def _podded(tree, like, cfg, device):
    """A reference tree with a leading pod axis on every leaf (or a
    scalar placeholder per leaf, shaped like `like`'s leaves without
    that axis) as name -> [n_pods, ...] tensors (or name -> scalar)."""
    def leaves(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from leaves(v)
        else:
            yield np.asarray(node)

    if all(a.ndim == 0 for a in leaves(tree)):
        # Placeholders: each scalar broadcast to its leaf's shape goes
        # through the per-layer split, then one element of it is kept.
        def spread(t, ref):
            if isinstance(t, dict):
                return {k: spread(v, ref[k]) for k, v in t.items()}
            return np.broadcast_to(np.asarray(t), np.asarray(ref).shape[1:])
        named = from_reference(spread(tree, like), cfg, "cpu")
        return {k: p.detach().reshape(-1)[0].clone().to(device)
                for k, p in named.named_parameters()}
    n_pods = next(leaves(tree)).shape[0]
    pods = [dict(from_reference(_tree(tree, lambda a, i=i: a[i]), cfg,
                                device).named_parameters())
            for i in range(n_pods)]
    return {k: torch.stack([pod[k].detach() for pod in pods])
            for k in pods[0]}


def hier_state_from_reference(np_state, cfg, device=None) -> HierState:
    """The reference's `parallel.hierarchical.HierState` (every leaf a
    numpy array: params, opt, anchor and err podded [n_pods, ...], or
    anchor and err scalar placeholders without compression; opt.step
    [n_pods]; step []) as the port's `HierState` on `device`."""
    device = resolve_device(device)
    opt = np_state.opt

    def ints(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)

    like = np_state.params
    return HierState(
        params=_podded(like, like, cfg, device),
        opt=AdamWState(step=ints(opt.step),
                       m=_podded(opt.m, like, cfg, device),
                       v=_podded(opt.v, like, cfg, device)),
        anchor=_podded(np_state.anchor, like, cfg, device),
        err=_podded(np_state.err, like, cfg, device),
        step=ints(np_state.step))

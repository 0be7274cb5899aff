"""Parameters of the JAX reference (`repro.models.lm.init_params`) as the
port's `LM`.

The input is the reference's params pytree with every leaf a numpy
array, e.g. `jax.tree.map(np.asarray, params)`: {"embed": {...},
"blocks": {...}} where each block leaf carries the layers on a leading
[L, ...] axis (the reference `vmap`s its block init). The conversion
keeps the leaf names and splits that axis into one `ParamTree` per
layer; values are copied as they are (f32).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.lm import LM


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(np.asarray(node))


def from_reference(np_params: dict, cfg, device=None) -> LM:
    """The reference's params (nested dict of numpy arrays) as an `LM` on
    `device` (CUDA unless given)."""
    device = resolve_device(device)
    extra = set(np_params) - {"embed", "blocks"}
    if extra:
        raise ValueError(f"{cfg.name}: parameter groups {sorted(extra)} "
                         "belong to families not ported yet")

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    embed = _tree(np_params["embed"], tensor)
    blocks = [_tree(np_params["blocks"], lambda a, i=i: tensor(a[i]))
              for i in range(cfg.n_layers)]
    return LM(cfg, embed, blocks)

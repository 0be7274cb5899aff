"""Parameter / batch / cache sharding rules as metadata (counterpart of
`repro.parallel.sharding`).

`param_spec_tree` walks a params tree in the reference's layout (nested
dicts, layers stacked on leading axes: `reference_shape_tree`) and gives
each leaf a spec from its path and shape: megatron-style tensor
parallelism over 'model', 2D expert parallelism for MoE banks (experts
over 'model', the expert FFN width over 'data'), replication for norms
and small vectors; `fsdp=True` also shards the largest free dim of every
large parameter over the data-parallel axes (ZeRO-3). `batch_specs` /
`cache_specs` shard inputs and serving caches over the data axes, or a
long single sequence's cache over its positions. Every assignment is
guarded by divisibility: a dim that does not divide stays unsharded.

A spec is a tuple with one entry per tensor dim: None, a mesh axis name,
or a tuple of names (a 1-tuple is written as its name), equal to
`tuple(jax.sharding.PartitionSpec(...))` of the reference's rule. The
rules read only a mesh's axis names and sizes: a torch `DeviceMesh`
(`mesh_dim_names`, `shape`) or any object with an `axis_names` tuple and
a `shape` dict.

The port keeps one module per layer (`models/convert.py`), so
`layer_placements` maps the stacked specs onto the per-layer parameters
(the stacked axes dropped) as DTensor placements per mesh dim; a spec
that shards a stacked (layer) axis cannot be expressed there and raises,
unless the caller takes the departure (the leaf replicated over that
axis) and lists it.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

Spec = Tuple[Any, ...]


def _sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a DeviceMesh or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _names(mesh) -> Tuple[str, ...]:
    return tuple(_sizes(mesh))


def dp_axes(mesh):
    return ("pod", "data") if "pod" in _names(mesh) else ("data",)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    return int(np.prod([sizes[a] for a in axes]))


def _fits(shape, dim, mesh, axes) -> bool:
    return dim < len(shape) and shape[dim] % axis_size(mesh, axes) == 0


class _Rule:
    """Accumulates per-dim assignments with divisibility guards. A mesh
    axis may appear at most once across the whole spec."""

    def __init__(self, shape, mesh):
        self.shape = tuple(shape)
        self.mesh = mesh
        self.spec = [None] * len(self.shape)
        self.used = set()

    def _names(self, axes):
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def put(self, dim, axes):
        if (axes is not None and self.spec[dim] is None
                and not (set(self._names(axes)) & self.used)
                and _fits(self.shape, dim, self.mesh, axes)):
            self.spec[dim] = axes
            self.used.update(self._names(axes))
        return self

    def fsdp_largest(self, axes):
        """Shard the largest still-unsharded dim over `axes` (ZeRO-3),
        or over the subset of `axes` not yet used. Among equal dims the
        order is numpy's (unstable) argsort of the negated sizes, as in
        the reference."""
        free = tuple(a for a in self._names(axes) if a not in self.used)
        if not free:
            return self
        order = np.argsort([-s for s in self.shape])
        for dim in order:
            if self.spec[dim] is None and _fits(self.shape, int(dim),
                                                self.mesh, free):
                self.spec[int(dim)] = free if len(free) > 1 else free[0]
                self.used.update(free)
                break
        return self

    def build(self) -> Spec:
        return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                     for a in self.spec)


def _spec_for(path: str, shape, mesh, dp, fsdp: bool) -> Spec:
    nd = len(shape)
    r = _Rule(shape, mesh)

    def final():
        if fsdp and nd >= 2 and int(np.prod(shape)) >= (1 << 20):
            r.fsdp_largest(dp)
        return r.build()

    # MoE expert banks: [.., E, D, F] / [.., E, F, D]: E over 'model',
    # the FFN width over 'data' (2D expert-parallel layout).
    for k, fdim in (("ffn/w_gate", -1), ("ffn/w_up", -1),
                    ("ffn/w_down", -2)):
        if path.endswith(k) and nd >= 3:
            r.put(nd - 3, "model")
            r.put(nd + fdim, "data")
            return final()
    if path.endswith("ffn/router"):
        return r.build()
    # Embedding / head: shard the vocab dimension.
    if path.endswith("embed/tok"):
        r.put(nd - 2, "model")
        return final()
    if path.endswith("embed/head") or "frame_proj" in path:
        r.put(nd - 1, "model")
        return final()
    # Attention projections.
    for k in ("wq", "wk", "wv", "q_up", "kv_up"):
        if path.endswith("attn/" + k):
            r.put(nd - 1, "model")
            return final()
    if path.endswith("attn/wo"):
        r.put(nd - 2, "model")
        return final()
    for k in ("q_down", "kv_down"):
        if path.endswith("attn/" + k):
            return final()                     # small LoRA-down: replicated
    if path.endswith(("bq", "bk", "bv")):
        r.put(nd - 1, "model")
        return r.build()
    # Dense FFN (incl. shared expert / dense residual / plain mlp).
    if path.endswith(("w_gate", "w_up")):
        r.put(nd - 1, "model")
        return final()
    if path.endswith("w_down"):
        r.put(nd - 2, "model")
        return final()
    if path.endswith("b_up"):
        r.put(nd - 1, "model")
        return r.build()
    # Mamba2.
    if path.endswith("in_proj"):
        r.put(nd - 1, "model")
        return final()
    if path.endswith("out_proj"):
        r.put(nd - 2, "model")
        return final()
    if path.endswith(("conv_w", "conv_b")):
        r.put(nd - 1, "model")
        return r.build()
    if path.endswith(("mtp_proj", "shared_in")):
        r.put(nd - 1, "model")
        return final()
    # Norms, biases, scalars: replicated.
    return r.build()


def path_str(path) -> str:
    """A tree path (a sequence of dict keys) as "a/b/c"."""
    return "/".join(str(p) for p in path)


def _map_with_path(fn, tree, path=()):
    """fn(path, leaf) over a nested dict, in the same structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_spec_tree(params_shape: Any, mesh, *, fsdp: bool = False,
                    fsdp_axes=None):
    """A spec per leaf (anything with a `.shape`) of a nested-dict params
    tree in the reference's layout. fsdp_axes: mesh axes for the ZeRO-3
    dim (default: every data-parallel axis); ("data",) on a multi-pod
    mesh keeps parameter gathers inside a pod."""
    dp = tuple(fsdp_axes) if fsdp_axes is not None else dp_axes(mesh)
    return _map_with_path(
        lambda path, leaf: _spec_for(path_str(path), tuple(leaf.shape), mesh,
                                     dp, fsdp), params_shape)


def batch_specs(batch_shape: Any, mesh):
    """Shard every batch leaf on its leading (batch) dim over the DP
    axes."""
    dp = dp_axes(mesh)

    def assign(path, leaf):
        r = _Rule(tuple(leaf.shape), mesh)
        r.put(0, dp)
        return r.build()

    return _map_with_path(assign, batch_shape)


def cache_specs(cache_shape: Any, mesh, *, seq_parallel: bool,
                seq_axis_2d=None, seq_parallel_axes=None):
    """Serving-cache sharding (the cache layout of `models.lm.make_cache`:
    k / v [L|G, B, S, ...], ssm [L, B, H, P, N] / [G, per, B, H, P, N],
    conv [L, B, K, C] / [G, per, B, K, C], "len" a scalar). The batch
    shards over the DP axes; with seq_parallel (a long single sequence)
    the attention cache shards S instead, over `seq_parallel_axes` or
    the DP axes; `seq_axis_2d` also shards S of a batch-sharded cache
    over that axis and leaves the heads whole."""
    dp = dp_axes(mesh)

    def assign(path, leaf):
        name = path_str(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        r = _Rule(shape, mesh)
        if nd == 0:
            return r.build()
        if name in ("k", "v") and nd >= 4:
            b_dim, s_dim = 1, 2                 # [L|G, B, S, ...]
            if seq_parallel:
                r.put(s_dim, seq_parallel_axes or dp)
            else:
                r.put(b_dim, dp)
                if seq_axis_2d is not None:
                    r.put(s_dim, seq_axis_2d)
                    return r.build()
            if nd == 5:
                r.put(3, "model")               # KV heads (if divisible)
            return r.build()
        if name == "ssm":
            b_dim = 2 if nd >= 6 else 1
            r.put(b_dim, dp)
            r.put(b_dim + 1, "model")           # SSD heads
            return r.build()
        if name == "conv":
            b_dim = 2 if nd >= 5 else 1
            r.put(b_dim, dp)
            r.put(nd - 1, "model")              # conv features
            return r.build()
        r.put(0, dp)
        return r.build()

    return _map_with_path(assign, cache_shape)


# ------------------------------------------------- the port's own layout
def _as_tree(node):
    """A module of the port's `LM` as the reference's nested tree: a
    `ParamTree` as a dict (children in the reference's pytree order,
    sorted by name), a module list as a list, a parameter as itself."""
    if isinstance(node, torch.nn.ModuleList):
        return [_as_tree(n) for n in node]
    if isinstance(node, torch.nn.Parameter):
        return node
    children = dict(node.named_parameters(recurse=False))
    children.update(node.named_children())
    return {k: _as_tree(children[k]) for k in sorted(children)}


def _restack(node):
    """Per-layer trees (a list) as one tree with a leading layer axis."""
    if isinstance(node, list):
        inner = [_restack(n) for n in node]
        first = inner[0]
        if isinstance(first, dict):
            return {k: _restack([t[k] for t in inner]) for k in first}
        return torch.empty((len(inner),) + tuple(first.shape),
                           dtype=first.dtype, device="meta")
    if isinstance(node, dict):
        return {k: _restack(v) for k, v in node.items()}
    return torch.empty(tuple(node.shape), dtype=node.dtype, device="meta")


def reference_shape_tree(cfg) -> Dict[str, Any]:
    """The reference's params tree for `cfg` as meta tensors (shapes and
    dtypes, no allocation): the port's `LM` built on the meta device,
    its per-layer groups stacked on leading axes (`blocks` [L, ...], a
    hybrid's [G, period, ...], `dense_blocks`, `moe_blocks`), the
    unstacked groups as they are."""
    from repro_torch.models import lm
    model = lm.init_params(cfg, device="meta")
    return _restack(_as_tree(model))


def _placements(spec: Spec, mesh, name: str):
    """DTensor placements, one per mesh dim, of a spec over that mesh."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    where = {}
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{name}: spec {spec} shards dim {dim} over "
                             f"{axes}, not in the mesh's order {names}")
        for a in axes:
            where[a] = dim
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def layer_specs(model, mesh, *, fsdp: bool = False, fsdp_axes=None,
                departures=None) -> Dict[str, Spec]:
    """Parameter name of the port's `LM` -> its spec under the
    reference's rules, the stacked (layer) axes dropped. Where a rule
    shards a stacked axis over more than one rank (the port keeps one
    tensor per layer and cannot hold that split), raises a ValueError naming the leaf, or,
    given a list as `departures`, appends the leaf's reference path to
    it (once) and keeps the spec's other entries: the parameter is
    replicated over that axis instead."""
    from repro_torch.models.convert import stack_depth
    cfg = model.cfg
    specs = param_spec_tree(reference_shape_tree(cfg), mesh, fsdp=fsdp,
                            fsdp_axes=fsdp_axes)
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        depth = stack_depth(cfg, parts[0])
        keys = [parts[0]] + parts[1 + depth:]
        spec = specs
        for k in keys:
            spec = spec[k]
        # A stacked axis split over mesh axes of size 1 is not split.
        if any(axis_size(mesh, e) > 1 for e in spec[:depth]):
            leaf = "/".join(keys)
            if departures is not None:
                if leaf not in departures:
                    departures.append(leaf)
                out[name] = spec[depth:]
                continue
            raise ValueError(
                f"{cfg.name}: the rule for {leaf} {spec} shards the stacked "
                f"layer axis, which the port's per-layer parameters "
                f"({name}) cannot hold")
        out[name] = spec[depth:]
    return out


def layer_placements(model, mesh, *, fsdp: bool = False, fsdp_axes=None,
                     departures=None):
    """Parameter name of the port's `LM` -> a tuple of DTensor placements
    (`Shard(dim)` / `Replicate()`), one per mesh dim, for
    `torch.distributed.tensor.distribute_tensor`. Raises where
    `layer_specs` does (or records in `departures`), and where a dim is
    sharded over several mesh axes out of the mesh's order."""
    return {name: _placements(spec, mesh, name) for name, spec in
            layer_specs(model, mesh, fsdp=fsdp, fsdp_axes=fsdp_axes,
                        departures=departures).items()}


def _podded(placements, pod: int):
    """Placements of a leaf with a leading pod axis: Shard(0) over mesh
    dim `pod`, every other mesh dim's shard moved one tensor dim on."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(0) if i == pod else
                 Shard(p.dim + 1) if p.is_shard() else p
                 for i, p in enumerate(placements))


def state_placements(state, mesh, cfg=None, *, departures=None):
    """(mesh, placements) for every leaf of a train state, in the state's
    structure: the tree `checkpoint.load_checkpoint(sharding_tree=)` and
    `checkpoint.place_state` read.

    - A `train.step.TrainState`: the parameters by `layer_placements`
      (tensor-parallel rules, no FSDP), AdamW's m and v as their
      parameters, `step` and `opt.step` replicated.
    - A `parallel.hierarchical.HierState` (its params a dict: pass the
      model's `cfg`) on a mesh with a 'pod' axis, as the reference's
      `lower_hier` lays it out: Shard(0) over 'pod' before every
      parameter's and m / v's placements, `opt.step` sharded over 'pod';
      the anchor and the error feedback like the parameters with
      `compress` (podded tensors), replicated scalars without.

    Raises where `layer_placements` does (a rule that shards the stacked
    layer axis: given a list as `departures`, the leaf is listed there
    and replicated over that axis instead) and for a HierState on a
    mesh without 'pod'."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import lm
    rep = (Replicate(),) * len(_names(mesh))
    if not hasattr(state, "anchor"):
        pl = layer_placements(state.params, mesh, departures=departures)
        tree = {k: (mesh, p) for k, p in pl.items()}
        return type(state)(
            params=tree,
            opt=type(state.opt)(step=(mesh, rep), m=dict(tree),
                                v=dict(tree)),
            step=(mesh, rep))
    if "pod" not in _names(mesh):
        raise ValueError(f"state_placements: a HierState needs a mesh with "
                         f"a 'pod' axis; this one has {_names(mesh)}")
    if cfg is None:
        raise ValueError("state_placements: a HierState needs the model's "
                         "cfg (its params are a dict)")
    pod = _names(mesh).index("pod")
    # The reference passes fsdp_axes=("data",) with fsdp off: the
    # tensor-parallel rules only.
    pl = layer_placements(lm.init_params(cfg, device="meta"), mesh,
                          departures=departures)
    tree = {k: (mesh, _podded(p, pod)) for k, p in pl.items()}

    def extra(leaves):
        return {k: tree[k] if t.dim() else (mesh, rep)
                for k, t in leaves.items()}

    steps = tuple(Shard(0) if i == pod else Replicate()
                  for i in range(len(rep)))
    return type(state)(
        params=tree,
        opt=type(state.opt)(step=(mesh, steps), m=dict(tree), v=dict(tree)),
        anchor=extra(state.anchor), err=extra(state.err), step=(mesh, rep))

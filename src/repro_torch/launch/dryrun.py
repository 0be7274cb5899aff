"""Dry run of every (arch x shape x mesh) cell on a fake world of 256 or
512 ranks (counterpart of `repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--remat none|dots|full]
        [--tag T] [--decode-seq2d] [--fsdp-axes data]
        [--grad-sync-dtype f32|bf16]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --hier T_POD
        [--compress] [--arch A] [--remat ...] [--tag T]

writes one record per cell to results/dryrun/<arch>__<shape>__<mesh>.json
and prints a line each; `--hier` writes one record of the pod-sync step
(`lower_hier`, below) to <arch>__hier_T<T>[_int8][__tag].json. Two
stages, as in the reference:

- `plan_cell` is the record's metadata, with no process group and no
  tensor beyond the meta model: status and skip reason, FSDP, chips,
  tokens per step, MODEL_FLOPS per device and the state bytes per
  device under the reference's layout (`parallel.sharding`'s specs on
  the reference-shaped trees, the reference's byte formula).
- `lower_cell` builds the production mesh (`launch.mesh`) over a fake
  world (`fake_world`: torch's `fake` process group, created for the
  call and destroyed before it returns; importing this module touches
  no process group and no environment variable), places the cell's
  model and inputs on the meta device as DTensors (parameters by
  `parallel.sharding.layer_placements`, inputs by `batch_specs` /
  `cache_specs`), and runs the real step once: the train step (forward,
  backward, AdamW in place), the prefill, or one decode step. Nothing
  is computed: every op runs on shapes.

What a lowering counts, all per rank on its LOCAL shards (a
`TorchDispatchMode` beneath DTensor):

- `flops`: the matrix products (torch.utils.flop_counter's formulas) and
  the kernels' own formulas (`kernels.meta`: 4 dh per kept (query, key)
  pair, the SSD's count), not the plain versions' arithmetic;
  elementwise ops are not counted.
- `bytes`: each op's tensor inputs and outputs, views, allocations and
  collectives left out: an unfused count (`bytes_basis: "unfused"`), an
  upper bound on a compiler's fused "bytes accessed".
- `collectives`: counts (`CommDebugMode`, checked against the dispatch
  mode's own), each op's result bytes per device, and the wire bytes
  (all-reduce 2x, the rest 1x). An all-to-all that DTensor asks for is
  recorded as one (its CPU-mesh fallback to all-gather + chunk is
  turned off for the lowering: the fake world moves no data).

The reference compiles each cell with XLA and also records `compile_s`
and XLA's `memory_analysis`; the port compiles nothing, so neither is
recorded.

`lower_hier` is the pod-local hierarchical step
(`parallel.hierarchical`, the state placed by
`parallel.sharding.state_placements`: each rank runs its own pod's step
over the (data, model) submesh) on train_4k x pod2x16x16, lowered
twice, with the sync never and always, under the same counting; the
difference of the two wires is one sync's cross-pod bytes, amortized
over T_pod. Each collectives record also gives `cross_pod_wire_bytes`,
the wire of the collectives whose group spans pods.

Layout departure: OLMo-1B, StarCoder2-7B and HuBERT-XLarge's rules shard
the stacked layer axis of their dense FFN over 'model', which one tensor
per layer cannot hold; the lowering replicates those leaves over
'model', lists them in `layout_departures` and records
`state_bytes_per_device_lowered` beside the reference layout's figure.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.models import lm
from repro_torch.parallel import sharding as shd

RESULTS_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun"))

# --- NVIDIA H100 SXM5 80GB (700 W) model, per GPU ------------------------
PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores (data sheet)
HBM_BW = 3.35e12             # bytes/s, HBM3 (data sheet)
# bytes/s per GPU across nodes: one 400 Gb/s InfiniBand NDR port per GPU
# (ConnectX-7). Every 16-rank axis spans more than one 8-GPU NVLink
# node, so its collectives run at this rate.
LINK_BW = 50e9

# Bytes-on-the-wire factor per byte of the op's result (ring algorithms:
# all-reduce moves ~2x the buffer; the rest ~1x), the reference's.
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

MESHES = {False: ("pod16x16", {"data": 16, "model": 16}),
          True: ("pod2x16x16", {"pod": 2, "data": 16, "model": 16})}


class AxisSizes:
    """A mesh as the sharding rules read it (axis names and sizes), with
    no process group."""

    def __init__(self, sizes: Dict[str, int]):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def collective_stats(events) -> Dict[str, Any]:
    """Per-device collective bytes from (op, result bytes) events."""
    by_op: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for op, b in events:
        by_op[op] = by_op.get(op, 0.0) + b
        counts[op] = counts.get(op, 0) + 1
    wire = sum(_WIRE_FACTOR.get(op, 1.0) * b for op, b in by_op.items())
    return {"bytes_by_op": by_op, "counts": counts, "wire_bytes": wire}


def needs_fsdp(cfg) -> bool:
    total, _ = lm.param_counts(cfg)
    return total > 20e9


# ------------------------------------------------------------------ plan
def _pairs(tree, specs):
    """(leaf, spec) pairs of a nested dict and its spec tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    else:
        yield tree, specs


def sharded_bytes(tree, spec_tree, mesh) -> int:
    """Exact per-device bytes of a tree under its specs: the
    reference's sum of numel * itemsize // (product of its axes)."""
    total = 0
    for leaf, spec in _pairs(tree, spec_tree):
        div = 1
        for axes in spec:
            div *= shd.axis_size(mesh, axes)
        total += leaf.numel() * leaf.element_size() // max(div, 1)
    return total


def _bf16(tree):
    return {k: _bf16(v) if isinstance(v, dict) else v.to(torch.bfloat16)
            for k, v in tree.items()}


def decode_cache_specs(cache, mesh, shape, decode_seq2d: bool):
    """The decode cache's specs, as the reference lays them out:
    long_500k (a single long sequence) shards S over the DP axes (with
    --decode-seq2d over data x model); decode_32k shards the batch (with
    --decode-seq2d also S over 'model')."""
    seq_par = shape.name == "long_500k"
    sp_axes = ("data", "model") if (decode_seq2d and seq_par) else None
    return shd.cache_specs(
        cache, mesh, seq_parallel=seq_par,
        seq_axis_2d="model" if (decode_seq2d and not seq_par) else None,
        seq_parallel_axes=sp_axes)


def plan(cfg, shape, sizes: Dict[str, int], *, decode_seq2d: bool = False,
         fsdp_axes=None) -> Dict[str, Any]:
    """The metadata of a supported cell of `cfg` at `shape` on a mesh of
    these axis sizes: fsdp, chips, tokens_per_step,
    state_bytes_per_device and roofline.model_flops_per_device."""
    mesh = AxisSizes(sizes)
    chips = int(np.prod(list(sizes.values())))
    fsdp = needs_fsdp(cfg) and shape.kind == "train"
    params = shd.reference_shape_tree(cfg)
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    if shape.kind == "train":
        pspecs = shd.param_spec_tree(params, mesh, fsdp=fsdp,
                                     fsdp_axes=fsdp_axes)
        # f32 params, m and v, plus two replicated int32 step scalars.
        state = 3 * sharded_bytes(params, pspecs, mesh) + 2 * 4
    else:
        params = _bf16(params)
        state = sharded_bytes(params, shd.param_spec_tree(params, mesh),
                              mesh)
        if shape.kind == "decode":
            from repro_torch.serve.steps import cache_shapes
            cache = cache_shapes(cfg, B, S)
            state += sharded_bytes(cache, decode_cache_specs(
                cache, mesh, shape, decode_seq2d), mesh)
            tokens = B
    _, active = lm.param_counts(cfg)
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    return {"status": "ok", "fsdp": fsdp, "chips": chips,
            "tokens_per_step": tokens, "state_bytes_per_device": int(state),
            "roofline": {"model_flops_per_device":
                         mult * active * tokens / chips}}


def plan_cell(arch: str, shape_name: str, multi_pod: bool, *,
              decode_seq2d: bool = False, fsdp_axes=None,
              extra_tag: str = "") -> Dict[str, Any]:
    """The record's metadata under the reference's layout, with no
    process group: a skip record as the reference's, or status "ok"
    with `plan`'s fields."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh_name, sizes = MESHES[multi_pod]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "tag": extra_tag}
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=reason)
    else:
        rec.update(plan(cfg, shape, sizes, decode_seq2d=decode_seq2d,
                        fsdp_axes=fsdp_axes))
    return rec


# -------------------------------------------------------------- counting
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_coalesced":
                "all-reduce", "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "shard_dim_alltoall": "all-to-all", "broadcast": "broadcast"}
_COMM_NAMESPACES = ("_c10d_functional", "c10d_functional",
                    "_c10d_functional_autograd", "_dtensor")
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh"}


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _collective(func):
    """The reference's name of a collective op, or None."""
    ns, _, name = func._schema.name.partition("::")
    if ns in _COMM_NAMESPACES:
        return _COLLECTIVES.get(name, "skip")
    return None


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the call stack: it
    runs some ops on plain tensors the first time it plans an op (a
    decomposition, a device mesh's coordinates), which are no rank's
    work and would make a count depend on what the process ran
    before."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        frame = frame.f_back
    return False


def _counter_mode():
    """A TorchDispatchMode that sits beneath DTensor and counts every op
    on plain (local) tensors: matrix-product flops, unfused bytes and
    collective events. DTensor-level calls pass through to DTensor
    (NotImplemented), and DTensor's own planning (fake tensors, ops run
    while it propagates a sharding) is not counted."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.events = []
            self.groups = []
            self.kernels: Dict[str, Dict[str, int]] = {}

        def kernel(self, name, flops, nbytes):
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.flops += flops
            self.bytes += nbytes

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if (any(issubclass(t, FakeTensor) for t in types)
                    or _in_sharding_propagation()):
                return out
            coll = _collective(func)
            if coll is not None:
                if coll != "skip":
                    self.events.append(
                        (coll, sum(t.numel() * t.element_size()
                                   for t in _tensors(out))))
                    self.groups.append([a for a in args
                                        if isinstance(a, str)][-1])
                return out
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                self.flops += int(fn(*args, **kwargs, out_val=out))
            if not func.is_view and \
                    func._schema.name.partition("::")[2] not in _NO_BYTES:
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in _tensors((args, kwargs, out)))
            return out

    return Counter()


def _comm_counts(cdm) -> Dict[str, int]:
    """CommDebugMode's counts under the reference's op names."""
    out: Dict[str, int] = {}
    for op, n in cdm.get_comm_counts().items():
        name = _COLLECTIVES.get(str(op).rpartition(".")[2], str(op))
        out[name] = out.get(name, 0) + n
    return out


@contextlib.contextmanager
def _alltoall_as_alltoall():
    """DTensor falls back to all-gather + chunk for a Shard -> Shard
    redistribution on a CPU mesh (gloo has no all-to-all); the fake
    world has one, so the lowering issues DTensor's own
    `_dtensor.shard_dim_alltoall` op, which runs on meta tensors."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    if not hasattr(placement_types, "shard_dim_alltoall"):
        raise RuntimeError(
            f"torch {torch.__version__}: DTensor's placement_types has no "
            "shard_dim_alltoall to route all-to-alls through")

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._group_or_group_name(group))

    prev = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = prev


@contextlib.contextmanager
def fake_world(world_size: int):
    """torch's `fake` process group of `world_size` ranks (this process
    is rank 0) for the block, destroyed at its end. Raises if a process
    group is already up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------------- lowering
def _distribute(t, mesh, spec, name):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, shd._placements(spec, mesh, name),
                             src_data_rank=None)


def _place_params(model, mesh, placements, dtype, trainable: bool):
    """Every parameter of `model` replaced by a DTensor of `dtype` on
    the meta device under its placements."""
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        dt = distribute_tensor(p.detach().to(dtype), mesh, placements[name],
                               src_data_rank=None)
        setattr(mod, leaf, torch.nn.Parameter(dt, requires_grad=trainable))


def _local_bytes(tensors) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               if hasattr(t, "to_local") else t.numel() * t.element_size()
               for t in tensors)


def lower(cfg, shape, mesh, *, remat: str = "dots", decode_seq2d=False,
          fsdp_axes=None, grad_sync_dtype: str = "f32") -> Dict[str, Any]:
    """Run one step of `cfg` at `shape` on `mesh` (a DeviceMesh of a
    fake world) with DTensors on the meta device. Returns what it
    counted: flops, bytes, kernels, collectives, the lowered state bytes
    of rank 0 and the layout departures."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.data.synthetic import input_specs
    from repro_torch.kernels import meta
    from repro_torch.parallel.constrain import (logical_axis_rules,
                                                rules_multi_pod,
                                                rules_single_pod)
    from repro_torch.serve.steps import build_decode_step, cache_shapes
    from repro_torch.train.step import TrainState, build_train_step
    from repro_torch.optim import adamw_init

    multi_pod = "pod" in mesh.mesh_dim_names
    rules = rules_multi_pod() if multi_pod else rules_single_pod()
    train = shape.kind == "train"
    fsdp = needs_fsdp(cfg) and train
    model = lm.init_params(cfg, device="meta")
    departures: list = []
    placements = shd.layer_placements(
        model, mesh, fsdp=fsdp, fsdp_axes=fsdp_axes if train else None,
        departures=departures)
    _place_params(model, mesh, placements,
                  torch.float32 if train else torch.bfloat16, train)
    B, S = shape.global_batch, shape.seq_len
    counter = _counter_mode()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_alltoall_as_alltoall())
        stack.enter_context(implicit_replication())
        stack.enter_context(logical_axis_rules(rules))
        if shape.kind != "decode":
            batch = input_specs(cfg, shape, compute_dtype=torch.bfloat16)
            bspecs = shd.batch_specs(batch, mesh)
            batch = {k: _distribute(v, mesh, bspecs[k], k)
                     for k, v in batch.items()}
        if train:
            opt = adamw_init(model)
            state = TrainState(params=model, opt=opt, step=opt.step.clone())
            step_fn = build_train_step(cfg, remat=remat,
                                       grad_sync_dtype=grad_sync_dtype)
            held = [*model.parameters(), *opt.m.values(), *opt.v.values(),
                    opt.step, state.step]
            run = lambda: step_fn(state, batch)           # noqa: E731
        elif shape.kind == "prefill":
            held = list(model.parameters())

            def run():
                with torch.no_grad():
                    return lm.prefill(model, cfg, batch)
        else:
            cache = cache_shapes(cfg, B, S)
            cspecs = decode_cache_specs(cache, mesh, shape, decode_seq2d)
            cache = {k: _distribute(v, mesh, cspecs[k], k)
                     for k, v in cache.items()}
            dp = shd.dp_axes(mesh)
            tok_spec = (dp if B % shd.axis_size(mesh, dp) == 0 else None,
                        None)
            tokens = _distribute(
                torch.empty((B, 1), dtype=torch.int32, device="meta"), mesh,
                tok_spec, "tokens")
            held = [*model.parameters(), *cache.values()]
            decode_fn = build_decode_step(cfg)
            run = lambda: decode_fn(model, tokens, cache)  # noqa: E731
        state_bytes = _local_bytes(held)
        cdm = CommDebugMode()
        with cdm, counter, meta.recording(counter.kernel):
            run()
    counts = _comm_counts(cdm)
    coll = collective_stats(counter.events)
    if counts != coll["counts"]:
        raise RuntimeError(f"CommDebugMode counted {counts}, the dispatch "
                           f"mode {coll['counts']}")
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "kernels": counter.kernels, "collectives": coll,
            "state_bytes_lowered": int(state_bytes),
            "departures": departures}


def lower_record(cfg, shape, mesh, *, remat: str = "dots",
                 decode_seq2d: bool = False, fsdp_axes=None,
                 grad_sync_dtype: str = "f32", header=None) -> Dict[str, Any]:
    """`plan` and `lower` of `cfg` at `shape` on `mesh` (a DeviceMesh of
    a fake world) as one record after `header`, with the roofline terms
    on the H100 model."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rec = dict(header or {})
    rec.update(plan(cfg, shape, sizes, decode_seq2d=decode_seq2d,
                    fsdp_axes=fsdp_axes))
    t0 = time.perf_counter()
    got = lower(cfg, shape, mesh, remat=remat, decode_seq2d=decode_seq2d,
                fsdp_axes=fsdp_axes, grad_sync_dtype=grad_sync_dtype)
    t_lower = time.perf_counter() - t0
    flops, nbytes, coll = got["flops"], got["bytes"], got["collectives"]
    rec.update(lower_s=round(t_lower, 2), flops=flops, bytes=nbytes,
               bytes_basis="unfused", kernels=got["kernels"],
               collectives=coll,
               state_bytes_per_device_lowered=got["state_bytes_lowered"],
               remat=remat)
    if got["departures"]:
        rec["layout_departures"] = got["departures"]
    rf = rec["roofline"]
    model_flops = rf["model_flops_per_device"]
    rf.update(compute_s=flops / PEAK_FLOPS, memory_s=nbytes / HBM_BW,
              collective_s=coll["wire_bytes"] / LINK_BW,
              useful_flops_ratio=(model_flops / flops) if flops else None)
    terms = {k: rf[k] for k in ("compute_s", "memory_s", "collective_s")}
    rf["bottleneck"] = max(terms, key=terms.get)
    rf["bound_s"] = max(terms.values())
    rf["roofline_fraction"] = (rf["compute_s"] / rf["bound_s"]
                               if rf["bound_s"] else None)
    return rec


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *,
               remat: str = "dots", extra_tag: str = "",
               decode_seq2d: bool = False, fsdp_axes=None,
               grad_sync_dtype: str = "f32") -> Dict[str, Any]:
    """Lower one cell on a fake world; returns the result record.

    Hillclimb levers, as the reference's: decode_seq2d shards the decode
    KV cache's S dim over 'model' (2D B x S layout); fsdp_axes overrides
    the ZeRO dim (e.g. ("data",) to keep param gathers off the pod
    links); grad_sync_dtype="bf16" rounds parameter cotangents."""
    from repro_torch.launch.mesh import make_production_mesh

    rec = plan_cell(arch, shape_name, multi_pod, decode_seq2d=decode_seq2d,
                    fsdp_axes=fsdp_axes, extra_tag=extra_tag)
    if rec["status"] != "ok":
        return rec
    header = {k: rec[k] for k in ("arch", "shape", "mesh", "kind", "tag")}
    with fake_world(rec["chips"]):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        return lower_record(get_config(arch), SHAPES[shape_name], mesh,
                            remat=remat, decode_seq2d=decode_seq2d,
                            fsdp_axes=fsdp_axes,
                            grad_sync_dtype=grad_sync_dtype, header=header)


def _spans_pods(mesh, pod: int):
    """group name -> whether that process group's ranks lie in more
    than one pod of `mesh` (pod: the mesh dim of 'pod')."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    pod_of = {int(r): i for i, sub in enumerate(mesh.mesh.movedim(pod, 0))
              for r in sub.flatten()}

    def spans(name) -> bool:
        ranks = dist.get_process_group_ranks(_resolve_process_group(name))
        return len({pod_of[r] for r in ranks}) > 1
    return spans


def lower_hier_record(cfg, shape, mesh, T_pod: int, *, compress=False,
                      remat: str = "dots", header=None) -> Dict[str, Any]:
    """The hierarchical step of `cfg` at `shape` on `mesh` (a DeviceMesh
    with 'pod' of a fake world), lowered with sync_mode "never" and
    "always" on the meta device; the record after `header`, with the
    reference's keys (`flops` / `bytes` for its `hlo_flops` /
    `hlo_bytes`, as `lower_record` names them)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint import place_state
    from repro_torch.data.synthetic import input_specs
    from repro_torch.kernels import meta
    from repro_torch.parallel.hierarchical import (build_hier_train_step,
                                                   init_hier_state)

    names = tuple(mesh.mesh_dim_names)
    n_pods = mesh.size(names.index("pod"))
    departures: list = []
    state = init_hier_state(cfg, None, n_pods, compress=compress,
                            device="meta")
    state = place_state(state, shd.state_placements(
        state, mesh, cfg, departures=departures))
    batch = {}
    for k, v in input_specs(cfg, shape, torch.bfloat16).items():
        v = v.reshape((n_pods, v.shape[0] // n_pods) + tuple(v.shape[1:]))
        spec = ("pod", "data") + (None,) * (v.dim() - 2)
        batch[k] = _distribute(v, mesh, spec, k)
    spans = _spans_pods(mesh, names.index("pod"))
    rec = dict(header or {})
    wires, flops, byts = {}, {}, {}
    for sync_mode in ("never", "always"):
        step_fn = build_hier_train_step(cfg, n_pods, T_pod,
                                        compress=compress, remat=remat,
                                        sync_mode=sync_mode)
        counter, cdm = _counter_mode(), CommDebugMode()
        with _alltoall_as_alltoall(), implicit_replication():
            with cdm, counter, meta.recording(counter.kernel):
                step_fn(state, batch)
        coll = collective_stats(counter.events)
        if _comm_counts(cdm) != coll["counts"]:
            raise RuntimeError(f"CommDebugMode counted {_comm_counts(cdm)}, "
                               f"the dispatch mode {coll['counts']}")
        coll["cross_pod_wire_bytes"] = collective_stats(
            [e for e, g in zip(counter.events, counter.groups)
             if spans(g)])["wire_bytes"]
        wires[sync_mode] = coll["wire_bytes"]
        flops[sync_mode] = float(counter.flops)
        byts[sync_mode] = float(counter.bytes)
        rec[f"collectives_{sync_mode}"] = coll
    cross_pod = max(wires["always"] - wires["never"], 0.0)
    amortized = wires["never"] + cross_pod / T_pod
    rec.update(
        wire_nosync=wires["never"], wire_sync=wires["always"],
        cross_pod_bytes_per_sync=cross_pod,
        amortized_wire_bytes=amortized,
        flops=flops["never"], bytes=byts["never"], bytes_basis="unfused",
        roofline={
            "compute_s": flops["never"] / PEAK_FLOPS,
            "memory_s": byts["never"] / HBM_BW,
            "collective_s": amortized / LINK_BW,
            "cross_pod_s_per_sync": cross_pod / LINK_BW,
        })
    if departures:
        rec["layout_departures"] = departures
    return rec


def lower_hier(arch: str, T_pod: int, *, compress: bool = False,
               remat: str = "dots", extra_tag: str = "") -> Dict[str, Any]:
    """The reference's `lower_hier`: the pod-local hierarchical train
    step of `arch` at train_4k on the pod2x16x16 mesh of a fake
    512-rank world, its sync and no-sync collectives and the amortized
    wire: wire(T) = wire_nosync + (wire_sync - wire_nosync) / T."""
    from repro_torch.launch.mesh import make_production_mesh

    header = {"arch": arch, "shape": "train_4k", "mesh": MESHES[True][0],
              "mode": f"hier_T{T_pod}" + ("_int8" if compress else ""),
              "tag": extra_tag, "status": "ok",
              "chips": int(np.prod(list(MESHES[True][1].values())))}
    with fake_world(header["chips"]):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        return lower_hier_record(get_config(arch), SHAPES["train_4k"], mesh,
                                 T_pod, compress=compress, remat=remat,
                                 header=header)


def hier_name(rec) -> str:
    """The record's file name, the reference's."""
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    return f"{rec['arch']}__{rec['mode']}{tag}.json"


def fmt_hier_line(rec, T_pod: int, compress: bool) -> str:
    """The reference's printed line of a `lower_hier` record."""
    r = rec["roofline"]
    return (f"{rec['arch']:18s} hier T={T_pod} int8={compress} "
            f"amortized_wire={rec['amortized_wire_bytes'] / 1e9:.3f}GB "
            f"cross_pod/sync={rec['cross_pod_bytes_per_sync'] / 1e9:.3f}GB "
            f"coll={r['collective_s']:.3e}s")


# ------------------------------------------------------------------ output
def save_rec(rec, out_dir=RESULTS_DIR):
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    return name


def fmt_line(rec):
    if rec["status"] == "skip":
        return (f"{rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:11s} "
                f"SKIP ({rec['reason']})")
    r = rec["roofline"]
    return (f"{rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:11s} "
            f"ok c={r['compute_s']:.3e}s m={r['memory_s']:.3e}s "
            f"coll={r['collective_s']:.3e}s -> {r['bottleneck']:<12s} "
            f"frac={r['roofline_fraction']:.2f} "
            f"(lower {rec['lower_s']:.0f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="one arch id (default: all)")
    ap.add_argument("--shape", default=None,
                    help="one shape name (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--remat", default="dots",
                    choices=["none", "dots", "full"])
    ap.add_argument("--tag", default="", help="result-file suffix")
    ap.add_argument("--decode-seq2d", action="store_true",
                    help="decode cache: shard S over 'model' (hillclimb)")
    ap.add_argument("--fsdp-axes", default=None,
                    help="comma axes for ZeRO dim, e.g. 'data'")
    ap.add_argument("--grad-sync-dtype", default="f32",
                    choices=["f32", "bf16"])
    ap.add_argument("--hier", type=int, default=0, metavar="T_POD",
                    help="lower the hierarchical pod-sync step instead")
    ap.add_argument("--compress", action="store_true",
                    help="with --hier: int8 delta exchange")
    args = ap.parse_args(argv)

    if args.hier:
        rec = lower_hier(args.arch or "qwen2_0p5b", args.hier,
                         compress=args.compress, remat=args.remat,
                         extra_tag=args.tag)
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(os.path.join(RESULTS_DIR, hier_name(rec)), "w") as f:
            json.dump(rec, f, indent=1)
        print(fmt_hier_line(rec, args.hier, args.compress), flush=True)
        return rec
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    fsdp_axes = (tuple(args.fsdp_axes.split(",")) if args.fsdp_axes
                 else None)

    n, failures = 0, []
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = lower_cell(
                        arch, shape, mp, remat=args.remat,
                        extra_tag=args.tag, decode_seq2d=args.decode_seq2d,
                        fsdp_axes=fsdp_axes,
                        grad_sync_dtype=args.grad_sync_dtype)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": MESHES[mp][0], "status": "error",
                           "tag": args.tag,
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(rec)
                save_rec(rec)
                n += 1
                print(fmt_line(rec) if rec["status"] != "error" else
                      f"{arch:18s} {shape:12s} ERROR {rec['error'][:120]}",
                      flush=True)
    print(f"{n} records in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed")


if __name__ == "__main__":
    main()

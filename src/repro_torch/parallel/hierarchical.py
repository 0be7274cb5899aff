"""Pod-local hierarchical training (counterpart of
`repro.parallel.hierarchical`): the paper's T_L idea moved to training.

The paper's distributed tree passes a lock within a machine element up
to T_L times before paying for a cross-element transfer. Here the
element is a pod and the pass is a parameter update: each pod trains its
own replica, and the expensive cross-pod synchronization runs only every
`T_pod` steps (local SGD at the pod level). T_pod = 1 syncs every step;
a larger T_pod trades staleness for cross-pod traffic, as T_L trades
fairness for locality.

Layout: the state keeps the reference's, a leading pod axis on every
tensor (`[n_pods, ...]`): params, AdamW m and v, the step counter
(`opt.step` is `[n_pods]`), and with `compress` the anchor (the params
at the last sync) and the error-feedback buffer. Without `compress` the
anchor and err are scalar zeros per leaf.

One card runs the pods one after another. `torch.func.vmap` cannot pass
through the attention and SSD kernels' autograd Functions, so pod i's
loss and its backward run on a meta-device model reparametrized by
leaves that are detached views of row i; its AdamW (`optim.adamw_update` /
`apply_updates`, in place) writes through to the podded storage, and the
sync runs in place too, so a full-width model holds one copy of each
tensor. Each pod clips by its own global norm; the learning rate is
constant (`lr_scale` 1: no schedule), as in the reference.

Optional int8 compression: pods exchange their parameter delta since the
last sync, quantized to int8 with one scale per tensor shared by every
pod, with error feedback. A wire would carry 1 byte per element (plus a
f32 scale per tensor) instead of 4; on one card nothing moves.

On a mesh with a 'pod' axis (the state placed by
`parallel.sharding.state_placements`, the batch [n_pods, B / n_pods,
...] sharded over 'pod' and 'data'), each rank runs only its own pod's
step, on its local 'pod' shard seen as a DTensor over the rest of the
mesh (`_pod_view`: the counterpart of the reference's vmap over pods
under pjit), and the sync runs over 'pod' only: the exact one an
all-reduce of the f32 parameters, the int8 one a max all-reduce of the
scale (over every mesh dim that shards the tensor) and, for two pods,
the int8 payload swapped with the other pod (a permute: one byte per
element). The metrics' means over pods are left Partial over 'pod'
(reduced when read), so a step without a sync moves nothing across
pods.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch.nn.utils.stateless import _reparametrize_module

from repro_torch.models import lm
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_update,
                               apply_updates)
from repro_torch.parallel import spmd
from repro_torch.train.step import _Loss

Tree = Dict[str, torch.Tensor]
SYNC_MODES = ("cond", "always", "never")


class HierState(NamedTuple):
    params: Tree          # [n_pods, ...] podded replicas
    opt: AdamWState       # podded: step [n_pods], m and v [n_pods, ...]
    anchor: Tree          # params at the last sync (compress) or zeros ()
    err: Tree             # error feedback [n_pods, ...] f32, or zeros ()
    step: torch.Tensor    # int32 []


def _pod_axis(tree: Tree, n_pods: int) -> Tree:
    """Each leaf repeated on a new leading axis of n_pods rows (copies:
    the rows diverge)."""
    return {k: p.unsqueeze(0).repeat((n_pods,) + (1,) * p.dim())
            for k, p in tree.items()}


def init_hier_state(cfg, generator, n_pods: int, *, compress: bool = False,
                    device=None) -> HierState:
    """Random f32 masters from `generator` (`lm.init_params` on `device`,
    CUDA unless given) on every pod, zeroed AdamW moments, step 0."""
    params = {k: p.detach() for k, p in
              lm.init_params(cfg, generator, device).named_parameters()}
    podded = _pod_axis(params, n_pods)
    dev = next(iter(podded.values())).device
    opt = AdamWState(
        step=torch.zeros((n_pods,), dtype=torch.int32, device=dev),
        m={k: torch.zeros_like(p) for k, p in podded.items()},
        v={k: torch.zeros_like(p) for k, p in podded.items()})
    if compress:
        anchor = {k: p.clone() for k, p in podded.items()}
        err = {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in podded.items()}
    else:
        anchor = {k: torch.zeros((), dtype=p.dtype, device=dev)
                  for k, p in params.items()}
        err = {k: torch.zeros((), dtype=torch.float32, device=dev)
               for k in params}
    del params
    return HierState(params=podded, opt=opt, anchor=anchor, err=err,
                     step=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def _mean_sync(params_p: Tree, anchor: Tree, err: Tree, n_pods: int):
    """Plain cross-pod average (one f32 all-reduce over the pods), in
    place: every pod row becomes the mean."""
    for p in params_p.values():
        p.copy_(torch.mean(p, dim=0, keepdim=True).expand_as(p))
    return params_p, anchor, err


@torch.no_grad()
def _compressed_sync(params_p: Tree, anchor_p: Tree, err: Tree,
                     n_pods: int):
    """int8 delta exchange with a shared scale and error feedback, in
    place. The anchor is podded (every pod keeps an identical copy), so
    every pod computes the same sum from the exchanged payloads and ends
    with the same bits. The scale is taken over every pod's rows (one
    scalar collective per tensor)."""
    for k, p in params_p.items():
        a, e = anchor_p[k], err[k]
        acc = p.float() - a.float()
        acc.add_(e)                                  # delta + e
        s = torch.clamp_min(acc.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(acc / s), -127, 127).to(torch.int8)
        e.copy_(acc.sub_(q.float() * s))             # acc - q s
        del acc
        if n_pods == 2:
            # Two pods swap their payloads (a 1-byte permute on a wire)
            # and add locally; both rows get q0 + q1.
            qsum = q.float() + torch.flip(q, dims=(0,)).float()
        else:
            qsum = torch.sum(q.float(), dim=0, keepdim=True).expand_as(e)
        mean_delta = qsum * (s / n_pods)
        a.copy_((a.float() + mean_delta).to(a.dtype))
        p.copy_(a.to(p.dtype))
    return params_p, anchor_p, err


def _pod_view(t, sub, pod: int):
    """DTensor t [n_pods, ...] (Shard(0) over mesh dim `pod`) as this
    rank's pod row: a DTensor over `sub` (the mesh without 'pod') of t's
    shape without the pod axis, on t's local storage."""
    from torch.distributed.tensor import Shard
    pl = tuple(Shard(p.dim - 1) if p.is_shard() else p
               for i, p in enumerate(t.placements) if i != pod)
    return spmd.wrap(t.to_local()[0], sub, pl, tuple(t.shape[1:]))


@torch.no_grad()
def _mesh_mean_sync(params_p: Tree, anchor: Tree, err: Tree, n_pods: int,
                    group):
    """`_mean_sync` on 'pod'-sharded DTensors: each local shard becomes
    the pods' mean by one all-reduce over `group` (mesh, pod dim)."""
    import torch.distributed._functional_collectives as funcol
    for p in params_p.values():
        x = p.to_local()
        x.copy_(funcol.all_reduce(x, "sum", group) / n_pods)
    return params_p, anchor, err


@torch.no_grad()
def _mesh_compressed_sync(params_p: Tree, anchor_p: Tree, err: Tree,
                          n_pods: int, group):
    """`_compressed_sync` on 'pod'-sharded DTensors, per rank on its
    local shards: the scale's max all-reduced over every mesh dim that
    shards the tensor (so it is the whole tensor's), the int8 payload
    swapped with the other pod (two pods) or summed in f32 over 'pod'."""
    import torch.distributed._functional_collectives as funcol
    mesh, _ = group
    for k, p in params_p.items():
        x, a, e = p.to_local(), anchor_p[k].to_local(), err[k].to_local()
        acc = x.float() - a.float()
        acc.add_(e)                                  # delta + e
        m = acc.abs().max()
        for dim in spmd.mesh_dims(p, lambda pl: pl.is_shard()):
            m = funcol.all_reduce(m, "max", (mesh, dim))
        s = torch.clamp_min(m, 1e-12) / 127.0
        q = torch.clamp(torch.round(acc / s), -127, 127).to(torch.int8)
        e.copy_(acc.sub_(q.float() * s))             # acc - q s
        del acc
        if n_pods == 2:
            # permute_tensor splits its input's dim 0 by numel: flat.
            other = funcol.permute_tensor(q.reshape(-1), [1, 0], group)
            qsum = q.float() + other.reshape(q.shape).float()
        else:
            qsum = funcol.all_reduce(q.float(), "sum", group)
        mean_delta = qsum * (s / n_pods)
        a.copy_((a.float() + mean_delta).to(a.dtype))
        x.copy_(a.to(x.dtype))
    return params_p, anchor_p, err


def build_hier_train_step(cfg, n_pods: int, T_pod: int,
                          opt_cfg: AdamWConfig = AdamWConfig(), *,
                          compress: bool = False, remat: str = "dots",
                          sync_mode: str = "cond"):
    """Returns hier_train_step(state, batch_podded) -> (state, metrics).

    batch_podded leaves are [n_pods, B / n_pods, ...] on the state's
    device, or DTensors on its mesh (see the module's docstring). The
    sync fires after the update when (step + 1) % T_pod == 0 (sync_mode
    "cond"), or always, or never. Metrics: "loss" and "grad_norm"
    (means over pods, f32; on a mesh 0-dim DTensors, Partial over 'pod')
    and "synced" (int32). The state's tensors are updated in place and
    the returned state holds them."""
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"sync_mode must be one of {SYNC_MODES}; got "
                         f"{sync_mode!r}")
    loss_mod = _Loss(lm.init_params(cfg, device="meta"), remat)

    def pod_step(rows: Tree, opt_i: AdamWState, batch):
        """One pod's loss, gradients and AdamW update, written into its
        rows. Returns (loss, gnorm, the pod's new AdamW step)."""
        leaves = {k: r.detach().requires_grad_() for k, r in rows.items()}
        # The leaves stay in the model through the backward too, where
        # remat recomputes the forward.
        with _reparametrize_module(loss_mod, {f"model.{k}": t for k, t
                                              in leaves.items()}):
            loss, _ = loss_mod(batch)
            loss.backward()
        # A parameter the loss does not read has a zero gradient.
        grads = {k: torch.zeros_like(t) if t.grad is None else t.grad
                 for k, t in leaves.items()}
        del leaves
        updates, new_opt, gnorm = adamw_update(grads, opt_i, rows, opt_cfg,
                                               lr_scale=1.0)
        del grads
        apply_updates(rows, updates)
        return spmd.full(loss.detach().float()), gnorm, new_opt.step

    def do_sync(state: HierState) -> bool:
        if sync_mode == "cond":
            return (int(spmd.to_local(state.step)) + 1) % T_pod == 0
        return sync_mode == "always"

    def metrics_of(loss, gnorm, synced: bool, dev):
        return {"loss": loss, "grad_norm": gnorm,
                "synced": torch.tensor(int(synced), dtype=torch.int32,
                                       device=dev)}

    def step_fn(state: HierState, batch_p):
        if spmd.is_dtensor(state.step):
            return mesh_step(state, batch_p)
        losses, gnorms, steps = zip(*(pod_step(
            {k: p[i] for k, p in state.params.items()},
            AdamWState(step=state.opt.step[i],
                       m={k: m[i] for k, m in state.opt.m.items()},
                       v={k: v[i] for k, v in state.opt.v.items()}),
            {k: x[i] for k, x in batch_p.items()}) for i in range(n_pods)))
        opt = AdamWState(step=torch.stack(steps), m=state.opt.m,
                         v=state.opt.v)
        synced = do_sync(state)
        if synced:
            sync = _compressed_sync if compress else _mean_sync
            sync(state.params, state.anchor, state.err, n_pods)
        metrics = metrics_of(torch.mean(torch.stack(losses)),
                             torch.mean(torch.stack(gnorms)), synced,
                             state.step.device)
        return HierState(params=state.params, opt=opt, anchor=state.anchor,
                         err=state.err, step=state.step + 1), metrics

    def mesh_step(state: HierState, batch_p):
        """This rank's pod's step on its 'pod' shard, then the sync over
        'pod'."""
        from torch.distributed.tensor import Partial, Replicate
        mesh = state.step.device_mesh
        names = mesh.mesh_dim_names
        pod = names.index("pod")
        sub = mesh[tuple(n for n in names if n != "pod")]

        def view(tree):
            return {k: _pod_view(t, sub, pod) for k, t in tree.items()}

        rows = view(state.params)
        with spmd.mesh_context(next(iter(rows.values()))):
            loss, gnorm, new_step = pod_step(
                rows, AdamWState(step=state.opt.step.to_local()[0],
                                 m=view(state.opt.m), v=view(state.opt.v)),
                view(batch_p))
        del rows
        opt = AdamWState(step=spmd.like(new_step.reshape(1), state.opt.step),
                         m=state.opt.m, v=state.opt.v)
        synced = do_sync(state)
        if synced:
            sync = _mesh_compressed_sync if compress else _mesh_mean_sync
            sync(state.params, state.anchor, state.err, n_pods, (mesh, pod))
        mean = tuple(Partial() if i == pod else Replicate()
                     for i in range(mesh.ndim))
        metrics = metrics_of(
            *(spmd.wrap(x / n_pods, mesh, mean, ()) for x in (loss, gnorm)),
            synced, loss.device)
        step = spmd.like(spmd.to_local(state.step) + 1, state.step)
        return HierState(params=state.params, opt=opt, anchor=state.anchor,
                         err=state.err, step=step), metrics

    return step_fn

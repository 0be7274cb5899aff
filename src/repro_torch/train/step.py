"""train_step / eval_step builders (counterpart of `repro.train.step`).

The step is a function (state, batch) -> (state, metrics), as the
reference's, run eagerly on the state's device: the loss's gradient by
autograd (through the attention and SSD kernels' autograd Functions on
the card), the warmup-cosine learning-rate scale, AdamW. The state's
parameters, m and v are updated in place and the returned state holds
them; each parameter's `.grad` keeps the step's gradient until the next
step. A state placed on a mesh (DTensors: `parallel.sharding.
state_placements`, `checkpoint.place_state`) takes the same step on
every rank: the model's per-rank plans (`parallel.spmd`) under the
logical axis rules of its mesh, gradients reduced to their parameters'
placements before AdamW, the metrics plain (replicated) tensors.
Pod-local replicas with a periodic sync are `parallel.hierarchical`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models import lm
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               adamw_update, apply_updates,
                               linear_warmup_cosine)
from repro_torch.parallel import spmd


class TrainState(NamedTuple):
    params: lm.LM
    opt: AdamWState
    step: torch.Tensor            # int32 []


class BF16GradBarrier(torch.autograd.Function):
    """Identity forward; the backward casts the parameter cotangent to
    bf16, as the reference's custom VJP does before the data-parallel
    all-reduce (half the grad-sync wire). Autograd hands the float32
    parameter the bf16-rounded gradient back in float32, the values the
    reference's AdamW reads."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16)


class _Loss(nn.Module):
    """`lm.loss_fn` as a module around the model, so that
    `torch.func.functional_call` can hand it barriered parameters."""

    def __init__(self, model, remat):
        super().__init__()
        self.model, self.remat = model, remat

    def forward(self, batch):
        return lm.loss_fn(self.model, self.model.cfg, batch,
                          remat=self.remat)


def init_state(cfg, generator=None, device=None) -> TrainState:
    """Random f32 masters from `generator` (see `lm.init_params`),
    trainable, with zeroed AdamW moments and step 0."""
    params = lm.make_trainable(lm.init_params(cfg, generator, device))
    opt = adamw_init(params)
    return TrainState(params=params, opt=opt, step=opt.step.clone())


def build_train_step(cfg, opt_cfg: AdamWConfig = AdamWConfig(), *,
                     remat: str = "dots", warmup_steps: int = 100,
                     total_steps: int = 10_000,
                     grad_sync_dtype: str = "f32"):
    """Returns train_step(state, batch) -> (state, metrics), metrics
    the 0-dim float32 tensors "loss", "aux", "grad_norm", "lr_scale".

    grad_sync_dtype="bf16" rounds parameter cotangents to bf16
    (BF16GradBarrier; Adam still accumulates in f32)."""
    if grad_sync_dtype not in ("f32", "bf16"):
        raise ValueError(f"grad_sync_dtype must be f32 or bf16; got "
                         f"{grad_sync_dtype!r}")

    def train_step(state: TrainState, batch):
        with spmd.mesh_context(next(state.params.parameters())):
            return step(state, batch)

    def step(state: TrainState, batch):
        params = state.params
        for p in params.parameters():
            p.grad = None
        if grad_sync_dtype == "bf16":
            barred = {f"model.{k}": BF16GradBarrier.apply(p)
                      for k, p in params.named_parameters()}
            loss, metrics = torch.func.functional_call(
                _Loss(params, remat), barred, (batch,))
        else:
            loss, metrics = lm.loss_fn(params, cfg, batch, remat=remat)
        loss.backward()
        # A parameter the loss does not read (an audio model's token
        # table) has a zero gradient, as in the reference.
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.named_parameters()}
        lr_scale = linear_warmup_cosine(spmd.to_local(state.step),
                                        warmup_steps, total_steps)
        updates, opt, gnorm = adamw_update(grads, state.opt, params,
                                           opt_cfg, lr_scale=lr_scale)
        apply_updates(params, updates)
        out_metrics = {
            "loss": spmd.full(metrics["loss"].detach().float()),
            "aux": spmd.full(metrics["aux"].detach().float()),
            "grad_norm": gnorm,
            "lr_scale": lr_scale,
        }
        new_step = spmd.like(spmd.to_local(state.step) + 1, state.step)
        return TrainState(params=params, opt=opt, step=new_step), \
            out_metrics

    return train_step


def build_eval_step(cfg):
    def eval_step(state: TrainState, batch):
        with torch.no_grad():
            _, metrics = lm.loss_fn(state.params, cfg, batch)
        return metrics["loss"].float()

    return eval_step

"""Where a full-width training step's time goes on the card.

    python src/repro_torch/launch/train_time.py [--arch qwen2-0.5b]
        [--batch 4] [--seq 1024] [--steps 3]

Builds the arch's train state at full width (random f32 masters from
seed 0, bf16 compute, remat none) and, after a warm-up step, times
`--steps` steps part by part between CUDA events on the card's timeline
(time the card waits on the host included): the forward with the loss
(`lm.loss_fn`), the backward, and AdamW (update and apply). Then it traces one more step
with torch.profiler (device activity only) and sums device time by
kind: the forward kernel the step launches (`flash_wgmma_kernel` /
`ssd_*`), matrix products (GEMM kernels), and the rest; their sum over
the median step time is the card's busy share. Last, it times the
kernel's autograd Function alone on layer 0's shapes: the forward (the
kernel launch) and the backward (the plain version recomputed under
autograd), each after a warm-up, median of 5 between CUDA events.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def _ms(fn, n: int = 5) -> float:
    """Median ms of fn() between CUDA events, after one warm-up."""
    import numpy as np
    import torch
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _kind(name: str) -> str:
    if re.search(r"flash_wgmma|flash_kernel|ssd_", name):
        return "forward kernel"
    if re.search(r"gemm|xmma|cutlass|nvjet|Kernel2", name, re.I):
        return "matmul"
    return "other"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=["qwen2-0.5b", "mamba2-130m"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import batch_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import lm
    from repro_torch.optim import (AdamWConfig, adamw_update, apply_updates,
                                   linear_warmup_cosine)
    from repro_torch.train.step import build_train_step, init_state

    if not torch.cuda.is_available():
        raise SystemExit("train_time: needs a CUDA device")
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    state = init_state(cfg, torch.Generator(dev).manual_seed(0), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             batch_for(cfg, args.batch, args.seq, 0).items()}
    step = build_train_step(cfg, remat="none")
    state, _ = step(state, batch)                 # warm-up
    torch.cuda.synchronize()

    parts = {"forward": [], "backward": [], "adamw": [], "step": []}
    for _ in range(args.steps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in state.params.parameters():
            p.grad = None
        marks[0].record()
        loss, _ = lm.loss_fn(state.params, cfg, batch)
        marks[1].record()
        loss.backward()
        marks[2].record()
        grads = {k: p.grad for k, p in state.params.named_parameters()}
        updates, opt, _ = adamw_update(grads, state.opt, state.params,
                                       AdamWConfig(),
                                       linear_warmup_cosine(state.step, 100,
                                                            10_000))
        apply_updates(state.params, updates)
        del updates
        marks[3].record()
        torch.cuda.synchronize()
        state = state._replace(opt=opt, step=state.step + 1)
        for name, (a, b) in zip(("forward", "backward", "adamw"),
                                zip(marks, marks[1:])):
            parts[name].append(a.elapsed_time(b))
        parts["step"].append(marks[0].elapsed_time(marks[3]))

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    by_kind = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kind = _kind(ev.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3

    # The kernel's autograd Function alone on layer 0's shapes.
    rng = np.random.RandomState(0)
    if cfg.family == "dense":
        shapes = [(args.batch, args.seq, cfg.n_heads, cfg.head_dim)] + [
            (args.batch, args.seq, cfg.n_kv_heads, cfg.head_dim)] * 2
        ins = [torch.from_numpy(rng.randn(*s).astype(np.float32))
               .to(dev, lm.COMPUTE_DTYPE).requires_grad_() for s in shapes]
        fwd = lambda: fa.flash_attention(*ins, causal=True)  # noqa: E731
        grad_out = [torch.randn_like(ins[0])]
    else:
        from repro_torch.models import ssm
        _, H, _ = ssm.ssm_dims(cfg)
        b, S, P, N = args.batch, args.seq, cfg.ssm_head_dim, cfg.ssm_state
        ins = [rng.randn(b, S, H, P), rng.rand(b, S, H) * 0.1 + 0.01,
               -np.linspace(1.0, 16.0, H), rng.randn(b, S, N),
               rng.randn(b, S, N)]
        ins = [torch.from_numpy(a.astype(np.float32)).to(dev)
               .requires_grad_() for a in ins]
        fwd = lambda: ssd.ssd_scan(*ins, chunk=cfg.ssm_chunk)  # noqa: E731
        grad_out = [torch.randn(b, S, H, P, device=dev),
                    torch.zeros(b, H, P, N, device=dev)]

    def backward():
        out = fwd()
        torch.autograd.backward(out, grad_out)

    fwd_ms = _ms(lambda: fwd())
    bwd_ms = _ms(backward) - fwd_ms
    ms = {k: float(np.median(v)) for k, v in parts.items()}
    out = {
        "arch": args.arch, "tokens_per_step": args.batch * args.seq,
        "card": torch.cuda.get_device_name(0),
        "ms": ms,
        "traced_device_ms": by_kind,
        "busy_share": sum(by_kind.values()) / ms["step"],
        "layer0_function_ms": {"forward (kernel)": fwd_ms,
                               "backward (plain recompute)": bwd_ms},
        "n_layers": cfg.n_layers,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

"""Kernel micro-benchmarks on the card: each CUDA kernel of
`repro_torch.kernels` against its plain PyTorch version, at the shapes
of `benchmarks/kernels_bench.py` (flash attention 1 x 256 x 4 x 64 with
2 KV heads, f32, causal; the SSD scan 1 x 128 x 2 x 32 x 16, chunk 32).

Times are microseconds per call on the card (CUDA events around
back-to-back calls after a warm-up), so they include the host's cost
per launch where a kernel is shorter than it. The kernels run on CUDA
only: on the CPU the wrappers are their plain versions, so
`bench_kernels` raises there. Counterpart of
`benchmarks/kernels_bench.py` (columns `kernel_us` / `plain_us` for
its `pallas_us` / `ref_us`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


def _us(fn, iters: int = 20) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def bench_kernels(device=None):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_kernels times the CUDA kernels and runs "
                           f"on a CUDA device only, not {device}")
    rng = np.random.RandomState(0)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    out = []
    B, S, H, KV, dh = 1, 256, 4, 2, 64
    q = dev(rng.randn(B, S, H, dh))
    k = dev(rng.randn(B, S, KV, dh))
    v = dev(rng.randn(B, S, KV, dh))
    out.append({"bench": "kernel_flash", "shape": f"{B}x{S}x{H}x{dh}",
                "kernel_us": _us(lambda: fa.flash_attention(q, k, v)),
                "plain_us": _us(lambda: fa.flash_attention_plain(q, k, v))})

    b, S2, H2, P, N = 1, 128, 2, 32, 16
    x = dev(rng.randn(b, S2, H2, P))
    dt = dev(rng.rand(b, S2, H2) * 0.5)
    A = -dev(rng.rand(H2) + 0.5)
    Bm = dev(rng.randn(b, S2, N))
    Cm = dev(rng.randn(b, S2, N))
    out.append({"bench": "kernel_ssd", "shape": f"{b}x{S2}x{H2}x{P}x{N}",
                "kernel_us": _us(lambda: ssd.ssd_scan(x, dt, A, Bm, Cm,
                                                      chunk=32)),
                "plain_us": _us(lambda: ssd.ssd_scan_plain(x, dt, A, Bm, Cm,
                                                           chunk=32))})
    return out

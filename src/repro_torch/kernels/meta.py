"""The kernels on the meta device: what a call costs, without running it.

A dry run (`launch/dryrun.py`) drives the model with meta tensors. There
`flash_attention` and `ssd_scan` return empty outputs of the right
shapes and dtypes, launch nothing, and report each call to the recorder
that `recording` installs: the kernel's name, its operations and the
bytes it moves (each input read once, each output written once). The
operation counts are the formulas of the kernels' bounds, not the plain
versions' arithmetic:

- attention: 4 dh per (query, key) pair the mask keeps (q.k and p.v);
- the SSD scan: per (batch, chunk) the lower triangle of C B^T, per head
  its (C B^T o L)(x dt) lower triangle, (C e^cum) state^T and
  (x dt decay)^T B.

A backward call (the autograd Functions' recompute) is reported as
BACKWARD_FACTOR times its forward's operations: four products of the
forward's sizes (the two gradients of each of the forward's two), and
its bytes as the saved inputs and the output gradient read, the input
gradients written.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

BACKWARD_FACTOR = 2
_state = threading.local()


@contextlib.contextmanager
def recording(sink):
    """Report every meta-device kernel call in this thread to
    sink(name, flops, nbytes) while the block runs."""
    prev = getattr(_state, "sink", None)
    _state.sink = sink
    try:
        yield sink
    finally:
        _state.sink = prev


def record(name: str, flops: int, nbytes: int) -> None:
    sink = getattr(_state, "sink", None)
    if sink is not None:
        sink(name, int(flops), int(nbytes))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kept_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """(query, key) pairs the attention mask keeps: key positions up to
    the query's when causal, and past query - window when windowed
    (positions from 0 on both sides, as the kernels count them)."""
    q = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0) if window is not None else 0 * q
    hi = np.minimum(q, Skv - 1) if causal else np.full_like(q, Skv - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_flops(q_shape, Skv: int, causal: bool, window) -> int:
    B, Sq, H, dh = q_shape
    return 4 * dh * B * H * kept_pairs(Sq, Skv, causal, window)


def ssd_flops(x_shape, N: int, chunk: int) -> int:
    b, S, H, P = x_shape
    pairs = chunk * (chunk + 1)          # 2 x the lower triangle
    return (b * (S // chunk)
            * (N * pairs + H * (P * pairs + 4 * chunk * N * P)))

"""Deterministic synthetic data pipeline (copy of `repro.data.synthetic`).

Batches are a pure function of (arch, step, seed): numpy's Philox
generator gives the reference's tokens, audio frames and labels and VLM
patch embeddings bit for bit. A background prefetch thread
(`SyntheticLM`) hides host-side generation latency.

`input_specs()` returns meta-device tensors standing in for every model
input (shapes and dtypes, no allocation).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec


def _tok_block(seed: int, lo: int, hi: int, shape) -> np.ndarray:
    """Deterministic token block from a counter-based RNG (Philox)."""
    rng = np.random.Generator(np.random.Philox(key=seed))
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


NOISE = 0.3      # fraction of transitions that resample a fresh token


def _lm_block(seed: int, vocab: int, B: int, S: int) -> np.ndarray:
    """Learnable token stream: sticky repeats (next == prev with
    probability 1-NOISE, fresh random token otherwise), a pure function
    of (seed, step)."""
    rng = np.random.Generator(np.random.Philox(key=seed))
    resets = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    noise = rng.random((B, S)) < NOISE
    noise[:, 0] = True
    # Segment-fill: each position takes the most recent reset token.
    idx = np.where(noise, np.arange(S)[None, :], 0)
    idx = np.maximum.accumulate(idx, axis=1)
    return np.take_along_axis(resets, idx, axis=1)


def _float_block(seed: int, shape) -> np.ndarray:
    rng = np.random.Generator(np.random.Philox(key=seed))
    return rng.standard_normal(size=shape, dtype=np.float32)


def batch_for(cfg: ArchConfig, B: int, S: int, step: int,
              *, seed: int = 0) -> Dict[str, np.ndarray]:
    """One global batch for `step` (pure function; no pipeline state):
    {"tokens": int32 [B, S]}, plus "patches" f32 [B, n_patches, d_model]
    for a VLM; {"frames": f32 [B, S, frame_dim], "labels": int32 [B, S]}
    for audio."""
    base = (seed * 1_000_003 + step) & 0x7FFFFFFF
    if cfg.frame_dim:                           # audio: frames + labels
        return {
            "frames": _float_block(base, (B, S, cfg.frame_dim)),
            "labels": _tok_block(base + 1, 0, cfg.vocab, (B, S)),
        }
    batch = {"tokens": _lm_block(base, cfg.vocab, B, S)}
    if cfg.n_patches:                           # vlm: stub patch embeddings
        batch["patches"] = _float_block(base + 2,
                                        (B, cfg.n_patches, cfg.d_model))
    return batch


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                compute_dtype=torch.float32) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input (no allocation), with
    the reference's shapes and dtypes: train/prefill take full [B, S]
    inputs; decode takes one new token against the serving cache."""
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.frame_dim:
        return {"frames": spec((B, S, cfg.frame_dim), compute_dtype),
                "labels": spec((B, S), torch.int32)}
    specs = {"tokens": spec((B, S), torch.int32)}
    if cfg.n_patches:
        specs["patches"] = spec((B, cfg.n_patches, cfg.d_model),
                                compute_dtype)
    return specs


class SyntheticLM:
    """Prefetching iterator over the deterministic stream.

    start_step lets a restarted job resume mid-stream; `device_put_fn`
    (optional) moves each batch onto the device while the next one is
    being generated on the host thread.
    """

    def __init__(self, cfg: ArchConfig, B: int, S: int, *, seed: int = 0,
                 start_step: int = 0, prefetch: int = 2,
                 device_put_fn=None):
        self.cfg, self.B, self.S, self.seed = cfg, B, S, seed
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._put = device_put_fn or (lambda x: x)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = batch_for(self.cfg, self.B, self.S, step, seed=self.seed)
            try:
                self._q.put((step, self._put(batch)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()
        # Drain so the producer's blocked put wakes up and exits.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

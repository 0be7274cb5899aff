"""Deterministic synthetic token batches (copy of the token part of
`repro.data.synthetic`).

Batches are a pure function of (arch, step, seed): numpy's Philox
generator gives the reference's tokens bit for bit. The audio and VLM
stub inputs (frames, patches) come with their families (ROADMAP.md,
queue 1).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ArchConfig


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


def batch_for(cfg: ArchConfig, B: int, S: int, step: int,
              *, seed: int = 0) -> Dict[str, np.ndarray]:
    """One global batch for `step` (pure function; no pipeline state):
    {"tokens": int32 [B, S]}."""
    if cfg.frame_dim or cfg.n_patches:
        raise ValueError(f"{cfg.name}: audio/VLM stub inputs are not "
                         "ported yet (ROADMAP.md, queue 1)")
    base = (seed * 1_000_003 + step) & 0x7FFFFFFF
    return {"tokens": _lm_block(base, cfg.vocab, B, S)}

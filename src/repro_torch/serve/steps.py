"""Serving step builders (counterpart of `repro.serve.steps`).

The prefill step takes the whole batch ("tokens", plus "patches" for a
VLM or "frames" for audio); `decode_step` is one new token against a
cache holding the past positions, for every family with a decode path.
The cache layout comes from `models.lm.make_cache`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import lm
from repro_torch.parallel import spmd


def cache_shapes(cfg, B: int, S: int) -> Dict[str, Any]:
    """The serving cache on the meta device: shapes and dtypes, no
    allocation."""
    return lm.make_cache(cfg, B, S, device="meta")


def build_prefill_step(cfg):
    def prefill_step(params, batch):
        with torch.no_grad():
            return lm.prefill(params, cfg, batch)

    return prefill_step


def build_decode_step(cfg, *, greedy: bool = True):
    def decode_step(params, tokens, cache):
        with torch.no_grad():
            logits, cache = lm.decode_step(params, cfg, tokens, cache)
        if greedy:
            last = logits[:, -1]
            nxt = (spmd.argmax(last) if spmd.is_dtensor(last)
                   else last.argmax(dim=-1)).to(torch.int32)
        else:
            nxt = tokens[:, -1]
        return nxt[:, None], cache

    return decode_step

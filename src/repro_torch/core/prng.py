"""JAX's threefry2x32 PRNG, bit for bit, as far as the simulator draws.

The engine's schedule jitter comes from `jax.random` in the reference:
`PRNGKey(seed)`, a 2-way `split` per event step and per handler, and
float32 `uniform(key, (), lo, hi)`. Reproducing those bits is what lets
a seed-for-seed comparison hold with jitter on. The reference runs with
`jax_threefry_partitionable=True`, under which

  * `split(key)[i]`      = threefry2x32(key, (0, i))          (both words)
  * `uniform` bits       = w0 ^ w1 of threefry2x32(key, (0, 0))

Keys are int64 tensors of shape [..., 2] holding uint32 words (every
operation masks back to 32 bits), batched over any leading axes.
`randint` is not ported yet: nothing on this slice's path draws it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = int(np.array(1.0, np.float32).view(np.uint32))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds), elementwise with
    broadcasting. All arguments are int64 tensors of uint32 values;
    returns the two uint32 output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed, device=None) -> torch.Tensor:
    """Keys for non-negative int32 seeds (any shape): [..., 2] =
    (seed >> 32, seed & 0xFFFFFFFF), i.e. (0, seed)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device)
    if bool((s < 0).any()) or bool((s > 0x7FFFFFFF).any()):
        raise ValueError("seeds must be int32 values >= 0")
    return torch.stack([s >> 32, s & _M32], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """[..., 2] keys -> [..., num, 2] subkeys (partitionable threefry)."""
    k1, k2 = key[..., 0:1], key[..., 1:2]
    ctr = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
    return torch.stack([b1, b2], dim=-1)


def random_bits32(key: torch.Tensor) -> torch.Tensor:
    """One uint32 draw per key (`random_bits(key, 32, ())`)."""
    zero = torch.zeros_like(key[..., 0])
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    return b1 ^ b2


def unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1): the mantissa trick of
    `jax.random.uniform` (23 random mantissa bits under exponent 0,
    minus 1.0)."""
    fb = (bits >> 9) | _ONE_F32_BITS
    # int64 -> int32 keeps the low 32 bits (two's complement), and
    # viewing those as float32 is the reference's bitcast.
    return fb.to(torch.int32).view(torch.float32) - 1.0


@functools.lru_cache(maxsize=None)
def _bounds(lo: float, hi: float, device: torch.device):
    return (torch.tensor(np.float32(lo), device=device),
            torch.tensor(np.float32(hi) - np.float32(lo), device=device))


def scale_uniform(f: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`max(lo, f * (hi - lo) + lo)` in float32, the last step of
    `jax.random.uniform`. Multiply and add are rounded separately, as
    XLA's CPU backend computes them (no fused multiply-add); with lo=0,
    the engine's jitter, the two roundings agree anyway."""
    lo32, span = _bounds(float(lo), float(hi), f.device)
    return torch.maximum(lo32, f * span + lo32)


def uniform(key: torch.Tensor, lo: float = 0.0, hi: float = 1.0
            ) -> torch.Tensor:
    """`jax.random.uniform(key, (), float32, lo, hi)` for every key in
    the [..., 2] batch."""
    return scale_uniform(unit_float(random_bits32(key)), lo, hi)

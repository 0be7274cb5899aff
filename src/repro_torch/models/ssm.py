"""Mamba2 (state-space duality / SSD) blocks (counterpart of
`repro.models.ssm`).

Prefill runs the chunked SSD scan through the port's hand-written
`ssd_scan` kernel (the reference calls its jnp `ssd_chunked`, the same
algorithm), with the reference's chunk rule. Decode is the
O(1)-per-token recurrence on the [B, H, P, N] state, in plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.kernels.ops import ssd_scan
from repro_torch.models import layers
from repro_torch.parallel import spmd

CONV_K = 4  # depthwise conv kernel width


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state          # x + B + C (n_groups=1)
    return d_inner, nheads, conv_dim


def init_mamba2(cfg, generator, device) -> dict:
    d = cfg.d_model
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    N = cfg.ssm_state
    in_dim = 2 * d_inner + 2 * N + nheads           # z, x, B, C, dt
    a_log = torch.log(torch.linspace(1.0, 16.0, nheads))
    return {
        "in_proj": layers.normal((d, in_dim), 1.0 / np.sqrt(d), generator,
                                 device),
        "conv_w": layers.normal((CONV_K, conv_dim), 0.2, generator, device),
        "conv_b": torch.zeros(conv_dim, device=device),
        "A_log": a_log.to(device),
        "D": torch.ones(nheads, device=device),
        "dt_bias": torch.zeros(nheads, device=device),
        "norm": {"w": torch.ones(d_inner, device=device)},
        "out_proj": layers.normal((d_inner, d), 1.0 / np.sqrt(d_inner),
                                  generator, device),
    }


def _split_in(proj, cfg):
    d_inner, nheads, _ = ssm_dims(cfg)
    N = cfg.ssm_state
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner: 2 * d_inner + 2 * N]
    dt = proj[..., 2 * d_inner + 2 * N:]
    return z, xBC, dt


def scan_chunk(chunk: int, S: int) -> int:
    """The reference's chunk rule (`ssd_chunked`): clip to S, then halve
    until it divides S (short or ragged prompts)."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    return chunk


def _conv1d(xBC, w, bias):
    """Causal depthwise conv along seq. xBC: [B,S,C]; w: [K,C]. On
    DTensors, per rank on its batch and channel shards."""
    if spmd.is_dtensor(xBC):
        return spmd.depthwise(_conv1d, xBC, w, bias)
    K = w.shape[0]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i: i + xBC.shape[1]] * w[i][None, None]
              for i in range(K))
    return F.silu(out + bias[None, None])


def mamba2_apply(p, x, cfg):
    """Full-sequence Mamba2 block. x: [B,S,D] -> ([B,S,D], final_state)."""
    Bsz, S, D = x.shape
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    N = cfg.ssm_state
    dt_ = x.dtype
    proj = layers.dense(x, p["in_proj"])
    z, xBC, dt_raw = _split_in(proj, cfg)
    xBC = _conv1d(xBC, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    xs = xBC[..., :d_inner].reshape(Bsz, S, nheads, cfg.ssm_head_dim)
    Bmat = xBC[..., d_inner: d_inner + N]
    Cmat = xBC[..., d_inner + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"].float())
    y, s_final = ssd_scan(xs.float().contiguous(), dt.contiguous(), A,
                          Bmat.float().contiguous(),
                          Cmat.float().contiguous(),
                          chunk=scan_chunk(cfg.ssm_chunk, S))
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, S, d_inner).to(dt_)
    y = layers.rms_norm(y * F.silu(z), p["norm"]["w"])
    return layers.dense(y, p["out_proj"]), s_final


def mamba2_decode(p, x, cfg, ssm_state, conv_state):
    """One-token recurrence.

    x: [B,1,D]; ssm_state: [B,H,P,N]; conv_state: [B,CONV_K-1,conv_dim].
    Returns (y [B,1,D], new ssm_state, new conv_state).
    """
    Bsz = x.shape[0]
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    N = cfg.ssm_state
    dt_ = x.dtype
    proj = layers.dense(x, p["in_proj"])
    z, xBC, dt_raw = _split_in(proj, cfg)

    window = torch.cat([conv_state, xBC], dim=1)          # [B,K,conv]
    # The prefill's per-tap sum (`_conv1d`), not the reference's einsum:
    # the same rounding in the compute dtype, so a decoded token's conv
    # output equals the prefill's for the same window.
    xBC1 = _conv1d(window, p["conv_w"].to(dt_), p["conv_b"].to(dt_))[:, -1:]
    new_conv = window[:, 1:]

    xs = xBC1[..., :d_inner].reshape(Bsz, nheads, cfg.ssm_head_dim)
    Bv = xBC1[:, 0, d_inner: d_inner + N]                 # [B,N]
    Cv = xBC1[:, 0, d_inner + N:]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"][None])  # [B,H]
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A[None])                       # [B,H]
    s_new = (ssm_state * decay[..., None, None]
             + torch.einsum("bhp,bn,bh->bhpn", xs.float(), Bv.float(), dt))
    y = torch.einsum("bhpn,bn->bhp", s_new, Cv.float())
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(Bsz, 1, d_inner).to(dt_)
    y = layers.rms_norm(y * F.silu(z), p["norm"]["w"])
    return layers.dense(y, p["out_proj"]), s_new, new_conv

"""Flash attention (GQA + causal + sliding window): two hand-written
CUDA kernels for Hopper plus their plain PyTorch version.

Replaces the Pallas TPU kernel of `repro.kernels.flash_attention`
(`_kernel` via `flash_attention`). Both kernels are built with nvcc for
sm_90a at first use and called through ctypes on PyTorch's current
stream (see each source's header for its design and what bounds it):

- `csrc/flash_attention_wgmma.cu`, the tensor-core variant: both
  products on `wgmma`, k/v through TMA into an `mbarrier` ring, P
  rounded to bf16 for P V.
- `csrc/flash_attention.cu`, the CUDA-core variant: f32 FMAs on
  register tiles, k/v staged by `cp.async`.

Which one runs is a rule on dtype and shape only (`variant`): bf16
inputs with head_dim a multiple of 16 up to 192 (WGMMA_MAX_DH) and Skv
>= 1 take the tensor-core variant (then H*dh*2 and KV*dh*2, TMA's row
strides, are multiples of 32 bytes); DeepSeek-V3's MLA prefill (dh 192)
is one of them. f32 inputs (whose 2e-5 tolerance TF32 misses) and every
other bf16 shape (head_dim not a multiple of 16, past 192, or no key)
take the CUDA-core variant.

Semantics: q [B,Sq,H,dh], k/v [B,Skv,KV,dh], f32 or bf16 (one dtype),
H % KV == 0, dh <= 256; query head h reads KV head h // (H // KV).
Scores are (q / sqrt(dh)) k^T, masked to -1e30 where `causal` forbids
(kpos > qpos) or the window does (kpos <= qpos - window); an online
softmax over kv tiles keeps m, l and the accumulator in f32, and the
output, normalised once by max(l, 1e-30), has q's dtype.

The wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches a kernel or raises. `flash_attention.launches`
counts kernel launches; `launches_wgmma` and `launches_fma` count each
variant's.

Gradients: when grad mode is on and an input requires grad, the call
goes through `FlashAttentionFn`, whose forward is that same launch (the
plain version on the CPU) and whose backward recomputes the function
with `flash_attention_plain` under autograd. That is the reference's own
gradient algorithm: the reference trains through XLA's autodiff of
`multihead_attention`'s blocked online softmax, and no Pallas backward
kernel exists. Otherwise (serving, `torch.no_grad()`) the call launches
directly, and that raw path refuses an input that requires grad while
grad mode is on, so a launch can never drop a gradient.

On the meta device (a dry run) a call launches nothing: it returns an
empty output and reports its operations and bytes to `kernels.meta`'s
recorder, and so does its backward. On DTensors a call runs on every
rank's shards, sharded over batch and heads (`parallel.spmd`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, meta
from repro_torch.parallel import spmd

NEG_INF = -1e30
# The tensor-core variant's widest head_dim: three 64-column slabs. A
# fourth (dh 208-256, which no model here runs) would fit a block's 227
# KB of shared memory only with 64-row k/v tiles in two stages beside a
# 64 KB Q, and hold a 128-register O tile per thread.
WGMMA_MAX_DH = 192
# The plain version's kv tile (the CUDA-core kernel's; the tensor-core
# kernel walks 128- or 64-key tiles, which changes only the rounding).
BLOCK_KV = 64


def variant(q, k) -> str:
    """The kernel a CUDA call launches: "wgmma" for bf16 with head_dim a
    multiple of 16 up to WGMMA_MAX_DH and at least one key, else "fma"."""
    dh, Skv = q.shape[3], k.shape[1]
    if (q.dtype == torch.bfloat16 and dh % 16 == 0 and dh <= WGMMA_MAX_DH
            and Skv >= 1):
        return "wgmma"
    return "fma"


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """Plain PyTorch version: the kernels' online softmax over kv tiles
    of BLOCK_KV, all query rows at once, in f32; where the tensor-core
    variant would run, P is rounded to bf16 before P V, as there.

    It is also the function `FlashAttentionFn` differentiates: the
    reference's `multihead_attention` (`_block_attn_body`) is this
    online softmax, m, l and the accumulator in f32, over kv blocks of
    up to 512 keys instead of BLOCK_KV (tiling changes only the
    rounding); the bf16 rounding of P keeps the recompute the function
    the tensor-core forward computed."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    round_p = variant(q, k) == "wgmma"
    G = H // KV
    qs = q.float().reshape(B, Sq, KV, G, dh) * (1.0 / math.sqrt(dh))
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, KV, G, Sq), NEG_INF, device=q.device)
    den = torch.zeros(B, KV, G, Sq, device=q.device)
    acc = torch.zeros(B, KV, G, Sq, dh, device=q.device)
    for k0 in range(0, Skv, BLOCK_KV):
        ks = k[:, k0:k0 + BLOCK_KV].float()
        vs = v[:, k0:k0 + BLOCK_KV].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qs, ks)
        kpos = torch.arange(k0, k0 + ks.shape[1], device=q.device)[None, :]
        mask = torch.ones(Sq, ks.shape[1], dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1)
        if round_p:
            p = p.bfloat16().float()
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vs)
        m = m_new
    out = acc / torch.clamp_min(den, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"shape {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise ValueError(f"flash_attention: q, k, v must share one "
                             f"dtype, float32 or bfloat16; got {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, _, H, dh = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh
            or H % k.shape[2] != 0):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "[B,Sq,H,dh] / [B,Skv,KV,dh] with H % KV == 0")
    if dh > 256:
        raise ValueError(f"flash_attention: head_dim {dh} > 256")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def _entry(kind: str):
    """The ctypes entry point of variant `kind` (one C signature for
    both)."""
    name = "flash_attention_wgmma" if kind == "wgmma" else "flash_attention"
    fn = getattr(build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i,
                       i, p]
        fn.restype = i
    return fn


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: forward is the kernel launch (the plain
    version on the CPU) and saves only q, k, v; backward recomputes
    `flash_attention_plain` under autograd and backpropagates through
    it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad):
        if grad.device.type == "meta":
            return _meta_backward(ctx, grad)
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = flash_attention_plain(*inputs, causal=ctx.causal,
                                        window=ctx.window)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None, None)


def _flops(q, k, causal, window) -> int:
    return meta.attention_flops(tuple(q.shape), k.shape[1], causal, window)


def _meta_backward(ctx, grad):
    """The backward on the meta device: empty input gradients, its cost
    reported (`kernels.meta`)."""
    saved = ctx.saved_tensors
    grads = [torch.empty_like(t) if need else None
             for t, need in zip(saved, ctx.needs_input_grad)]
    meta.record("flash_attention_backward",
                meta.BACKWARD_FACTOR * _flops(saved[0], saved[1],
                                              ctx.causal, ctx.window),
                meta.nbytes(*saved, grad, *[g for g in grads if g is not None]))
    return tuple(grads) + (None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: [B,Sq,H,dh]; k,v: [B,Skv,KV,dh] -> [B,Sq,H,dh] in q's dtype."""
    if spmd.is_dtensor(q):
        return spmd.attention(flash_attention, q, k, v, causal=causal,
                              window=window)
    _check(q, k, v, window)
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)


def _launch(q, k, v, causal, window):
    """The kernel launch (the plain version for CPU tensors, the meta
    path for meta ones), without a gradient: refuses inputs that require
    one while grad mode is on."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        meta.record("flash_attention", _flops(q, k, causal, window),
                    meta.nbytes(q, k, v, q))
        return torch.empty_like(q)
    if _needs_grad(q, k, v):
        raise RuntimeError("flash_attention: the kernel launch carries no "
                           "gradient; call flash_attention(), which routes "
                           "inputs that require grad through "
                           "FlashAttentionFn")
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    kind = variant(q, k)
    if kind == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the tensor-core variant reads "
                         "q, k, v with TMA, which needs 16-byte aligned "
                         "addresses; pass .clone() of an offset view")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _entry(kind)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KV, dh, int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(dh), int(causal),
            -1 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch of the {kind} "
                           f"kernel failed with error {err}")
    flash_attention.launches += 1
    if kind == "wgmma":
        flash_attention.launches_wgmma += 1
    else:
        flash_attention.launches_fma += 1
    return out


flash_attention.launches = 0
flash_attention.launches_wgmma = 0
flash_attention.launches_fma = 0

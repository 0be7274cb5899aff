"""Mamba2 SSD chunked scan: hand-written CUDA kernels for Hopper plus
their plain PyTorch version.

Replaces the Pallas TPU kernel of `repro.kernels.ssd_scan` (`_kernel`
via `ssd_scan`). The kernels live in `csrc/ssd_scan.cu`, are built with
nvcc for sm_90a at first use and called through ctypes on PyTorch's
current stream. One call launches KERNELS_PER_CALL (4) CUDA kernels back
to back, with no host sync between them; they compute in f32 on CUDA
cores (see the source's header for their design and what bounds them):

  1. per (b, chunk): the lower triangle of C B^T, once for all heads;
  2. per (b, chunk, h): cum, the in-chunk prefix sum of dt*A for the
     head, then the chunk's own state contribution, all chunks in
     parallel;
  3. per (b, h): the sequential carry over the chunks, which stores the
     state entering each chunk and the final state;
  4. per (b, chunk, h): y.

Semantics: x [b,S,H,P], dt [b,S,H], A [H], B/C [b,S,N], all float32;
`chunk` (at most 128, clipped to S) divides S. With cum the in-chunk
prefix sum of dt*A and L = exp(segment sums) on the lower triangle
(masked before the exp): y = (C B^T o L)(x dt) + (C e^cum) S_prev^T and
S_next = e^{cum[-1]} S_prev + (x dt e^{cum[-1] - cum})^T B. Returns
(y [b,S,H,P], final state [b,H,P,N]).

The wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernels or raises. `ssd_scan.launches` counts
calls that launched them (one per call, not per CUDA kernel).

Gradients: when grad mode is on and an input requires grad, the call
goes through `SSDScanFn`, whose forward is that same launch (the plain
version on the CPU) and whose backward recomputes `ssd_scan_plain` under
autograd: the reference trains through XLA's autodiff of its jnp
`ssd_chunked`, and no Pallas backward kernel exists. Otherwise the call
launches directly, and that raw path refuses an input that requires
grad while grad mode is on.

On the meta device (a dry run) a call launches nothing: it returns empty
outputs and reports its operations and bytes to `kernels.meta`'s
recorder, and so does its backward. On DTensors a call runs on every
rank's shards, sharded over batch and heads (`parallel.spmd`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta
from repro_torch.parallel import spmd

MAX_CHUNK = 128
KERNELS_PER_CALL = 4


def ssd_scan_plain(x, dt, A, B, C, *, chunk=128):
    """Plain PyTorch version, pass by pass as the kernels compute, in
    f32: C B^T per (b, chunk); every chunk's own state at once; the
    sequential carry; then y.

    It is also the function `SSDScanFn` differentiates: the reference's
    `ssd_chunked` computes the same y and final state from the same
    terms (in-chunk cum of dt*A, L = exp(segment sums) masked to -inf
    before the exp, per-chunk states, the carry, C e^cum S_prev), only
    associated in another order, which changes the rounding alone."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    cl = min(chunk, S)
    nc = S // cl
    xc = x.reshape(b, nc, cl, H, P)
    dtc = dt.reshape(b, nc, cl, H)
    Bc, Cc = B.reshape(b, nc, cl, N), C.reshape(b, nc, cl, N)
    # 1. C B^T (its lower triangle is used) and cum, per (b, chunk).
    G = Cc @ Bc.transpose(-1, -2)                          # [b,nc,i,j]
    cum = torch.cumsum(dtc * A, dim=2)                     # [b,nc,cl,H]
    total = cum[:, :, -1]                                  # [b,nc,H]
    xdt = xc * dtc[..., None]                              # [b,nc,cl,H,P]
    # 2. Each chunk's own state contribution, all chunks at once.
    decay = torch.exp(total[:, :, None] - cum)             # [b,nc,cl,H]
    local = torch.einsum("bcjhp,bcjn->bchpn", xdt * decay[..., None], Bc)
    # 3. The carry: the state entering each chunk, and the final state.
    state = torch.zeros(b, H, P, N, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = torch.exp(total[:, c])[..., None, None] * state + local[:, c]
    prev = torch.stack(prev, dim=1)                        # [b,nc,H,P,N]
    # 4. y, with the segment sums masked before the exp.
    tri = torch.ones(cl, cl, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [b,nc,i,j,H]
    L = torch.exp(torch.where(tri[..., None], seg, -torch.inf))
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", G[..., None] * L, xdt)
    y_off = torch.einsum("bcin,bchpn->bcihp", Cc, prev) * torch.exp(
        cum)[..., None]
    return (y_diag + y_off).reshape(b, S, H, P), state


def _check(x, dt, A, B, C):
    dev = x.device
    for name, t, nd in (("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("B", B, 3),
                        ("C", C, 3)):
        if t.dtype != torch.float32 or t.dim() != nd:
            raise ValueError(f"ssd_scan: {name} must be a {nd}-D float32 "
                             f"tensor, got {t.dtype} of shape "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"ssd_scan: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_scan: unsupported device {dev}")
    b, S, H, _ = x.shape
    if (dt.shape != (b, S, H) or A.shape != (H,) or B.shape[:2] != (b, S)
            or C.shape != B.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not fit "
                         "[b,S,H,P], [b,S,H], [H], [b,S,N]")


def _lib():
    lib = build.load("ssd_scan")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.ssd_scan_launch.restype = i
        lib._argtypes_set = True
    return lib


class SSDScanFn(torch.autograd.Function):
    """The scan with a gradient: forward is the kernels' launch (the
    plain version on the CPU) and saves only the inputs; backward
    recomputes `ssd_scan_plain` under autograd and backpropagates
    through it."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _launch(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        if grad_y.device.type == "meta":
            return _meta_backward(ctx, grad_y, grad_state)
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, state = ssd_scan_plain(*inputs, chunk=ctx.chunk)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad((y, state), wanted,
                                             (grad_y, grad_state)))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)


def _flops(x, B, chunk) -> int:
    return meta.ssd_flops(tuple(x.shape), B.shape[-1], chunk)


def _meta_backward(ctx, grad_y, grad_state):
    """The backward on the meta device: empty input gradients, its cost
    reported (`kernels.meta`)."""
    saved = ctx.saved_tensors
    grads = [torch.empty_like(t) if need else None
             for t, need in zip(saved, ctx.needs_input_grad)]
    meta.record("ssd_scan_backward",
                meta.BACKWARD_FACTOR * _flops(saved[0], saved[3], ctx.chunk),
                meta.nbytes(*saved, grad_y, grad_state,
                            *[g for g in grads if g is not None]))
    return tuple(grads) + (None,)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ssd_scan(x, dt, A, B, C, *, chunk=128):
    """x: [b,S,H,P]; dt: [b,S,H]; A: [H]; B,C: [b,S,N] (float32).

    Returns (y [b,S,H,P], final_state [b,H,P,N]), float32."""
    if spmd.is_dtensor(x):
        return spmd.ssd(ssd_scan, x, dt, A, B, C, chunk=chunk)
    _check(x, dt, A, B, C)
    S = x.shape[1]
    chunk = min(chunk, S)
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must be in [1, "
                         f"{MAX_CHUNK}] and divide S={S}")
    if _needs_grad(x, dt, A, B, C):
        return SSDScanFn.apply(x, dt, A, B, C, chunk)
    return _launch(x, dt, A, B, C, chunk)


def _launch(x, dt, A, B, C, chunk):
    """The kernels' launch (the plain version for CPU tensors, the meta
    path for meta ones), without a gradient: refuses inputs that require
    one while grad mode is on."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    if x.device.type == "meta":
        b, _, H, P = x.shape
        y = torch.empty_like(x)
        state = torch.empty(b, H, P, B.shape[-1], device=x.device)
        meta.record("ssd_scan", _flops(x, B, chunk),
                    meta.nbytes(x, dt, A, B, C, y, state))
        return y, state
    if _needs_grad(x, dt, A, B, C):
        raise RuntimeError("ssd_scan: the kernel launch carries no "
                           "gradient; call ssd_scan(), which routes inputs "
                           "that require grad through SSDScanFn")
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    y = torch.empty_like(x)
    state = torch.empty(b, H, P, N, device=x.device)
    # Scratch: C B^T per (b, chunk), cum per head, and the chunk states.
    gt = torch.empty(b, nc, chunk, chunk, device=x.device)
    cum = torch.empty(b, nc, H, chunk, device=x.device)
    states = torch.empty(b, nc, H, P, N, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), gt.data_ptr(),
            cum.data_ptr(), states.data_ptr(), b, S, H, P, N, chunk,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: CUDA launch failed with error {err}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0

"""Mamba2 SSD chunked scan: a hand-written CUDA kernel for Hopper plus
its plain PyTorch version.

Replaces the Pallas TPU kernel of `repro.kernels.ssd_scan` (`_kernel`
via `ssd_scan`). The kernel lives in `csrc/ssd_scan.cu`, is built with
nvcc for sm_90a at first use and called through ctypes on PyTorch's
current stream. It computes in f32 on CUDA cores (see the source's
header for its design and what bounds it).

Semantics: x [b,S,H,P], dt [b,S,H], A [H], B/C [b,S,N], all float32;
`chunk` (at most 128, clipped to S) divides S. Per (b, h) the chunks run
in order with an f32 [P, N] state carry; inside a chunk, with cum the
in-chunk prefix sum of dt*A and L = exp(segment sums) on the lower
triangle: y = (C B^T o L)(x dt) + (C e^cum) state^T and
state' = e^{cum[-1]} state + (x dt e^{cum[-1] - cum})^T B. Returns
(y [b,S,H,P], final state [b,H,P,N]).

The wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. `ssd_scan.launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_CHUNK = 128


def ssd_scan_plain(x, dt, A, B, C, *, chunk=128):
    """Plain PyTorch version: the kernel's chunk loop over all (b, h) at
    once, in f32."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, S)
    state = torch.zeros(b, H, P, N, device=x.device)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        dtc, Bc, Cc = dt[:, sl], B[:, sl], C[:, sl]
        cum = torch.cumsum(dtc * A, dim=1)                     # [b,cl,H]
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # [b,i,j,H]
        L = torch.exp(torch.where(tri[None, :, :, None], seg,
                                  -torch.inf))
        scores = torch.einsum("bin,bjn->bij", Cc, Bc)[..., None] * L
        xdt = x[:, sl] * dtc[..., None]                        # [b,cl,H,P]
        y_diag = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        c_decay = Cc[:, :, None, :] * torch.exp(cum)[..., None]  # [b,i,H,N]
        y_off = torch.einsum("bihn,bhpn->bihp", c_decay, state)
        ys.append(y_diag + y_off)
        decay_end = torch.exp(cum[:, -1:] - cum)               # [b,cl,H]
        state = (torch.exp(cum[:, -1])[..., None, None] * state
                 + torch.einsum("bjhp,bjn->bhpn",
                                xdt * decay_end[..., None], Bc))
    return torch.cat(ys, dim=1), state


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
    if dev.type not in ("cpu", "cuda"):
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
        lib.ssd_scan_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                        i, p]
        lib.ssd_scan_launch.restype = i
        lib._argtypes_set = True
    return lib


def ssd_scan(x, dt, A, B, C, *, chunk=128):
    """x: [b,S,H,P]; dt: [b,S,H]; A: [H]; B,C: [b,S,N] (float32).

    Returns (y [b,S,H,P], final_state [b,H,P,N]), float32."""
    _check(x, dt, A, B, C)
    S = x.shape[1]
    chunk = min(chunk, S)
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must be in [1, "
                         f"{MAX_CHUNK}] and divide S={S}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    b, _, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty(b, H, P, N, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), b, S, H, P, N,
            chunk, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: CUDA launch failed with error {err}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0

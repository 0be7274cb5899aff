"""The port's CUDA kernels against their plain PyTorch versions and the
oracles, on the card (marked `cuda`; they skip without one). The shapes
are those of tests/test_kernels.py plus ragged lengths, so these cover
what the model's path does not: windows, GQA groups, non-causal Sq !=
Skv, head dims 16-256, f32 (at model width too, and off a 16-byte
boundary), and chunks below 128. Each attention case
also checks which variant ran (`variant()`: tensor-core `wgmma` for bf16
with head_dim a multiple of 16 up to 192, CUDA-core `fma` otherwise).

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dht_probe, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain, variant)
from repro_torch.kernels.ssd_scan import ssd_scan_plain  # noqa: E402

pytestmark = pytest.mark.cuda

ATTN_SHAPES = [
    (2, 128, 128, 4, 2, 32, True, None, torch.float32),
    (1, 256, 256, 8, 8, 16, True, 64, torch.float32),
    (2, 128, 256, 4, 1, 64, False, None, torch.float32),
    (1, 64, 64, 2, 2, 128, True, None, torch.bfloat16),
    (1, 128, 128, 6, 3, 32, True, 32, torch.float32),
    (2, 100, 100, 4, 2, 32, True, 24, torch.float32),      # ragged tiles
    (1, 150, 70, 4, 2, 64, True, 40, torch.float32),       # empty rows
    (2, 1024, 1024, 14, 2, 64, True, None, torch.bfloat16),  # Qwen2 layer
    # The tensor-core variant: Qwen2-0.5B's prefill shape, ragged S, GQA
    # groups 1, 2 and 7, dh 64 and 128 (and 16, 48, 96: partial slabs),
    # a window, non-causal Sq != Skv, a q tile with key-less rows.
    (4, 1024, 1024, 14, 2, 64, True, None, torch.bfloat16),
    (2, 1000, 1000, 14, 2, 64, True, None, torch.bfloat16),
    (1, 256, 256, 4, 4, 64, True, None, torch.bfloat16),
    (1, 256, 256, 8, 4, 128, True, None, torch.bfloat16),
    (2, 300, 300, 4, 2, 128, True, 100, torch.bfloat16),
    (2, 200, 330, 4, 1, 64, False, None, torch.bfloat16),
    (1, 150, 70, 4, 2, 64, True, 40, torch.bfloat16),
    (1, 64, 64, 2, 1, 16, True, None, torch.bfloat16),
    (1, 128, 128, 4, 2, 48, True, None, torch.bfloat16),
    (1, 128, 200, 4, 2, 96, False, 32, torch.bfloat16),
    # bf16 shapes the tensor-core variant does not take.
    (1, 64, 64, 2, 2, 40, True, None, torch.bfloat16),
    (1, 96, 96, 2, 1, 8, True, 16, torch.bfloat16),
    # The CUDA-core variant in f32: Qwen2-0.5B's layer (the f32
    # teacher-forced path), dh 128 (one K/V stage) causal and windowed, a
    # dh that is not a multiple of 4 (4-byte copies), non-causal Sq != Skv
    # at dh 96.
    (4, 1024, 1024, 14, 2, 64, True, None, torch.float32),
    (1, 256, 256, 8, 4, 128, True, None, torch.float32),
    (2, 300, 300, 4, 2, 128, True, 100, torch.float32),
    (1, 70, 70, 2, 1, 5, True, None, torch.float32),
    (1, 128, 200, 4, 2, 96, False, 32, torch.float32),
    # The new families' shapes. dh 80 on the tensor cores (Zamba2's
    # shared block, H2O-Danube, HuBERT): causal, non-causal, windowed.
    (2, 256, 256, 4, 4, 80, True, None, torch.bfloat16),
    (2, 256, 256, 4, 4, 80, False, None, torch.bfloat16),
    (1, 300, 300, 8, 2, 80, True, 100, torch.bfloat16),
    # Past 128: dh 144 and 192 (DeepSeek-V3's MLA) in bf16 on the tensor
    # cores (three 64-column slabs, 64-row kv tiles), the rest on the
    # CUDA-core bucket (64-row q tiles): dh 144-256 in f32, 256 in bf16;
    # causal, windowed, GQA, non-causal Sq != Skv, rows with no key, a dh
    # that is not a multiple of 4.
    (1, 128, 128, 4, 2, 144, True, None, torch.bfloat16),
    (1, 128, 128, 4, 2, 144, True, None, torch.float32),
    (1, 256, 256, 4, 4, 192, True, None, torch.bfloat16),
    (1, 256, 256, 4, 4, 192, True, None, torch.float32),
    (2, 200, 200, 8, 2, 192, True, 64, torch.bfloat16),
    (2, 200, 200, 8, 2, 192, True, 64, torch.float32),
    (1, 150, 70, 4, 2, 192, True, 40, torch.float32),
    (1, 1024, 1024, 16, 16, 192, True, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 256, True, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 256, True, None, torch.float32),
    (1, 300, 300, 4, 2, 256, True, 100, torch.float32),
    (1, 200, 330, 4, 1, 256, False, None, torch.float32),
    (1, 130, 130, 2, 1, 130, True, 32, torch.float32),
    # bf16 dh 192 on the tensor cores: DeepSeek-V3's layer (4 batches of
    # 128 heads) cut to 16 heads, non-causal Sq != Skv, ragged lengths
    # (not multiples of the 128-row q or 64-row kv tiles) with a window,
    # GQA groups of 8, a q tile with key-less rows, and dh 160 and 176
    # (a partial third slab).
    (4, 1024, 1024, 16, 16, 192, True, None, torch.bfloat16),
    (2, 200, 330, 4, 1, 192, False, None, torch.bfloat16),
    (2, 300, 250, 8, 2, 192, True, 100, torch.bfloat16),
    (1, 256, 256, 16, 2, 192, True, None, torch.bfloat16),
    (1, 150, 70, 4, 2, 192, True, 40, torch.bfloat16),
    (1, 200, 200, 4, 2, 160, True, None, torch.bfloat16),
    (1, 128, 300, 4, 4, 176, False, 64, torch.bfloat16),
]
SSD_SHAPES = [
    (2, 64, 3, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (1, 64, 1, 8, 8, 64),
    (3, 32, 4, 16, 4, 8),
    (2, 48, 2, 8, 4, 16),
    (2, 256, 3, 64, 128, 128),                              # model widths
    (4, 1024, 24, 64, 128, 128),                            # Mamba2-130M
    (2, 128, 3, 64, 128, 128),                              # one chunk
    (2, 256, 4, 64, 128, 64),                               # chunk 64
    (2, 256, 3, 48, 128, 128),                              # P 48
    (2, 256, 3, 64, 64, 128),                               # N 64
    (2, 36, 3, 6, 5, 6),                # 4-byte loads: P, N, chunk odd
    (1, 21, 2, 8, 8, 7),
    (4, 1024, 80, 64, 64, 128),                             # Zamba2-2.7B
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("B,Sq,Skv,H,KV,dh,causal,win,dtype", ATTN_SHAPES)
def test_flash_attention_kernel(dev, B, Sq, Skv, H, KV, dh, causal, win,
                                dtype):
    rng = np.random.RandomState(Sq + dh)
    q, k, v = (torch.from_numpy(rng.randn(B, S, h, dh).astype(np.float32))
               .to(dev, dtype) for S, h in ((Sq, H), (Skv, KV), (Skv, KV)))
    fa = ops.flash_attention
    before = (fa.launches, fa.launches_wgmma, fa.launches_fma)
    out = fa(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    wgmma = variant(q, k) == "wgmma"
    assert (fa.launches, fa.launches_wgmma, fa.launches_fma) == (
        before[0] + 1, before[1] + wgmma, before[2] + (not wgmma))
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for want in (flash_attention_plain(q, k, v, causal=causal, window=win),
                 ref.attention_ref(q, k, v, causal=causal, window=win)):
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,dh,win", [
    (4, 1024, 14, 2, 64, None),                             # Qwen2 layer
    (1, 300, 4, 2, 128, 100),
])
def test_flash_attention_kernel_unaligned_inputs(dev, B, S, H, KV, dh, win):
    """f32 q, k, v 4 bytes off a 16-byte boundary at model width: the
    CUDA-core variant takes 4-byte copies although dh is a multiple of 4."""
    rng = np.random.RandomState(S + dh)

    def offset(shape):
        a = rng.randn(*shape).astype(np.float32)
        flat = torch.zeros(1 + a.size, device=dev)
        flat[1:] = torch.from_numpy(a.ravel()).to(dev)
        return flat[1:].view(shape)

    q, k, v = offset((B, S, H, dh)), offset((B, S, KV, dh)), offset(
        (B, S, KV, dh))
    assert all(t.data_ptr() % 16 == 4 for t in (q, k, v))
    fa = ops.flash_attention
    before = fa.launches_fma
    out = fa(q, k, v, causal=True, window=win)
    torch.cuda.synchronize()
    assert fa.launches_fma == before + 1
    for want in (flash_attention_plain(q, k, v, causal=True, window=win),
                 ref.attention_ref(q, k, v, causal=True, window=win)):
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


def test_flash_attention_refuses_what_no_variant_takes(dev):
    q = torch.zeros(1, 64, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 2, 272, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
    flat = torch.zeros(1 + 1 * 64 * 2 * 64, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(1, 64, 2, 64)                       # 2-byte offset
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, q, q)


@pytest.mark.parametrize("offset", [1, 4])
def test_flash_attention_refuses_a_misaligned_view_at_dh_192(dev, offset):
    """bf16 dh 192 takes the tensor-core variant, whose TMA loads need
    16-byte aligned q, k, v: a view 2 or 8 bytes off is refused before any
    launch, and never handed to the CUDA-core kernel."""
    q = torch.zeros(1, 64, 2, 192, device=dev, dtype=torch.bfloat16)
    flat = torch.zeros(offset + q.numel(), device=dev, dtype=torch.bfloat16)
    k = flat[offset:].view(q.shape)
    assert variant(q, k) == "wgmma" and k.data_ptr() % 16 == 2 * offset
    fa = ops.flash_attention
    before = (fa.launches, fa.launches_wgmma, fa.launches_fma)
    with pytest.raises(ValueError, match="aligned"):
        fa(q, k, q)
    assert (fa.launches, fa.launches_wgmma, fa.launches_fma) == before


@pytest.mark.parametrize("b,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_kernel(dev, b, S, H, P, N, chunk):
    _ssd_case(dev, b, S, H, P, N, chunk, a_scale=4, dt_scale=0.5)


def test_ssd_scan_kernel_large_decay(dev):
    """|A| dt of ~0.9 per step on average: cum spans over 88 inside a
    chunk, so the upper triangle's segment sums overflow exp in f32
    unless they are masked first. (Much larger spans leave f32 too few
    digits in cum for 2e-4 in any chunked form.)"""
    dt, A = _ssd_case(dev, 2, 256, 3, 64, 128, 128, a_scale=6,
                      dt_scale=0.5)
    span = (dt * A).reshape(2, 2, 128, 3).sum(axis=2)
    assert np.abs(span).min() > 89


def test_ssd_scan_kernel_unaligned_inputs(dev):
    """x, B and C at a 4-byte offset from a 16-byte boundary: the kernels
    take 4-byte copies although P, N and the chunk are multiples of 4."""
    rng = np.random.RandomState(7)
    b, S, H, P, N = 2, 256, 3, 64, 128

    def offset(a):
        flat = torch.zeros(1 + a.size, device=dev)
        flat[1:] = torch.from_numpy(a.astype(np.float32).ravel()).to(dev)
        return flat[1:].view(a.shape)

    x = offset(rng.randn(b, S, H, P))
    Bm, Cm = offset(rng.randn(b, S, N)), offset(rng.randn(b, S, N))
    dt = torch.from_numpy((rng.rand(b, S, H) * 0.5 + 0.01).astype(
        np.float32)).to(dev)
    A = torch.from_numpy(-(rng.rand(H) * 4 + 0.5).astype(np.float32)).to(dev)
    assert x.data_ptr() % 16 == 4
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=128)
    for want in (ssd_scan_plain(x, dt, A, Bm, Cm, chunk=128),
                 ref.ssd_ref(x, dt, A, Bm, Cm)):
        torch.testing.assert_close(y, want[0], atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(s, want[1], atol=2e-4, rtol=2e-4)


def _ssd_case(dev, b, S, H, P, N, chunk, *, a_scale, dt_scale):
    """Runs one case; returns the f64 (dt, A) it drew."""
    rng = np.random.RandomState(S + N)
    x = rng.randn(b, S, H, P)
    dt = rng.rand(b, S, H) * dt_scale + 0.01
    A = -(rng.rand(H) * a_scale + 0.5)
    Bm, Cm = rng.randn(b, S, N), rng.randn(b, S, N)
    args = [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (x, dt, A, Bm, Cm)]
    before = ops.ssd_scan.launches
    y, s = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    for want in (ssd_scan_plain(*args, chunk=chunk), ref.ssd_ref(*args)):
        torch.testing.assert_close(y, want[0], atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(s, want[1], atol=2e-4, rtol=2e-4)
    return dt, A


def test_dht_kernels(dev):
    rng = np.random.RandomState(0)
    nb, TB, KB = 8, 128, 100
    tk = torch.full((nb, TB), -1, dtype=torch.int32, device=dev)
    tv = tk.clone()
    keys = torch.from_numpy((rng.permutation(50_000)[: nb * KB] + 1)
                            .reshape(nb, KB).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.randint(0, 1 << 20, (nb, KB))
                            .astype(np.int32)).to(dev)
    got = dht_probe.dht_insert(tk, tv, keys, vals)
    want = dht_probe.dht_insert_plain(tk, tv, keys, vals)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(dht_probe.dht_lookup(got[0], got[1], keys),
                    dht_probe.dht_lookup_plain(got[0], got[1], keys)):
        assert torch.equal(g, w)


# ------------------------------------------------------------ gradients
GRAD_ATTN_SHAPES = [  # B, Sq, Skv, H, KV, dh, causal, window, dtype
    (2, 256, 256, 4, 2, 64, True, None, torch.bfloat16),   # wgmma, P bf16
    (1, 200, 200, 4, 1, 192, True, 64, torch.bfloat16),    # three slabs
    (2, 128, 128, 4, 2, 32, True, None, torch.float32),    # fma
    (1, 96, 160, 4, 4, 64, False, None, torch.float32),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,dh,causal,win,dtype",
                         GRAD_ATTN_SHAPES)
def test_flash_attention_gradients_on_the_card(dev, B, Sq, Skv, H, KV, dh,
                                               causal, win, dtype):
    """With inputs that require grad the kernel still runs the forward
    (one launch of its variant) and the gradients are autograd's through
    the plain version on the same inputs."""
    rng = np.random.RandomState(Sq + dh)
    raw = [rng.randn(B, S, h, dh).astype(np.float32)
           for S, h in ((Sq, H), (Skv, KV), (Skv, KV), (Sq, H))]
    g = torch.from_numpy(raw[3]).to(dev, dtype)

    def grads(fn):
        ts = [torch.from_numpy(a).to(dev, dtype).requires_grad_()
              for a in raw[:3]]
        out = fn(*ts, causal=causal, window=win)
        out.backward(g)
        return out, [t.grad for t in ts]

    fa = ops.flash_attention
    before = fa.launches
    out, got = grads(fa)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    out_p, want = grads(flash_attention_plain)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), out_p.float(), atol=tol,
                               rtol=tol)
    for a, w in zip(got, want):
        assert a.dtype == dtype and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("b,S,H,P,N,chunk", [(2, 256, 3, 64, 128, 128),
                                             (1, 64, 2, 8, 16, 16)])
def test_ssd_scan_gradients_on_the_card(dev, b, S, H, P, N, chunk):
    rng = np.random.RandomState(S + N)
    raw = [rng.randn(b, S, H, P), rng.rand(b, S, H) * 0.5 + 0.01,
           -(rng.rand(H) * 4 + 0.5), rng.randn(b, S, N), rng.randn(b, S, N),
           rng.randn(b, S, H, P), rng.randn(b, H, P, N)]
    raw = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in raw]

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in raw[:5]]
        y, s = fn(*ts, chunk=chunk)
        torch.autograd.backward((y, s), (raw[5], raw[6]))
        return (y, s), [t.grad for t in ts]

    before = ops.ssd_scan.launches
    out, got = grads(ops.ssd_scan)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert "SSDScanFn" in type(out[0].grad_fn).__name__
    out_p, want = grads(ssd_scan_plain)
    for o, w in zip(out, out_p):
        torch.testing.assert_close(o, w, atol=2e-4, rtol=2e-4)
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, w, atol=1e-6, rtol=1e-6)


def test_raw_kernel_paths_refuse_inputs_that_require_grad(dev):
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod

    q = torch.randn(1, 64, 2, 64, device=dev,
                    dtype=torch.bfloat16).requires_grad_()
    k = torch.randn(1, 64, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        fa_mod._launch(q, k, k, True, None)
    x = torch.randn(1, 32, 2, 8, device=dev).requires_grad_()
    dt = torch.rand(1, 32, 2, device=dev)
    A = -torch.rand(2, device=dev)
    Bm = torch.randn(1, 32, 4, device=dev)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        ssd_mod._launch(x, dt, A, Bm, Bm, 16)
    with torch.no_grad():                     # no graph: the raw launch
        before = (ops.flash_attention.launches, ops.ssd_scan.launches)
        assert fa_mod._launch(q, k, k, True, None).grad_fn is None
        assert ssd_mod._launch(x, dt, A, Bm, Bm, 16)[0].grad_fn is None
        assert (ops.flash_attention.launches, ops.ssd_scan.launches) == (
            before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_serving_launches_unchanged_and_training_step_counts(dev, arch):
    """Serving's prefill (frozen params, grad mode on; or trainable params
    under no_grad) launches the layer's kernel once per layer and records
    no graph; a train step launches it once per layer too (the forward;
    the backward recomputes the plain version) and leaves a finite
    gradient on every parameter."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import batch_for
    from repro_torch.models import lm
    from repro_torch.train.step import build_train_step, init_state

    cfg = get_smoke_config(arch)
    fn = ops.ssd_scan if cfg.family == "ssm" else ops.flash_attention
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in batch_for(cfg, 2, 64, 0).items()}
    served = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    state = init_state(cfg, torch.Generator(dev).manual_seed(0), dev)
    for params, mode in ((served, torch.enable_grad),
                         (state.params, torch.no_grad)):
        before = fn.launches
        with mode():
            logits, _ = lm.prefill(params, cfg, batch)
        torch.cuda.synchronize()
        assert fn.launches == before + cfg.n_layers
        assert logits.grad_fn is None
    step = build_train_step(cfg, remat="none")
    before = fn.launches
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert fn.launches == before + cfg.n_layers
    assert bool(torch.isfinite(metrics["loss"]))
    for name, p in state.params.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name

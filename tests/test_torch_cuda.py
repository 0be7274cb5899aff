"""The port's CUDA kernels against their plain PyTorch versions and the
oracles, on the card (marked `cuda`; they skip without one). The shapes
are those of tests/test_kernels.py plus ragged lengths, so these cover
what the model's path does not: windows, GQA groups, non-causal Sq !=
Skv, head dims 16-128, f32, and chunks below 128.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dht_probe, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_plain)
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
]
SSD_SHAPES = [
    (2, 64, 3, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (1, 64, 1, 8, 8, 64),
    (3, 32, 4, 16, 4, 8),
    (2, 48, 2, 8, 4, 16),
    (2, 256, 3, 64, 128, 128),                              # model widths
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
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for want in (flash_attention_plain(q, k, v, causal=causal, window=win),
                 ref.attention_ref(q, k, v, causal=causal, window=win)):
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("b,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_kernel(dev, b, S, H, P, N, chunk):
    rng = np.random.RandomState(S + N)
    x = rng.randn(b, S, H, P)
    dt = rng.rand(b, S, H) * 0.5 + 0.01
    A = -(rng.rand(H) * 4 + 0.5)
    Bm, Cm = rng.randn(b, S, N), rng.randn(b, S, N)
    args = [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (x, dt, A, Bm, Cm)]
    before = ops.ssd_scan.launches
    y, s = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    for want in (ssd_scan_plain(*args, chunk=chunk), ref.ssd_ref(*args)):
        torch.testing.assert_close(y, want[0], atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(s, want[1], atol=2e-4, rtol=2e-4)


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

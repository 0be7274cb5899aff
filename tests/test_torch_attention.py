"""The port's flash attention against the JAX reference, on the CPU.

On CPU tensors `flash_attention` runs its plain PyTorch version, which
must match the Pallas kernel (interpret mode), the reference's blocked
jnp attention and the naive oracle: 2e-5 in f32, 2e-2 in bf16 (the
tolerances of tests/test_kernels.py). The CUDA kernel itself is held to
the same numbers on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.layers import multihead_attention  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# tests/test_kernels.py's shapes, then ragged lengths (not multiples of
# the kernel's 64-row tiles).
SHAPES = [
    (2, 128, 128, 4, 2, 32, True, None, "float32"),
    (1, 256, 256, 8, 8, 16, True, 64, "float32"),
    (2, 128, 256, 4, 1, 64, False, None, "float32"),
    (1, 64, 64, 2, 2, 128, True, None, "bfloat16"),
    (1, 128, 128, 6, 3, 32, True, 32, "float32"),
    (2, 100, 100, 4, 2, 32, True, None, "float32"),
    (1, 100, 100, 4, 2, 16, True, 24, "float32"),
    (1, 72, 72, 4, 1, 32, True, None, "bfloat16"),
    # Qwen2-0.5B's heads (14 / 2, dh 64) cut to S 256, in bf16: the
    # tensor-core variant's tiles and bf16 P in the plain version.
    (1, 256, 256, 14, 2, 64, True, None, "bfloat16"),
    (1, 200, 200, 8, 4, 128, True, 50, "bfloat16"),
    # Past head_dim 128: DeepSeek-V3's MLA width 192 (causal, windowed,
    # GQA; bf16 takes the tensor-core variant on the card, so the plain
    # version rounds P to bf16) and 256 (the CUDA-core bucket), in both
    # dtypes.
    (1, 128, 128, 4, 4, 192, True, None, "float32"),
    (1, 128, 128, 4, 2, 192, True, 32, "bfloat16"),
    (2, 100, 100, 4, 1, 192, True, None, "bfloat16"),
    (1, 64, 128, 4, 1, 192, False, None, "bfloat16"),
    (1, 128, 128, 4, 2, 144, True, None, "bfloat16"),
    (1, 64, 128, 2, 1, 256, False, None, "float32"),
    (1, 128, 128, 4, 2, 256, True, 40, "bfloat16"),
]


def _inputs(B, Sq, Skv, H, KV, dh, dtype, seed=7):
    rng = np.random.RandomState(seed)
    qkv = [rng.randn(B, S, h, dh).astype(np.float32)
           for S, h in ((Sq, H), (Skv, KV), (Skv, KV))]
    jax_in = [jnp.asarray(a, getattr(jnp, dtype)) for a in qkv]
    # The same (rounded) values on both sides.
    torch_in = [torch.from_numpy(np.array(a.astype(jnp.float32)))
                .to(getattr(torch, dtype)) for a in jax_in]
    return jax_in, torch_in


@pytest.mark.parametrize("B,Sq,Skv,H,KV,dh,causal,win,dtype", SHAPES)
def test_plain_matches_reference(B, Sq, Skv, H, KV, dh, causal, win, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Skv, H, KV, dh, dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=win)
    assert got.dtype == q.dtype and got.shape == q.shape
    wants = [jref.attention_ref(jq, jk, jv, causal=causal, window=win),
             multihead_attention(jq, jk, jv, causal=causal, window=win)]
    if Sq % 64 == 0 and Skv % 64 == 0:      # the Pallas tiles must divide
        wants.append(ref_ops.flash_attention(
            jq, jk, jv, causal=causal, window=win, block_q=64, block_kv=64,
            interpret=True))
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,win", [(True, None), (True, 40),
                                        (False, 30)])
def test_oracle_matches_reference_oracle(causal, win):
    (jq, jk, jv), (q, k, v) = _inputs(2, 96, 96, 4, 2, 32, "float32", 3)
    np.testing.assert_allclose(
        ref.attention_ref(q, k, v, causal=causal, window=win).numpy(),
        np.asarray(jref.attention_ref(jq, jk, jv, causal=causal,
                                      window=win)), atol=2e-5, rtol=2e-5)


def test_rows_with_no_key_average_every_value():
    """A window that ends before the keys do leaves rows with nothing to
    attend: like the reference, they average all values."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 150, 70, 4, 2, 64, "float32", 5)
    got = ops.flash_attention(q, k, v, causal=True, window=40)
    want = jref.attention_ref(jq, jk, jv, causal=True, window=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got[0, -1].numpy(),
                               np.repeat(v[0].mean(0).numpy(), 2, axis=0),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,dh,Skv,want", [
    ("bfloat16", 64, 1024, "wgmma"), ("bfloat16", 128, 8, "wgmma"),
    ("bfloat16", 16, 1, "wgmma"), ("bfloat16", 48, 64, "wgmma"),
    ("bfloat16", 40, 64, "fma"), ("bfloat16", 8, 64, "fma"),
    ("bfloat16", 64, 0, "fma"), ("float32", 64, 1024, "fma"),
    ("float32", 128, 64, "fma"), ("bfloat16", 144, 64, "wgmma"),
    ("bfloat16", 192, 1024, "wgmma"), ("bfloat16", 176, 8, "wgmma"),
    ("bfloat16", 192, 0, "fma"), ("float32", 192, 1024, "fma"),
    ("bfloat16", 200, 64, "fma"), ("bfloat16", 208, 64, "fma"),
    ("bfloat16", 256, 64, "fma"), ("float32", 256, 64, "fma")])
def test_variant_rule(dtype, dh, Skv, want):
    """The CUDA kernel a call takes follows dtype and shape only."""
    dt = getattr(torch, dtype)
    q = torch.zeros(1, 4, 2, dh, dtype=dt)
    k = torch.zeros(1, Skv, 1, dh, dtype=dt)
    assert fa.variant(q, k) == want


@pytest.mark.parametrize("dh", [64, 192])
def test_plain_rounds_p_to_bf16_only_for_the_tensor_core_variant(dh):
    """bf16 inputs of the tensor-core shapes (Qwen2's dh 64, MLA's 192):
    P V uses P rounded to bf16, as the kernel does; f32 inputs keep P in
    f32."""
    (_, _, _), (q, k, v) = _inputs(1, 128, 128, 2, 1, dh, "float32", 9)
    exact = fa.flash_attention_plain(q, k, v)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = fa.flash_attention_plain(qb, kb, vb).float()
    want = fa.flash_attention_plain(qb.float(), kb.float(), vb.float())
    assert not torch.equal(got, want.bfloat16().float())    # P was rounded
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(exact.numpy(), ref.attention_ref(
        q, k, v).numpy(), atol=2e-5, rtol=2e-5)


def test_cpu_wrapper_runs_the_plain_version(monkeypatch):
    calls = []
    plain = fa.flash_attention_plain

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_plain", spy)
    _, (q, k, v) = _inputs(1, 64, 64, 2, 1, 16, "float32")
    before = fa.flash_attention.launches
    fa.flash_attention(q, k, v, causal=False, window=8)
    assert calls == [{"causal": False, "window": 8}]
    assert fa.flash_attention.launches == before      # no kernel launch


def test_wrapper_refuses_mixed_or_bad_inputs():
    _, (q, k, v) = _inputs(1, 64, 64, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="tensors on"):
        ops.flash_attention(q, k.to("meta"), v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, v)
    wide = torch.zeros(1, 8, 2, 272)
    with pytest.raises(ValueError, match="head_dim 272 > 256"):
        ops.flash_attention(wide, wide, wide)
    k2, v2 = torch.cat([k, k], dim=2), torch.cat([v, v], dim=2)
    with pytest.raises(ValueError, match="H % KV"):
        ops.flash_attention(torch.cat([q, q[:, :, :1]], dim=2), k2, v2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=-1)

"""The port's SSD scan against the JAX reference, on the CPU.

On CPU tensors `ssd_scan` runs its plain PyTorch version, which must
match the Pallas kernel (interpret mode), the sequential oracle and the
model's jnp `ssd_chunked` at 2e-4 (tests/test_kernels.py's tolerance).
The CUDA kernel is held to the same on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models.ssm import scan_chunk  # noqa: E402

# tests/test_kernels.py's shapes, then ragged S where the model's chunk
# rule halves the chunk (48 -> 16, 40 -> 8).
SHAPES = [
    (2, 64, 3, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (1, 64, 1, 8, 8, 64),
    (3, 32, 4, 16, 4, 8),
    (2, 48, 2, 8, 4, 32),
    (1, 40, 3, 16, 8, 128),
]


def _inputs(b, S, H, P, N, seed=7):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, S, H, P), rng.rand(b, S, H) * 0.5 + 0.01,
            -(rng.rand(H) * 4 + 0.5), rng.randn(b, S, N), rng.randn(b, S, N)]
    arrs = [a.astype(np.float32) for a in arrs]
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


@pytest.mark.parametrize("b,S,H,P,N,chunk", SHAPES)
def test_plain_matches_reference(b, S, H, P, N, chunk):
    jin, tin = _inputs(b, S, H, P, N)
    cl = scan_chunk(chunk, S)
    y, s = ops.ssd_scan(*tin, chunk=cl)
    wants = [ref_ops.ssd_scan(*jin, chunk=cl, interpret=True),
             jref.ssd_ref(*jin), ssd_chunked(*jin, chunk)]
    for wy, ws in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=2e-4,
                                   rtol=2e-4)


def test_plain_passes_at_model_widths():
    """Mamba2-130M's widths (H 24, P 64, N 128, chunk 128) cut to S 256:
    the plain version's four passes (C B^T per chunk, chunk states in
    parallel, the sequential carry, y) against the Pallas kernel and the
    sequential oracle, so the decomposition the CUDA kernels follow is
    proved on two chunks."""
    jin, tin = _inputs(2, 256, 24, 64, 128, seed=11)
    y, s = ssd.ssd_scan_plain(*tin, chunk=128)
    for wy, ws in (ref_ops.ssd_scan(*jin, chunk=128, interpret=True),
                   jref.ssd_ref(*jin)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=2e-4,
                                   rtol=2e-4)


def test_oracle_matches_reference_oracle():
    jin, tin = _inputs(2, 24, 3, 8, 4, seed=3)
    for got, want in zip(ref.ssd_ref(*tin), jref.ssd_ref(*jin)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("S,chunk", [(1024, 128), (1016, 128), (48, 32),
                                     (7, 128), (96, 64)])
def test_chunk_rule_is_the_reference_rule(S, chunk):
    """`scan_chunk` gives the chunk `ssd_chunked` uses: its states equal
    the Pallas kernel's at that chunk only if the chunks agree."""
    cl = min(chunk, S)
    while S % cl:
        cl //= 2
    assert scan_chunk(chunk, S) == cl and S % cl == 0


def test_cpu_wrapper_runs_the_plain_version(monkeypatch):
    calls = []
    plain = ssd.ssd_scan_plain

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ssd, "ssd_scan_plain", spy)
    _, tin = _inputs(1, 32, 2, 8, 4)
    before = ssd.ssd_scan.launches
    ssd.ssd_scan(*tin, chunk=16)
    assert calls == [{"chunk": 16}]
    assert ssd.ssd_scan.launches == before            # no kernel launch


def test_wrapper_refuses_bad_inputs():
    _, (x, dt, A, B, C) = _inputs(1, 32, 2, 8, 4)
    with pytest.raises(ValueError, match="divide"):
        ops.ssd_scan(x, dt, A, B, C, chunk=12)
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_scan(x.double(), dt, A, B, C)
    with pytest.raises(ValueError, match="tensors on"):
        ops.ssd_scan(x, dt, A, B.to("meta"), C)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B,
                     C)
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd_scan(x, dt[:, :16], A, B, C)

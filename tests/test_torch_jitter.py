"""Seed-for-seed parity of the port's simulator with the JAX reference
under the default cost model (jitter 0.08), on the CPU.

Each seed's schedule is drawn from threefry keys, so this holds only
because the port reproduces `jax.random`'s bits. The port runs seeds
0-3 as four lanes of one batch; the reference runs them one by one.
Metrics are compared exactly, `mean_latency` at rtol=1e-6 (a float32
sum over processes, possibly in another order).
"""
import pytest

torch = pytest.importorskip("torch")

from repro.core import LockSpec as RefSpec  # noqa: E402
from repro.core import Session as RefSession  # noqa: E402
from repro_torch.core import LockSpec, Session, metrics_at  # noqa: E402
from test_torch_engine import assert_metrics_equal  # noqa: E402

KINDS = {
    "fompi_spin": dict(kind="fompi_spin", P=16),
    "fompi_rw": dict(kind="fompi_rw", P=16, writer_fraction=0.25),
    "rma_rw": dict(kind="rma_rw", P=16, fanout=(2,), T_DC=4, T_L=(64, 4),
                   T_R=8, writer_fraction=0.25),
    "rma_mcs": dict(kind="rma_mcs", P=16, fanout=(4,), T_L=(64, 4)),
    "d_mcs": dict(kind="d_mcs", P=16),
}
SEEDS = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def runs():
    """kind -> (reference Metrics per seed, the port's batched Metrics)."""
    cache = {}

    def get(kind):
        if kind not in cache:
            kw = KINDS[kind]
            ref = RefSession(RefSpec(**kw), target_acq=4)
            port = Session(LockSpec(**kw), target_acq=4, device="cpu")
            cache[kind] = ([ref.run(s) for s in SEEDS],
                           port.run_batch(SEEDS))
        return cache[kind]
    return get


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_default_jitter_seed_matches_reference(runs, kind, seed):
    ref, batch = runs(kind)
    got = metrics_at(batch, seed)
    assert_metrics_equal(ref[seed], got)
    assert int(got.violations) == 0 and bool(got.completed)

"""`chip_smoke.py` checks the port on the card, which has no JAX, against
seed-0 constants it holds (events, total acquires, makespan as float32
bits). This pins the constants of its README- and paper-sized
configurations to the JAX reference (the P=16 configurations are
pinned in test_torch_engine.py), those of its grid phase (every point
of the gate grid, and the tuner's winner and per-seed throughputs at
P=64), and those of its Fig. 6 / faults / examples phase: the Fig. 6
rows at P=64, the crash matrix's payload and the quickstart's DHT line.
The port's crash matrix on the CPU is held against the same reference
payload, one reference run shared by both. The script is imported, not
run."""
import numpy as np
import pytest

pytest.importorskip("torch")

from benchmarks import dht_bench as ref_dht  # noqa: E402
from benchmarks import faults as ref_faults  # noqa: E402
from repro.dht import BatchedDHT as RefDHT  # noqa: E402

from repro.core import LockSpec as RefSpec  # noqa: E402
from repro.core import Session as RefSession  # noqa: E402
from repro.core import metrics_at as ref_metrics_at  # noqa: E402
from repro.core.cost import CostModel as RefCost  # noqa: E402
from repro.core.tuner import tune as ref_tune  # noqa: E402
from repro_torch.bench import faults  # noqa: E402
from test_torch_engine import (P16, chip_smoke, ref_run0,  # noqa: E402
                               seed0_constants)

LARGE = [name for name in chip_smoke.SIM_CONFIGS if name not in P16]


def test_every_configuration_has_constants():
    assert set(chip_smoke.SIM_EXPECTED) == set(chip_smoke.SIM_CONFIGS)
    assert len(LARGE) == 3


@pytest.mark.parametrize("name", LARGE)
def test_chip_smoke_constants_match_reference(name):
    assert chip_smoke.SIM_EXPECTED[name] == seed0_constants(ref_run0(name))


def test_chip_smoke_grid_constants_match_reference():
    """GRID_EXPECTED: the reference's seed-0 constants of every point of
    gate_rma_rw's 18-point grid, in (T_DC, T_L, T_R) order."""
    cfg = chip_smoke.SIM_CONFIGS["gate_rma_rw"]
    sess = RefSession(chip_smoke.make_spec(RefSpec, RefCost, cfg),
                      **cfg["session"])
    m = sess.grid(*chip_smoke.GRID_AXES, seeds=[0])
    D, L, R = (len(a) for a in chip_smoke.GRID_AXES)
    assert chip_smoke.GRID_EXPECTED == tuple(
        seed0_constants(ref_metrics_at(m, d, l, r, 0))
        for d in range(D) for l in range(L) for r in range(R))
    assert all(0 <= i < n for p in chip_smoke.GRID_FRESH
               for i, n in zip(p, (D, L, R)))


def test_chip_smoke_tune_constants_match_reference():
    """TUNE_EXPECTED: the reference tuner's winner and per-seed
    throughputs on `benchmarks/run.py --tune`'s default workload."""
    kind, P, kw = chip_smoke.TUNE_SPEC
    res = ref_tune(RefSpec.paper_default(kind, P, **kw),
                   **chip_smoke.TUNE_ARGS)
    assert res.spec.to_json() == chip_smoke.TUNE_EXPECTED["spec"]
    assert tuple(chip_smoke.f64_bits(x) for x in res.throughput_per_seed) \
        == chip_smoke.TUNE_EXPECTED["throughput_per_seed"]


def test_chip_smoke_dht_constants_match_reference():
    """DHT_EXPECTED: the reference's Fig. 6 rows at P=64, every float
    as Python computes it."""
    assert list(chip_smoke.DHT_EXPECTED) == ref_dht.bench_dht(
        ps=chip_smoke.DHT_PS)


@pytest.fixture(scope="module")
def ref_faults_payload():
    """The reference's full crash matrix (`benchmarks/faults.py`)."""
    return ref_faults.bench_faults(quick=False)


def test_chip_smoke_faults_constants_match_reference(ref_faults_payload):
    assert chip_smoke.FAULTS_EXPECTED == ref_faults_payload


def test_bench_faults_matches_reference(ref_faults_payload):
    """The port's crash matrix: every (kind, crash time) pair's seeds as
    the lanes of one run, the same payload as the reference's."""
    payload = faults.bench_faults(quick=False, device="cpu")
    assert payload == ref_faults_payload
    assert all(r["violations"] == 0 and r["all_completed"]
               for r in payload["rows"])


def test_chip_smoke_quickstart_dht_constants_match_reference():
    """QUICKSTART_DHT_EXPECTED: the (inserted, overflow) counts of the
    reference quickstart's DHT line."""
    dht = RefDHT(nb=8, TB=128, heap=1024, interpret=True)
    keys = np.random.RandomState(0).permutation(10_000)[:200] + 1
    _, status = dht.insert(dht.init(), keys.astype(np.int32),
                           np.arange(200, dtype=np.int32))
    status = np.asarray(status)
    assert chip_smoke.QUICKSTART_DHT_EXPECTED == (int((status == 0).sum()),
                                                  int((status == 2).sum()))

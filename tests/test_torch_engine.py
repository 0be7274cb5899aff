"""The port's lock simulator against the JAX reference, on the CPU.

The five deterministic P=16 gates (jitter 0), crash-fault runs, and a
run continued from a mid-run reference state must give the reference's
metrics exactly: events, makespan (as float32 bits), per-process
acquires, locality, violations, completion and the fault metrics.
`mean_latency` is compared at rtol=1e-6 because it is a float32 sum
over processes, which the two frameworks may add in another order.

It also pins the seed-0 constants of the P=16 configurations (the gates
and a crash run) that `chip_smoke.py` checks on the card (which has no
JAX) to the reference;
test_torch_smoke_constants.py pins the larger configurations.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LockSpec as RefSpec  # noqa: E402
from repro.core import Session as RefSession  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.cost import CostModel as RefCost  # noqa: E402
from repro_torch.core import LockSpec, Session, engine  # noqa: E402
from repro_torch.core.cost import CostModel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

EXACT = ("events", "makespan", "per_proc_acq", "locality", "violations",
         "completed", "total_acquires", "throughput", "n_crashed",
         "reclaims", "recovery_retries", "t_crash", "t_recover")


def assert_metrics_equal(ref, got):
    for f in EXACT:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).cpu().numpy()
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(
                b.astype(np.float32).view(np.uint32), a.view(np.uint32),
                err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_allclose(got.mean_latency.cpu().numpy(),
                               np.asarray(ref.mean_latency), rtol=1e-6,
                               atol=0)


GATES = [k for k in chip_smoke.SIM_CONFIGS if k.startswith("gate_")]
# The P=16 configurations: the gates and the rma_rw gate under a crash.
P16 = GATES + ["crash_rma_rw"]


def ref_run0(name):
    """Seed-0 reference Metrics of one chip_smoke configuration (under
    its crash plan, if it has one)."""
    cfg = chip_smoke.SIM_CONFIGS[name]
    sess = RefSession(chip_smoke.make_spec(RefSpec, RefCost, cfg),
                      **cfg["session"])
    return chip_smoke.run_seed(sess, ref_engine, cfg, 0)


@pytest.fixture(scope="module")
def ref_seed0():
    """Seed-0 reference Metrics of the P=16 configurations."""
    return {name: ref_run0(name) for name in P16}


@pytest.mark.parametrize("name", P16)
def test_deterministic_gate_matches_reference(ref_seed0, name):
    cfg = chip_smoke.SIM_CONFIGS[name]
    sess = Session(chip_smoke.make_spec(LockSpec, CostModel, cfg),
                   device="cpu", **cfg["session"])
    got = chip_smoke.run_seed(sess, engine, cfg, 0)
    assert_metrics_equal(ref_seed0[name], got)
    assert int(got.violations) == 0 and bool(got.completed)


def seed0_constants(m):
    """(events, total_acquires, makespan float32 bits), as chip_smoke
    holds them."""
    return (int(m.events), int(m.total_acquires),
            int(np.asarray(m.makespan, np.float32).view(np.uint32)))


@pytest.mark.parametrize("name", P16)
def test_chip_smoke_gate_constants_match_reference(ref_seed0, name):
    assert chip_smoke.SIM_EXPECTED[name] == seed0_constants(ref_seed0[name])


# The README's crash example and its fompi counterpart: victim 3 dies
# at t=1.5 us; the survivors must reclaim and finish.
CRASH = [dict(kind="fompi_rw", P=8, writer_fraction=0.25),
         dict(kind="rma_mcs", P=8, fanout=(2,), T_L=(4, 4))]


@pytest.mark.parametrize("kw", CRASH, ids=[c["kind"] for c in CRASH])
def test_crash_fault_run_matches_reference(kw):
    ref = RefSession(RefSpec(**kw), target_acq=4)
    m_ref = ref_engine.run_sim(
        ref.program, ref.env, ref.layout, seed=0,
        fault=ref_engine.FaultPlan.single(kw["P"], victim=3, t=1.5))
    sess = Session(LockSpec(**kw), target_acq=4, device="cpu")
    got = engine.run_sim(sess.program, sess.env, sess.layout, seed=0,
                         fault=engine.FaultPlan.single(kw["P"], victim=3,
                                                       t=1.5))
    assert_metrics_equal(m_ref, got)
    assert int(got.n_crashed) == 1 and int(got.reclaims) >= 1
    assert int(got.violations) == 0 and bool(got.completed)


def test_reference_recovery_livelock_is_reproduced():
    """The reference's rma_mcs recovery livelocks when victim 3 of P=4
    (fanout (2,), T_L (2, 2)) crashes at 2.0 us under seed 5: survivor
    2 never acquires and the run spins to its event cap (a falsifying
    example of tests/test_faults.py's property test). The port, a copy
    of the protocol, does the same, bit for bit, cut at 1000 events."""
    kw = dict(kind="rma_mcs", P=4, fanout=(2,), T_L=(2, 2))
    ref = RefSession(RefSpec(**kw), target_acq=3)
    m_ref = ref_engine.run_sim(
        ref.program, ref.env, ref.layout, seed=5, max_events=1000,
        fault=ref_engine.FaultPlan.single(4, victim=3, t=2.0))
    sess = Session(LockSpec(**kw), target_acq=3, device="cpu")
    got = engine.run_sim(sess.program, sess.env, sess.layout, seed=5,
                         max_events=1000,
                         fault=engine.FaultPlan.single(4, victim=3, t=2.0))
    assert_metrics_equal(m_ref, got)
    assert int(got.events) == 1000 and not bool(got.completed)
    assert got.per_proc_acq.tolist() == [3, 3, 0, 0]
    assert int(got.violations) == 0 and int(got.reclaims) == 2


def test_run_continued_from_reference_state():
    """A reference state stopped after 300 events, continued under
    another seed by both implementations, ends in the same state."""
    kw = dict(kind="fompi_rw", P=16, writer_fraction=0.25)
    ref = RefSession(RefSpec(**kw), target_acq=4, max_events=300)
    mid = ref.run_state(0)
    assert int(mid.events) == 300
    ref_final = ref_engine._run(ref.handlers, 2_000_000, mid, 7)
    sess = Session(LockSpec(**kw), target_acq=4, device="cpu")
    st = engine.state_from_numpy(
        {k: np.asarray(v) for k, v in mid._asdict().items()}, "cpu")
    final = engine.step_loop(sess.handlers, 2_000_000, st, [7])
    got = engine.state_to_numpy(final)
    for k, v in ref_final._asdict().items():
        np.testing.assert_array_equal(got[k][0], np.asarray(v), err_msg=k)
    assert_metrics_equal(ref_engine.summarize(ref_final),
                         engine.metrics_at(engine.summarize(final), 0))


def test_batch_lanes_equal_single_runs():
    cfg = chip_smoke.SIM_CONFIGS["gate_rma_rw"]
    spec = chip_smoke.make_spec(LockSpec, CostModel, cfg).replace(
        cost=CostModel())
    sess = Session(spec, device="cpu", **cfg["session"])
    batch = sess.run_batch([5, 0])
    for lane, seed in enumerate([5, 0]):
        single = sess.run(seed)
        for a, b in zip(engine.metrics_at(batch, lane), single):
            assert torch.equal(a, b)

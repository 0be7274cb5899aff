"""The port's coarse-to-fine tuner against the JAX reference, on the CPU.

For the same inputs `TuneResult.to_dict()` must equal the reference's
key for key (scores, per-seed throughputs, rounds and winner included),
the winner must reproduce bit for bit on a fresh session, and the JSON
report must round-trip. Uses the reference's P=8 `SMALL_RW` of
tests/test_grid_tuner.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LockSpec as RefSpec  # noqa: E402
from repro.core import tuner as ref_tuner  # noqa: E402
from repro_torch.core import LockSpec, Session, TuneResult, tune  # noqa: E402
from repro_torch.core import tuner  # noqa: E402

MAX_EVENTS = 400_000
SMALL_RW = dict(kind="rma_rw", P=8, fanout=(2,), T_DC=2, T_L=(2, 2), T_R=8,
                writer_fraction=0.25)
# The reference test's two tunes: a refined throughput tune and a
# one-round latency tune.
TUNES = {
    "throughput": dict(t_dc=[1, 2, 8], t_l=[(2, 2), (4, 1)], t_r=[4, 16],
                       seeds=(0, 1), refine_rounds=1, target_acq=2,
                       max_events=MAX_EVENTS),
    "latency": dict(t_dc=[2], t_l=[(2, 2)], t_r=[8, 16], seeds=(0,),
                    refine_rounds=0, target_acq=2, max_events=MAX_EVENTS,
                    objective="latency"),
}


@pytest.fixture(scope="module")
def ref_results():
    return {k: ref_tuner.tune(RefSpec(**SMALL_RW), **kw)
            for k, kw in TUNES.items()}


@pytest.mark.parametrize("name", list(TUNES))
def test_tune_matches_reference(ref_results, name):
    res = tune(LockSpec(**SMALL_RW), device="cpu", **TUNES[name])
    assert res.to_dict() == ref_results[name].to_dict()
    assert res.objective == name and res.violations == 0 and res.completed
    if name == "latency":
        assert res.score == -res.latency_us


def test_tune_winner_reproduces_and_json_round_trips(ref_results):
    res = tune(LockSpec(**SMALL_RW), device="cpu", devices=["cpu"] * 2,
               **TUNES["throughput"])
    want = ref_results["throughput"].to_dict()
    assert res.n_devices == 2 and want["n_devices"] == 1
    assert {**res.to_dict(), "n_devices": 1} == want
    assert len(res.rounds) == 2
    assert res.score >= res.rounds[0]["best_score"]
    assert LockSpec.from_dict(res.to_dict()["spec"]) == res.spec
    back = TuneResult.from_json(res.to_json())
    assert back == res and back.to_json() == res.to_json()
    # The reference's report reads back into the port's TuneResult.
    ref_back = TuneResult.from_json(ref_results["throughput"].to_json())
    assert ref_back.to_dict() == want
    fresh = Session(res.spec, target_acq=2, max_events=MAX_EVENTS,
                    device="cpu").run_batch(res.seeds)
    assert int(fresh.violations.sum()) == 0
    assert tuple(float(x) for x in fresh.throughput.numpy()) \
        == res.throughput_per_seed


def _error(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("bad", [
    dict(objective="vibes"), dict(t_dc=[0]), dict(t_dc=[9]),
    dict(t_l=[(2, 0)]), dict(t_l=[()]), dict(t_r=[0])],
    ids=["objective", "tdc0", "tdc_gt_P", "tl0", "tl_empty", "tr0"])
def test_tune_raises_the_reference_errors(bad):
    """Bad inputs are rejected before any run, with the reference's
    message."""
    assert _error(lambda: tune(LockSpec(**SMALL_RW), device="cpu", **bad)) \
        == _error(lambda: ref_tuner.tune(RefSpec(**SMALL_RW), **bad))


@pytest.mark.parametrize("kw", [
    SMALL_RW, dict(kind="rma_rw", P=64, fanout=(4,), T_L=(1 << 20, 64)),
    dict(kind="fompi_rw", P=16), dict(kind="d_mcs", P=16, T_L=(8,))],
    ids=["small_rw", "p64", "fompi_rw", "d_mcs"])
def test_lattices_match_reference(kw):
    lat = tuner.default_lattice(LockSpec(**kw))
    assert lat == ref_tuner.default_lattice(RefSpec(**kw))
    for d in lat["t_dc"]:
        for tl in lat["t_l"]:
            for r in lat["t_r"]:
                best = (d, tl, r)
                assert tuner._refine_lattice(lat, best) \
                    == ref_tuner._refine_lattice(lat, best)
    assert np.all([1 <= d <= kw["P"] for d in lat["t_dc"]])


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.bench import locks, thresholds
    from repro_torch.bench import tune as tune_cli
    for call in (lambda: tune(LockSpec(**SMALL_RW)),
                 lambda: locks.make_session("rma_rw", 16),
                 lambda: locks.bench_rw_vs_sota(ps=(16,)),
                 lambda: thresholds.sweep_tdc(ps=(16,)),
                 lambda: tune_cli.main(["--quick"])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_tune_cli_writes_a_round_tripping_report(tmp_path, monkeypatch,
                                                 capsys):
    from repro_torch.bench import tune as tune_cli
    monkeypatch.setattr(tune_cli, "RESULTS", str(tmp_path))
    tune_cli.main(["--quick", "--device", "cpu", "--devices", "2"])
    report = (tmp_path / "tuned_spec_torch.json").read_text()
    res = TuneResult.from_json(report)
    assert res.n_devices == 2 and len(res.rounds) == 1
    assert res.spec == LockSpec.paper_default(
        "rma_rw", 16, writer_fraction=0.05).replace(
            T_DC=res.spec.T_DC, T_L=res.spec.T_L, T_R=res.spec.T_R)
    assert f"T_DC={res.spec.T_DC}" in capsys.readouterr().out

"""The port's paper-figure benchmarks against the reference's, on the
CPU: `bench_latency` and `bench_throughput` (Fig. 3), `bench_rw_vs_sota`
(Fig. 5), `sweep_tdc` (Fig. 4a), `sweep_tl_product` and
`sweep_tl_split` (Fig. 4b-d) and `sweep_tr` (Fig. 4e-f) at P=16 give
the rows of `benchmarks/locks.py` and `benchmarks/thresholds.py`
exactly (same keys, same values), one point or kind each where the
function takes a list."""
import pytest

pytest.importorskip("torch")

from benchmarks import locks as ref_locks  # noqa: E402
from benchmarks import thresholds as ref_thresholds  # noqa: E402
from repro_torch.bench import locks, thresholds  # noqa: E402

CASES = {
    "latency": (lambda mod, **kw: mod.bench_latency(
        ps=(16,), kinds=("d_mcs",), **kw), ref_locks, locks),
    "throughput": (lambda mod, **kw: mod.bench_throughput(
        "ecsb", ps=(16,), kinds=("rma_mcs",), **kw), ref_locks, locks),
    "rw_vs_sota": (lambda mod, **kw: mod.bench_rw_vs_sota(ps=(16,), **kw),
                   ref_locks, locks),
    "tdc": (lambda mod, **kw: mod.sweep_tdc(ps=(16,), **kw),
            ref_thresholds, thresholds),
    "tl_product": (lambda mod, **kw: mod.sweep_tl_product(
        P=16, products=(16,), **kw), ref_thresholds, thresholds),
    "tl_split": (lambda mod, **kw: mod.sweep_tl_split(
        P=16, splits=((4, 2),), **kw), ref_thresholds, thresholds),
    "tr": (lambda mod, **kw: mod.sweep_tr(P=16, fws=(0.05,), **kw),
           ref_thresholds, thresholds),
}


@pytest.mark.parametrize("name", list(CASES))
def test_rows_match_reference(name):
    call, ref_mod, mod = CASES[name]
    got = call(mod, device="cpu")
    assert got == call(ref_mod)
    # T_L rows carry no "completed": `_tl_rows` raises on a violation
    # or an incomplete point instead.
    assert got and all(r["completed"] for r in got if "completed" in r)

"""Lock benchmarks -- one per paper figure (Fig. 3 / Fig. 5).

  LB    latency of acquire+release           (Fig. 3 left)
  ECSB  empty-critical-section throughput    (Fig. 3)
  SOB   single-operation throughput          (Fig. 3)
  WCSB  1-4us workload in the CS             (Fig. 3)
  WARB  1-4us wait after release             (Fig. 3)
  RW    RMA-RW vs foMPI-RW across F_W        (Fig. 5)

Every configuration is a `LockSpec.paper_default` point (Piz Daint
machine model: 16 processes/node) run through a `Session` on `device`
(CUDA unless "cpu"). The RW figure scans the writer fraction with
`Session.sweep`: every (F_W, seed) pair is a lane of one run per
(kind, P). Results are *simulated microseconds* of the calibrated
cost model (core/cost.py). Counterpart of `benchmarks/locks.py`: same
functions plus `device=`, same rows.
"""
from __future__ import annotations

from repro_torch.core import LockSpec, PROCS_PER_NODE, Session, metrics_at

BENCH_CS = {"ecsb": 0, "sob": 1, "wcsb": 2, "lb": 0, "warb": 0}


def make_session(kind, P, *, bench="ecsb", target_acq=4,
                 writer_fraction=None, T_DC=PROCS_PER_NODE, T_R=1024,
                 cost=None, max_events=2_000_000, device=None) -> Session:
    spec = LockSpec.paper_default(
        kind, P, writer_fraction=writer_fraction, T_DC=T_DC, T_R=T_R,
        **({} if cost is None else {"cost": cost}))
    return Session(spec, target_acq=target_acq, cs_kind=BENCH_CS[bench],
                   think=bench == "warb", max_events=max_events,
                   device=device)


def metrics_row(m, *, bench, kind, P) -> dict:
    """Flatten one Metrics point into a result row.

    Safety always holds; centralized baselines can SATURATE at scale
    (zero finished acquires in the event budget -- the paper's
    "does not scale" regime). Throughput/latency are then steady-state
    estimates over whatever completed.
    """
    if int(m.violations) != 0:
        raise RuntimeError(f"{kind} P={P}: mutual exclusion violated")
    done = int(m.total_acquires)
    return {
        "bench": bench, "kind": kind, "P": P,
        "latency_us": float(m.mean_latency) if done else float("inf"),
        "throughput_per_s": float(m.throughput),
        "makespan_us": float(m.makespan),
        "locality": float(m.locality),
        "acquires": done,
        "completed": bool(m.completed),
    }


def run_benchmark(kind, P, *, bench="ecsb", target_acq=4, seed=0,
                  writer_fraction=0.002, T_DC=PROCS_PER_NODE, T_R=1024,
                  max_events=2_000_000, device=None):
    sess = make_session(kind, P, bench=bench, target_acq=target_acq,
                        writer_fraction=writer_fraction, T_DC=T_DC,
                        T_R=T_R, max_events=max_events, device=device)
    return metrics_row(sess.run(seed), bench=bench, kind=kind, P=P)


def bench_latency(ps=(16, 64, 256), kinds=("fompi_spin", "d_mcs",
                                           "rma_mcs"), device=None):
    """LB: mutual-exclusion locks, mean acquire+release latency."""
    return [run_benchmark(k, P, bench="lb", device=device)
            for k in kinds for P in ps]


def bench_throughput(bench, ps=(16, 64, 256),
                     kinds=("fompi_spin", "d_mcs", "rma_mcs"), device=None):
    return [run_benchmark(k, P, bench=bench, device=device)
            for k in kinds for P in ps]


def bench_rw_vs_sota(ps=(16, 64, 256), fws=(0.002, 0.02, 0.05),
                     kinds=("fompi_rw", "rma_rw"), seed=0, device=None):
    """Fig. 5: RW locks across writer fractions (one lane-batched sweep
    per (kind, P) pair)."""
    out = []
    for k in kinds:
        for P in ps:
            sess = make_session(k, P, bench="ecsb", device=device)
            m = sess.sweep("writer_fraction", fws, seeds=(seed,))
            for i, fw in enumerate(fws):
                r = metrics_row(metrics_at(m, i, 0), bench="ecsb",
                                kind=k, P=P)
                r["F_W"] = fw
                out.append(r)
    return out

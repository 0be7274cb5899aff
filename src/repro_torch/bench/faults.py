"""Crash-fault injection benchmark: lease-based lock recovery.

    PYTHONPATH=src python -m repro_torch.bench.faults [--quick] \
        [--out PATH] [--device cpu]

For each recoverable lock kind, crash one process at several simulated
times (before, during, and after its first critical section) and let the
survivors detect the expired lease and repair the abandoned queue/lock
state. Reported per kind:

  recovery_us_p50/p90/p99  time from the crash to the first successful
                           reclaim (lease expiry + detection + repair),
                           over the runs where a survivor had to recover
  n_recovered              runs in which at least one reclaim happened
                           (a crash that never blocks anyone needs none)
  total_reclaims           abandoned words reclaimed across all runs
  recovery_retries         recovery steps that had to re-block (lease
                           raced with an in-flight handoff)
  violations               mutual-exclusion violations -- must be 0
  all_completed            every survivor reached its acquire target

Victims are chosen to stress the hardest paths: the writer for RW kinds
(readers must drain and un-bar; a successor must inherit or pass over
the dead writer) and process 0 otherwise. Revive is not exercised: the
hierarchical queue locks do not support it.

The seeds of one (kind, crash time) pair run as the lanes of one
`engine.run_sim_batch` under the shared `FaultPlan`, on `device` (CUDA
unless "cpu"). Results are simulated microseconds under the calibrated
cost model; the lease is the `make_env` default (2.0 us). Counterpart
of `benchmarks/faults.py`, with the same payload; the JSON goes to
results/bench/BENCH_faults_torch.json.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.core import LockSpec, Session, engine
from repro_torch.core.engine import FaultPlan

RESULTS = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "bench"))

CRASH_TIMES_US = (0.5, 1.5, 3.0)

#    kind          P  victim  spec kwargs
FAULT_POINTS = (
    ("d_mcs",      2, 0, {}),
    ("rma_mcs",    2, 0, {"fanout": (2,), "T_L": (2, 1)}),
    ("rma_rw",     2, 0, {"fanout": (2,), "T_DC": 1, "T_L": (1, 1),
                          "T_R": 1, "writer_fraction": 0.5}),
    ("fompi_spin", 4, 0, {}),
    ("fompi_rw",   4, 0, {"writer_fraction": 0.5}),
)


def _session(kind, P, spec_kwargs, *, target_acq=6, device=None):
    spec = LockSpec(kind=kind, P=P, **spec_kwargs)
    return Session(spec, target_acq=target_acq, cs_kind=0, think=False,
                   device=device)


def bench_faults(*, quick: bool = False, target_acq: int = 6, device=None):
    """Run the crash matrix; returns the BENCH_faults payload dict."""
    crash_times = CRASH_TIMES_US[:2] if quick else CRASH_TIMES_US
    rows = []
    for kind, P, victim, spec_kwargs in FAULT_POINTS:
        sess = _session(kind, P, spec_kwargs, target_acq=target_acq,
                        device=device)
        seeds = list(range(1 if quick else P))
        recovery_us = []
        n_recovered = reclaims = retries = violations = 0
        all_completed = True
        n_runs = 0
        for t in crash_times:
            fault = FaultPlan.single(P, victim, t)
            mb = engine.run_sim_batch(sess.program, sess.env, sess.layout,
                                      seeds=seeds,
                                      max_events=sess.max_events,
                                      fault=fault)
            for s in range(len(seeds)):
                m = engine.metrics_at(mb, s)
                n_runs += 1
                violations += int(m.violations)
                reclaims += int(m.reclaims)
                retries += int(m.recovery_retries)
                all_completed &= bool(m.completed)
                t_rec, t_crash = float(m.t_recover), float(m.t_crash)
                if t_rec < float(engine.INF):
                    n_recovered += 1
                    recovery_us.append(t_rec - t_crash)
        pcts = (np.percentile(recovery_us, (50, 90, 99))
                if recovery_us else np.zeros(3))
        rows.append({
            "kind": kind, "P": P,
            "n_runs": n_runs,
            "n_recovered": n_recovered,
            "recovery_us_p50": float(pcts[0]),
            "recovery_us_p90": float(pcts[1]),
            "recovery_us_p99": float(pcts[2]),
            "total_reclaims": reclaims,
            "recovery_retries": retries,
            "violations": violations,
            "all_completed": all_completed,
        })
    return {"crash_times_us": list(crash_times), "rows": rows}


def check_rows(rows):
    """Raise unless every row has zero violations and all survivors
    completed."""
    for row in rows:
        if row["violations"] != 0:
            raise RuntimeError(f"ME violated: {row}")
        if not row["all_completed"]:
            raise RuntimeError(f"survivors stalled: {row}")


def write_payload(payload, path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="2 crash times x 1 seed; checks only, no JSON")
    ap.add_argument("--out", default=os.path.join(RESULTS,
                                                  "BENCH_faults_torch.json"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises without it "
                         "unless given \"cpu\")")
    args = ap.parse_args(argv)

    payload = bench_faults(quick=args.quick, device=args.device)
    for row in payload["rows"]:
        print(f"{row['kind']:<12} P={row['P']} runs={row['n_runs']:>2} "
              f"recovered={row['n_recovered']:>2} "
              f"reclaims={row['total_reclaims']:>2} "
              f"p50={row['recovery_us_p50']:.3f}us "
              f"p99={row['recovery_us_p99']:.3f}us "
              f"violations={row['violations']} "
              f"completed={row['all_completed']}")
    check_rows(payload["rows"])
    if not args.quick:
        write_payload(payload, args.out)
        print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()

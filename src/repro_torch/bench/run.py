"""Benchmark command line: one section per paper table/figure, on the port.

    PYTHONPATH=src python -m repro_torch.bench.run [--quick] [--full] \
        [--only SECTIONS] [--devices N] [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.run --tune [--quick]

Sections: lb, ecsb, sob, wcsb, warb (Fig. 3), rw (Fig. 5), tdc, tl, tr
(Fig. 4), dht (Fig. 6), table (the batched DHT's wall clock), kernels
(the CUDA kernels against their plain versions; CUDA only), faults
(crash injection + lease recovery), roofline (the dry run's table). Each
calls the port's function with
the arguments `benchmarks/run.py` gives the reference's, on `--device`
(CUDA unless "cpu"), writes results/bench/<section>_torch.csv and
prints a summary. Simulated latencies / throughputs come from the
calibrated cost model. `--tune` runs `repro_torch.bench.tune`'s
auto-tuner. The roofline section prints the pod16x16 table of the dry
run's records (`python -m repro_torch.launch.dryrun` writes them to
results/dryrun/), or a hint to run it first. Counterpart of
`benchmarks/run.py`.
"""
from __future__ import annotations

import argparse
import csv
import os

from repro_torch.core.engine import resolve_device

RESULTS = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "bench"))

SECTIONS = ("lb", "ecsb", "sob", "wcsb", "warb", "rw", "tdc", "tl", "tr",
            "dht", "table", "kernels", "roofline", "faults")


def coerce_scalars(rows):
    """Convert numpy scalars and 0-d torch tensors to plain Python
    values, so show() formats them as numbers and write_csv writes
    plain values rather than their repr."""
    import numpy as np
    import torch

    def plain(v):
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, torch.Tensor) and v.dim() == 0:
            return v.item()
        return v

    return [{k: plain(v) for k, v in r.items()} for r in rows]


def write_csv(name, rows):
    """results/bench/<name>_torch.csv, one column per key of any row."""
    if not rows:
        return
    rows = coerce_scalars(rows)
    keys = sorted({k for r in rows for k in r})
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, name + "_torch.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def show(title, rows, cols):
    rows = coerce_scalars(rows)
    print(f"\n== {title} ==")
    hdr = " ".join(f"{c:>16s}" for c in cols)
    print(hdr)
    for r in rows:
        print(" ".join(
            f"{r.get(c, ''):>16.4g}" if isinstance(r.get(c), float)
            else f"{str(r.get(c, '')):>16s}" for c in cols))


def sections(only):
    """The sections to run: all of SECTIONS, or the comma list `only`
    (a ValueError for a name that is not a section)."""
    if only is None:
        return set(SECTIONS)
    names = set(only.split(","))
    unknown = names - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}; the "
                         f"sections are {','.join(SECTIONS)}")
    return names


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small P values only (CI-speed)")
    ap.add_argument("--full", action="store_true",
                    help="larger P sweep (P up to 1024; slow)")
    ap.add_argument("--only", default=None,
                    help="comma list: " + ",".join(SECTIONS))
    ap.add_argument("--tune", action="store_true",
                    help="run the 3D grid auto-tuner and write "
                         "results/bench/tuned_spec_torch.json")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="split --tune and the threshold-sweep sections "
                         "over the first N CUDA devices (N chunks on the "
                         "CPU with --device cpu), run one after another")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises without it "
                         "unless given \"cpu\")")
    args = ap.parse_args(argv)

    if args.tune:
        from repro_torch.bench import tune
        if args.only:
            print("note: --tune runs alone; ignoring --only "
                  f"{args.only!r} (run the sections without --tune)")
        tune.run_tuner(args)
        return

    want = sections(args.only)
    dev = args.device
    if "kernels" in want and resolve_device(dev).type != "cuda":
        raise ValueError("the kernels section times the CUDA kernels and "
                         "runs on a CUDA device only; leave it out of "
                         "--only on the CPU")
    from repro_torch.bench import dht, faults, kernels, locks, thresholds

    devices = args.devices
    if devices is not None and dev == "cpu":
        devices = ["cpu"] * devices
    ps = (16, 64) if args.quick else (16, 64, 256)
    if args.full:
        ps = (16, 64, 256, 1024)

    if "lb" in want:
        rows = locks.bench_latency(ps=ps, device=dev)
        write_csv("lb", rows)
        show("LB: acquire+release latency (us, simulated)", rows,
             ["bench", "kind", "P", "latency_us"])
    for b in ("ecsb", "sob", "wcsb", "warb"):
        if b in want:
            rows = locks.bench_throughput(b, ps=ps, device=dev)
            write_csv(b, rows)
            show(f"{b.upper()}: throughput (acquires/s, simulated)", rows,
                 ["bench", "kind", "P", "throughput_per_s", "locality"])
    if "rw" in want:
        rows = locks.bench_rw_vs_sota(ps=ps, device=dev)
        write_csv("rw", rows)
        show("RW vs SOTA (Fig. 5)", rows,
             ["kind", "F_W", "P", "throughput_per_s"])
    if "tdc" in want:
        rows = thresholds.sweep_tdc(ps=ps[:2] if args.quick else ps,
                                    devices=devices, device=dev)
        write_csv("tdc", rows)
        show("T_DC sweep (Fig. 4a)", rows,
             ["T_DC", "P", "throughput_per_s", "latency_us"])
    if "tl" in want:
        rows = thresholds.sweep_tl_product(devices=devices, device=dev)
        rows += thresholds.sweep_tl_split(devices=devices, device=dev)
        write_csv("tl", rows)
        show("T_L sweeps (Fig. 4b-d)", rows,
             ["bench", "T_L", "throughput_per_s", "latency_us",
              "locality"])
    if "tr" in want:
        rows = thresholds.sweep_tr(devices=devices, device=dev)
        write_csv("tr", rows)
        show("T_R sweep (Fig. 4e-f)", rows,
             ["T_R", "F_W", "throughput_per_s"])
    if "dht" in want:
        rows = dht.bench_dht(ps=(16,) if args.quick else (16, 64),
                             device=dev)
        write_csv("dht", rows)
        show("DHT case study (Fig. 6; total us, lower=better)", rows,
             ["P", "F_W", "fompi_a_us", "fompi_rw_us", "rma_rw_us"])
    if "table" in want:
        rows = dht.bench_batched_table(device=dev)
        write_csv("table", rows)
        show("Batched table (wall us per batch)", rows,
             ["n_keys", "insert_us_per_batch", "lookup_us_per_batch"])
    if "kernels" in want:
        rows = kernels.bench_kernels(device=dev)
        write_csv("kernels", rows)
        show("CUDA kernels (us per call on the card)", rows,
             ["bench", "shape", "kernel_us", "plain_us"])
    if "faults" in want:
        payload = faults.bench_faults(quick=args.quick, device=dev)
        rows = payload["rows"]
        faults.check_rows(rows)
        write_csv("faults", rows)
        show("FAULTS: crash injection + lease recovery (us, simulated)",
             rows, ["kind", "P", "n_runs", "n_recovered",
                    "recovery_us_p50", "recovery_us_p99",
                    "total_reclaims", "violations"])
        if not args.quick:
            faults.write_payload(payload, os.path.join(
                RESULTS, "BENCH_faults_torch.json"))
    if "roofline" in want:
        from repro_torch.bench import roofline
        print("\n" + roofline.report(mesh="pod16x16"))
    print(f"\nbenchmarks complete; csv in {RESULTS}")


if __name__ == "__main__":
    main()

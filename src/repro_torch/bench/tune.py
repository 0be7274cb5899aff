"""The (T_DC, T_L, T_R) auto-tuner for the paper's benchmark workload.

    PYTHONPATH=src python -m repro_torch.bench.tune [--quick|--full] \
        [--devices N] [--device cpu]

Counterpart of `benchmarks/run.py --tune`, with its workloads:
`LockSpec.paper_default("rma_rw", P, writer_fraction=0.05)` at P=16
(--quick), 64 (default) or 256 (--full), with that command's seeds,
refine rounds, target acquires and event budget. Writes the winning
LockSpec and its evidence to results/bench/tuned_spec_torch.json; the
embedded spec round-trips through `LockSpec.from_dict` unchanged. Runs
on CUDA unless `--device cpu`; `--devices N` splits every grid over
the first N CUDA devices (with `--device cpu`, over N chunks on the
CPU), run chunk after chunk: bitwise the same result, about N times
slower than one device.
"""
from __future__ import annotations

import argparse
import json
import os
import time

RESULTS = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "bench"))


def run_tuner(args) -> str:
    from repro_torch.core import LockSpec
    from repro_torch.core.tuner import tune

    P = 16 if args.quick else (256 if args.full else 64)
    spec = LockSpec.paper_default("rma_rw", P, writer_fraction=0.05)
    devices = args.devices
    if devices is not None and args.device == "cpu":
        devices = ["cpu"] * devices
    t0 = time.perf_counter()
    res = tune(spec,
               seeds=(0, 1) if args.quick else tuple(range(4)),
               refine_rounds=0 if args.quick else (2 if args.full else 1),
               target_acq=2 if args.quick else 4,
               max_events=400_000 if args.quick else 2_000_000,
               devices=devices, device=args.device)
    wall = time.perf_counter() - t0      # results are on the host
    # The emitted spec must survive serialization exactly — it is the
    # deployment artifact.
    if LockSpec.from_dict(res.to_dict()["spec"]) != res.spec:
        raise RuntimeError("the winning spec does not round-trip through "
                           "LockSpec.from_dict")
    os.makedirs(RESULTS, exist_ok=True)
    path = os.path.join(RESULTS, "tuned_spec_torch.json")
    with open(path, "w") as f:
        json.dump(res.to_dict(), f, indent=2, sort_keys=True)
    print(f"\n== TUNE: best (T_DC, T_L, T_R) point for rma_rw P={P} ==")
    print(f"  winner: T_DC={res.spec.T_DC} T_L={res.spec.T_L} "
          f"T_R={res.spec.T_R}")
    print(f"  {res.objective}: {res.score:.4g} "
          f"({res.n_points} lattice points, {len(res.rounds)} rounds, "
          f"{res.n_devices} device(s), {wall:.2f} s)")
    print(f"  report: {path}")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--quick", action="store_true",
                      help="P=16, 2 seeds, no refinement (CI-speed)")
    size.add_argument("--full", action="store_true",
                      help="P=256, 2 refine rounds (slow)")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="split every grid over the first N CUDA devices "
                         "(N chunks on the CPU with --device cpu), run "
                         "one after another: the same result, about N "
                         "times slower than one device")
    ap.add_argument("--device", default=None,
                    help="the session's device (default: CUDA; raises "
                         "without it unless given \"cpu\")")
    run_tuner(ap.parse_args(argv))


if __name__ == "__main__":
    main()

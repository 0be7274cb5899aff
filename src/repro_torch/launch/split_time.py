"""Time `Session.grid` split over devices against the one-device grid:
the 18-point gate lattice of `chip_smoke.py` (gate_rma_rw, P=16, seed 0)
run once with `devices=None` and once with `--devices` (default two
chunks on cuda:0), each chunk timed on its own.

    python src/repro_torch/launch/split_time.py [--src TREE/src] \
        [--devices cuda:0,cuda:0] [--device cpu]

`--src` names the source tree whose `repro_torch` is timed (default:
the one holding this file), so that two trees' `devices=` dispatch can
be compared on one card in one session, in turns (parent, change,
change, parent). `--device cpu` (with `--devices cpu,cpu`) rehearses
the script on the CPU. Prints one JSON line: the wall time (s), event
steps and ms per event step of the one-device grid and of the split
grid, each chunk's lanes, event steps, wall time and ms per step,
whether the split grid is bitwise equal to the one-device grid, and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the source tree (its src/ directory) to time")
    ap.add_argument("--devices", default="cuda:0,cuda:0",
                    help="comma-separated devices of the split grid")
    ap.add_argument("--device", default=None,
                    help="the session's device (default: CUDA)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))

    import torch
    import chip_smoke
    from repro_torch.core import LockSpec, Session
    from repro_torch.core.cost import CostModel

    cuda = args.device is None or str(args.device).startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    chunks = []
    run_entries = Session._run_entries

    def timed_entries(self, points, entries, device):
        sync()
        t0 = time.perf_counter()
        m = run_entries(self, points, entries, device)
        sync()
        wall = time.perf_counter() - t0
        steps = int(m.events.max())
        chunks.append({"device": str(device), "lanes": len(entries),
                       "steps": steps, "s": wall,
                       "ms_per_step": 1e3 * wall / steps})
        return m

    Session._run_entries = timed_entries
    cfg = chip_smoke.SIM_CONFIGS["gate_rma_rw"]
    spec = chip_smoke.make_spec(LockSpec, CostModel, cfg)
    sess = Session(spec, device=args.device, **cfg["session"])
    out = {"src": str(Path(args.src).resolve())}
    grids = {}
    for name, devices in (("one", None),
                          ("split", args.devices.split(","))):
        chunks.clear()
        sync()
        t0 = time.perf_counter()
        m = sess.grid(*chip_smoke.GRID_AXES, seeds=[0], devices=devices)
        sync()
        wall = time.perf_counter() - t0
        steps = int(m.events.max())
        grids[name] = m
        out[name] = {"devices": devices, "s": wall, "steps": steps,
                     "ms_per_step": 1e3 * wall / steps,
                     "chunks": list(chunks)}
    out["split_over_one"] = out["split"]["s"] / out["one"]["s"]
    out["bitwise_equal"] = chip_smoke.same(grids["split"], grids["one"])
    if cuda:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0 if out["bitwise_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())

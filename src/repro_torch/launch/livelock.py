"""Model-check the hierarchical crash recovery at P=4: RMA-MCS, fanout
(2,), T_L (2, 2), process 3 crashing at any point of any interleaving
(the configuration of a recovery livelock a seeded crash run can hit).

    python -m repro_torch.launch.livelock [--acq 1 2 3]
        [--max-states 2000000] [--device cpu] [--out FILE]

Runs `repro_torch.analysis.model.Explorer(crash_victim=3)` for each
target acquire count in turn and stops after the first run that hits
the state cap. Prints, per run, the states, edges, breadth-first
levels, the widest level's lanes, the wall time and the peak host
memory, the findings by kind, and the first few findings with their
counterexample traces; `--out` writes every finding as JSON.
"""
from __future__ import annotations

import argparse
import json
import resource
import time
from collections import Counter

from repro_torch.analysis.model import Explorer
from repro_torch.core import LockSpec, Session, engine

SPEC = dict(kind="rma_mcs", P=4, fanout=(2,), T_L=(2, 2))
VICTIM = 3


def check(target_acq: int, max_states: int, device) -> dict:
    s = Session(LockSpec(**SPEC), target_acq=target_acq, cs_kind=0,
                think=False, device=device)
    meta = s.program.meta(s.env)
    t0 = time.perf_counter()
    res = Explorer(s.program, s.env, s.layout, max_states=max_states,
                   crash_victim=VICTIM).explore()
    return {
        "target_acq": target_acq, "n_states": res.n_states,
        "n_edges": res.n_edges, "capped": res.capped,
        "n_terminals": res.n_terminals, "levels": res.levels,
        "widest": res.widest, "seconds": time.perf_counter() - t0,
        "max_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        // 1024,
        "findings": [{"kind": f.kind, "message": f.message,
                      "trace": f.render_trace(meta)} for f in res.findings]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--acq", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--max-states", type=int, default=2_000_000)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = engine.resolve_device(args.device)
    runs = []
    for acq in args.acq:
        r = check(acq, args.max_states, device)
        runs.append(r)
        kinds = Counter(f["kind"] for f in r["findings"])
        print(f"rma_mcs P=4 fanout=(2,) T_L=(2, 2) crash=p{VICTIM} "
              f"acq={acq}: {r['n_states']} states, {r['n_edges']} edges, "
              f"{r['n_terminals']} terminals, capped {r['capped']}, "
              f"{r['levels']} levels, widest {r['widest']} lanes, "
              f"{r['seconds']:.1f} s on {device}, peak {r['max_rss_mb']} "
              f"MB; findings {dict(kinds)}", flush=True)
        for f in r["findings"][:3]:
            print(f"  {f['kind']}: {f['message']}\n    trace: {f['trace']}",
                  flush=True)
        if r["capped"]:
            break
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(runs, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

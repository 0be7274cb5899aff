"""Quickstart: the paper's RMA-RW lock + the DHT it accelerates.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Counterpart of `examples/quickstart.py`, on CUDA unless `--device cpu`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import LockSpec, Session
from repro_torch.dht import BatchedDHT
from repro_torch.examples._cli import Out, device_arg


def rw_demo(device=None) -> dict:
    """Part 1: the RMA-RW lock, a 32-seed batch, the foMPI-RW baseline.
    Returns the sessions, their Metrics and the printed lines."""
    say = Out()
    # --- 1. A topology-aware distributed Reader-Writer lock (paper §3) --
    # 64 processes on 4 nodes; one physical counter per node (T_DC=16);
    # up to 8 consecutive local writer passes (T_L leaf), 1024 reader
    # batch. A LockSpec is one point in the paper's (T_DC, T_L, T_R)
    # space -- it validates on construction and round-trips through JSON.
    spec = LockSpec(kind="rma_rw", P=64, fanout=(4,), T_DC=16,
                    T_L=(1 << 20, 8), T_R=1024, writer_fraction=0.02)
    assert LockSpec.from_json(spec.to_json()) == spec

    sess = Session(spec, target_acq=8, cs_kind=1, device=device)
    m = sess.run(seed=0)
    say(f"RMA-RW:  {int(m.total_acquires)} acquires, "
        f"violations={int(m.violations)}, "
        f"throughput={float(m.throughput):.3g}/s (simulated), "
        f"locality={float(m.locality):.2f}")

    # One run, 32 seeds = 32 distinct schedule interleavings as lanes
    # (the executable analogue of the paper's SPIN checking, §4.4).
    mb = sess.run_batch(np.arange(32))
    say(f"         32-seed batch: violations={int(mb.violations.sum())}, "
        f"throughput={float(mb.throughput.mean()):.3g}"
        f"+-{float(mb.throughput.std(correction=0)):.2g}/s")

    # The same workload on the centralized foMPI-RW baseline:
    base = Session(LockSpec(kind="fompi_rw", P=64, writer_fraction=0.02),
                   target_acq=8, cs_kind=1, device=device)
    mbase = base.run(seed=0)
    say(f"foMPI-RW: throughput={float(mbase.throughput):.3g}/s "
        f"({float(m.throughput) / float(mbase.throughput):.1f}x slower "
        f"than RMA-RW)")
    return {"sessions": {"rma_rw": sess, "fompi_rw": base},
            "rma_rw": m, "batch": mb, "fompi_rw": mbase,
            "lines": say.lines}


def dht_demo(device=None) -> dict:
    """Part 2: the distributed hashtable case study (paper §5.3) on the
    batched table (the CUDA dht_probe kernels on the card). Returns its
    counts and the printed lines."""
    say = Out()
    dht = BatchedDHT(nb=8, TB=128, heap=1024, device=device)
    st = dht.init()
    keys = torch.as_tensor(
        np.random.RandomState(0).permutation(10_000)[:200] + 1,
        dtype=torch.int32, device=dht.device)
    vals = torch.arange(200, dtype=torch.int32, device=dht.device)
    st, status = dht.insert(st, keys, vals)
    out, found = dht.lookup(st, keys)
    res = {"inserted": int((status == 0).sum()),
           "overflow": int((status == 2).sum()),
           "all_found": bool(found.all()),
           "values_ok": bool((out == vals).all())}
    say(f"DHT:     inserted={res['inserted']}, "
        f"overflow={res['overflow']}, "
        f"all found={res['all_found']}, "
        f"values ok={res['values_ok']}")
    return dict(res, lines=say.lines)


def main(device=None) -> dict:
    """Both parts; returns part 1's dict with part 2's under "dht"."""
    out = rw_demo(device)
    out["dht"] = dht_demo(device)
    out["lines"] = out["lines"] + out["dht"]["lines"]
    return out


if __name__ == "__main__":
    main(device_arg(__doc__))

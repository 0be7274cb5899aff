"""Lock family tour: every protocol of the paper on one workload, plus
the locality/fairness dial (T_L) and the reader/writer dial (T_R) --
each dial turned with one lane-batched `Session.sweep` call -- and the
full 3D (T_DC, T_L, T_R) lattice as the lanes of one `Session.grid` run.

    PYTHONPATH=src python -m repro_torch.examples.lock_demo [--device cpu]

Counterpart of `examples/lock_demo.py`, on CUDA unless `--device cpu`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import LockSpec, Session, metrics_at, registered_kinds
from repro_torch.examples._cli import Out, device_arg

P = 64


def main(device=None) -> dict:
    """Runs the tour; returns each part's Metrics and the printed
    lines."""
    say = Out()
    out = {"kinds": {}}
    say(f"== all five protocols, P={P}, single-op CS ==")
    for kind in ("fompi_spin", "fompi_rw", "d_mcs", "rma_mcs", "rma_rw"):
        kw = {}
        if kind in ("rma_mcs", "rma_rw"):
            kw = dict(fanout=(4,), T_L=(1 << 20, 8))
        if kind in ("rma_rw", "fompi_rw"):
            kw["writer_fraction"] = 0.05
        if kind == "rma_rw":
            kw.update(T_DC=16, T_R=1024)
        sess = Session(LockSpec(kind=kind, P=P, **kw), target_acq=6,
                       cs_kind=1, device=device)
        m = out["kinds"][kind] = sess.run(seed=0)
        say(f"  {kind:11s} latency={float(m.mean_latency):9.2f}us "
            f"throughput={float(m.throughput):10.3g}/s "
            f"locality={float(m.locality):.2f} "
            f"(violations={int(m.violations)})")
    assert set(registered_kinds()) == {"fompi_spin", "fompi_rw", "d_mcs",
                                       "rma_mcs", "rma_rw"}

    say("\n== T_L: locality vs fairness (RMA-MCS, Fig. 4c) ==")
    mcs = Session(LockSpec(kind="rma_mcs", P=P, fanout=(4,),
                           T_L=(1 << 20, 1)), target_acq=6, device=device)
    leaves = (1, 4, 16, 64)
    m = out["T_L"] = mcs.sweep("T_L", [(1 << 20, t) for t in leaves])
    for i, t_leaf in enumerate(leaves):
        mi = metrics_at(m, i, 0)
        say(f"  T_L,leaf={t_leaf:3d}: locality={float(mi.locality):.2f} "
            f"throughput={float(mi.throughput):10.3g}/s")

    say("\n== T_R: reader batch before writer handover (Fig. 4e) ==")
    rw = Session(LockSpec(kind="rma_rw", P=P, fanout=(4,), T_DC=16,
                          T_L=(4, 4), T_R=16, writer_fraction=0.05),
                 target_acq=6, device=device)
    trs = (16, 256, 4096)
    m = out["T_R"] = rw.sweep("T_R", trs)
    for i, t_r in enumerate(trs):
        mi = metrics_at(m, i, 0)
        say(f"  T_R={t_r:5d}: throughput={float(mi.throughput):10.3g}/s")

    say("\n== the full 3D space (Fig. 4 as the lanes of ONE run) ==")
    t_dc, t_l, t_r = (1, 16, 64), ((1 << 20, 1), (1 << 20, 16)), (64, 1024)
    g = out["grid"] = rw.grid(t_dc, t_l, t_r, seeds=(0,))
    assert int(g.violations.sum()) == 0
    tput = g.throughput[..., 0].cpu().numpy()      # [T_DC, T_L, T_R]
    best = np.unravel_index(np.argmax(tput), tput.shape)
    say(f"  {tput.size} lattice points, one run; best point "
        f"T_DC={t_dc[best[0]]} T_L={t_l[best[1]]} T_R={t_r[best[2]]} "
        f"at {tput[best]:.3g}/s (see also: python -m "
        f"repro_torch.bench.run --tune)")
    out["lines"] = say.lines
    return out


if __name__ == "__main__":
    main(device_arg(__doc__))

"""Threshold sweeps -- Fig. 4 of the paper.

  sweep_tdc  (4a): physical-counter spacing T_DC
  sweep_tl   (4b-d): locality thresholds T_L,i (product + split)
  sweep_tr   (4e-f): reader batch T_R, crossed with F_W

Each figure is a `Session.sweep` call whose (point, seed) pairs are the
lanes of one run — T_DC included: window layouts are padded to a
common counter-slot count, so every point shares the window. Every
sweep takes `devices=` (an int count of CUDA devices or a device list)
to split the flattened (points x seeds) batch across devices, chunk
after chunk — results are bitwise those of the one-device run, and N
devices take about N times as long as one — and `device=` for the
session (CUDA unless "cpu"). Rows assert only the safety/liveness
invariants (violations == 0, completed), never absolute values.
Counterpart of `benchmarks/thresholds.py`: same functions plus
`device=`, same rows.
"""
from __future__ import annotations

from repro_torch.bench.locks import PROCS_PER_NODE, make_session, metrics_row
from repro_torch.core import LockSpec, Session, metrics_at


def sweep_tdc(ps=(32, 64, 256), tdcs=(4, 16, 32, 64), fw=0.002,
              devices=None, device=None):
    out = []
    for P in ps:
        values = [t for t in tdcs if t <= P]
        if not values:
            continue
        sess = make_session("rma_rw", P, writer_fraction=fw, device=device)
        m = sess.sweep("T_DC", values, devices=devices)
        for i, t in enumerate(values):
            r = metrics_row(metrics_at(m, i, 0), bench="ecsb",
                            kind="rma_rw", P=P)
            r["T_DC"] = t
            out.append(r)
    return out


def _tl_session(P, fw, device=None):
    spec = LockSpec(kind="rma_rw", P=P,
                    fanout=(max(P // PROCS_PER_NODE, 1),),
                    T_DC=PROCS_PER_NODE, T_L=(1 << 20, 64), T_R=1024,
                    writer_fraction=fw)
    return Session(spec, target_acq=4, cs_kind=0, device=device)


def _tl_rows(bench, P, sess, points, devices=None):
    m = sess.sweep("T_L", points, devices=devices)
    out = []
    for i, (root, leaf) in enumerate(points):
        mi = metrics_at(m, i, 0)
        if int(mi.violations) != 0 or not bool(mi.completed):
            raise RuntimeError(f"{bench} P={P} T_L={(root, leaf)}: "
                                 "violations or not completed")
        out.append({"bench": bench, "P": P, "T_W": root * leaf,
                    "T_L": (root, leaf),
                    "throughput_per_s": float(mi.throughput),
                    "latency_us": float(mi.mean_latency),
                    "locality": float(mi.locality)})
    return out


def sweep_tl_product(P=64, products=(16, 100, 1000), fw=0.25,
                     devices=None, device=None):
    """Fig 4b: total writer batch T_W = prod(T_L) before reader handover."""
    points = []
    for prod in products:
        leaf = max(int(prod ** 0.5), 1)
        root = max(prod // leaf, 1)
        points.append((root, leaf))
    return _tl_rows("tl_product", P, _tl_session(P, fw, device), points,
                    devices=devices)


def sweep_tl_split(P=64, splits=((100, 10), (40, 25), (20, 50)), fw=0.25,
                   devices=None, device=None):
    """Fig 4c/d: fixed product, varying the per-level split (root, leaf)."""
    return _tl_rows("tl_split", P, _tl_session(P, fw, device), list(splits),
                    devices=devices)


def sweep_tr(P=64, trs=(64, 512, 4096), fws=(0.002, 0.02, 0.05),
             devices=None, device=None):
    out = []
    for fw in fws:
        sess = make_session("rma_rw", P, writer_fraction=fw, device=device)
        m = sess.sweep("T_R", trs, devices=devices)
        for i, tr in enumerate(trs):
            r = metrics_row(metrics_at(m, i, 0), bench="ecsb",
                            kind="rma_rw", P=P)
            r["T_R"] = tr
            r["F_W"] = fw
            out.append(r)
    return out

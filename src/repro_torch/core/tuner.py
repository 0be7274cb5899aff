"""Coarse-to-fine auto-tuner over the paper's 3D lock parameter space.

The paper's central claim is that a lock is a *point* in the space
spanned by (T_DC, T_L, T_R) (§3.2) and that the right point depends on
the workload (reader/writer mix, contention, topology). The tuner makes
that operational, in the spirit of BRAVO-style runtime re-biasing (Dice
& Kogan, *BRAVO: Biased Locking for Reader-Writer Locks*): evaluate a
coarse lattice over the whole space, zoom into the neighborhood of the
winner, and emit the winning `LockSpec` as JSON for deployment.

Every round is ONE `Session.grid` run, every (lattice point, seed)
pair a lane of it (window layouts padded to a common counter-slot
count let every T_DC share the window), so a round costs about one run
of its slowest point, not one run per point. With `devices=` each grid
splits the flattened (lattice points × seeds) batch across devices,
chunk after chunk — scores are bitwise those of a one-device tune
(`TuneResult.n_devices` records the count), and N devices take about N
times as long as one, since a round's cost is set by its event steps,
not its lanes. Scores are averaged over a
seed batch of schedule interleavings; any point that violates mutual
exclusion or fails to complete under any seed is disqualified outright.

    from repro_torch.core import LockSpec
    from repro_torch.core.tuner import tune

    result = tune(LockSpec.paper_default("rma_rw", 64), seeds=range(4))
    result.spec              # the winning point (a plain LockSpec)
    result.to_json()         # full report; spec round-trips exactly

The CLI is `python -m repro_torch.bench.tune`, which writes the report
to `results/bench/tuned_spec_torch.json`. Counterpart of
`repro.core.tuner`: for the same inputs `TuneResult.to_dict()` is the
reference's, key for key.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.session import Session
from repro_torch.core.spec import LockSpec

OBJECTIVES = ("throughput", "latency")


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one `tune` call: the winning point + its evidence."""

    spec: LockSpec                # winner; run it to reproduce the score
    objective: str
    score: float                  # objective value at the winner
    throughput: float             # mean acquires/s over seeds at winner
    latency_us: float             # mean acquire latency at winner
    seeds: tuple
    throughput_per_seed: tuple    # bitwise-reproducible per-seed values
    n_points: int                 # distinct lattice points evaluated
    rounds: tuple                 # per-round lattices + incumbents
    n_devices: int = 1            # devices the grid runs were split over
    # Safety evidence at the winner: total mutual-exclusion violations
    # and completion across ALL seeds. Winner selection already rejects
    # any point with violations > 0 or completed == False, so a report
    # with anything but (0, True) here indicates a tuner bug — the
    # columns exist so deployment consumers can verify, not trust.
    violations: int = 0
    completed: bool = True

    def to_dict(self) -> dict:
        return {
            "spec": self.spec.to_dict(),
            "objective": self.objective,
            "score": self.score,
            "throughput": self.throughput,
            "latency_us": self.latency_us,
            "seeds": list(self.seeds),
            "throughput_per_seed": list(self.throughput_per_seed),
            "n_points": self.n_points,
            "rounds": [dict(r) for r in self.rounds],
            "n_devices": self.n_devices,
            "violations": self.violations,
            "completed": self.completed,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TuneResult":
        d = json.loads(s)
        return cls(
            spec=LockSpec.from_dict(d["spec"]), objective=d["objective"],
            score=d["score"], throughput=d["throughput"],
            latency_us=d["latency_us"], seeds=tuple(d["seeds"]),
            throughput_per_seed=tuple(d["throughput_per_seed"]),
            n_points=d["n_points"],
            rounds=tuple(_round_from_dict(r) for r in d["rounds"]),
            n_devices=d.get("n_devices", 1),
            # Reports written before the safety columns existed default
            # to the only values a correct tuner can emit.
            violations=d.get("violations", 0),
            completed=d.get("completed", True))


def _round_from_dict(r: dict) -> dict:
    r = dict(r)
    r["t_l"] = [None if v is None else tuple(v) for v in r["t_l"]]
    r["best"] = _key_from_json(r["best"])
    return r


def _key_from_json(k) -> tuple:
    d, tl, r = k
    return (int(d), None if tl is None else tuple(tl), int(r))


def default_lattice(spec: LockSpec) -> dict:
    """Coarse starting lattice: geometric coverage of each axis.

    T_DC spans one-counter-per-process (1) .. one shared counter (P);
    T_L varies the leaf (local-pass) threshold around the spec's own
    point; T_R spans small to effectively-unbounded reader batches.
    """
    P = spec.P
    t_dc = sorted({d for d in (1, 4, 16, 64, 256, P) if d <= P})
    if spec.T_L is None:
        t_l = [None]
    else:
        base = spec.T_L
        t_l = [base[:-1] + (leaf,)
               for leaf in sorted({1, 8, 64, base[-1]})]
    t_r = [16, 256, 4096]
    return {"t_dc": t_dc, "t_l": t_l, "t_r": t_r}


def _validate_lattice(lattice: dict, P: int) -> None:
    """Reject nonsense axis values up front with an error naming the
    offending axis — out-of-range entries would otherwise reach
    `counter_ranks` / the threshold encoding and produce silently
    meaningless lattices."""
    for d in lattice["t_dc"]:
        if not 1 <= d <= P:
            raise ValueError(
                f"t_dc axis: T_DC={d} out of range [1, P={P}]")
    for tl in lattice["t_l"]:
        if tl is None:
            continue
        if not tl or any(int(x) < 1 for x in tl):
            raise ValueError(
                f"t_l axis: T_L={tl} — per-level thresholds must be a "
                f"non-empty tuple of entries >= 1 (or None)")
    for r in lattice["t_r"]:
        if r < 1:
            raise ValueError(f"t_r axis: T_R={r} must be >= 1")


def _geo_mid(a: int, b: int) -> int:
    return int(round((a * b) ** 0.5))


def _refine_ints(values, best: int) -> list:
    """Geometric midpoints between the incumbent and its lattice
    neighbors (coarse-to-fine zoom on one integer axis)."""
    vals = sorted(set(values))
    i = vals.index(best)
    out = {best}
    for j in (i - 1, i + 1):
        if 0 <= j < len(vals):
            mid = _geo_mid(best, vals[j])
            if mid not in vals:
                out.add(mid)
    return sorted(out)


def _refine_lattice(lattice: dict, best: tuple) -> dict:
    d, tl, r = best
    t_l = lattice["t_l"]
    if tl is not None and None not in t_l:
        leafs = sorted({v[-1] for v in t_l})
        t_l = [tl[:-1] + (leaf,) for leaf in _refine_ints(leafs, tl[-1])]
    return {"t_dc": _refine_ints(lattice["t_dc"], d),
            "t_l": t_l,
            "t_r": _refine_ints(lattice["t_r"], r)}


def tune(spec: LockSpec, *, t_dc=None, t_l=None, t_r=None,
         seeds=(0, 1), refine_rounds: int = 1, target_acq: int = 4,
         cs_kind: int = 0, think: bool = False,
         max_events: int = 2_000_000,
         objective: str = "throughput", devices=None,
         device=None) -> TuneResult:
    """Search the (T_DC, T_L, T_R) space for the workload described by
    (spec roles + cs_kind/think), one `Session.grid` run per round.

    Axis candidates default to `default_lattice(spec)`; pass explicit
    lists to pin or narrow an axis (entries are validated up front —
    `t_dc` must lie in [1, P], `t_l` thresholds and `t_r` must be
    >= 1). `refine_rounds` extra rounds zoom geometrically around the
    incumbent. `device` is where the session lives (CUDA unless
    "cpu"); `devices` (an int count of CUDA devices or a device list)
    splits every grid across devices, run chunk after chunk — scores
    are unchanged (per-point results are bitwise equal to the
    one-device run), but N devices take about N times one device's
    time. Returns the best point seen.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}, "
                         f"got {objective!r}")
    lattice = default_lattice(spec)
    if t_dc is not None:
        lattice["t_dc"] = sorted({int(v) for v in t_dc})
    if t_l is not None:
        lattice["t_l"] = [None if v is None else tuple(v) for v in t_l]
    if t_r is not None:
        lattice["t_r"] = sorted({int(v) for v in t_r})
    _validate_lattice(lattice, spec.P)
    seeds = tuple(int(s) for s in seeds)

    sess = Session(spec, target_acq=target_acq, cs_kind=cs_kind,
                   think=think, max_events=max_events, device=device,
                   devices=devices)
    evaluated: dict = {}          # (d, l, r) -> (score, tput, lat, per_seed)
    rounds = []
    for rnd in range(refine_rounds + 1):
        m = sess.grid(lattice["t_dc"], lattice["t_l"], lattice["t_r"],
                      seeds=seeds)
        viol = m.violations.cpu().numpy().sum(axis=-1)
        comp = m.completed.cpu().numpy().all(axis=-1)
        tput_s = m.throughput.cpu().numpy()
        tput = tput_s.mean(axis=-1)
        lat = m.mean_latency.cpu().numpy().mean(axis=-1)
        valid = (viol == 0) & comp
        if objective == "throughput":
            score = np.where(valid, tput, -np.inf)
        else:
            score = np.where(valid, -lat, -np.inf)
        for di, d in enumerate(lattice["t_dc"]):
            for li, tl in enumerate(lattice["t_l"]):
                for ri, r in enumerate(lattice["t_r"]):
                    evaluated[(d, tl, r)] = (
                        float(score[di, li, ri]), float(tput[di, li, ri]),
                        float(lat[di, li, ri]),
                        tuple(float(x) for x in tput_s[di, li, ri]),
                        int(viol[di, li, ri]), bool(comp[di, li, ri]))
        best = max(evaluated, key=lambda k: evaluated[k][0])
        if not np.isfinite(evaluated[best][0]):
            # Fail fast: refining around an arbitrary disqualified
            # point would only burn more grid runs.
            raise RuntimeError(
                "no lattice point completed without violations; widen "
                "the lattice or raise max_events")
        rounds.append({"t_dc": list(lattice["t_dc"]),
                       "t_l": list(lattice["t_l"]),
                       "t_r": list(lattice["t_r"]),
                       "best": best, "best_score": evaluated[best][0],
                       "n_disqualified": int(np.sum(~valid))})
        if rnd < refine_rounds:
            lattice = _refine_lattice(lattice, best)

    best = max(evaluated, key=lambda k: evaluated[k][0])
    b_score, b_tput, b_lat, b_per_seed, b_viol, b_comp = evaluated[best]
    d, tl, r = best
    return TuneResult(
        spec=spec.replace(T_DC=d, T_L=tl, T_R=r), objective=objective,
        score=b_score, throughput=b_tput, latency_us=b_lat, seeds=seeds,
        throughput_per_seed=b_per_seed, n_points=len(evaluated),
        rounds=tuple(rounds),
        n_devices=1 if sess.devices is None else len(sess.devices),
        violations=b_viol, completed=b_comp)

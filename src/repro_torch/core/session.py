"""Lock sessions: one spec, one realized environment, many runs.

A `Session` realizes a `LockSpec` under a fixed workload (target
acquires per process, critical-section kind, think time) on one device
and offers four execution shapes:

  * `run(seed)`        — one schedule, scalar Metrics.
  * `run_batch(seeds)` — one lane per seed, all lanes stepped together;
    Metrics leaves gain a leading [S] axis. Lane s is bitwise equal to
    `run(s)`: lanes never interact.
  * `sweep(axis, values, seeds=...)` — one axis of the paper's parameter
    space (`SWEEP_AXES`); every (point, seed) pair is a lane of ONE
    run, Metrics leaves gain leading [len(values), len(seeds)] axes.
    T_DC points run on window layouts padded to a common counter-slot
    count (`build_layout(pad_counters_to=...)`), so every point of the
    axis shares the window's words but its counters'.
  * `grid(t_dc, t_l, t_r, seeds=...)` — the full 3D (T_DC, T_L, T_R)
    lattice × seeds as the lanes of one run; leading [D, L, R, S] axes.
    The substrate of `repro_torch.core.tuner`.

A lattice run builds one environment whose per-point tables
(`engine.LATTICE_GROUPS`) are stacked over the distinct values each
group takes, never per lane, and every lane reads its own point's rows.
Each point is bitwise equal to a fresh per-point session: the loop runs
to the slowest lane, and finished lanes stay untouched.

Multiple devices: `sweep`, `grid` and `run_batch` take `devices=` (the
constructor's value unless passed; per-call `devices=None` keeps the
session's own device). The flattened (points × seeds) batch is split
into contiguous chunks, one per device, run one after another, and the
Metrics are concatenated back on the session's device. Chunks need not
be equal, so nothing is padded; per-entry results are bitwise those of
the one-device run. Splitting is slower than one device: an event step
costs about the same for 1 or 64 lanes (the engine is bound by its
host's launches), so N chunks take about N times one device's run.

Counterpart of `repro.core.session`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.engine import metrics_at
from repro_torch.core.spec import EXTRA_WORDS, LockSpec
from repro_torch.core.topology import counter_ranks
from repro_torch.core.window import Layout, build_layout

__all__ = ["DYNAMIC_AXES", "SWEEP_AXES", "Session", "metrics_at",
           "resolve_devices"]

# Sentinel for "devices not passed": per-call `devices=None` forces the
# session's own device even on a Session constructed with devices.
_UNSET = object()

# Axes of `sweep`; every one is a lattice group of the engine's env.
DYNAMIC_AXES = ("T_DC", "T_L", "T_R", "writer_fraction")
SWEEP_AXES = DYNAMIC_AXES


def resolve_devices(devices):
    """Normalize a `devices=` argument to a tuple of torch devices.

    Accepts None (the session's own device — returns None), an int N
    (the first N CUDA devices), or an explicit device sequence (e.g.
    `["cuda:0", "cuda:1"]`, or `["cpu"] * N` for N chunks on the CPU).
    """
    if devices is None:
        return None
    if isinstance(devices, int):
        n = torch.cuda.device_count()
        if not 1 <= devices <= n:
            raise ValueError(
                f"devices={devices} but this host has {n} CUDA device(s) "
                f"(torch.cuda.device_count()); pass a device sequence, "
                f"e.g. [\"cpu\"] * N, to split a batch on the CPU")
        return tuple(torch.device("cuda", i) for i in range(devices))
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("devices must be None, an int >= 1, or a "
                         "non-empty device sequence")
    return devices


@dataclasses.dataclass(frozen=True)
class _Point:
    """One lattice point: its spec and its (possibly padded) layout."""

    spec: LockSpec
    layout: Layout


class Session:
    """A realized (spec, workload) pair ready to run under many seeds.

    `device=None` means CUDA; without a CUDA device the constructor
    raises (pass `device="cpu"` to run on the CPU). `devices=` is the
    default of the per-call `devices=` of `run_batch`/`sweep`/`grid`."""

    def __init__(self, spec: LockSpec, *, target_acq: int = 8,
                 cs_kind: int = 0, think: bool = False,
                 max_events: int = 2_000_000,
                 extra_words: int = EXTRA_WORDS, device=None, devices=None):
        self.spec = spec
        self.device = engine.resolve_device(device)
        self.devices = resolve_devices(devices)
        self.target_acq = int(target_acq)
        self.cs_kind = int(cs_kind)
        self.think = bool(think)
        self.max_events = int(max_events)
        self.extra_words = int(extra_words)
        self.machine = spec.machine()
        self.layout = spec.layout(self.machine, extra_words=extra_words)
        self.is_writer = spec.roles()
        self.program = spec.program(self.layout)
        self.env = engine.make_env(
            self.machine, self.layout, T_L=spec.T_L, T_R=spec.T_R,
            is_writer=self.is_writer, target_acq=self.target_acq,
            cs_kind=self.cs_kind, think=self.think, cost=spec.cost,
            device=self.device)
        self.handlers = self.program.build(self.env)

    def init_state(self, lanes: int = 1,
                   fault: engine.FaultPlan | None = None) -> engine.SimState:
        return engine.init_state(
            self.env, self.layout, self.program.init_pc(self.env),
            self.program.n_regs, self.program.init_regs(self.env),
            fault=fault, lanes=lanes)

    def _devices(self, devices):
        """Per-call `devices=` override (the constructor's value when
        not passed; explicit None forces the session's own device)."""
        return (self.devices if devices is _UNSET
                else resolve_devices(devices))

    # ------------------------------------------------------ execution
    def run_state(self, seed: int = 0) -> engine.SimState:
        """One schedule to completion; returns the final simulator state
        (lane axis of 1 kept)."""
        return engine.step_loop(self.handlers, self.max_events,
                                self.init_state(), [seed])

    def run(self, seed: int = 0) -> engine.Metrics:
        return metrics_at(engine.summarize(self.run_state(seed)), 0)

    def run_batch(self, seeds, *, devices=_UNSET) -> engine.Metrics:
        """All seeds as lanes of one run; Metrics leaves gain a leading
        [len(seeds)] axis. With `devices`, the seeds are split into one
        chunk per device."""
        seeds = np.asarray(seeds).reshape(-1)
        devices = self._devices(devices)
        if devices is None:
            st = self.init_state(lanes=len(seeds))
            return engine.summarize(engine.step_loop(
                self.handlers, self.max_events, st, seeds))
        m = self._dispatch([_Point(self.spec, self.layout)], seeds, devices)
        return metrics_at(m, 0)

    # --------------------------------------------------------- sweeps
    def specs_along(self, axis: str, values) -> list:
        """The derived LockSpec for every point of a sweep (validated)."""
        if axis not in SWEEP_AXES:
            raise ValueError(f"axis must be one of {SWEEP_AXES}, "
                             f"got {axis!r}")
        return [self.spec.replace(**{axis: v}) for v in values]

    def sweep(self, axis: str, values, *, seeds=(0,),
              devices=_UNSET) -> engine.Metrics:
        """Scan one parameter axis under a batch of seeds, every (point,
        seed) pair a lane of one run (T_DC points on layouts padded to
        a common counter-slot count). With `devices`, the flattened
        (points × seeds) batch is split across them.

        Returns stacked Metrics with leading axes [len(values),
        len(seeds)]; index with `metrics_at(m, k, s)`.
        """
        specs = self.specs_along(axis, values)
        return self._dispatch(self._sweep_points(axis, specs), seeds,
                              self._devices(devices))

    def grid(self, t_dc, t_l, t_r, *, seeds=(0,),
             devices=_UNSET) -> engine.Metrics:
        """Scan the paper's full 3D (T_DC, T_L, T_R) lattice under a
        batch of seeds as the lanes of one run.

        `t_l` entries are per-level threshold tuples (or None for
        unbounded). Roles (writer_fraction) are those of the session's
        spec. Returns stacked Metrics with leading axes
        [len(t_dc), len(t_l), len(t_r), len(seeds)]; index with
        `metrics_at(m, d, l, r, s)`. Each lattice point is bitwise equal
        to a fresh per-point `Session.run_batch` — padding only adds
        dead counter slots, never dynamics. With `devices` (a device
        list or an int count; defaults to the constructor's), the
        flattened (lattice points × seeds) batch is split across
        devices, still bitwise equal per point, and run chunk after
        chunk: N devices take about N times one device's run.
        """
        t_dc = [int(v) for v in t_dc]
        t_l = [v if v is None else tuple(int(x) for x in v) for v in t_l]
        t_r = [int(v) for v in t_r]
        if not (t_dc and t_l and t_r):
            raise ValueError("grid axes must be non-empty")
        C_pad = max(len(counter_ranks(self.machine, d)) for d in t_dc)
        points = []
        for d in t_dc:
            layout_d = self._padded_layout(d, C_pad)
            for tl in t_l:
                for r in t_r:
                    points.append(_Point(
                        self.spec.replace(T_DC=d, T_L=tl, T_R=r), layout_d))
        m = self._dispatch(points, seeds, self._devices(devices))
        shape = (len(t_dc), len(t_l), len(t_r))
        return engine.Metrics(
            *(leaf.reshape(shape + leaf.shape[1:]) for leaf in m))

    def _padded_layout(self, T_DC: int, C_pad: int) -> Layout:
        """One T_DC point's layout with C_pad counter slots."""
        return build_layout(self.machine, T_DC, extra_words=self.extra_words,
                            pad_counters_to=C_pad)

    def _sweep_points(self, axis: str, specs) -> list:
        """The sweep's points: T_DC points on layouts padded to the
        axis's largest counter count, the others on the session's."""
        if axis != "T_DC":
            return [_Point(s, self.layout) for s in specs]
        C_pad = max(len(counter_ranks(self.machine, s.T_DC)) for s in specs)
        layouts = {}
        for s in specs:
            if s.T_DC not in layouts:
                layouts[s.T_DC] = self._padded_layout(s.T_DC, C_pad)
        return [_Point(s, layouts[s.T_DC]) for s in specs]

    # ------------------------------------------------------- dispatch
    def _dispatch(self, points, seeds, devices) -> engine.Metrics:
        """Run the points × seeds batch; Metrics leaves come back with
        leading [K, S] axes on the session's device. The flattened
        batch (point-major) is cut into contiguous chunks, one per
        device, run in turn."""
        seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
        entries = [(k, s) for k in range(len(points)) for s in seeds]
        devs = (self.device,) if devices is None else devices
        base, extra = divmod(len(entries), len(devs))
        chunks, at = [], 0
        for i, dev in enumerate(devs):
            n = base + (i < extra)
            if n:
                chunks.append((entries[at:at + n], dev))
            at += n
        parts = [self._run_entries(points, *c) for c in chunks]
        shape = (len(points), len(seeds))
        return engine.Metrics(*(
            torch.cat([x.to(self.device) for x in leaves]).reshape(
                shape + leaves[0].shape[1:]) for leaves in zip(*parts)))

    def _run_entries(self, points, entries, device) -> engine.Metrics:
        """Run (point, seed) entries as the lanes of one run on
        `device`: one env whose lattice groups are stacked over the
        distinct values the entries' points take."""
        device = engine.resolve_device(device)
        used = sorted({k for k, _ in entries})
        keys = {"layout": lambda pt: id(pt.layout),
                "T_L": lambda pt: pt.spec.T_L,
                "T_R": lambda pt: pt.spec.T_R,
                "roles": lambda pt: pt.spec.writer_fraction}
        values = {"layout": lambda pt: pt.layout,
                  "T_L": lambda pt: pt.spec.T_L,
                  "T_R": lambda pt: pt.spec.T_R,
                  "roles": lambda pt: pt.spec.roles()}
        args, row_of = {}, {}
        for group in engine.LATTICE_GROUPS:
            seen = {}
            for k in used:
                key = keys[group](points[k])
                if key not in seen:
                    seen[key] = len(seen)
                    args.setdefault(group, []).append(
                        values[group](points[k]))
                row_of[group, k] = seen[key]
        lanes = {g: np.asarray([row_of[g, k] for k, _ in entries])
                 for g in engine.LATTICE_GROUPS}
        env = engine.make_env(
            self.machine, args["layout"], T_L=args["T_L"], T_R=args["T_R"],
            is_writer=args["roles"], target_acq=self.target_acq,
            cs_kind=self.cs_kind, think=self.think, cost=self.spec.cost,
            device=device, lanes=lanes)
        program = self.program.build(env)
        states = []
        for k in used:
            # init_pc / init_regs read the point's roles only.
            env_k = dataclasses.replace(self.env, is_writer=torch.as_tensor(
                args["roles"][row_of["roles", k]]))
            states.append(engine.init_state(
                env, points[k].layout, self.program.init_pc(env_k),
                self.program.n_regs, self.program.init_regs(env_k),
                lanes=sum(kk == k for kk, _ in entries)))
        final = engine.step_loop(program, self.max_events,
                                 engine.cat_states(states),
                                 [s for _, s in entries])
        return engine.summarize(final)

"""Lock sessions: one spec, one realized environment, many runs.

A `Session` realizes a `LockSpec` under a fixed workload (target
acquires per process, critical-section kind, think time) on one device
and offers two execution shapes:

  * `run(seed)`        — one schedule, scalar Metrics.
  * `run_batch(seeds)` — one lane per seed, all lanes stepped together;
    Metrics leaves gain a leading [S] axis. Lane s is bitwise equal to
    `run(s)`: lanes never interact.

Counterpart of `repro.core.session` for `run`/`run_batch`; the sweeps,
grids and multi-device dispatch come in a later slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import engine
from repro_torch.core.engine import metrics_at
from repro_torch.core.spec import EXTRA_WORDS, LockSpec

__all__ = ["Session", "metrics_at"]


class Session:
    """A realized (spec, workload) pair ready to run under many seeds.

    `device=None` means CUDA; without a CUDA device the constructor
    raises (pass `device="cpu"` to run on the CPU)."""

    def __init__(self, spec: LockSpec, *, target_acq: int = 8,
                 cs_kind: int = 0, think: bool = False,
                 max_events: int = 2_000_000,
                 extra_words: int = EXTRA_WORDS, device=None):
        self.spec = spec
        self.device = engine.resolve_device(device)
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

    # ------------------------------------------------------ execution
    def run_state(self, seed: int = 0) -> engine.SimState:
        """One schedule to completion; returns the final simulator state
        (lane axis of 1 kept)."""
        return engine.step_loop(self.handlers, self.max_events,
                                self.init_state(), [seed])

    def run(self, seed: int = 0) -> engine.Metrics:
        return metrics_at(engine.summarize(self.run_state(seed)), 0)

    def run_batch(self, seeds) -> engine.Metrics:
        """All seeds as lanes of one run; Metrics leaves gain a leading
        [len(seeds)] axis."""
        seeds = np.asarray(seeds).reshape(-1)
        st = self.init_state(lanes=len(seeds))
        return engine.summarize(engine.step_loop(
            self.handlers, self.max_events, st, seeds))

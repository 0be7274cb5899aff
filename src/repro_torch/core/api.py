"""Deprecated per-kind lock classes — compatibility shims.

Counterpart of `repro.core.api`. New code should use the declarative
spec/session API instead:

    from repro_torch.core import LockSpec, Session
    spec = LockSpec(kind="rma_rw", P=64, fanout=(4,), T_DC=16,
                    T_L=(1 << 20, 8), T_R=1024, writer_fraction=0.02)
    sess = Session(spec, target_acq=16)
    m = sess.run(seed=0)                      # one schedule
    ms = sess.run_batch(range(64))            # 64 schedules, one dispatch
    assert int(ms.violations.sum()) == 0

Lock kinds map to the paper: `rma_rw` (§3), `rma_mcs` (§3.5), `d_mcs`
(§2.4), `fompi_spin` / `fompi_rw` (§5 baselines) — see
`repro_torch.core.spec` for the registry.

The classes below mirror the original seed API (`RMARWLock(P=...,
...).run(...)`). They are thin wrappers that build a `LockSpec` and
cache one `Session` per workload; they will be removed once nothing
imports them. Like every entry point of the port they run on CUDA
unless `device=` says otherwise.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

from repro_torch.core import engine
from repro_torch.core.cost import CostModel, DEFAULT_COST
from repro_torch.core.session import Session
from repro_torch.core.spec import LockSpec, registered_kinds, writer_mask  # noqa: F401 (re-export)

warnings.warn(
    "repro_torch.core.api is deprecated: build a repro_torch.core.LockSpec "
    "and run it through repro_torch.core.Session instead (the per-kind "
    "classes here are thin shims over exactly that).",
    DeprecationWarning, stacklevel=2)


@dataclasses.dataclass
class BaseLock:
    P: int
    fanout: Sequence[int] = (1,)
    T_DC: int = 1
    T_L: Sequence[int] | None = None
    T_R: int = 1 << 26
    writer_fraction: float = 1.0
    cost: CostModel = DEFAULT_COST
    role_seed: int = 17
    device: object = None         # torch device; None means CUDA

    kind = None                   # overridden per subclass

    def __post_init__(self):
        warnings.warn(
            f"{type(self).__name__} is deprecated; use "
            f"LockSpec(kind={self.kind!r}, ...) with "
            "repro_torch.core.Session",
            DeprecationWarning, stacklevel=3)
        self.spec = LockSpec(
            kind=self.kind, P=self.P, fanout=tuple(self.fanout),
            T_DC=self.T_DC,
            T_L=None if self.T_L is None else tuple(self.T_L),
            T_R=self.T_R, writer_fraction=self.writer_fraction,
            role_seed=self.role_seed, cost=self.cost)
        self.device = engine.resolve_device(self.device)
        self._sessions = {}
        self._built = None

    # Legacy attribute surface, built lazily so locks that only ever
    # call run() don't duplicate the Session's machine/layout work.
    def _build_legacy(self):
        if self._built is None:
            machine = self.spec.machine()
            layout = self.spec.layout(machine)
            self._built = (machine, layout, self.spec.roles(),
                           self.spec.program(layout))
        return self._built

    @property
    def machine(self):
        return self._build_legacy()[0]

    @property
    def layout(self):
        return self._build_legacy()[1]

    @property
    def is_writer(self):
        return self._build_legacy()[2]

    @property
    def program(self):
        return self._build_legacy()[3]

    def _session(self, *, target_acq=8, cs_kind=0, think=False,
                 max_events=2_000_000) -> Session:
        key = (target_acq, cs_kind, think, max_events)
        if key not in self._sessions:
            self._sessions[key] = Session(
                self.spec, target_acq=target_acq, cs_kind=cs_kind,
                think=think, max_events=max_events, device=self.device)
        return self._sessions[key]

    def make_env(self, *, target_acq=8, cs_kind=0, think=False) -> engine.Env:
        return self._session(target_acq=target_acq, cs_kind=cs_kind,
                             think=think).env

    def run(self, *, target_acq=8, cs_kind=0, think=False, seed=0,
            max_events=2_000_000, env: engine.Env | None = None
            ) -> engine.Metrics:
        if env is not None:       # legacy escape hatch: custom env
            return engine.run_sim(self.program, env, self.layout,
                                  seed=seed, max_events=max_events)
        return self._session(target_acq=target_acq, cs_kind=cs_kind,
                             think=think, max_events=max_events).run(seed)


@dataclasses.dataclass
class RMARWLock(BaseLock):
    """Deprecated: LockSpec(kind="rma_rw", ...) — paper §3."""

    writer_fraction: float = 0.002
    kind = "rma_rw"


@dataclasses.dataclass
class RMAMCSLock(BaseLock):
    """Deprecated: LockSpec(kind="rma_mcs", ...) — paper §3.5."""

    kind = "rma_mcs"


@dataclasses.dataclass
class DMCSLock(BaseLock):
    """Deprecated: LockSpec(kind="d_mcs", ...) — paper §2.4."""

    kind = "d_mcs"


@dataclasses.dataclass
class FompiSpinLock(BaseLock):
    """Deprecated: LockSpec(kind="fompi_spin", ...) — paper §5."""

    kind = "fompi_spin"


@dataclasses.dataclass
class FompiRWLock(BaseLock):
    """Deprecated: LockSpec(kind="fompi_rw", ...) — paper §5."""

    writer_fraction: float = 0.002
    kind = "fompi_rw"


LOCKS = {
    "rma_rw": RMARWLock,
    "rma_mcs": RMAMCSLock,
    "d_mcs": DMCSLock,
    "fompi_spin": FompiSpinLock,
    "fompi_rw": FompiRWLock,
}
assert set(LOCKS) == set(registered_kinds())

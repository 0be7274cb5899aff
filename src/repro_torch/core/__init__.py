"""Distributed RMA lock core in PyTorch: declarative specs + sessions.

Counterpart of `repro.core`: `LockSpec` (repro_torch.core.spec) is the
frozen, validated, JSON-round-trippable description of one lock
configuration; `Session` (repro_torch.core.session) runs it under one
seed, a batch of seeds (one lane per seed), a sweep of one parameter
axis or the full (T_DC, T_L, T_R) grid (one lane per point and seed);
`tune` (repro_torch.core.tuner) searches that grid coarse to fine and
emits the winning `LockSpec` as JSON.
"""
from repro_torch.core.engine import FaultPlan, Metrics
from repro_torch.core.session import (DYNAMIC_AXES, SWEEP_AXES, Session,
                                      metrics_at, resolve_devices)
from repro_torch.core.spec import (EXTRA_WORDS, PROCS_PER_NODE, LockKind,
                                   LockSpec, get_kind, register_kind,
                                   registered_kinds, writer_mask)
from repro_torch.core.tuner import TuneResult, tune

__all__ = [
    "DYNAMIC_AXES", "EXTRA_WORDS", "FaultPlan", "LockKind", "LockSpec",
    "Metrics", "PROCS_PER_NODE", "SWEEP_AXES", "Session", "TuneResult",
    "get_kind", "metrics_at", "register_kind", "registered_kinds",
    "resolve_devices", "tune", "writer_mask",
]

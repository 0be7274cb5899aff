"""Distributed RMA lock core in PyTorch: declarative specs + sessions.

Counterpart of `repro.core`: `LockSpec` (repro_torch.core.spec) is the
frozen, validated, JSON-round-trippable description of one lock
configuration, and `Session` (repro_torch.core.session) runs it under
one seed or a batch of seeds (one lane per seed) on a device.
"""
from repro_torch.core.engine import FaultPlan, Metrics
from repro_torch.core.session import Session, metrics_at
from repro_torch.core.spec import (EXTRA_WORDS, PROCS_PER_NODE, LockKind,
                                   LockSpec, get_kind, register_kind,
                                   registered_kinds, writer_mask)

__all__ = [
    "EXTRA_WORDS", "FaultPlan", "LockKind", "LockSpec", "Metrics",
    "PROCS_PER_NODE", "Session", "get_kind", "metrics_at",
    "register_kind", "registered_kinds", "writer_mask",
]

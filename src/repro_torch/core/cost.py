"""Calibrated network cost model (Aries/Cray-XC30 class, §4 of DESIGN.md).

The simulator charges each RMA operation a latency that depends on the
hierarchy distance between the origin process and the rank hosting the
targeted word, plus a serialization ("occupancy") charge at the word to
model contention at hot locations — the effect that makes centralized
locks collapse at scale (paper §1, §5).

Constants are microseconds. They are calibrated to reproduce the
*relative* results of the paper (Piz Daint, Aries): intra-node RMA is
~5-6x cheaper than inter-node, remote atomics cost ~35% over plain
puts/gets, and a hot word serializes concurrent atomics.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    # latency by hierarchy distance: [self, same-node, cross-node, cross-rack, ...]
    lat: tuple = (0.05, 0.30, 1.70, 2.10, 2.40)
    atomic_factor: float = 1.35   # FAO/CAS/Accumulate premium
    # Serialization at the target's atomic unit per AMO: calibrated to
    # Schweizer/Besta/Hoefler PACT'15 (the paper's [43]): contended
    # remote atomics on Aries sustain ~2.5 Mops/s => ~0.4 us apart.
    occupancy: float = 0.40
    wake: float = 0.10            # local wake-up / re-check delay
    backoff0: float = 1.0         # initial blocked-retry timeout
    backoff_max: float = 32.0     # max blocked-retry timeout
    jitter: float = 0.08          # uniform schedule jitter (also explores interleavings)

    def tables(self, dist_matrix: np.ndarray):
        """Return (plain[P,P], atomic[P,P]) float32 latency tables."""
        lat = np.asarray(self.lat, np.float32)
        idx = np.minimum(dist_matrix, len(self.lat) - 1)
        plain = lat[idx]
        return plain, (plain * self.atomic_factor).astype(np.float32)


DEFAULT_COST = CostModel()

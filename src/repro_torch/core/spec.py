"""Declarative lock specifications — the single entry point to the
paper's 3D parameter space.

The paper frames every lock in the family as a *point* in the space
spanned by (T_DC, T_L, T_R) (§3.2): counter spacing, per-level locality
thresholds, and the reader batch. A `LockSpec` is a frozen, validated,
dict/JSON-round-trippable value capturing kind + topology fanout + that
full point + roles + cost model. Benchmarks, examples, tests, and the
serving layer all construct locks from specs, so they cannot drift from
each other, and a spec can be logged, hashed, diffed, or shipped to a
tuner unchanged.

Lock kinds map to the paper:

    kind         paper      structure
    ----------   --------   ----------------------------------------
    rma_rw       §3         topology-aware distributed RW lock
    rma_mcs      §3.5       topology-aware distributed MCS (writers)
    d_mcs        §2.4       topology-oblivious MCS, one root queue
    fompi_spin   §5         foMPI CAS spin lock (baseline)
    fompi_rw     §5         foMPI centralized RW lock (baseline)

Execution lives in `repro_torch.core.session.Session`; this module is pure
data + the kind registry.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable

import numpy as np

from repro_torch.core.cost import CostModel, DEFAULT_COST
from repro_torch.core.programs import fompi, hier
from repro_torch.core.topology import Machine, build_machine
from repro_torch.core.window import Layout, build_layout

# Machine model mirroring the paper's Piz Daint runs: 16 processes per
# node (8-core HT Xeon), all nodes under one fabric level.
PROCS_PER_NODE = 16

# Scratch words appended to every window (baselines, DHT, CS payloads).
EXTRA_WORDS = 4


def writer_mask(P: int, writer_fraction: float, seed: int = 17) -> np.ndarray:
    """Random reader/writer roles (paper §4.4: 'defined randomly')."""
    n_writers = max(1, int(round(P * writer_fraction))) if writer_fraction > 0 else 0
    rng = np.random.RandomState(seed)
    mask = np.zeros(P, bool)
    if n_writers:
        mask[rng.choice(P, size=n_writers, replace=False)] = True
    return mask


@dataclasses.dataclass(frozen=True)
class LockKind:
    """Registry entry: how to realize one lock kind from a spec."""

    name: str
    paper_section: str
    has_readers: bool             # reader/writer roles (else writers only)
    flat: bool                    # centralized / single root queue: fanout=()
    default_writer_fraction: float
    make_program: Callable        # (spec: LockSpec, layout: Layout) -> program


_REGISTRY: dict[str, LockKind] = {}


def register_kind(info: LockKind) -> LockKind:
    if info.name in _REGISTRY:
        raise ValueError(f"lock kind {info.name!r} already registered")
    _REGISTRY[info.name] = info
    return info


def get_kind(name: str) -> LockKind:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown lock kind {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def registered_kinds() -> tuple:
    return tuple(sorted(_REGISTRY))


register_kind(LockKind(
    name="rma_rw", paper_section="§3", has_readers=True, flat=False,
    default_writer_fraction=0.002,
    make_program=lambda spec, layout: hier.rma_rw()))
register_kind(LockKind(
    name="rma_mcs", paper_section="§3.5", has_readers=False, flat=False,
    default_writer_fraction=1.0,
    make_program=lambda spec, layout: hier.rma_mcs()))
register_kind(LockKind(
    name="d_mcs", paper_section="§2.4", has_readers=False, flat=True,
    default_writer_fraction=1.0,
    make_program=lambda spec, layout: hier.d_mcs()))
# The foMPI baselines address scratch SLOTS resolved through the env
# (env.scratch_w), never absolute layout indices: absolute word
# positions shift with counter padding under shape-stable T_DC sweeps.
register_kind(LockKind(
    name="fompi_spin", paper_section="§5", has_readers=False, flat=True,
    default_writer_fraction=1.0,
    make_program=lambda spec, layout: fompi.FompiSpin(lock_slot=0)))
register_kind(LockKind(
    name="fompi_rw", paper_section="§5", has_readers=True, flat=True,
    default_writer_fraction=0.002,
    make_program=lambda spec, layout: fompi.FompiRW(
        rcnt_slot=0, wflag_slot=1)))


@dataclasses.dataclass(frozen=True)
class LockSpec:
    """One point in the lock design space: kind + topology + (T_DC, T_L,
    T_R) + roles + cost model.

    All fields are plain Python values (ints, floats, tuples), so specs
    are hashable, comparable, and round-trip through dict/JSON exactly.
    Construction validates and *normalizes*: flat kinds force
    `fanout=()`, mutex-only kinds force `writer_fraction=1.0`, and
    `writer_fraction=None` resolves to the kind's paper default.
    """

    kind: str
    P: int
    fanout: tuple = (1,)
    T_DC: int = 1
    T_L: tuple | None = None
    T_R: int = 1 << 26
    writer_fraction: float | None = None
    role_seed: int = 17
    cost: CostModel = DEFAULT_COST

    def __post_init__(self):
        info = get_kind(self.kind)
        if self.P < 1:
            raise ValueError(f"P must be >= 1, got {self.P}")
        fanout = () if info.flat else tuple(int(f) for f in self.fanout)
        for f in fanout:
            if f < 1:
                raise ValueError(f"fanout entries must be >= 1: {fanout}")
        leafs = int(np.prod(fanout, dtype=np.int64)) if fanout else 1
        if self.P % leafs != 0:
            raise ValueError(
                f"P={self.P} not divisible by leaf element count {leafs} "
                f"(fanout={fanout})")
        if not 1 <= self.T_DC <= self.P:
            # T_DC > P would silently degrade to a single counter in
            # counter_ranks — reject it at the single validation point
            # every entry path (grid, sweep, tuner, serving) shares.
            raise ValueError(
                f"T_DC must be in [1, P={self.P}], got {self.T_DC}")
        if self.T_R < 1:
            raise ValueError(f"T_R must be >= 1, got {self.T_R}")
        T_L = self.T_L
        if T_L is not None:
            T_L = tuple(int(t) for t in T_L)
            if info.flat and not info.has_readers and len(T_L) != 1:
                # d_mcs has a single (root) level.
                raise ValueError(
                    f"{self.kind} is flat: T_L must have 1 entry, got {T_L}")
            if info.flat and info.has_readers:
                T_L = None        # centralized baselines have no thresholds
            elif len(T_L) != len(fanout) + 1:
                raise ValueError(
                    f"T_L must have one entry per level "
                    f"(len(fanout)+1 = {len(fanout) + 1}), got {T_L}")
            if T_L is not None and any(t < 1 for t in T_L):
                raise ValueError(f"T_L entries must be >= 1: {T_L}")
        wf = self.writer_fraction
        if not info.has_readers:
            wf = 1.0              # writers only; roles are ignored
        elif wf is None:
            wf = info.default_writer_fraction
        if not 0.0 <= wf <= 1.0:
            raise ValueError(f"writer_fraction must be in [0, 1], got {wf}")
        cost = self.cost
        if isinstance(cost, dict):
            cost = CostModel(**{**cost, "lat": tuple(cost["lat"])}
                             if "lat" in cost else cost)
        object.__setattr__(self, "fanout", fanout)
        object.__setattr__(self, "T_L", T_L)
        object.__setattr__(self, "writer_fraction", float(wf))
        object.__setattr__(self, "cost", cost)

    # ------------------------------------------------------------ info
    @property
    def info(self) -> LockKind:
        return get_kind(self.kind)

    @property
    def n_levels(self) -> int:
        return len(self.fanout) + 1

    # ------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "P": self.P,
            "fanout": list(self.fanout),
            "T_DC": self.T_DC,
            "T_L": None if self.T_L is None else list(self.T_L),
            "T_R": self.T_R,
            "writer_fraction": self.writer_fraction,
            "role_seed": self.role_seed,
            "cost": dataclasses.asdict(self.cost) | {
                "lat": list(self.cost.lat)},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LockSpec":
        d = dict(d)
        if "fanout" in d:
            d["fanout"] = tuple(d["fanout"])
        if d.get("T_L") is not None:
            d["T_L"] = tuple(d["T_L"])
        cost = d.get("cost", None)
        if isinstance(cost, dict):
            d["cost"] = CostModel(**{**cost, "lat": tuple(cost["lat"])})
        elif cost is None:
            d.pop("cost", None)
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "LockSpec":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "LockSpec":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------- presets
    @classmethod
    def paper_default(cls, kind: str, P: int, *, writer_fraction=None,
                      T_DC: int = PROCS_PER_NODE, T_R: int = 1024,
                      cost: CostModel = DEFAULT_COST) -> "LockSpec":
        """The benchmark configuration of the paper's Piz Daint runs:
        16 processes/node, one fabric level, root queue unbounded with
        64 local passes per node, one counter per node, T_R=1024."""
        info = get_kind(kind)
        kw = dict(kind=kind, P=P, cost=cost,
                  writer_fraction=writer_fraction)
        if not info.flat:
            kw.update(fanout=(max(P // PROCS_PER_NODE, 1),),
                      T_L=(1 << 20, 64))
        if kind == "rma_rw":
            kw.update(T_DC=min(T_DC, P), T_R=T_R)
        return cls(**kw)

    # ------------------------------------------------- realization
    def machine(self) -> Machine:
        return build_machine(self.P, self.fanout)

    def layout(self, machine: Machine | None = None,
               extra_words: int = EXTRA_WORDS) -> Layout:
        return build_layout(machine or self.machine(), self.T_DC,
                            extra_words=extra_words)

    def roles(self) -> np.ndarray:
        """is_writer[P]; all-writers for mutex-only kinds."""
        if self.info.has_readers:
            return writer_mask(self.P, self.writer_fraction, self.role_seed)
        return np.ones(self.P, bool)

    def program(self, layout: Layout):
        return self.info.make_program(self, layout)

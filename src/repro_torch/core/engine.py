"""Discrete-event simulator for distributed RMA lock protocols, batched
over lanes in PyTorch.

Execution model (as in the JAX reference, `repro.core.engine`): every
protocol is a list of *instructions* — atomic protocol actions of one or
a few RMA operations. Each process owns a program counter and a register
file. Per event the simulator picks the process with the smallest
ready-time and executes its current instruction. Atomicity of FAO/CAS
follows from the one-event-at-a-time semantics, contention is an
occupancy charge that serializes atomics on a hot word, and spinning is
block-on-word with wake-on-write plus an exponential-backoff timeout.

Batching: every `SimState` field carries a leading lane axis L, one lane
per seed (`run` is `run_batch` with L=1). One event step is a fixed
sequence of tensor ops over all lanes with no host sync:

  * every instruction handler is evaluated on every lane and returns an
    `Effect` (duration, hot word, stores, wake words, next pc, register
    updates, watch words, accounting flags) — the "evaluate every
    branch, select by index" form that `lax.switch` takes under
    `jax.vmap`;
  * the effects are selected per lane by the executing process's pc;
  * one shared tail (`_apply`) does what the reference's
    `finish_instr`, `cs_enter`, `cs_exit` and `_fault_event` do, on the
    lanes that are still running.

A lane whose loop condition is false (or whose `events` reached
`max_events`) is left untouched, so the host tests "any lane pending"
only once per chunk of steps. Float state is float32 in the reference's
operand order, so `makespan` and `t_ready` are bitwise equal. Integer
state is int64 on the device, so every window value and register can
serve as a torch index without a conversion; protocol values stay far
inside int32 (the largest is WRITE_FLAG = 2**28 plus a counter), so the
results equal the int32 reference's, and `state_to_numpy` exports the
reference's int32.

Index semantics: JAX gathers wrap a negative index once and then clamp,
JAX scatters wrap once and then drop out-of-bounds updates. Handlers
are evaluated on lanes where they are not selected, with whatever
indices those lanes give them, so every data-dependent lookup here does
exactly that. Gathers go through tables extended to three times their
length (`_ext_np`): the table, then its last entry n times, then the
table again. Clamping an index i into [-n, 2n) and indexing with it
(torch wraps a negative index once) then reads what JAX reads at i.

The engine is launch-bound by design: one event step is on the order
of a thousand small tensor ops.

An event step is two parts: `_select` picks each lane's process and
time, `_exec` runs that process's instruction. The model checker
(`repro_torch.analysis.model`) calls `_exec` alone, with its own
process per lane.

Opt-in runtime sanitizer (`REPRO_CHECKS=1` in the environment, or
`with runtime_checks(True):`), the counterpart of the reference's
checkify path: every step of `step_loop` also checks, on the lanes that
run an instruction, the raw window and register indices the selected
handler computed (`RecordingCtx`) and its declared words (hot word,
writes, watch words: in [-1, W) and never a padded dead counter slot)
and duration (>= 0). The first error of each lane is kept in a per-lane
tensor, read at the loop's once-per-chunk host sync and raised as a
RuntimeError. Off by default, and then no op of a step changes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.cost import CostModel, DEFAULT_COST
from repro_torch.core.topology import Machine, proc_distance_matrix
from repro_torch.core.window import Layout, padded_level_table

INF = float(np.float32(3.4e38))     # the reference's INF, not float("inf")

# Instruction kinds: the accounting the engine adds around a handler.
PLAIN = 0   # finish_instr only, jitter drawn from the step key
CS = 1      # cs_enter + reset_backoff; jitter from k1, duration from k2
DONE = 2    # acquire accounting (acq_count/done, t_attempt := finish);
            # think time and jitter both drawn from the step key

# Host syncs ("any lane still pending?") happen once per chunk of steps.
CHECK_EVERY = 64

_RUNTIME_CHECKS_OVERRIDE: bool | None = None


def checks_enabled() -> bool:
    """Whether runs go through the runtime sanitizer."""
    if _RUNTIME_CHECKS_OVERRIDE is not None:
        return _RUNTIME_CHECKS_OVERRIDE
    return os.environ.get("REPRO_CHECKS", "0").lower() not in (
        "", "0", "false", "no")


@contextlib.contextmanager
def runtime_checks(enable: bool = True):
    """Force the runtime sanitizer on (or off) within a scope,
    overriding the REPRO_CHECKS environment variable."""
    global _RUNTIME_CHECKS_OVERRIDE
    prev = _RUNTIME_CHECKS_OVERRIDE
    _RUNTIME_CHECKS_OVERRIDE = bool(enable)
    try:
        yield
    finally:
        _RUNTIME_CHECKS_OVERRIDE = prev


def resolve_device(device) -> torch.device:
    """`device=None` means CUDA. Without a CUDA device that is an error
    that names the CPU escape hatch — the port never runs on the CPU
    unless asked to."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def _scalar(kind: type, v, device: torch.device) -> torch.Tensor:
    dtype = {bool: torch.bool, int: torch.int64, float: torch.float32}[kind]
    return torch.tensor(np.float32(v) if kind is float else v, dtype=dtype,
                        device=device)


def scalar(v, device) -> torch.Tensor:
    """A cached 0-dim tensor for a Python bool / int (int64) / float
    (float32), so constants enter tensor ops without a conversion."""
    kind = bool if isinstance(v, (bool, np.bool_)) else (
        int if isinstance(v, (int, np.integer)) else float)
    return _scalar(kind, kind(v), torch.device(device))


def where(cond: torch.Tensor, a, b) -> torch.Tensor:
    """`jnp.where` with Python scalars as cached device constants (ints
    become int64, floats float32)."""
    if not isinstance(a, torch.Tensor):
        a = scalar(a, cond.device)
    if not isinstance(b, torch.Tensor):
        b = scalar(b, cond.device)
    return torch.where(cond, a, b)


class SimState(NamedTuple):
    """Simulator state; every field has a leading lane axis [L, ...]."""

    window: torch.Tensor      # int64 [L, W]
    pc: torch.Tensor          # int64 [L, P]
    regs: torch.Tensor        # int64 [L, P, R]
    t_ready: torch.Tensor     # float32 [L, P]
    blocked_a: torch.Tensor   # int64 [L, P]  (watched word or -1)
    blocked_b: torch.Tensor   # int64 [L, P]
    backoff: torch.Tensor     # float32 [L, P]
    busy: torch.Tensor        # float32 [L, W]
    clock: torch.Tensor       # float32 [L] start time of the latest event
    t_finish: torch.Tensor    # float32 [L] max instruction *finish* time
    done: torch.Tensor        # bool [L, P]
    events: torch.Tensor      # int64 [L]
    # metrics
    acq_count: torch.Tensor   # int64 [L, P]
    lat_sum: torch.Tensor     # float32 [L, P]
    t_attempt: torch.Tensor   # float32 [L, P]
    writer_active: torch.Tensor  # int64 [L]
    reader_active: torch.Tensor  # int64 [L]
    violations: torch.Tensor  # int64 [L]
    hold_rank: torch.Tensor   # int64 [L] rank of last CS enterer
    local_passes: torch.Tensor   # int64 [L] CS handoffs that stayed on-node
    total_passes: torch.Tensor   # int64 [L]
    # crash-fault state (FaultPlan)
    crash_t: torch.Tensor     # float32 [L, P] planned, then ACTUAL crash time
    revive_t: torch.Tensor    # float32 [L, P] revive time (INF = never)
    crashed: torch.Tensor     # bool [L, P]
    in_cs: torch.Tensor       # int64 [L, P] 0 out, 1 reader in CS, 2 writer
    restart_pc: torch.Tensor  # int64 [L, P] pc restored on revive
    restart_regs: torch.Tensor   # int64 [L, P, R] registers restored on revive
    # recovery metrics
    reclaims: torch.Tensor    # int64 [L]
    rec_retries: torch.Tensor    # int64 [L]
    t_recover: torch.Tensor   # float32 [L] first successful reclaim (INF = none)


# Rank of each field without the lane axis.
_STATE_RANK = {
    "window": 1, "pc": 1, "regs": 2, "t_ready": 1, "blocked_a": 1,
    "blocked_b": 1, "backoff": 1, "busy": 1, "clock": 0, "t_finish": 0,
    "done": 1, "events": 0, "acq_count": 1, "lat_sum": 1, "t_attempt": 1,
    "writer_active": 0, "reader_active": 0, "violations": 0,
    "hold_rank": 0, "local_passes": 0, "total_passes": 0, "crash_t": 1,
    "revive_t": 1, "crashed": 1, "in_cs": 1, "restart_pc": 1,
    "restart_regs": 2, "reclaims": 0, "rec_retries": 0, "t_recover": 0,
}


def _device_dtype(a: np.ndarray) -> torch.dtype:
    if a.dtype == np.bool_:
        return torch.bool
    if np.issubdtype(a.dtype, np.floating):
        return torch.float32
    return torch.int64


def state_from_numpy(arrays, device) -> SimState:
    """A `SimState` from numpy arrays of a reference (JAX) `SimState` —
    a mapping or any object with the field attributes, e.g.
    `{k: np.asarray(v) for k, v in jax_state._asdict().items()}`.
    Unbatched arrays gain a lane axis of 1; batched ones keep theirs."""
    get = (arrays.__getitem__ if isinstance(arrays, dict)
           else lambda k: getattr(arrays, k))
    raw = {k: np.asarray(get(k)) for k in SimState._fields}
    batched = raw["window"].ndim == 2
    out = {}
    for k, a in raw.items():
        t = torch.as_tensor(np.array(a), device=device).to(_device_dtype(a))
        if not batched:
            t = t.unsqueeze(0)
        if t.dim() != _STATE_RANK[k] + 1:
            raise ValueError(f"state field {k!r} has shape {tuple(a.shape)}")
        out[k] = t.contiguous()
    return SimState(**out)


def state_to_numpy(st: SimState) -> dict:
    """Field name -> numpy array in the reference's dtypes (int32 /
    float32 / bool), lane axis kept."""
    out = {}
    for k, v in st._asdict().items():
        a = v.cpu().numpy()
        out[k] = a.astype(np.int32) if a.dtype == np.int64 else a
    return out


def _cw_np(idx: np.ndarray, n: int) -> np.ndarray:
    """JAX gather index semantics on numpy: wrap once, then clamp."""
    return np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)


def _ext_np(t: np.ndarray, axes=None) -> np.ndarray:
    """Extend `t` along `axes` (default: all) to [t, t[-1] * n, t]:
    indexing the extension at clamp(i, -n, 2n - 1), where torch wraps a
    negative index once, reads t at JAX's index for i (a negative index
    wraps once, then every index clamps into [0, n))."""
    axes = range(t.ndim) if axes is None else axes
    for ax in axes:
        n = t.shape[ax]
        ar = np.arange(n)
        t = np.take(t, np.concatenate([ar, np.full(n, n - 1), ar]), axis=ax)
    return np.ascontiguousarray(t)


def _ix(i: torch.Tensor, n: int) -> torch.Tensor:
    """The index into an `_ext_np` extension of length 3n."""
    return i.clamp(-n, 2 * n - 1)


# Env fields that a point of the (T_DC, T_L, T_R, writer_fraction)
# lattice can change, by the group of points that share them: every
# T_DC has its own counter words and word owners, every T_L its own
# thresholds and writer batch.
LATTICE_GROUPS = ("layout", "T_L", "T_R", "roles")
_GROUP_OF = {"n_ctr": "layout", "ctr_of_p": "layout", "arrive": "layout",
             "depart": "layout", "plain_w": "layout", "atomic_w": "layout",
             "T_L": "T_L", "T_W": "T_L", "T_R": "T_R", "is_writer": "roles"}
_EXT_FIELDS = ("arrive", "depart", "plain_w", "atomic_w", "T_L")  # in Env.ext


@dataclasses.dataclass(frozen=True, eq=False)
class Env:
    """Static simulation environment shared by handlers (device tensors
    plus the workload's Python scalars).

    A lattice env (`make_env(..., lanes=...)`) runs several lattice
    points as the lanes of one run: each field of a group in `lanes`
    carries a leading axis over that group's distinct values (n_ctr,
    T_R and T_W become tensors), and lane l reads row lanes[group][l].
    Groups absent from `lanes` hold one value for every lane, exactly as
    in a single-point env; handlers read every such field through
    `Ctx.point` / `Ctx.point_at_p`, which index only where a group is
    batched."""

    P: int
    N: int
    W: int
    device: torch.device
    n_ctr: int | torch.Tensor  # live counters (the counter loops' bound)
    ctr_of_p: torch.Tensor     # [P] counter c(p) of each process
    scratch_w: tuple           # scratch word indices (Python ints)
    same_leaf: torch.Tensor    # [P, P] bool (locality statistics)
    T_R: int | torch.Tensor
    T_W: int | torch.Tensor
    is_writer: torch.Tensor    # [P] bool
    target_acq: int
    cs_kind: int               # 0 empty, 1 single-op, 2 random 1-4us workload
    think: bool                # wait-after-release 1-4us (WARB)
    cost: CostModel
    lease: float = 2.0
    # Lookup tables extended for JAX index semantics (`_ext_np`):
    # next/status [N, maxE] word tables (and next<lvl>/status<lvl>
    # rows), arrive/depart [C_pad] counter words, T_L [N], ent_rows /
    # tw_rows [N, P] (entity and TAIL word of p at each level), and
    # plain_w / atomic_w [P, W] latencies from p to each word's owner.
    ext: dict = dataclasses.field(default_factory=dict)
    # Lattice group -> [L] int64: each lane's row of the group's fields.
    lanes: dict = dataclasses.field(default_factory=dict)


class FaultPlan(NamedTuple):
    """Crash-fault injection plan: crash process p at simulated time
    crash_t[p] (INF = never), optionally revive it at revive_t[p]. A
    crash takes effect at the victim's next scheduling point at or after
    crash_t; see the reference's `engine.FaultPlan`."""

    crash_t: np.ndarray    # float32 [P]
    revive_t: np.ndarray   # float32 [P]

    @classmethod
    def none(cls, P: int) -> "FaultPlan":
        return cls(np.full(P, INF, np.float32), np.full(P, INF, np.float32))

    @classmethod
    def single(cls, P: int, victim: int, t: float,
               revive_at: float | None = None) -> "FaultPlan":
        plan = cls.none(P)
        plan.crash_t[victim] = np.float32(t)
        if revive_at is not None:
            plan.revive_t[victim] = np.float32(revive_at)
        return plan


class Metrics(NamedTuple):
    completed: torch.Tensor       # bool: every SURVIVOR reached its target
    violations: torch.Tensor      # int: mutual-exclusion violations (must be 0)
    makespan: torch.Tensor        # float: total simulated time (us)
    total_acquires: torch.Tensor  # int
    mean_latency: torch.Tensor    # float us per acquire
    throughput: torch.Tensor      # acquires per second
    events: torch.Tensor
    locality: torch.Tensor        # fraction of CS handoffs staying on-node
    per_proc_acq: torch.Tensor    # [P]
    n_crashed: torch.Tensor       # int: processes crashed at the end
    reclaims: torch.Tensor        # int: abandoned nodes/words reclaimed
    recovery_retries: torch.Tensor   # int: stale-word re-check retries
    t_recover: torch.Tensor       # float us: first reclaim time (INF = none)
    t_crash: torch.Tensor         # float us: first actual crash time (INF = none)


def derive_tw(T_L) -> int:
    """Total writer batch T_W = prod(T_L), clamped to the unbounded
    sentinel."""
    T_L = np.asarray(T_L, np.int32)
    return int(np.minimum(np.prod(T_L.astype(np.int64)), 1 << 26))


def make_env(m: Machine, layout, *, T_L=None, T_R=1 << 26,
             is_writer=None, target_acq=8, cs_kind=0, think=False,
             cost: CostModel = DEFAULT_COST, lease: float = 2.0,
             device=None, lanes=None) -> Env:
    """The environment of one lattice point, or with `lanes` of several.

    `lanes` maps lattice groups (`LATTICE_GROUPS`) to [L] int arrays.
    For each group in it, the group's argument is the sequence of its
    distinct values (Layouts for "layout", T_L for "T_L", T_R for
    "T_R", is_writer arrays for "roles") and lane l runs value
    lanes[group][l]. A group with one distinct value is stored
    un-batched. The layouts of one env must share every word but the
    counters' (`build_layout(pad_counters_to=...)` gives that)."""
    device = resolve_device(device)
    dist = proc_distance_matrix(m)
    plain, atomic = cost.tables(dist)
    lanes = dict(lanes or {})
    if set(lanes) - set(LATTICE_GROUPS):
        raise ValueError(f"lattice groups are {LATTICE_GROUPS}, got "
                         f"{sorted(lanes)}")
    args = {"layout": layout, "T_L": T_L, "T_R": T_R, "roles": is_writer}
    values = {g: list(a) if g in lanes else [a] for g, a in args.items()}
    layout = values["layout"][0]
    for other in values["layout"][1:]:
        if not _same_words(layout, other):
            raise ValueError("the layouts of one env must differ only in "
                             "their counters (pad them to one C_pad)")

    def dev(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def layout_fields(lay):
        return {"n_ctr": int(lay.ctr_mask.sum()), "ctr_of_p": lay.ctr_of_p,
                "arrive": _ext_np(lay.arrive_w),
                "depart": _ext_np(lay.depart_w),
                # Latency from p to the owner of word w, extended over w.
                "plain_w": _ext_np(plain[:, lay.owner], (1,)),
                "atomic_w": _ext_np(atomic[:, lay.owner], (1,))}

    def tl_fields(tl):
        tl = np.asarray(np.full(m.N, 1 << 26) if tl is None else tl,
                        np.int32)
        return {"T_L": _ext_np(tl), "T_W": derive_tw(tl)}

    fields, ext, lane_ix = {}, {}, {}
    for group, make in (
            ("layout", layout_fields), ("T_L", tl_fields),
            ("T_R", lambda r: {"T_R": int(r)}),
            ("roles", lambda w: {"is_writer": np.ones(m.P, bool) if w is None
                                 else np.asarray(w, bool)})):
        rows = [make(v) for v in values[group]]
        batched = len(rows) > 1
        if batched:
            lane_ix[group] = dev(lanes[group])
        for k in rows[0]:
            if batched:
                v = dev(np.stack([r[k] for r in rows]))
            else:
                v = rows[0][k]
                v = dev(v) if isinstance(v, np.ndarray) else v
            (ext if k in _EXT_FIELDS else fields)[k] = v

    tabs = {k: padded_level_table(layout, k + "_w")
            for k in ("next", "status", "tail")}
    # TAIL word of p's element at level lvl, over lvl (p is always a
    # valid index): tw[lvl, p] = tail_t[lvl, elem_of_p[lvl, p]].
    tw = np.take_along_axis(tabs["tail"], layout.elem_of_p, axis=1)
    ext.update({
        "next": dev(_ext_np(tabs["next"])),
        "status": dev(_ext_np(tabs["status"])),
        "ent_rows": dev(_ext_np(layout.ent_of_p, (0,))),
        "tw_rows": dev(_ext_np(tw, (0,)))})
    for name in ("next", "status"):
        for lvl in range(m.N):
            ext[f"{name}{lvl}"] = dev(_ext_np(tabs[name][lvl]))
    return Env(
        P=m.P, N=m.N, W=layout.W, device=device,
        scratch_w=tuple(int(w) for w in layout.scratch_w),
        same_leaf=dev(dist <= 1), target_acq=int(target_acq),
        cs_kind=int(cs_kind), think=bool(think), cost=cost,
        lease=float(lease), ext=ext, lanes=lane_ix, **fields)


def _same_words(a: Layout, b: Layout) -> bool:
    """Whether two layouts agree on every word but the counters': the
    window size, the queue and scratch words, and the counter slots'
    count."""
    return (a.W == b.W and len(a.arrive_w) == len(b.arrive_w)
            and np.array_equal(a.scratch_w, b.scratch_w)
            and all(np.array_equal(padded_level_table(a, t),
                                   padded_level_table(b, t))
                    for t in ("next_w", "status_w", "tail_w")))


def init_state(env: Env, layout: Layout, init_pc: np.ndarray, n_regs: int,
               init_regs: np.ndarray | None = None,
               fault: FaultPlan | None = None, lanes: int = 1) -> SimState:
    """Initial state, replicated over `lanes` lanes."""
    P, L, dev = env.P, lanes, env.device
    regs = (np.zeros((P, n_regs), np.int64) if init_regs is None
            else np.asarray(init_regs, np.int64))
    plan = FaultPlan.none(P) if fault is None else fault

    def rep(a):
        a = np.asarray(a)
        t = torch.as_tensor(np.ascontiguousarray(a), device=dev)
        t = t.to(_device_dtype(a))
        return t.unsqueeze(0).repeat((L,) + (1,) * t.dim()).contiguous()

    def full(shape, v, dtype):
        return torch.full((L,) + shape, v, dtype=dtype, device=dev)

    f32, i64 = torch.float32, torch.int64
    zero_i = full((), 0, i64)
    return SimState(
        window=rep(layout.init), pc=rep(init_pc), regs=rep(regs),
        t_ready=full((P,), 0.0, f32),
        blocked_a=full((P,), -1, i64), blocked_b=full((P,), -1, i64),
        backoff=full((P,), float(np.float32(env.cost.backoff0)), f32),
        busy=full((layout.W,), 0.0, f32), clock=full((), 0.0, f32),
        t_finish=full((), 0.0, f32), done=full((P,), False, torch.bool),
        events=zero_i, acq_count=full((P,), 0, i64),
        lat_sum=full((P,), 0.0, f32), t_attempt=full((P,), 0.0, f32),
        writer_active=zero_i, reader_active=zero_i, violations=zero_i,
        hold_rank=full((), -1, i64), local_passes=zero_i,
        total_passes=zero_i,
        crash_t=rep(np.asarray(plan.crash_t, np.float32)),
        revive_t=rep(np.asarray(plan.revive_t, np.float32)),
        crashed=full((P,), False, torch.bool), in_cs=full((P,), 0, i64),
        restart_pc=rep(init_pc), restart_regs=rep(regs),
        reclaims=zero_i, rec_retries=zero_i, t_recover=full((), INF, f32))


# --------------------------------------------------------------- handlers
@dataclasses.dataclass(frozen=True)
class Instr:
    """One instruction slot: its handler and its accounting kind."""

    fn: Callable            # (Ctx) -> Effect
    kind: int = PLAIN


@dataclasses.dataclass
class Effect:
    """What one handler does to every lane, before the shared tail.

    Fields are [L] tensors or Python scalars; None means the default
    (no hot word, not blocked, no CS exit, nothing reclaimed). `regs`
    maps static register indices to new values; `reg_at` = (index,
    value) is a per-lane register index, applied before `regs`, with JAX
    scatter semantics. `stores` are (word, value) or (word, value,
    enable) triples applied in order with JAX scatter semantics;
    `writes` are the words whose watchers wake if the stored value
    changed (the reference's `writes=`). `dur` is None for CS and DONE
    instructions, whose duration the engine draws.
    """

    next_pc: object
    dur: object = None
    regs: dict | None = None
    reg_at: tuple | None = None
    hot: object = None
    writes: tuple = ()
    stores: tuple = ()
    block_a: object = None
    block_b: object = None
    cs_exit: object = None
    reclaimed: object = None
    retried: object = None


class Ctx:
    """One event step's view of the pre-step state, shared by every
    handler on every lane. Gathers that several handlers need are
    computed once per step (`memo`)."""

    def __init__(self, env: Env, st: SimState, p: torch.Tensor,
                 now: torch.Tensor, draws: dict, consts: dict,
                 faults: bool = True):
        self.env, self.st, self.p, self.now = env, st, p, now
        self.crash_free = not faults      # see Program
        self.L = p.shape[0]
        self.p1 = p[:, None]
        self.lanes = consts["lanes"]
        self.regs = st.regs[self.lanes, p]             # [L, R]
        self.pc_p = st.pc.gather(1, self.p1)[:, 0]
        self.draws = draws
        self._consts = consts
        self._memo = {}

    def memo(self, key, fn):
        v = self._memo.get(key)
        if v is None:
            v = self._memo[key] = fn()
        return v

    def const(self, v) -> torch.Tensor:
        """A cached [L] tensor filled with Python scalar v."""
        key = (type(v), v)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = scalar(v, self.env.device).expand(
                self.L).contiguous()
        return t

    # ---- registers -------------------------------------------------
    def reg(self, i: int) -> torch.Tensor:
        return self.regs[:, i]

    def reg_at(self, idx: torch.Tensor) -> torch.Tensor:
        """r[idx] for a per-lane register index (JAX gather)."""
        rext = self.memo("regs_ext", lambda: _ext_rows(self.regs))
        return rext[self.lanes, _ix(idx, self.regs.shape[1])]

    # ---- window and tables -------------------------------------------
    def win(self, w) -> torch.Tensor:
        """window[w] (per-lane word index, or a static int)."""
        if isinstance(w, int):
            return self.st.window[:, w]
        wext = self.memo("wext", lambda: _ext_rows(self.st.window))
        return wext[self.lanes, _ix(w, self.env.W)]

    def tab(self, name: str, i, j=None) -> torch.Tensor:
        """A 1-D table at i, or a 2-D word table at (i, j), with JAX
        gather semantics; a static int first index selects a row."""
        ext = self.env.ext
        if j is None:
            t = ext[name]
            i = _ix(i, t.shape[-1] // 3)
            pix = self.env.lanes.get(_GROUP_OF.get(name))
            return t[i] if pix is None else t[pix, i]
        if isinstance(i, int):
            t = ext[f"{name}{i}"]
            return t[_ix(j, t.shape[0] // 3)]
        t = ext[name]
        return t[_ix(i, t.shape[0] // 3), _ix(j, t.shape[1] // 3)]

    def at_p(self, name: str, lvl, q=None) -> torch.Tensor:
        """table[lvl, q] (q defaults to p; always a valid process) for a
        [N, P] table extended over levels."""
        t = self.env.ext[name]
        q = self.p if q is None else q
        if isinstance(lvl, int):
            return t[lvl][q]
        return t[_ix(lvl, t.shape[0] // 3), q]

    def rows(self, name: str, lvl) -> torch.Tensor:
        """table[lvl] -> [L, P] for a [N, P] table extended over levels."""
        t = self.env.ext[name]
        if isinstance(lvl, int):
            return t[lvl].expand(self.L, -1)
        return t[_ix(lvl, t.shape[0] // 3)]

    def lat_plain(self, w) -> torch.Tensor:
        return self._lat("plain_w", w)

    def lat_atomic(self, w) -> torch.Tensor:
        return self._lat("atomic_w", w)

    def _lat(self, name, w):
        t = self.env.ext[name]                     # [P, 3W] (or [K, P, 3W])
        pix = self.env.lanes.get("layout")
        if pix is None:
            if isinstance(w, int):
                return t[:, w][self.p]
            return t[self.p, _ix(w, self.env.W)]
        return t[pix, self.p, w if isinstance(w, int) else _ix(w, self.env.W)]

    # ---- lattice fields ----------------------------------------------
    def point(self, name: str):
        """Env field `name` of each lane's lattice point: the field
        itself where every lane shares it, else its rows per lane ([L]
        for n_ctr / T_R / T_W, [L, P] for is_writer / ctr_of_p)."""
        v = getattr(self.env, name)
        pix = self.env.lanes.get(_GROUP_OF[name])
        if pix is None:
            return v
        return self.memo(("point", name), lambda: v[pix])

    def point_at_p(self, name: str) -> torch.Tensor:
        """[P] env field `name` at the executing process, per lane."""
        v = getattr(self.env, name)
        pix = self.env.lanes.get(_GROUP_OF[name])
        if pix is None:
            return v[self.p]
        return self.memo(("point_at_p", name), lambda: v[pix, self.p])

    # ---- per-step shared quantities ----------------------------------
    @property
    def expired(self) -> torch.Tensor:
        """[L, P] leases_expired: crashed for at least `lease` us
        (all False when no process can crash)."""
        if self.crash_free:
            return self._consts["no_lp"]
        return self.memo("expired", lambda: leases_expired(
            self.env, self.st, self.now))

    def pc_is(self, pc: int) -> torch.Tensor:
        """[L, P] bool: st.pc == pc."""
        return self.memo(("pc_is", pc), lambda: self.st.pc == pc)

    @property
    def not_p(self) -> torch.Tensor:
        """[L, P] bool: q != p."""
        return self.memo("not_p", lambda: self._consts["q"] != self.p1)

    @property
    def cs_dur(self) -> torch.Tensor:
        """cs_duration(env, k2, p)."""
        env = self.env
        if env.cs_kind == 0:
            return self.const(0.0)
        if env.cs_kind == 1:
            return self.const(float(np.float32(env.cost.lat[2])))
        return self.memo("cs_dur", lambda: prng.scale_uniform(
            self.draws["k2"], 1.0, 4.0))

    @property
    def think_dur(self) -> torch.Tensor:
        """think_duration(env, key)."""
        if not self.env.think:
            return self.const(0.0)
        return self.memo("think", lambda: prng.scale_uniform(
            self.draws["key"], 1.0, 4.0))


CH_WINDOW = "window"        # window word gathers (`Ctx.win`)
CH_REGS = "regs"            # register gathers (`Ctx.reg`, `Ctx.reg_at`)


class RecordingCtx(Ctx):
    """A Ctx that notes the raw index of every window and register
    gather, before the JAX-style wrap and clamp, with the handler that
    computed it: `log` holds (handler, channel, index), the index a
    Python int or an [L] tensor. `evaluate` sets the handler of each
    call. A memoized value notes its gathers again for every handler
    that reads it, so each handler's entries are its own footprint.
    Window and register writes are read off the handlers' Effects.

    The runtime sanitizer checks these indices on the lanes that select
    the handler; `repro_torch.analysis.trace` reads them per lane."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.handler = -1
        self.log = []
        self._memo_log = {}

    def evaluate(self, instrs) -> list:
        """Every instruction's Effect, each call under its own index."""
        effs = []
        for i, ins in enumerate(instrs):
            self.handler = i
            effs.append(ins.fn(self))
        self.handler = -1
        return effs

    def memo(self, key, fn):
        noted = self._memo_log.get(key)
        if noted is not None:
            self.log.extend((self.handler, ch, i) for _, ch, i in noted)
            return self._memo[key]
        start = len(self.log)
        v = super().memo(key, fn)
        self._memo_log[key] = self.log[start:]
        return v

    def reg(self, i: int) -> torch.Tensor:
        self.log.append((self.handler, CH_REGS, i))
        return super().reg(i)

    def reg_at(self, idx: torch.Tensor) -> torch.Tensor:
        self.log.append((self.handler, CH_REGS, idx))
        return super().reg_at(idx)

    def win(self, w) -> torch.Tensor:
        self.log.append((self.handler, CH_WINDOW, w))
        return super().win(w)


def _ext_rows(x: torch.Tensor) -> torch.Tensor:
    """[L, n] -> [L, 3n] extension of each row (see `_ext_np`)."""
    n = x.shape[1]
    return torch.cat([x, x[:, n - 1:].expand(-1, n), x], dim=1)


def set_reg_at(regs: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """r.at[idx].set(val) for a per-lane register index, with JAX
    scatter semantics (wrap once, drop out of bounds)."""
    R = regs.shape[1]
    idx = where(idx < 0, idx + R, idx)
    ok = (idx >= 0) & (idx < R)
    idx1 = idx.clamp(0, R - 1)[:, None]
    cur = regs.gather(1, idx1)[:, 0]
    return regs.scatter(1, idx1, where(ok, val, cur)[:, None])


def leases_expired(env: Env, st: SimState, now) -> torch.Tensor:
    """[L, P] bool: process q crashed and its lease ran out at least
    `env.lease` simulated us ago (the reference's `leases_expired`)."""
    return st.crashed & (now[:, None]
                         >= st.crash_t + scalar(env.lease, env.device))


# ------------------------------------------------------------ the program
class Program:
    """A built instruction program: one handler table per variant and
    per-pc kind tables.

    `crash_free` is the table used when no process of any lane can
    crash (no planned crash, none crashed). Without a crash
    `leases_expired` is all False, so every guard that requires an
    expired process is exactly False: the handlers may skip computing
    it, and the instructions that only such a guard routes to are
    unreachable. `full` is used otherwise. The lease guards are most of
    a hierarchical step's ops, so the full table dispatches about 1.8x
    the ops per step of the crash-free one (`chip_smoke.py` prints
    both).

    `draws` declares the random draws the handlers read from
    `Ctx.draws` beyond the engine's own: {"slot": n} for
    randint(split(sub)[0], 0, n), {"k2": True} for the uniform bits of
    split(sub)[1] (see `_KeyStream`). A program that declares none gets
    only the draws its env's jitter, think time and CS kind need."""

    def __init__(self, env: Env, full, crash_free=None, draws=None):
        self.env = env
        self.full = tuple(full)
        self.crash_free = self.full if crash_free is None else tuple(crash_free)
        self.draws = dict(draws or {})
        if set(self.draws) - {"slot", "k2"}:
            raise ValueError(f"a program may declare the draws 'slot' and "
                             f"'k2', got {sorted(self.draws)}")
        kinds = torch.tensor([i.kind for i in self.full],
                             dtype=torch.int64, device=env.device)
        self.is_cs = kinds == CS
        self.is_done = kinds == DONE
        self._plans = {}

    def instrs(self, faults: bool):
        return self.full if faults else self.crash_free


_SCALAR_FIELDS = (("next_pc", 0), ("hot", -1), ("block_a", -1),
                  ("block_b", -1), ("dur", 0.0), ("cs_exit", False),
                  ("reclaimed", False), ("retried", False))
_DTYPE_OF = {int: torch.int64, float: torch.float32, bool: torch.bool}
_PY_OF = {v: k for k, v in _DTYPE_OF.items()}


def _field(e: Effect, key):
    if isinstance(key, str):
        return getattr(e, key)
    kind, k = key[0], key[1]
    if kind == "writes":
        return e.writes[k] if k < len(e.writes) else None
    if kind == "reg":
        return None if e.reg_at is not None or not e.regs else e.regs.get(k)
    if k >= len(e.stores):                              # ("store", k, f)
        return None
    s = e.stores[k]
    return s[key[2]] if key[2] < len(s) else True


class _MergePlan:
    """Static layout of one step's merge. For each dtype, every field's
    candidate values (its default, then each handler's value) are
    entries of ONE stacked tensor; a [fields, n_pcs] table maps each
    field and pc to its entry, so selecting every field of that dtype
    is one stack and one gather. Which handler sets which field, and
    with a Python constant or a tensor, is fixed by the handler code,
    so the plan is built once per program variant."""

    def __init__(self, ctx: Ctx, effs, keys, defaults):
        self.keys = {}           # dtype -> [field key]
        self.recipe = {}         # dtype -> [entry source]
        tables = {}
        const_pos = {}
        for key in keys:
            default = defaults[key]
            dtype = (torch.int64 if isinstance(default, torch.Tensor)
                     else _DTYPE_OF[type(default)])
            recipe = self.recipe.setdefault(dtype, [])
            self.keys.setdefault(dtype, []).append(key)

            def entry(src, dtype=dtype, recipe=recipe):
                if src[0] == "const":
                    ck = (dtype, type(src[1]), src[1])
                    if ck not in const_pos:
                        const_pos[ck] = len(recipe)
                        recipe.append(src)
                    return const_pos[ck]
                recipe.append(src)
                return len(recipe) - 1

            d = (entry(("default", key)) if isinstance(default, torch.Tensor)
                 else entry(("const", default)))
            row = []
            for i, e in enumerate(effs):
                v = _field(e, key)
                if v is None:
                    row.append(d)
                elif isinstance(v, torch.Tensor):
                    row.append(entry(("eff", i, key)))
                else:
                    row.append(entry(("const", _PY_OF[dtype](v))))
            tables.setdefault(dtype, []).append(row)
        self.tables = {dt: torch.tensor(rows, dtype=torch.int64,
                                        device=ctx.env.device)
                       for dt, rows in tables.items()}
        self._cols = None

    def reg_cols(self, cols, ctx: Ctx) -> torch.Tensor:
        if self._cols is None:
            self._cols = torch.tensor(cols, dtype=torch.int64,
                                      device=ctx.env.device)
        return self._cols

    def select(self, ctx: Ctx, effs, defaults, idx) -> dict:
        """{dtype: [fields, L] selected values}, rows in `self.keys`
        order."""
        out = {}
        for dtype, recipe in self.recipe.items():
            vals = []
            for src in recipe:
                if src[0] == "eff":
                    v = _field(effs[src[1]], src[2])
                elif src[0] == "const":
                    v = ctx.const(src[1])
                else:
                    v = defaults[src[1]]
                vals.append(v.expand(ctx.L) if v.dim() == 0 else v)
            stacked = torch.stack(vals)                    # [entries, L]
            out[dtype] = stacked[self.tables[dtype][:, idx], ctx.lanes]
        return out

    def rows(self, dtype, first_key, n: int):
        """Slice of the `n` consecutive rows starting at `first_key`."""
        j = self.keys[dtype].index(first_key)
        return slice(j, j + n)


def _merge(ctx: Ctx, prog: Program, effs, faults: bool) -> dict:
    """Select each lane's effect by its executing process's pc (a pc
    outside the table is clamped, as `lax.switch` clamps its index).
    Fields of one kind sit in consecutive rows of the selected tensors,
    so the write words, the stores and the register columns come out
    as slices."""
    idx = ctx.pc_p.clamp(0, len(effs) - 1)
    base = _regs_base(ctx, effs, idx)
    defaults = dict(_SCALAR_FIELDS)
    nw = max(len(e.writes) for e in effs)
    ns = max(len(e.stores) for e in effs)
    defaults.update({("writes", k): -1 for k in range(nw)})
    for f, default in ((0, 0), (1, 0), (2, False)):
        defaults.update({("store", k, f): default for k in range(ns)})
    cols = sorted({i for e in effs if e.reg_at is None and e.regs
                   for i in e.regs})
    defaults.update({("reg", i): base[:, i] for i in cols})
    plan = prog._plans.get(faults)
    if plan is None:
        plan = prog._plans[faults] = _MergePlan(ctx, effs, list(defaults),
                                                defaults)
    sel = plan.select(ctx, effs, defaults, idx)
    i64, f32, b = sel[torch.int64], sel[torch.float32], sel[torch.bool]
    row = {dt: {k: j for j, k in enumerate(plan.keys[dt])}
           for dt in plan.keys}
    out = {name: (f32 if name == "dur" else
                  b if isinstance(default, bool) else i64)[
                      row[_DTYPE_OF[type(default)]][name]]
           for name, default in _SCALAR_FIELDS}
    out["idx"] = idx
    out["writes"] = (i64[plan.rows(torch.int64, ("writes", 0), nw)].T
                     if nw else None)
    out["stores"] = ((i64[plan.rows(torch.int64, ("store", 0, 0), ns)],
                      i64[plan.rows(torch.int64, ("store", 0, 1), ns)],
                      b[plan.rows(torch.bool, ("store", 0, 2), ns)])
                     if ns else None)
    if cols:
        src = i64[plan.rows(torch.int64, ("reg", cols[0]), len(cols))]
        out["regs"] = base.index_copy(1, plan.reg_cols(cols, ctx), src.T)
    else:
        out["regs"] = base
    return out


def _regs_base(ctx: Ctx, effs, idx) -> torch.Tensor:
    """Register rows of handlers with a per-lane register write (whole
    rows, static columns applied after it), selected per lane; the
    pre-step row elsewhere."""
    fulls = []
    for i, e in enumerate(effs):
        if e.reg_at is not None:
            r = set_reg_at(ctx.regs, *e.reg_at)
            for col, v in (e.regs or {}).items():
                r[:, col] = v
            fulls.append((i, r))
    base = ctx.regs
    for i, r in fulls:
        base = torch.where((idx == i)[:, None], r, base)
    return base


def _row(x: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    return x.gather(1, p1)[:, 0]


def _step(prog: Program, st: SimState, draws: dict, max_events: int,
          consts: dict, faults: bool = True, san=None) -> SimState:
    """One event step on every lane (the reference's `step_loop` body,
    including its loop condition as a per-lane mask)."""
    p, now, hm, fm = _select(st, max_events, consts)
    return _exec(prog, st, p, now, draws, consts, faults, hm, fm, san)


def _select(st: SimState, max_events: int, consts: dict):
    """Each lane's process p (the smallest ready time, first on ties),
    its time `now`, and the lanes that run p's instruction (`hm`) or
    crash or revive p (`fm`)."""
    inf = consts["inf"]
    parked = st.crashed & (st.t_ready >= inf)
    off = st.done | parked
    act = (~off).any(1) & (st.events < max_events)
    tr = torch.where(off, inf, st.t_ready)
    p = tr.argmin(1)                      # first index on ties
    p1 = p[:, None]
    now = tr.gather(1, p1)[:, 0]
    fault = _row(st.crashed, p1) | (now >= _row(st.crash_t, p1))
    return p, now, act & ~fault, act & fault


def _exec(prog: Program, st: SimState, p: torch.Tensor, now: torch.Tensor,
          draws: dict, consts: dict, faults: bool, hm: torch.Tensor,
          fm: torch.Tensor, san=None) -> SimState:
    """Run process p[l]'s current instruction at time now[l] on the `hm`
    lanes, and the fault event of p[l] on the `fm` lanes; other lanes
    are left as they are. `san` is the step loop's `_Sanitizer` when
    runtime checks are on."""
    if san is None:
        ctx = Ctx(prog.env, st, p, now, draws, consts, faults)
        effs = [ins.fn(ctx) for ins in prog.instrs(faults)]
    else:
        ctx = RecordingCtx(prog.env, st, p, now, draws, consts, faults)
        effs = ctx.evaluate(prog.instrs(faults))
    eff = _merge(ctx, prog, effs, faults)
    return _apply(prog, st, ctx, eff, hm, fm, draws, consts, faults, san,
                  effs)


def _apply(prog, st, ctx, eff, hm, fm, draws, consts, faults, san=None,
           effs=None) -> SimState:
    """The shared tail: finish_instr + cs_enter/cs_exit + acquire
    accounting on `hm` lanes, `_fault_event` on `fm` lanes."""
    env = prog.env
    p, p1, now = ctx.p, ctx.p1, ctx.now
    cost = env.cost
    idx = eff["idx"]
    cs_sel = prog.is_cs[idx]
    is_cs = cs_sel & hm
    is_done = prog.is_done[idx] & hm

    # finish = start + dur + jitter, in this order.
    dur = torch.where(cs_sel, ctx.cs_dur, eff["dur"])
    dur = torch.where(is_done, ctx.think_dur, dur)
    if san is not None:
        san.check(ctx, effs, eff, dur, hm)
    if cost.jitter > 0.0:
        unit = torch.where(cs_sel, draws["k1"], draws["key"])
        jit = prng.scale_uniform(unit, 0.0, cost.jitter)
    else:
        jit = consts["zero_f"]
    hot = eff["hot"]
    hot_ok = hot >= 0
    hot0 = hot.clamp(min=0)
    busy_at = torch.where(hot_ok, st.busy[ctx.lanes, hot0.clamp(max=env.W - 1)],
                          consts["zero_f"])
    start = torch.maximum(now, busy_at)
    finish = start + dur + jit
    wq = consts["wq"]                              # [1, W] word ids
    busy = torch.where((wq == hot0[:, None]) & (hm & hot_ok)[:, None],
                       (start + consts["occupancy"])[:, None], st.busy)

    # Window stores, in order, with JAX scatter semantics (a negative
    # word wraps once, an out-of-bounds one is dropped).
    window = st.window
    if eff["stores"] is not None:
        ws, vs, ens = eff["stores"]                               # [S, L]
        ws = torch.where(ws < 0, ws + env.W, ws)
        ens = ens & hm
        for w, v, en in zip(ws, vs, ens):
            window = torch.where((wq == w[:, None]) & en[:, None],
                                 v[:, None], window)

    # Wake watchers of written words whose value changed (never the
    # executing process, a done or a crashed one; a -1 write slot
    # matches nothing).
    blocked_a, blocked_b, t_ready = st.blocked_a, st.blocked_b, st.t_ready
    if eff["writes"] is not None:
        wr = eff["writes"]                                      # [L, M]
        ix = wr.clamp(0, env.W - 1)
        changed = ((st.window.gather(1, ix) != window.gather(1, ix))
                   & (wr >= 0))
        wr = torch.where(changed, wr, consts["neg2"])   # -2 watches nothing
        hit = ((blocked_a[:, :, None] == wr[:, None, :])
               | (blocked_b[:, :, None] == wr[:, None, :])).any(2)
        hit = hit & ~(st.done | st.crashed) & ctx.not_p & hm[:, None]
        t_ready = torch.where(
            hit, torch.minimum(t_ready, (finish + consts["wake"])[:, None]),
            t_ready)
        blocked_a = torch.where(hit, consts["neg1"], blocked_a)
        blocked_b = torch.where(hit, consts["neg1"], blocked_b)

    # The executing process p: instruction (hm lanes) or fault event
    # (fm lanes), written through one-hot [L, P] masks of p.
    at_p = ~ctx.not_p
    oh_hm = at_p & hm[:, None]
    ba, bb = eff["block_a"], eff["block_b"]
    blocked_now = (ba >= 0) | (bb >= 0)
    backoff_p = _row(st.backoff, p1)
    fin_ready = finish + torch.where(blocked_now, backoff_p,
                                     consts["zero_f"])
    grown = torch.minimum(backoff_p * 2.0, consts["backoff_max"])
    new_backoff = torch.where(blocked_now, grown, torch.where(
        cs_sel, consts["backoff0"], backoff_p))
    neg1 = consts["neg1"]
    pc = torch.where(oh_hm, eff["next_pc"][:, None], st.pc)
    regs = torch.where(oh_hm[:, :, None], eff["regs"][:, None, :], st.regs)
    t_ready = torch.where(oh_hm, fin_ready[:, None], t_ready)
    blocked_a = torch.where(oh_hm, ba[:, None], blocked_a)
    blocked_b = torch.where(oh_hm, bb[:, None], blocked_b)
    backoff = torch.where(oh_hm, new_backoff[:, None], st.backoff)

    # cs_enter / cs_exit.
    w_p = ctx.point_at_p("is_writer")
    ex = eff["cs_exit"] & hm
    viol = (st.writer_active > 0) | (w_p & (st.reader_active > 0))
    writer_active = (st.writer_active + (is_cs & w_p).long()
                     - (ex & w_p).long())
    reader_active = (st.reader_active + (is_cs & ~w_p).long()
                     - (ex & ~w_p).long())
    in_cs = torch.where(at_p & is_cs[:, None], (1 + w_p.long())[:, None],
                        torch.where(at_p & ex[:, None], consts["zero_i"],
                                    st.in_cs))
    oh_cs = at_p & is_cs[:, None]
    lat_sum = torch.where(oh_cs, st.lat_sum + (now[:, None] - st.t_attempt),
                          st.lat_sum)
    hr = st.hold_rank
    same = env.same_leaf[hr.clamp(min=0), p] & (hr >= 0)

    # Acquire accounting (DONE instructions).
    oh_done = at_p & is_done[:, None]
    cnt = st.acq_count + 1
    acq_count = torch.where(oh_done, cnt, st.acq_count)
    done = torch.where(oh_done, cnt >= env.target_acq, st.done)
    t_attempt = torch.where(oh_done, finish[:, None], st.t_attempt)

    crashed, crash_t = st.crashed, st.crash_t
    if faults:
        # _fault_event: a crash parks p until revive_t and releases its
        # CS occupancy for accounting; a revive restores the restart pc
        # and registers and runs p at once. crash_t := now (INF on
        # revive, which consumes the plan).
        oh_fm = at_p & fm[:, None]
        oh_rev = oh_fm & st.crashed
        in_cs_p = _row(st.in_cs, p1)
        fm_crash = fm & ~_row(st.crashed, p1)
        writer_active = writer_active - (fm_crash & (in_cs_p == 2)).long()
        reader_active = reader_active - (fm_crash & (in_cs_p == 1)).long()
        in_cs = torch.where(oh_fm, consts["zero_i"], in_cs)
        pc = torch.where(oh_rev, st.restart_pc, pc)
        regs = torch.where(oh_rev[:, :, None], st.restart_regs, regs)
        t_ready = torch.where(oh_fm, torch.where(
            st.crashed, now[:, None], st.revive_t), t_ready)
        blocked_a = torch.where(oh_fm, neg1, blocked_a)
        blocked_b = torch.where(oh_fm, neg1, blocked_b)
        crash_t = torch.where(oh_fm, torch.where(
            st.crashed, consts["inf"], now[:, None]), crash_t)
        crashed = crashed ^ oh_fm
    act = hm | fm

    rec = eff["reclaimed"] & hm
    return SimState(
        window=window, pc=pc, regs=regs, t_ready=t_ready,
        blocked_a=blocked_a, blocked_b=blocked_b, backoff=backoff,
        busy=busy, clock=torch.where(act, now, st.clock),
        t_finish=torch.where(hm, torch.maximum(st.t_finish, finish),
                             st.t_finish),
        done=done, events=st.events + act.long(),
        acq_count=acq_count, lat_sum=lat_sum, t_attempt=t_attempt,
        writer_active=writer_active, reader_active=reader_active,
        violations=st.violations + (is_cs & viol).long(),
        hold_rank=torch.where(is_cs, p, hr),
        local_passes=st.local_passes + (is_cs & same).long(),
        total_passes=st.total_passes + is_cs.long(),
        crash_t=crash_t, revive_t=st.revive_t, crashed=crashed,
        in_cs=in_cs, restart_pc=st.restart_pc,
        restart_regs=st.restart_regs,
        reclaims=st.reclaims + rec.long(),
        rec_retries=st.rec_retries + (eff["retried"] & hm).long(),
        t_recover=torch.where(rec, torch.minimum(st.t_recover, finish),
                              st.t_recover))


# --------------------------------------------------------------- the loop
def _consts(env: Env, L: int) -> dict:
    dev = env.device
    return {
        "lanes": torch.arange(L, device=dev),
        "q": torch.arange(env.P, device=dev)[None, :],
        "wq": torch.arange(env.W, device=dev)[None, :],
        "no_lp": torch.zeros((L, env.P), dtype=torch.bool, device=dev),
        "neg2": scalar(-2, dev),
        "inf": scalar(INF, dev), "zero_f": scalar(0.0, dev),
        "zero_i": scalar(0, dev), "neg1": scalar(-1, dev),
        "wake": scalar(env.cost.wake, dev),
        "occupancy": scalar(env.cost.occupancy, dev),
        "backoff0": scalar(env.cost.backoff0, dev),
        "backoff_max": scalar(env.cost.backoff_max, dev),
    }


class _KeyStream:
    """The per-lane key chain of the reference's loop (`key0 =
    PRNGKey(seed)`, then `key, sub = split(key)` once per event step),
    with the draws each step can consume, computed `n` steps at a time
    on the host and moved to the device in one copy:

      key:  uniform bits of `sub` (finish_instr's jitter, think time)
      k1:   uniform bits of split(sub)[0] (jitter of CS instructions)
      k2:   uniform bits of split(sub)[1] (cs_kind=2 duration, or a
            program's declared uniform draw)
      slot: randint(split(sub)[0], 0, n), declared by a program as
            {"slot": n} (the DHT's random table slot)

    The uniform draws are float32 in [0, 1) before the final
    `* (hi - lo) + lo`; slot is int64. `draws` is the program's
    declaration (`Program.draws`).
    """

    def __init__(self, env: Env, seeds: torch.Tensor, draws=None):
        draws = draws or {}
        self.env = env
        self.need_key = env.cost.jitter > 0.0 or env.think
        self.need_k1 = env.cost.jitter > 0.0
        self.need_k2 = env.cs_kind == 2 or bool(draws.get("k2"))
        self.n_slots = draws.get("slot")
        self.key = prng.PRNGKey(seeds.cpu())

    @property
    def needed(self) -> bool:
        return (self.need_key or self.need_k1 or self.need_k2
                or self.n_slots is not None)

    def chunk(self, n: int) -> dict:
        key, subs = self.key, []
        for _ in range(n):
            ks = prng.split(key)
            key = ks[:, 0]
            subs.append(ks[:, 1])
        self.key = key
        return self.draws_of(torch.stack(subs, dim=1))       # [L, n, 2]

    def draws_of(self, sub: torch.Tensor) -> dict:
        """The draws of step keys `sub` ([..., 2], on the host), each
        [...] on the env's device. The model checker passes one key per
        lane, as the reference passes its model key as the step key."""
        out = {}
        if self.need_key:
            out["key"] = prng.unit_float(prng.random_bits32(sub))
        if self.need_k1 or self.need_k2 or self.n_slots is not None:
            kk = prng.split(sub)                              # [..., 2, 2]
            if self.need_k1:
                out["k1"] = prng.unit_float(prng.random_bits32(kk[..., 0, :]))
            if self.need_k2:
                out["k2"] = prng.unit_float(prng.random_bits32(kk[..., 1, :]))
            if self.n_slots is not None:
                out["slot"] = prng.randint(kk[..., 0, :], 0, self.n_slots)
        return {k: v.to(self.env.device) for k, v in out.items()}


class _Sanitizer:
    """The runtime checks of one `step_loop` (see the module docstring).

    Per lane, the first failed check is kept: its message's index
    (`code`, 0 = none) and value (`val`, or `fval` for a duration).
    Index checks take a raw index i into an axis of size n as JAX does:
    valid iff -n <= i < n (a negative index wraps once)."""

    def __init__(self, env: Env, L: int):
        dev = env.device
        C = env.ext["arrive"].shape[-1] // 3
        arrive = env.ext["arrive"].cpu().numpy()[..., :C].reshape(-1, C)
        depart = env.ext["depart"].cpu().numpy()[..., :C].reshape(-1, C)
        n_ctr = np.broadcast_to(np.asarray(
            env.n_ctr.cpu() if isinstance(env.n_ctr, torch.Tensor)
            else env.n_ctr), (arrive.shape[0],))
        dead = np.zeros((arrive.shape[0], env.W), bool)
        for k, n in enumerate(n_ctr):
            dead[k, arrive[k, n:]] = True
            dead[k, depart[k, n:]] = True
        dead = torch.as_tensor(dead, device=dev)
        pix = env.lanes.get("layout")
        self.dead = (dead[0].expand(L, -1) if pix is None else dead[pix])
        self.code = torch.zeros(L, dtype=torch.int64, device=dev)
        self.val = torch.zeros(L, dtype=torch.int64, device=dev)
        self.fval = torch.zeros(L, dtype=torch.float32, device=dev)
        self.messages = []
        self._codes = {}

    def _code(self, message: str) -> int:
        c = self._codes.get(message)
        if c is None:
            self.messages.append(message)
            c = self._codes[message] = len(self.messages)
        return c

    def check(self, ctx: Ctx, effs, eff: dict, dur: torch.Tensor,
              hm: torch.Tensor):
        """Check one step's selected handlers on the `hm` lanes."""
        dev, W, R = ctx.env.device, ctx.env.W, ctx.regs.shape[1]
        index = []                  # (handler, what, size, raw index)
        for h, ch, i in ctx.log:
            index.append((h, f"{ch} gather", W if ch == CH_WINDOW else R, i))
        for h, e in enumerate(effs):
            index += [(h, "window scatter", W, s[0]) for s in e.stores]
            if e.reg_at is not None:
                index.append((h, "regs scatter", R, e.reg_at[0]))
            index += [(h, "regs scatter", R, r) for r in (e.regs or {})]
        bads, vals, codes = [], [], []
        if index:
            ix = torch.stack([i.expand(ctx.L) if isinstance(i, torch.Tensor)
                              else ctx.const(int(i)) for *_, i in index])
            hid = torch.tensor([h for h, *_ in index], device=dev)
            n = torch.tensor([n for _, _, n, _ in index], device=dev)[:, None]
            bads.append((eff["idx"] == hid[:, None])
                        & ((ix < -n) | (ix >= n)))
            vals.append(ix)
            codes += [self._code(
                f"out-of-bounds indexing for {what} of shape ({n},): index "
                f"{{v}} is out of bounds for axis 0 with size {n} (pc {h})")
                for h, what, n, _ in index]
        names = ["hot"]
        words = [eff["hot"]]
        if eff["writes"] is not None:
            names += ["write"] * eff["writes"].shape[1]
            words += list(eff["writes"].T)
        names += ["block_a", "block_b"]
        words += [eff["block_a"], eff["block_b"]]
        wv = torch.stack(words)                                   # [M, L]
        out = (wv < -1) | (wv >= W)
        dead = (self.dead.gather(1, wv.clamp(0, W - 1).T).T & (wv >= 0)
                & ~out)
        bads.append(torch.stack([out, dead], 1).flatten(0, 1))
        vals.append(wv.repeat_interleave(2, 0))
        for what in names:
            codes += [self._code(f"{what} word {{v}} outside [-1, W)"),
                      self._code(f"{what} word {{v}} is a padded dead "
                                 "counter slot")]
        bads.append(~(dur >= 0)[None])
        vals.append(torch.zeros_like(vals[-1][:1]))
        codes.append(self._code("negative instruction duration {d}"))

        bad = torch.cat(bads) & hm
        first = bad.to(torch.int32).argmax(0)[None]
        code = torch.where(bad.any(0), torch.tensor(codes, device=dev)[
            first[0]], scalar(0, dev))
        new = (self.code == 0) & (code > 0)
        self.code = torch.where(new, code, self.code)
        self.val = torch.where(new, torch.cat(vals).gather(0, first)[0],
                               self.val)
        self.fval = torch.where(new, dur, self.fval)

    def raise_first(self):
        """Raise the first failed check of the lowest lane, if any."""
        code = self.code.cpu()
        lanes = code.nonzero()
        if lanes.numel():
            lane = int(lanes[0, 0])
            msg = self.messages[int(code[lane]) - 1].format(
                v=int(self.val[lane]), d=float(self.fval[lane]))
            raise RuntimeError(f"{msg}; first at lane {lane}")


def pending(st: SimState, max_events: int) -> torch.Tensor:
    """[L] bool: the reference's loop condition, per lane."""
    parked = st.crashed & (st.t_ready >= scalar(INF, st.t_ready.device))
    return (~(st.done | parked)).any(1) & (st.events < max_events)


def step_loop(prog: Program, max_events: int, st: SimState,
              seeds) -> SimState:
    """Run every lane of `st` to completion, lane l under seed
    seeds[l]. The host reads "any lane pending" once per `CHECK_EVERY`
    steps; steps past a lane's end leave it bit-for-bit untouched."""
    seeds = torch.as_tensor(np.asarray(seeds), dtype=torch.int64).reshape(-1)
    L = st.window.shape[0]
    if seeds.shape[0] != L:
        raise ValueError(f"{seeds.shape[0]} seeds for {L} lanes")
    for group, pix in prog.env.lanes.items():
        if pix.shape[0] != L:
            raise ValueError(f"the env's {group!r} index has "
                             f"{pix.shape[0]} lanes, the state {L}")
    consts = _consts(prog.env, L)
    stream = _KeyStream(prog.env, seeds, prog.draws)
    san = _Sanitizer(prog.env, L) if checks_enabled() else None
    # A run where no process can crash takes the crash-free handlers.
    faults = bool((st.crashed | (st.crash_t < INF)).any())
    with torch.inference_mode():
        while bool(pending(st, max_events).any()):
            draws = stream.chunk(CHECK_EVERY) if stream.needed else {}
            for j in range(CHECK_EVERY):
                st = _step(prog, st, {k: v[:, j] for k, v in draws.items()},
                           max_events, consts, faults, san)
            if san is not None:
                san.raise_first()
    return st


def cat_states(states) -> SimState:
    """The states' lanes, in order, as one state."""
    return SimState(*(torch.cat(f) for f in zip(*states)))


def summarize(st: SimState) -> Metrics:
    """Reduce a final SimState to Metrics, per lane. `mean_latency`
    sums lat_sum over P left to right, the same order for every lane
    count and device (so a batch lane equals its single run bit for
    bit); XLA may sum in another order, so it can differ from the
    reference in the last bit. Every other metric is exact. Integer
    metrics are int32, as in the reference."""
    i32 = torch.int32
    dev = st.t_finish.device
    total = st.acq_count.sum(1).to(i32)
    lat = st.lat_sum[:, 0]
    for q in range(1, st.lat_sum.shape[1]):
        lat = lat + st.lat_sum[:, q]
    mk = torch.maximum(st.t_finish, scalar(1e-6, dev))
    return Metrics(
        completed=(st.done | st.crashed).all(1),
        violations=st.violations.to(i32),
        makespan=mk,
        total_acquires=total,
        mean_latency=lat / total.clamp(min=1),
        throughput=total.to(torch.float32) / (mk * scalar(1e-6, dev)),
        events=st.events.to(i32),
        locality=(st.local_passes.to(i32)
                  / st.total_passes.to(i32).clamp(min=1)),
        per_proc_acq=st.acq_count.to(i32),
        n_crashed=st.crashed.sum(1).to(i32),
        reclaims=st.reclaims.to(i32),
        recovery_retries=st.rec_retries.to(i32),
        t_recover=st.t_recover,
        t_crash=torch.where(st.crashed, st.crash_t,
                            scalar(INF, dev)).amin(1))


def metrics_at(m: Metrics, *index) -> Metrics:
    """Select one element from stacked Metrics (`metrics_at(m, s)` for
    run_batch output)."""
    return Metrics(*(leaf[index] for leaf in m))


def run_sim(program, env: Env, layout: Layout, *, seed=0,
            max_events: int = 2_000_000,
            fault: FaultPlan | None = None) -> Metrics:
    """Run a protocol program to completion and summarize metrics."""
    return metrics_at(run_sim_batch(program, env, layout, seeds=[seed],
                                    max_events=max_events, fault=fault), 0)


def run_sim_batch(program, env: Env, layout: Layout, *, seeds,
                  max_events: int = 2_000_000,
                  fault: FaultPlan | None = None) -> Metrics:
    """Run one configuration under many seeds, one lane per seed.
    Returns Metrics whose leaves carry a leading [len(seeds)] axis."""
    seeds = np.asarray(seeds).reshape(-1)
    st = init_state(env, layout, program.init_pc(env), program.n_regs,
                    program.init_regs(env), fault=fault, lanes=len(seeds))
    return summarize(step_loop(program.build(env), max_events, st, seeds))

"""Exhaustive small-P model checking of the lock programs, one
breadth-first level per engine call.

Counterpart of `repro.analysis.model`, the repo's analogue of the
paper's SPIN verification (§4.4). The checker reuses the engine's own
instruction handlers: `engine._exec` runs, for every lane, process
p[l]'s current instruction on state l, and a breadth-first search
enumerates every reachable state of the canonical (timing-free) state
space.

Batching: the reference steps one state per dispatch (every process of
it at once, `vmap` over P). Here the lanes of one `_exec` call are the
(state, enabled process) pairs of a whole breadth-first level, so a
search costs one engine step per level (chunked at `LANE_BUDGET`
lanes), whatever the level's width. The successors are read back and
inserted in the reference's order: states in queue order; for each
state the crash transition first, then p ascending. So the states, the
edges and their order, the parents, the samples and therefore the
counterexample traces and interleaving counts equal the reference's.

Canonical states and why they are sound (as in the reference):

  * The engine's blocking is "sleep with a backoff timeout": a blocked
    process always keeps a finite `t_ready`, so wake-on-write only
    changes *when* it retries, never *whether* it can. The canonical
    state drops `blocked_a/b` and treats every non-done process as
    enabled: a strict superset of the schedules any seed can produce.
  * With `cs_kind=0` and `think=False` every random draw lands in
    timing fields, which the canonical state also drops, so transitions
    are deterministic given the fixed model key (`PRNGKey(model_seed)`
    as every step's key) and the exploration is exhaustive. Programs
    that branch on randomness (the DHT) are explored per fixed key.

Checked properties: safety (`violations` never increments on an edge),
deadlock/livelock freedom (every bottom SCC of the state graph is a
single all-done terminal), and completion (terminals have every
survivor at `target_acq` and no CS occupant). With `crash_victim=v`,
every state where v is alive and not done also has a crash transition
(v stops forever; its CS occupancy is released; its words go stale).

States are kept as their `canon_key` bytes (the reference's bytes:
int32 window, pc, regs, acquires and scalars; bool done and crashed;
int32 in_cs) and decoded a level at a time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine, prng

# Pseudo-pc labeling a crash transition in counterexample traces.
CRASH_PC = -99
# Most (state, process) lanes of one engine call.
LANE_BUDGET = 1 << 16


class Canon(NamedTuple):
    """Canonical (timing-free) logical state."""

    window: np.ndarray       # int32 [W]
    pc: np.ndarray           # int32 [P]
    regs: np.ndarray         # int32 [P, R]
    done: np.ndarray         # bool [P]
    acq: np.ndarray          # int32 [P]
    writer_active: np.ndarray  # int32 []
    reader_active: np.ndarray  # int32 []
    violations: np.ndarray   # int32 []
    # A crashed process is permanently disabled (its lease is modeled as
    # already expired). `in_cs` feeds both the crash transition's
    # occupancy release and the recovery guards.
    crashed: np.ndarray      # bool [P]
    in_cs: np.ndarray        # int32 [P]


_DTYPES = (np.int32, np.int32, np.int32, np.bool_, np.int32, np.int32,
           np.int32, np.int32, np.bool_, np.int32)


def canon_key(c: Canon) -> bytes:
    return b"".join(np.ascontiguousarray(x).tobytes() for x in c)


def canon_of_state(st: engine.SimState, lane: int = 0) -> Canon:
    """The canonical state of one lane of a port `SimState` (the port's
    int64 state cast to the reference's int32)."""
    def a(x, dt):
        return np.asarray(x[lane].cpu().numpy(), dt)

    return Canon(
        window=a(st.window, np.int32), pc=a(st.pc, np.int32),
        regs=a(st.regs, np.int32), done=a(st.done, bool),
        acq=a(st.acq_count, np.int32),
        writer_active=a(st.writer_active, np.int32),
        reader_active=a(st.reader_active, np.int32),
        violations=a(st.violations, np.int32),
        crashed=a(st.crashed, bool), in_cs=a(st.in_cs, np.int32))


def crash_canon(c: Canon, victim: int) -> Canon:
    """The canonical successor of `c` when `victim` crashes: disabled
    forever, CS occupancy released for accounting, window words left
    exactly as they are (they go stale)."""
    crashed = c.crashed.copy()
    crashed[victim] = True
    in_cs = c.in_cs.copy()
    wact = c.writer_active - (1 if int(in_cs[victim]) == 2 else 0)
    ract = c.reader_active - (1 if int(in_cs[victim]) == 1 else 0)
    in_cs[victim] = 0
    return c._replace(crashed=crashed, in_cs=in_cs,
                      writer_active=np.int32(wact),
                      reader_active=np.int32(ract))


class _Codec:
    """Canonical states as key bytes, many at a time: `encode` maps
    field arrays with a leading state axis to keys, `decode` back."""

    def __init__(self, c: Canon):
        self.shapes = [np.shape(x) for x in c]
        self.nbytes = [np.dtype(dt).itemsize * math.prod(s)
                       for dt, s in zip(_DTYPES, self.shapes)]
        self.size = sum(self.nbytes)

    def encode(self, cols) -> list:
        n = len(cols[0])
        rows = np.concatenate(
            [np.ascontiguousarray(np.asarray(x).astype(dt, copy=False))
             .view(np.uint8).reshape(n, -1)
             for x, dt in zip(cols, _DTYPES)], axis=1)
        b, s = rows.tobytes(), self.size
        return [b[i * s:(i + 1) * s] for i in range(n)]

    def decode(self, keys) -> Canon:
        """A Canon of [n, ...] arrays, one row per key."""
        n = len(keys)
        buf = np.frombuffer(b"".join(keys), np.uint8).reshape(n, self.size)
        out, o = [], 0
        for dt, s, nb in zip(_DTYPES, self.shapes, self.nbytes):
            out.append(buf[:, o:o + nb].copy().view(dt).reshape((n,) + s))
            o += nb
        return Canon(*out)

    @staticmethod
    def row(cols: Canon, i: int) -> Canon:
        return Canon(*(x[i] for x in cols))


def canon_state(env: engine.Env, cols: Canon) -> engine.SimState:
    """A SimState whose lanes are the canonical states `cols` ([n, ...]
    arrays), with the reference model's timing-free fields: nothing
    ready late, blocked or busy, backoff at its start, a crashed
    process's lease already expired (crash_t = -INF, now = 0), restart
    pc and registers the current ones."""
    dev, P, W = env.device, env.P, env.W
    n = len(cols.pc)
    f32, i64 = torch.float32, torch.int64

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def full(shape, v, dtype):
        return torch.full((n,) + shape, v, dtype=dtype, device=dev)

    pc, regs = t(cols.pc, i64), t(cols.regs, i64)
    crashed = t(cols.crashed, torch.bool)
    zero_f, zero_i = full((), 0.0, f32), full((), 0, i64)
    return engine.SimState(
        window=t(cols.window, i64), pc=pc, regs=regs,
        t_ready=full((P,), 0.0, f32),
        blocked_a=full((P,), -1, i64), blocked_b=full((P,), -1, i64),
        backoff=full((P,), float(np.float32(env.cost.backoff0)), f32),
        busy=full((W,), 0.0, f32), clock=zero_f, t_finish=zero_f,
        done=t(cols.done, torch.bool), events=zero_i,
        acq_count=t(cols.acq, i64), lat_sum=full((P,), 0.0, f32),
        t_attempt=full((P,), 0.0, f32),
        writer_active=t(cols.writer_active, i64),
        reader_active=t(cols.reader_active, i64),
        violations=t(cols.violations, i64), hold_rank=full((), -1, i64),
        local_passes=zero_i, total_passes=zero_i,
        crash_t=torch.where(crashed, -engine.INF, engine.INF).to(f32),
        revive_t=full((P,), engine.INF, f32), crashed=crashed,
        in_cs=t(cols.in_cs, i64), restart_pc=pc, restart_regs=regs,
        reclaims=zero_i, rec_retries=zero_i,
        t_recover=full((), engine.INF, f32))


def step_draws(env: engine.Env, prog: engine.Program, keys: torch.Tensor):
    """The draws of step keys `keys` ([n, 2]), one per lane, as the
    engine's key stream makes them from a step's subkey."""
    stream = engine._KeyStream(env, torch.zeros(1, dtype=torch.int64),
                               prog.draws)
    return stream.draws_of(keys)


@dataclasses.dataclass
class ModelFinding:
    """One property violation found by the explorer."""

    kind: str                 # "safety" | "stuck" | "incomplete"
    message: str
    trace: tuple = ()         # ((p, pc), ...) interleaving from init

    def render_trace(self, meta=None) -> str:
        if not self.trace:
            return "<init>"
        base = (meta.pc_name if meta is not None
                else lambda k: f"pc{k}")
        name = lambda k: "CRASH" if k == CRASH_PC else base(k)
        return " -> ".join(f"p{p}:{name(k)}" for p, k in self.trace)


@dataclasses.dataclass
class ExploreResult:
    n_states: int
    n_edges: int
    n_terminals: int
    capped: bool              # hit max_states; properties only cover
    findings: list            # the explored prefix when True
    pc_reached: set
    pc_successors: dict       # pc -> set of observed next pcs
    watch_words: dict         # pc -> set of observed watched words
    samples: dict             # pc -> [(Canon, p), ...]
    n_interleavings: int = 0
    interleavings_capped: bool = False
    levels: int = 0           # breadth-first levels expanded
    widest: int = 0           # lanes of the widest level's engine call

    @property
    def ok(self) -> bool:
        return not self.findings


class Explorer:
    """BFS over all interleavings of a program at one configuration.

    With `crash_victim=v`, every state where v is still alive (and not
    done) additionally has a crash transition: v stops forever, its CS
    occupancy is released for accounting, its window words stay as they
    are. The properties then become: survivors never violate exclusion
    and always complete. Runs with a crash victim use the program's
    full handler table, others its crash-free one (as `step_loop`
    chooses)."""

    def __init__(self, program, env, layout, *, max_states=200_000,
                 samples_per_pc=3, model_seed: int = 0,
                 crash_victim: int | None = None,
                 lane_budget: int = LANE_BUDGET):
        self.program = program
        self.env = env
        self.layout = layout
        self.handlers = program.build(env)
        self.max_states = int(max_states)
        self.samples_per_pc = int(samples_per_pc)
        self.P = int(env.P)
        self.target_acq = int(env.target_acq)
        self.crash_victim = (None if crash_victim is None
                             else int(crash_victim))
        self.faults = self.crash_victim is not None
        self.lane_budget = int(lane_budget)
        self._draws = step_draws(env, self.handlers, prng.PRNGKey(
            torch.tensor([int(model_seed)])))

    def init_canon(self) -> Canon:
        st0 = engine.init_state(
            self.env, self.layout, self.program.init_pc(self.env),
            self.program.n_regs, self.program.init_regs(self.env))
        return canon_of_state(st0)

    def successors(self, cols: Canon, ps: np.ndarray):
        """Run process ps[l] of state l (`cols`: [n, ...] arrays) for
        every lane: (successor Canon of [n, ...] arrays, the executing
        process's watch words block_a and block_b, each [n])."""
        n = len(ps)
        parts = [self._exec(Canon(*(x[s:s + self.lane_budget]
                                    for x in cols)),
                            ps[s:s + self.lane_budget])
                 for s in range(0, n, self.lane_budget)]
        return (Canon(*(np.concatenate(f) for f in zip(*(c for c, _ in parts)))),
                np.concatenate([w for _, w in parts]))

    def _exec(self, cols: Canon, ps: np.ndarray):
        env = self.env
        L, P = len(ps), self.P
        st = canon_state(env, cols)
        p = torch.as_tensor(ps, device=env.device).to(torch.int64)
        now = torch.zeros(L, dtype=torch.float32, device=env.device)
        on = torch.ones(L, dtype=torch.bool, device=env.device)
        with torch.inference_mode():
            nx = engine._exec(
                self.handlers, st, p, now,
                {k: v.expand(L) for k, v in self._draws.items()},
                engine._consts(env, L), self.faults, on, ~on)
            p1 = p[:, None]
            ints = torch.cat([
                nx.window, nx.pc, nx.regs.flatten(1), nx.acq_count,
                nx.writer_active[:, None], nx.reader_active[:, None],
                nx.violations[:, None], nx.in_cs,
                nx.blocked_a.gather(1, p1), nx.blocked_b.gather(1, p1)],
                1).cpu().numpy().astype(np.int32)
            bools = torch.cat([nx.done, nx.crashed], 1).cpu().numpy()
        W, R = env.W, cols.regs.shape[2]
        cut = np.cumsum([W, P, P * R, P, 1, 1, 1, P])
        win, pc, regs, acq, wact, ract, viol, in_cs, watch = np.split(
            ints, cut, axis=1)
        succ = Canon(win, pc, regs.reshape(L, P, R), bools[:, :P], acq,
                     wact[:, 0], ract[:, 0], viol[:, 0], bools[:, P:],
                     in_cs)
        return succ, watch

    # -------------------------------------------------------- explore
    def explore(self, *, count_paths_cap: int = 50_000) -> ExploreResult:
        c0 = self.init_canon()
        codec = _Codec(c0)
        k0 = canon_key(c0)
        states = {k0: None}           # insertion-ordered key set
        parents = {k0: None}          # key -> (parent_key, p, pc)
        graph = {}                    # key -> [(p, succ_key), ...]
        pc_reached, pc_succ, watch = set(), {}, {}
        samples = {}
        findings = []
        n_edges = 0
        capped = False
        levels = widest = 0
        v = self.crash_victim

        level = [k0]
        while level and not capped:
            cols = codec.decode(level)
            rows, ps = np.nonzero(~(cols.done | cols.crashed))
            levels += 1
            widest = max(widest, len(rows))
            if len(rows):
                succ, wa = self.successors(Canon(*(x[rows] for x in cols)),
                                           ps)
                keys = codec.encode(succ)
                lanes = np.arange(len(rows))
                k_exec = cols.pc[rows, ps].tolist()
                nxt_pc = succ.pc[lanes, ps].tolist()
                viol_up = (succ.violations > cols.violations[rows]).tolist()
                wa = wa.tolist()
                ps_l = ps.tolist()
            if v is not None:
                can_crash = (~cols.crashed[:, v] & ~cols.done[:, v]).tolist()
                crashed = cols.crashed.copy()
                crashed[:, v] = True
                in_cs = cols.in_cs.copy()
                in_cs[:, v] = 0
                crash_keys = codec.encode(cols._replace(
                    crashed=crashed, in_cs=in_cs,
                    writer_active=cols.writer_active
                    - (cols.in_cs[:, v] == 2),
                    reader_active=cols.reader_active
                    - (cols.in_cs[:, v] == 1)))
            starts = np.searchsorted(rows, np.arange(len(level) + 1)).tolist()
            nxt = []
            for i, k in enumerate(level):
                edges = graph[k] = []
                if v is not None and can_crash[i]:
                    nk = crash_keys[i]
                    n_edges += 1
                    edges.append((v, nk))
                    if nk not in states:
                        states[nk] = None
                        parents[nk] = (k, v, CRASH_PC)
                        if len(states) >= self.max_states:
                            capped = True
                            break
                        nxt.append(nk)
                for j in range(starts[i], starts[i + 1]):
                    p, ke = ps_l[j], k_exec[j]
                    pc_reached.add(ke)
                    nk = keys[j]
                    n_edges += 1
                    edges.append((p, nk))
                    pc_succ.setdefault(ke, set()).add(nxt_pc[j])
                    for b in wa[j]:
                        if b >= 0:
                            watch.setdefault(ke, set()).add(b)
                    bucket = samples.setdefault(ke, [])
                    if len(bucket) < self.samples_per_pc:
                        bucket.append((codec.row(cols, i), p))
                    if viol_up[j]:
                        findings.append(ModelFinding(
                            kind="safety",
                            message=(f"exclusion violation when p{p} "
                                     f"executes pc {ke}"),
                            trace=self._trace_of(parents, k) + ((p, ke),)))
                    if nk not in states:
                        states[nk] = None
                        parents[nk] = (k, p, ke)
                        if len(states) >= self.max_states:
                            capped = True
                            break
                        nxt.append(nk)
                if capped:
                    break
            level = nxt

        leaves = [k for k, succs in graph.items() if not succs]
        terminals = []
        if leaves:
            lc = codec.decode(leaves)
            for i, k in enumerate(leaves):
                c = codec.row(lc, i)
                if not bool((c.done | c.crashed).all()):
                    continue
                terminals.append(k)
                if (int(c.writer_active) != 0 or int(c.reader_active) != 0):
                    findings.append(ModelFinding(
                        kind="incomplete",
                        message=(f"terminal state with active CS occupants "
                                 f"(writer={int(c.writer_active)}, "
                                 f"reader={int(c.reader_active)})"),
                        trace=self._trace_of(parents, k)))
                survivors_ok = bool(
                    ((c.acq == self.target_acq) | c.crashed).all())
                if not survivors_ok:
                    findings.append(ModelFinding(
                        kind="incomplete",
                        message=(f"terminal state with acquire counts "
                                 f"{c.acq.tolist()} != target "
                                 f"{self.target_acq} (crashed="
                                 f"{c.crashed.tolist()})"),
                        trace=self._trace_of(parents, k)))

        if not capped:
            findings.extend(self._stuck_findings(codec, parents, graph))

        if capped:
            # A truncated graph has few complete root->terminal paths;
            # the DFS would mostly wander the frontier. Skip it.
            n_paths, paths_capped = 0, True
        else:
            n_paths, paths_capped = _count_interleavings(
                graph, k0, set(terminals), cap=count_paths_cap)

        return ExploreResult(
            n_states=len(states), n_edges=n_edges,
            n_terminals=len(terminals), capped=capped,
            findings=findings, pc_reached=pc_reached,
            pc_successors=pc_succ, watch_words=watch, samples=samples,
            n_interleavings=n_paths, interleavings_capped=paths_capped,
            levels=levels, widest=widest)

    # ------------------------------------------------------- internals
    @staticmethod
    def _trace_of(parents, key, limit=80):
        steps = []
        k = key
        while parents.get(k) is not None:
            k, p, pc = parents[k]
            steps.append((p, pc))
        steps.reverse()
        return tuple(steps[-limit:])

    def _stuck_findings(self, codec, parents, graph):
        """Bottom SCCs that are not all-done terminals = states from
        which no schedule (not even timeout retries) completes."""
        findings = []
        for scc in _bottom_sccs(graph):
            rep = next(iter(scc))
            c = codec.row(codec.decode([rep]), 0)
            if len(scc) == 1 and bool((c.done | c.crashed).all()):
                continue              # a proper terminal
            waiting = [p for p in range(self.P)
                       if not c.done[p] and not c.crashed[p]]
            pcs = sorted({int(x) for x in
                          codec.decode(list(scc)).pc[:, waiting].ravel()})
            findings.append(ModelFinding(
                kind="stuck",
                message=(f"deadlock/livelock: {len(scc)} state(s) with "
                         f"no path to completion; waiting procs "
                         f"{waiting} cycle through pcs {pcs}"),
                trace=self._trace_of(parents, rep)))
        return findings


def _bottom_sccs(graph):
    """Tarjan SCCs (iterative); yield SCCs with no edge leaving them."""
    index = {}
    low = {}
    onstack = {}
    stack = []
    sccs = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(graph.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        onstack[root] = True
        while work:
            v, it = work[-1]
            advanced = False
            for _, w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    onstack[w] = True
                    work.append((w, iter(graph.get(w, ()))))
                    advanced = True
                    break
                if onstack.get(w):
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                u = work[-1][0]
                low[u] = min(low[u], low[v])
            if low[v] == index[v]:
                scc = set()
                while True:
                    w = stack.pop()
                    onstack[w] = False
                    scc.add(w)
                    if w == v:
                        break
                sccs.append(scc)

    # Callers only run this on uncapped explorations, where BFS has
    # expanded every state, so each successor key appears in `graph`.
    for scc in sccs:
        if all(w in scc for v in scc for _, w in graph.get(v, ())):
            yield scc


def _count_interleavings(graph, root, terminals, *, cap=50_000,
                         step_cap=2_000_000):
    """Count distinct maximal interleavings (paths root -> terminal),
    skipping on-path cycles, up to `cap` paths (and `step_cap` DFS
    steps, so cyclic graphs with few terminals stay bounded). Returns
    (count, capped)."""
    if root in terminals:
        return 1, False
    count = 0
    steps = 0
    onpath = {root}
    stack = [(root, iter(graph.get(root, ())))]
    while stack:
        steps += 1
        if count >= cap or steps >= step_cap:
            return count, True
        node, it = stack[-1]
        nxt = next(it, None)
        if nxt is None:
            stack.pop()
            onpath.discard(node)
            continue
        _, succ = nxt
        if succ in onpath:
            continue
        if succ in terminals:
            count += 1
            continue
        if succ not in graph:
            continue                  # unexplored frontier (capped run)
        onpath.add(succ)
        stack.append((succ, iter(graph.get(succ, ()))))
    return count, False

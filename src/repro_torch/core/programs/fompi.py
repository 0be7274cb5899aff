"""State-of-the-art comparison targets from foMPI (Gerstenberger et al.,
SC'13), the paper's §5 baselines, as lane-batched instruction handlers.

  * foMPI-Spin — a CAS spin lock over one global word (mutual exclusion
    only). Topology-oblivious and centralized: contention at the lock
    word is what limits it at scale (paper §5.1).
  * foMPI-RW   — a centralized reader-writer lock: a shared reader
    counter plus a writer flag, both on one rank. Readers FAO the
    counter then verify the flag; writers CAS the flag then wait for the
    counter to drain.

Counterpart of `repro.core.programs.fompi`; each handler computes, for
every lane at once, what the reference handler computes for one. The
baselines live in the window's scratch region, addressed through
`env.scratch_w` slots.

Crash recovery (lease-based): lock words store the OWNER'S id (p+1), so
a waiter that finds the word held asks the lease oracle
(`engine.leases_expired`) whether that exact owner is dead. The reclaim
is a separate recovery instruction that re-validates the guard in its
own atomic step, so a release racing the detection costs a bounded
retry (Metrics.recovery_retries), never a wrong reclaim.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (CS, DONE, Ctx, Effect, Env, Instr,
                                     Program, where as _w)
from repro_torch.core.programs.meta import SEG_SCRATCH, ProgramMeta

# foMPI-Spin PCs.
S_TRY, S_CS, S_REL, S_DONE, S_REC = 0, 1, 2, 3, 4
# foMPI-RW PCs.
W_TRY, W_WAITR, W_CS, W_REL, W_DONE = 0, 1, 2, 3, 4
R_INC, R_CHECK, R_UNDO, R_CS, R_REL, R_DONE = 5, 6, 7, 8, 9, 10
W_REC, R_REC, W_DRAIN = 11, 12, 13


def _owner_dead(c: Ctx, word_val: torch.Tensor) -> torch.Tensor:
    """True iff `word_val` encodes an owner id whose lease expired
    (constant False in the crash-free variant, see `engine.Program`)."""
    if c.crash_free:
        return c.const(False)
    owner = (word_val - 1).clamp(0, c.env.P - 1)
    return (word_val > 0) & c.expired.gather(1, owner[:, None])[:, 0]


class FompiSpin:
    """CAS spin lock on scratch slot `lock_slot`."""

    n_regs = 2

    def __init__(self, lock_slot: int = 0):
        self.lock_slot = int(lock_slot)

    def init_pc(self, env: Env):
        return np.zeros(env.P, np.int32)

    def init_regs(self, env: Env):
        return np.zeros((env.P, self.n_regs), np.int32)

    def meta(self, env: Env) -> ProgramMeta:
        """Declared program shape (the reference's locklint contract)."""
        return ProgramMeta(
            name="fompi_spin", n_pcs=5, n_regs=self.n_regs,
            pc_names=("S_TRY", "S_CS", "S_REL", "S_DONE", "S_REC"),
            dead_pcs=frozenset(),
            cs_enter_pcs=frozenset({S_CS}),
            cs_exit_pcs=frozenset({S_REL}),
            done_pcs=frozenset({S_DONE}),
            blocking_pcs=frozenset({S_TRY}),
            segments=(SEG_SCRATCH,),
            scratch_slots=(self.lock_slot,),
            recovery_pcs=frozenset({S_REC}))

    def build(self, env: Env) -> Program:
        LW = env.scratch_w[self.lock_slot]

        def s_try(c: Ctx):
            cur = c.win(LW)
            pid = c.p + 1
            # cur == p+1 happens only after this process crashed holding
            # the lock and revived before anyone reclaimed it.
            got = (cur == 0) | (cur == pid)
            dead = _owner_dead(c, cur) & ~got
            return Effect(dur=c.lat_atomic(LW), hot=LW, writes=(LW,),
                          next_pc=_w(got, S_CS, _w(dead, S_REC, S_TRY)),
                          stores=((LW, _w(got, pid, cur)),),
                          block_a=_w(got | dead, -1, LW))

        def s_cs(c: Ctx):
            return Effect(next_pc=S_REL)

        def s_rel(c: Ctx):
            return Effect(dur=c.lat_atomic(LW), hot=LW, writes=(LW,),
                          next_pc=S_DONE, stores=((LW, 0),),
                          cs_exit=True)

        def s_done(c: Ctx):
            return Effect(next_pc=S_TRY)

        def s_rec(c: Ctx):
            # Atomic re-validate + reclaim: CAS(dead-owner-id -> p+1).
            cur = c.win(LW)
            dead = _owner_dead(c, cur)
            return Effect(dur=c.lat_atomic(LW), hot=LW, writes=(LW,),
                          next_pc=_w(dead, S_CS, S_TRY),
                          stores=((LW, _w(dead, c.p + 1, cur)),),
                          reclaimed=dead, retried=~dead)

        return Program(env, (Instr(s_try), Instr(s_cs, CS), Instr(s_rel),
                             Instr(s_done, DONE), Instr(s_rec)))


class FompiRW:
    """Centralized reader-writer lock: RCNT + WFLAG scratch slots."""

    n_regs = 2

    def __init__(self, rcnt_slot: int = 0, wflag_slot: int = 1):
        self.rcnt_slot = int(rcnt_slot)
        self.wflag_slot = int(wflag_slot)

    def init_pc(self, env: Env):
        pc = np.full(env.P, R_INC, np.int32)
        pc[env.is_writer.cpu().numpy()] = W_TRY
        return pc

    def init_regs(self, env: Env):
        return np.zeros((env.P, self.n_regs), np.int32)

    def meta(self, env: Env) -> ProgramMeta:
        """Declared program shape (the reference's locklint contract)."""
        writers = env.is_writer.cpu().numpy()
        dead = set()
        if not writers.any():
            dead |= {W_TRY, W_WAITR, W_CS, W_REL, W_DONE, W_REC, W_DRAIN}
        if writers.all():
            dead |= {R_INC, R_CHECK, R_UNDO, R_CS, R_REL, R_DONE, R_REC}
        return ProgramMeta(
            name="fompi_rw", n_pcs=14, n_regs=self.n_regs,
            pc_names=("W_TRY", "W_WAITR", "W_CS", "W_REL", "W_DONE",
                      "R_INC", "R_CHECK", "R_UNDO", "R_CS", "R_REL",
                      "R_DONE", "W_REC", "R_REC", "W_DRAIN"),
            dead_pcs=frozenset(dead),
            cs_enter_pcs=frozenset({W_CS, R_CS}),
            cs_exit_pcs=frozenset({W_REL, R_REL}),
            done_pcs=frozenset({W_DONE, R_DONE}),
            blocking_pcs=frozenset({W_TRY, W_WAITR, R_UNDO}),
            segments=(SEG_SCRATCH,),
            scratch_slots=(self.rcnt_slot, self.wflag_slot),
            recovery_pcs=frozenset({W_REC, R_REC, W_DRAIN} - dead))

    def build(self, env: Env) -> Program:
        RC = env.scratch_w[self.rcnt_slot]
        WF = env.scratch_w[self.wflag_slot]

        def readers_quiescent(c: Ctx):
            # True iff no live reader can hold an arrival on RC: every
            # reader is done, lease-expired, or at a pc with no
            # outstanding arrival (R_INC is pre-FAO, R_DONE is past the
            # release). Residual RC then belongs to dead readers only.
            def f():
                free = c.pc_is(R_INC) | c.pc_is(R_DONE)
                return (env.is_writer | c.st.done | c.expired | free).all(1)
            return c.memo("readers_quiescent", f)

        def w_try(c: Ctx):
            cur = c.win(WF)
            pid = c.p + 1
            got = (cur == 0) | (cur == pid)
            dead = _owner_dead(c, cur) & ~got
            return Effect(dur=c.lat_atomic(WF), hot=WF, writes=(WF,),
                          next_pc=_w(got, W_WAITR, _w(dead, W_REC, W_TRY)),
                          stores=((WF, _w(got, pid, cur)),),
                          block_a=_w(got | dead, -1, WF))

        def w_waitr(c: Ctx):
            drained = c.win(RC) == 0
            stale = ~drained & readers_quiescent(c)
            return Effect(dur=c.lat_plain(RC),
                          next_pc=_w(drained, W_CS,
                                     _w(stale, W_DRAIN, W_WAITR)),
                          block_a=_w(drained | stale, -1, RC))

        def w_cs(c: Ctx):
            return Effect(next_pc=W_REL)

        def w_rel(c: Ctx):
            return Effect(dur=c.lat_atomic(WF), hot=WF, writes=(WF,),
                          next_pc=W_DONE, stores=((WF, 0),), cs_exit=True)

        def w_done(c: Ctx):
            return Effect(next_pc=W_TRY)

        def r_inc(c: Ctx):
            return Effect(dur=c.lat_atomic(RC), hot=RC, writes=(RC,),
                          next_pc=R_CHECK, stores=((RC, c.win(RC) + 1),))

        def r_check(c: Ctx):
            f = c.win(WF)
            dead = _owner_dead(c, f)
            return Effect(dur=c.lat_plain(WF),
                          next_pc=_w(f == 0, R_CS,
                                     _w(dead, R_REC, R_UNDO)))

        def r_undo(c: Ctx):
            return Effect(dur=c.lat_atomic(RC), hot=RC, writes=(RC,),
                          next_pc=R_INC, stores=((RC, c.win(RC) - 1),),
                          block_a=WF)

        def r_cs(c: Ctx):
            return Effect(next_pc=R_REL)

        def r_rel(c: Ctx):
            return Effect(dur=c.lat_atomic(RC), hot=RC, writes=(RC,),
                          next_pc=R_DONE, stores=((RC, c.win(RC) - 1),),
                          cs_exit=True)

        def r_done(c: Ctx):
            return Effect(next_pc=R_INC)

        def w_rec(c: Ctx):
            # Atomic re-validate + steal the dead writer's flag.
            cur = c.win(WF)
            dead = _owner_dead(c, cur)
            return Effect(dur=c.lat_atomic(WF), hot=WF, writes=(WF,),
                          next_pc=_w(dead, W_WAITR, W_TRY),
                          stores=((WF, _w(dead, c.p + 1, cur)),),
                          reclaimed=dead, retried=~dead)

        def r_rec(c: Ctx):
            # Reader clears a dead writer's flag; its own arrival is
            # still counted in RC, so on re-check it proceeds to CS.
            cur = c.win(WF)
            dead = _owner_dead(c, cur)
            return Effect(dur=c.lat_atomic(WF), hot=WF, writes=(WF,),
                          next_pc=R_CHECK,
                          stores=((WF, _w(dead, 0, cur)),),
                          reclaimed=dead, retried=~dead)

        def w_drain(c: Ctx):
            # Atomic re-validate + zero the reader counter: every
            # residual arrival provably belongs to a lease-expired
            # reader (the quiescence guard).
            r = c.win(RC)
            stale = (r != 0) & readers_quiescent(c)
            drained = r == 0
            return Effect(dur=c.lat_atomic(RC), hot=RC, writes=(RC,),
                          next_pc=_w(stale | drained, W_CS, W_WAITR),
                          stores=((RC, _w(stale, 0, r)),),
                          reclaimed=stale, retried=~(stale | drained))

        return Program(env, (
            Instr(w_try), Instr(w_waitr), Instr(w_cs, CS), Instr(w_rel),
            Instr(w_done, DONE), Instr(r_inc), Instr(r_check),
            Instr(r_undo), Instr(r_cs, CS), Instr(r_rel),
            Instr(r_done, DONE), Instr(w_rec), Instr(r_rec),
            Instr(w_drain)))

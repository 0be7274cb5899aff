"""Seeded protocol mutations of foMPI-Spin, one per locklint pass.

Each mutant breaks one instruction of `FompiSpin` the way a real
refactor could, and one pass of the analyzer owns the bug:

  * `DroppedExitSpin`   — the release clears the lock word but drops
    the CS-exit accounting: the model pass finds a safety violation.
  * `StuckReleaseSpin`  — the release forgets to clear the lock word:
    every later acquire spins forever, the model pass finds a stuck
    bottom SCC (a liveness bug, not a safety one).
  * `MisaimedWakeSpin`  — the spin watches scratch slot 1, which nothing
    writes: the wakeup pass finds a lost wakeup.
  * `OutOfSegmentSpin`  — the CS reads a counter word the program never
    declared: the bounds pass finds the stray word.

They are the counterparts of the reference's test mutants
(`tests/test_locklint.py`), written as `Effect` handlers.
`OWNERS` maps each to the finding that must catch it.
"""
from __future__ import annotations

from repro_torch.core.engine import Effect, Instr, Program, where as _w
from repro_torch.core.programs.fompi import (S_CS, S_DONE, S_REL, S_TRY,
                                             FompiSpin)


def _replace(prog: Program, env, pc: int, fn) -> Program:
    instrs = list(prog.full)
    instrs[pc] = Instr(fn, instrs[pc].kind)
    return Program(env, instrs)


class DroppedExitSpin(FompiSpin):
    """Release clears the word but forgets the cs_exit accounting."""

    def build(self, env) -> Program:
        LW = env.scratch_w[self.lock_slot]

        def s_rel(c):
            return Effect(dur=c.lat_atomic(LW), hot=LW, writes=(LW,),
                          next_pc=S_DONE, stores=((LW, 0),))
        return _replace(super().build(env), env, S_REL, s_rel)


class StuckReleaseSpin(FompiSpin):
    """Release forgets to clear the lock word."""

    def build(self, env) -> Program:
        LW = env.scratch_w[self.lock_slot]

        def s_rel(c):
            return Effect(dur=c.lat_atomic(LW), next_pc=S_DONE,
                          cs_exit=True)
        return _replace(super().build(env), env, S_REL, s_rel)


class MisaimedWakeSpin(FompiSpin):
    """The spin watches scratch slot 1, which nothing ever writes."""

    def build(self, env) -> Program:
        LW = env.scratch_w[self.lock_slot]
        WRONG = env.scratch_w[1]

        def s_try(c):
            cur = c.win(LW)
            got = cur == 0
            return Effect(dur=c.lat_atomic(LW), hot=LW, writes=(LW,),
                          next_pc=_w(got, S_CS, S_TRY),
                          stores=((LW, _w(got, 1, cur)),),
                          block_a=_w(got, -1, WRONG))
        return _replace(super().build(env), env, S_TRY, s_try)


class OutOfSegmentSpin(FompiSpin):
    """The CS body reads a counter word the program never declared."""

    def build(self, env) -> Program:
        prog = super().build(env)
        orig = prog.full[S_CS].fn
        counter0 = int(env.ext["arrive"][0])      # arrive_w[0]

        def s_cs(c):
            c.win(counter0)                      # noted by the recorder
            return orig(c)
        return _replace(prog, env, S_CS, s_cs)


# Mutant -> (pass name, a word its finding's message must hold).
OWNERS = {
    DroppedExitSpin: ("model", "safety"),
    StuckReleaseSpin: ("model", "stuck"),
    MisaimedWakeSpin: ("wakeup", "lost wakeup"),
    OutOfSegmentSpin: ("bounds", ""),
}


def caught(mutant: type, findings) -> bool:
    """Whether the pass that owns `mutant`'s bug reported it."""
    pass_name, word = OWNERS[mutant]
    return any(f.pass_name == pass_name and word in f.message
               for f in findings)

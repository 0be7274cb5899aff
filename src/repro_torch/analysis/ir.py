"""Instruction-level IR extracted from the lock programs.

Counterpart of `repro.analysis.ir`. The programs ship no syntax to
analyze — each instruction is a Python closure over torch ops returning
an `engine.Effect`. The extractor recovers a checkable IR per pc by
*replaying* the closure on recorded inputs: for a handful of sampled
model states per pc (and several PRNG keys, so key-dependent branches
like the DHT's are all taken at least once), `repro_torch.analysis.trace`
runs every replay as a lane of one call over a recording Ctx and
collects

  * the observed window-word read/write footprint and register indices,
  * the declared effects (hot word, declared writes, successor pc,
    watch words) — these are exact,
  * whether the instruction entered/exited the critical section.

The union over samples approximates each instruction's footprint and
CFG edges; `repro_torch.analysis.lints` checks it against the program's
declared `ProgramMeta` and the window `Layout`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import prng


@dataclasses.dataclass
class InstrIR:
    """Merged observation of one instruction (program counter)."""

    pc: int
    name: str
    n_samples: int = 0
    reads: set = dataclasses.field(default_factory=set)
    writes: set = dataclasses.field(default_factory=set)
    declared_writes: set = dataclasses.field(default_factory=set)
    hot_words: set = dataclasses.field(default_factory=set)
    watch_words: set = dataclasses.field(default_factory=set)
    successors: set = dataclasses.field(default_factory=set)
    reg_reads: set = dataclasses.field(default_factory=set)
    reg_writes: set = dataclasses.field(default_factory=set)
    regs_row_lens: set = dataclasses.field(default_factory=set)
    enters_cs: bool = False
    exits_cs: bool = False

    @property
    def atomic_words(self):
        """Words accessed under an occupancy charge (RMA atomics)."""
        return {w for w in self.hot_words if w >= 0}

    @property
    def all_words(self):
        """Every window word this instruction touched or declared."""
        out = set(self.reads) | set(self.writes) | set(self.declared_writes)
        out |= self.atomic_words | set(self.watch_words)
        return out


@dataclasses.dataclass
class ProgramIR:
    name: str
    instrs: dict                  # pc -> InstrIR
    pc_reached: set               # from the model explorer
    pc_successors: dict           # pc -> set(pc), model-observed edges

    def cfg_successors(self, pc: int) -> set:
        """Model edges + declared/replayed successors for pc."""
        out = set(self.pc_successors.get(pc, ()))
        ir = self.instrs.get(pc)
        if ir is not None:
            out |= set(ir.successors)
        return out


def extract(program, env, layout, explore_result, *, meta=None,
            n_keys: int = 4) -> ProgramIR:
    """Build the ProgramIR from a model-exploration's per-pc samples:
    every (pc, sample, key) replay is a lane of one call."""
    from repro_torch.analysis import trace

    if meta is None:
        meta = program.meta(env)
    handlers = program.build(env)
    keys = prng.PRNGKey(list(range(n_keys)))
    items = [(canon, pc, p, key)
             for pc, samples in sorted(explore_result.samples.items())
             for canon, p in samples for key in keys]
    recs = iter(trace.record_steps(handlers, env, layout, items)
                if items else ())
    instrs = {}
    for pc, samples in sorted(explore_result.samples.items()):
        ir = InstrIR(pc=pc, name=meta.pc_name(pc))
        for canon, p in samples:
            for _ in keys:
                rec = next(recs)
                ir.n_samples += 1
                ir.reads |= rec.window_reads
                ir.writes |= rec.window_writes
                ir.declared_writes |= {w for w in rec.declared_writes
                                       if w >= 0}
                ir.hot_words.add(rec.hot_word)
                ir.watch_words |= rec.block_words
                ir.successors.add(rec.next_pc)
                ir.reg_reads |= rec.reg_reads
                ir.reg_writes |= rec.reg_writes
                if rec.regs_row_len is not None:
                    ir.regs_row_lens.add(rec.regs_row_len)
                ir.enters_cs |= rec.entered_cs
                ir.exits_cs |= rec.exited_cs
        instrs[pc] = ir
    for pc, watched in explore_result.watch_words.items():
        if pc in instrs:
            instrs[pc].watch_words |= set(watched)
    return ProgramIR(name=meta.name, instrs=instrs,
                     pc_reached=set(explore_result.pc_reached),
                     pc_successors={k: set(v) for k, v in
                                    explore_result.pc_successors.items()})

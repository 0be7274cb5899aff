"""Static program metadata, the contract of each instruction program.

Every instruction program exposes a `meta(env)` method returning a
`ProgramMeta`: the program's own declaration of its shape — pc names,
which pcs enter/leave the critical section, which may block, which are
dead for the given environment (e.g. reader pcs of a writers-only
lock), and which `Layout` segments its address expressions are allowed
to touch. The analyzer checks the *observed* behavior of the compiled
handlers against this declaration, so a refactor that silently grows a
program's footprint (or orphans an instruction) fails the lint rather
than shipping.

The metadata is intentionally redundant with the handler code — that is
the point: it is the contract the static analyzer holds the handlers
to.
"""
from __future__ import annotations

import dataclasses

# Layout segment names (the segments a program's addresses may touch).
SEG_QUEUES = "queues"        # next/status/tail words of every level
SEG_COUNTERS = "counters"    # live (non-padded) arrive/depart words
SEG_SCRATCH = "scratch"      # layout.scratch_w (baselines, DHT, payloads)
KNOWN_SEGMENTS = (SEG_QUEUES, SEG_COUNTERS, SEG_SCRATCH)


@dataclasses.dataclass(frozen=True)
class ProgramMeta:
    """Declared shape of one instruction program under one env.

    Attributes:
      name: short program identifier for findings.
      n_pcs: number of instruction slots (len of the handler tuple).
      n_regs: register-file width.
      pc_names: one human-readable name per pc, len == n_pcs.
      dead_pcs: pcs that must NEVER execute under this env — unused
        trap slots plus role/level-disabled instructions (e.g. reader
        pcs when has_readers=False, unwind pcs on a 1-level machine).
      cs_enter_pcs: pcs whose handler calls `cs_enter`.
      cs_exit_pcs: pcs whose handler may call `cs_exit`.
      done_pcs: pcs that perform completion accounting (acq_count/done).
      blocking_pcs: pcs that may block (set a watch word).
      segments: Layout segment names this program may address; all
        observed window accesses must fall inside their word sets.
      scratch_slots: scratch slot indices addressed via env.scratch_w
        (checked against the layout's extra_words).
      recovery_pcs: pcs implementing lease-based crash recovery. They
        must be unreachable in a crash-free exploration, and from every
        one of them the observed CFG must reach a done pc (a recovery
        path that cannot complete is a wedge, not a repair) — both
        checked by lints.check_recovery.
    """

    name: str
    n_pcs: int
    n_regs: int
    pc_names: tuple
    dead_pcs: frozenset
    cs_enter_pcs: frozenset
    cs_exit_pcs: frozenset
    done_pcs: frozenset
    blocking_pcs: frozenset
    segments: tuple
    scratch_slots: tuple = ()
    recovery_pcs: frozenset = frozenset()

    def __post_init__(self):
        if len(self.pc_names) != self.n_pcs:
            raise ValueError(
                f"{self.name}: pc_names has {len(self.pc_names)} entries "
                f"for n_pcs={self.n_pcs}")
        for seg in self.segments:
            if seg not in KNOWN_SEGMENTS:
                raise ValueError(
                    f"{self.name}: unknown layout segment {seg!r} "
                    f"(known: {KNOWN_SEGMENTS})")

    @property
    def live_pcs(self) -> frozenset:
        return frozenset(range(self.n_pcs)) - self.dead_pcs

    def pc_name(self, pc: int) -> str:
        if 0 <= pc < self.n_pcs:
            return f"{self.pc_names[pc]}({pc})"
        return f"<invalid pc {pc}>"

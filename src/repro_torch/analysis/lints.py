"""Lint passes over window layouts and extracted program IR.

Counterpart of `repro.analysis.lints`, the same passes and the same
finding texts over the port's `Layout` and `ProgramMeta`.

Three families:

  * layout lints — pure-numpy invariants of a `window.Layout` (words
    partition the window, counters padded correctly, scratch last,
    owners in range). Cheap: run over a wide (T_DC, fanout, Machine)
    lattice without simulating anything.
  * bounds lints — every window word an instruction touched (observed
    footprint + declared effects) lies inside the window, inside the
    program's declared segments, and never on a padded dead counter
    slot; register indices stay inside the register file.
  * structural lints — declared vs observed critical-section behavior,
    no dead instruction executes, live instructions are reachable
    (checked on the union of configs), every acquire path releases
    before completing, and every watched (spin) word is written by some
    other instruction — the lost-wakeup lint.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.programs.meta import (SEG_COUNTERS, SEG_QUEUES,
                                            SEG_SCRATCH, ProgramMeta)
from repro_torch.core.window import Layout, padded_level_table


@dataclasses.dataclass
class Finding:
    """One lint/model finding, printable for the CLI."""

    pass_name: str           # "layout" | "bounds" | "structure" |
                             # "wakeup" | "model"
    program: str
    message: str
    config: str = ""
    pc: int | None = None
    pc_name: str = ""

    def __str__(self):
        loc = f" @ {self.pc_name or self.pc}" if self.pc is not None else ""
        cfg = f" [{self.config}]" if self.config else ""
        return f"{self.pass_name}:{self.program}{cfg}{loc}: {self.message}"


def _ints(arr):
    return {int(x) for x in np.asarray(arr).ravel()}


def segment_words(layout: Layout, meta: ProgramMeta) -> set:
    """Window words the program's declared segments may touch."""
    allowed = set()
    for seg in meta.segments:
        if seg == SEG_QUEUES:
            for tabs in (layout.next_w, layout.status_w, layout.tail_w):
                for t in tabs:
                    allowed |= _ints(t)
        elif seg == SEG_COUNTERS:
            live = np.asarray(layout.ctr_mask)
            allowed |= _ints(np.asarray(layout.arrive_w)[live])
            allowed |= _ints(np.asarray(layout.depart_w)[live])
        elif seg == SEG_SCRATCH:
            sw = np.asarray(layout.scratch_w)
            if meta.scratch_slots:
                allowed |= {int(sw[s]) for s in meta.scratch_slots}
            else:
                allowed |= _ints(sw)
    return allowed


def dead_counter_words(layout: Layout) -> set:
    """Padded counter slots (ctr_mask == False): allocated but dead —
    no protocol may ever read or write them."""
    pad = ~np.asarray(layout.ctr_mask)
    return (_ints(np.asarray(layout.arrive_w)[pad])
            | _ints(np.asarray(layout.depart_w)[pad]))


# --------------------------------------------------------------- layout
def check_layout(layout: Layout, machine, config: str = "") -> list:
    """Static invariants of one built Layout."""
    out = []

    def bad(msg):
        out.append(Finding("layout", "window", msg, config=config))

    W = int(layout.W)
    allocated = []
    for tabs in (layout.next_w, layout.status_w, layout.tail_w):
        for t in tabs:
            allocated.extend(int(x) for x in np.asarray(t))
    allocated.extend(int(x) for x in np.asarray(layout.arrive_w))
    allocated.extend(int(x) for x in np.asarray(layout.depart_w))
    allocated.extend(int(x) for x in np.asarray(layout.scratch_w))
    if len(allocated) != len(set(allocated)):
        bad("layout tables alias: some window word is allocated twice")
    if set(allocated) != set(range(W)):
        missing = sorted(set(range(W)) - set(allocated))[:5]
        extra = sorted(set(allocated) - set(range(W)))[:5]
        bad(f"layout tables do not partition [0, {W}): "
            f"missing {missing}, out-of-range {extra}")
    if len(np.asarray(layout.owner)) != W or len(np.asarray(layout.init)) != W:
        bad("owner/init length != W")
    owners = np.asarray(layout.owner)
    if owners.size and (owners.min() < 0 or owners.max() >= machine.P):
        bad(f"word owner outside [0, {machine.P})")

    C = int(layout.C)
    mask = np.asarray(layout.ctr_mask)
    if not (mask[:C].all() and not mask[C:].any()):
        bad(f"ctr_mask is not [True]*{C} + [False]*pad: {mask.tolist()}")
    cofp = np.asarray(layout.ctr_of_p)
    if cofp.size and (cofp.min() < 0 or cofp.max() >= C):
        bad(f"ctr_of_p escapes the live counters: max {cofp.max()} "
            f">= C={C}")
    ranks = np.asarray(layout.ctr_rank)
    if ranks.size and (ranks.min() < 0 or ranks.max() >= machine.P):
        bad("ctr_rank outside [0, P)")

    sw = np.asarray(layout.scratch_w)
    if sw.size and sw.tolist() != list(range(W - sw.size, W)):
        bad(f"scratch words are not the last {sw.size} of the window: "
            f"{sw.tolist()}")

    for attr in ("next_w", "status_w", "tail_w"):
        padded = padded_level_table(layout, attr)
        tabs = getattr(layout, attr)
        for i, t in enumerate(tabs):
            row = padded[i]
            if not (row[:len(t)] == np.asarray(t)).all():
                bad(f"padded_level_table({attr}) mangles level {i}")
            if (row[len(t):] != -1).any():
                bad(f"padded_level_table({attr}) pad of level {i} "
                    f"is not -1")
    return out


# --------------------------------------------------------------- bounds
def check_bounds(pir, layout: Layout, meta: ProgramMeta,
                 config: str = "") -> list:
    """Observed + declared footprints stay inside the window, inside
    the declared segments, and off the padded dead counter slots."""
    out = []
    allowed = segment_words(layout, meta)
    dead_words = dead_counter_words(layout)
    W = int(layout.W)
    for pc, ir in sorted(pir.instrs.items()):
        def bad(pass_name, msg, _pc=pc, _ir=ir):
            out.append(Finding(pass_name, meta.name, msg, config=config,
                               pc=_pc, pc_name=_ir.name))

        words = ir.all_words
        oob = sorted(w for w in words if not 0 <= w < W)
        if oob:
            bad("bounds", f"accesses words outside the window "
                f"[0, {W}): {oob}")
        hit_dead = sorted(set(words) & dead_words)
        if hit_dead:
            bad("bounds", f"touches padded dead counter words "
                f"{hit_dead} (ctr_mask is False there)")
        stray = sorted(w for w in words
                       if 0 <= w < W and w not in allowed)
        if stray:
            bad("bounds", f"escapes declared segments "
                f"{tuple(meta.segments)}: words {stray}")
        bad_regs = sorted(r for r in (ir.reg_reads | ir.reg_writes)
                          if not 0 <= r < meta.n_regs)
        if bad_regs:
            bad("bounds", f"register indices {bad_regs} outside "
                f"[0, {meta.n_regs})")
        # The port's handlers return `Effect.regs` and pass no register
        # row, so `regs_row_lens` stays empty and this check never fires.
        bad_rows = sorted(n for n in ir.regs_row_lens
                          if n != meta.n_regs)
        if bad_rows:
            bad("bounds", f"finish_instr regs_row lengths {bad_rows} "
                f"!= n_regs={meta.n_regs}")
    return out


# ------------------------------------------------------------ structure
def check_structure(pir, meta: ProgramMeta, config: str = "") -> list:
    """Declared-vs-observed CS behavior, dead/undeclared pcs, successor
    sanity, and acquire-reaches-release over the observed CFG."""
    out = []

    def bad(msg, pc=None):
        name = meta.pc_name(pc) if pc is not None else ""
        out.append(Finding("structure", meta.name, msg, config=config,
                           pc=pc, pc_name=name))

    executed_dead = sorted(pir.pc_reached & meta.dead_pcs)
    for pc in executed_dead:
        bad("declared-dead instruction executed", pc)
    for pc in sorted(pir.pc_reached):
        if not 0 <= pc < meta.n_pcs:
            bad(f"pc {pc} outside the program's [0, {meta.n_pcs})")

    enters, exits = set(), set()
    for pc, ir in sorted(pir.instrs.items()):
        if ir.enters_cs:
            enters.add(pc)
        if ir.exits_cs:
            exits.add(pc)
        bad_succ = sorted(s for s in pir.cfg_successors(pc)
                          if not 0 <= s < meta.n_pcs)
        if bad_succ:
            bad(f"successors {bad_succ} outside [0, {meta.n_pcs})", pc)
        into_dead = sorted(set(pir.cfg_successors(pc)) & meta.dead_pcs)
        if into_dead:
            bad(f"branches into declared-dead pcs {into_dead}", pc)

    for pc in sorted(enters - meta.cs_enter_pcs):
        bad("enters the critical section but is not declared in "
            "cs_enter_pcs", pc)
    for pc in sorted(exits - meta.cs_exit_pcs):
        bad("exits the critical section but is not declared in "
            "cs_exit_pcs", pc)
    for pc in sorted((meta.cs_enter_pcs & pir.pc_reached) - enters):
        bad("declared cs_enter pc never called cs_enter in any "
            "sample", pc)
    for pc in sorted((meta.cs_exit_pcs & pir.pc_reached) - exits):
        bad("declared cs_exit pc never called cs_exit in any sample",
            pc)

    # Acquire-reaches-release: from each observed CS entry, no done pc
    # may be reachable without passing an instruction that (observably)
    # exits the CS. Walk the observed CFG with exit pcs absorbing.
    for enter_pc in sorted(enters):
        seen = set()
        frontier = [s for s in pir.cfg_successors(enter_pc)
                    if s not in exits]
        leak = None
        while frontier:
            pc = frontier.pop()
            if pc in seen:
                continue
            seen.add(pc)
            if pc in meta.done_pcs:
                leak = pc
                break
            frontier.extend(s for s in pir.cfg_successors(pc)
                            if s not in exits and s not in seen)
        if leak is not None:
            bad(f"path from CS entry reaches done pc "
                f"{meta.pc_name(leak)} without a CS exit", enter_pc)
    return out


def check_coverage(meta: ProgramMeta, union_reached: set,
                   configs: str = "") -> list:
    """Unreachable-instruction lint over the UNION of all configs of a
    program: a live pc no config ever reaches is dead code the program
    failed to declare (or a broken branch)."""
    out = []
    for pc in sorted(meta.live_pcs - union_reached):
        out.append(Finding(
            "structure", meta.name,
            "live instruction unreachable in every checked config "
            f"({configs})", pc=pc, pc_name=meta.pc_name(pc)))
    return out


# ------------------------------------------------------------- recovery
def check_recovery(pir, meta: ProgramMeta, crashed: bool,
                   config: str = "") -> list:
    """Crash-recovery structural lint over one config's observed IR.

    In a crash-free config (`crashed=False`), no declared recovery pc
    may execute: a recovery path taken without a crash means its guard
    fires on live state (a false reclaim waiting to happen). In a crash
    config, every recovery pc that executed must have an observed CFG
    path to a done pc — a repair that cannot complete is a wedge, not a
    recovery."""
    out = []

    def bad(msg, pc):
        out.append(Finding("recovery", meta.name, msg, config=config,
                           pc=pc, pc_name=meta.pc_name(pc)))

    hit = pir.pc_reached & meta.recovery_pcs
    if not crashed:
        for pc in sorted(hit):
            bad("recovery instruction executed in a crash-free run "
                "(its guard fires on live state)", pc)
        return out
    for start in sorted(hit):
        seen, frontier = set(), [start]
        reaches_done = False
        while frontier:
            pc = frontier.pop()
            if pc in seen:
                continue
            seen.add(pc)
            if pc in meta.done_pcs:
                reaches_done = True
                break
            frontier.extend(pir.cfg_successors(pc))
        if not reaches_done:
            bad("no observed path from this recovery instruction to "
                "any done pc (a repair that cannot complete is a "
                "wedge, not a recovery)", start)
    return out


# --------------------------------------------------------------- wakeup
def word_classes(layout: Layout) -> dict:
    """Map each window word to its layout table family.

    Families: ("next"|"status"|"tail", level), ("arrive"|"depart",)
    and one singleton class per scratch slot. Protocol addresses inside
    a family are register/data-dependent (e.g. "my predecessor's NEXT
    word"), so the wakeup lint matches writers at family granularity —
    sampled replays cannot enumerate every concrete predecessor."""
    classes = {}
    for fam in ("next", "status", "tail"):
        for lvl, t in enumerate(getattr(layout, f"{fam}_w")):
            for w in _ints(t):
                classes[w] = (fam, lvl)
    for fam in ("arrive", "depart"):
        for w in _ints(getattr(layout, f"{fam}_w")):
            classes[w] = (fam,)
    for slot, w in enumerate(np.asarray(layout.scratch_w)):
        classes[int(w)] = ("scratch", slot)
    return classes


def check_wakeup(pir, meta: ProgramMeta, layout: Layout,
                 config: str = "") -> list:
    """Lost-wakeup lint: every word a blocking instruction watches must
    be declared as written (`Effect(writes=...)`) by at least
    one OTHER instruction — otherwise nothing can ever wake the sleeper
    and only the backoff timeout saves it. Writers are matched at
    word-class granularity (see `word_classes`)."""
    out = []
    classes = word_classes(layout)
    word_writers = {}
    class_writers = {}
    for pc, ir in pir.instrs.items():
        for w in ir.declared_writes:
            word_writers.setdefault(w, set()).add(pc)
            cls = classes.get(w)
            if cls is not None:
                class_writers.setdefault(cls, set()).add(pc)
    for pc, ir in sorted(pir.instrs.items()):
        if not ir.watch_words:
            continue
        if pc not in meta.blocking_pcs:
            out.append(Finding(
                "wakeup", meta.name,
                f"blocks on words {sorted(ir.watch_words)} but is not "
                "declared in blocking_pcs", config=config, pc=pc,
                pc_name=ir.name))
        for w in sorted(ir.watch_words):
            cls = classes.get(w)
            others = word_writers.get(w, set()) - {pc}
            if cls is not None:
                others |= class_writers.get(cls, set()) - {pc}
            if not others:
                out.append(Finding(
                    "wakeup", meta.name,
                    f"watches word {w} ({classes.get(w)}) but no other "
                    "instruction declares a write to it or its class — "
                    "lost wakeup (only the backoff timeout can "
                    "unblock)", config=config, pc=pc, pc_name=ir.name))
    return out

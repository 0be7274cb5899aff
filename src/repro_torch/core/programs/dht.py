"""DHT access programs for the lock simulator (paper §5.3), as
lane-batched instruction handlers.

Models the paper's benchmark: the processes fire inserts/reads at one
selected process's local volume. Three synchronization variants:

  * foMPI-A  -- no lock: per the paper it "only synchronizes accesses
    with CAS/FAO", so EVERY access (read or insert) is a remote atomic
    on the victim volume. RDMA atomics serialize in the target NIC's
    atomic unit, modelled by one designated occupancy word (the NIC
    proxy, `table[0]`) that all of the volume's atomics pass through.
    Inserts additionally take the overflow path (FAO heap pointer + Put
    + second CAS for the last-element pointer, §5.3) on a collision.
  * foMPI-RW / RMA-RW -- the whole volume is protected by the lock; the
    CS performs the single table access (cs_kind=1: plain Gets/Puts
    stream at line rate, no atomic-unit serialization).

This module provides the foMPI-A program; the lock-protected variants
reuse the standard lock programs with cs_kind=1 (`repro_torch.bench.dht`).
Counterpart of `repro.core.programs.dht`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (DONE, Ctx, Effect, Env, Instr, Program,
                                     where as _w)
from repro_torch.core.programs.meta import SEG_SCRATCH, ProgramMeta

A_OP, A_OVERFLOW, A_DONE, A_CHAIN = 0, 1, 2, 3

# The paper's benchmark operates the table at a high load factor (random
# keys into a fixed-size table), so roughly half of the accesses touch
# an overflow chain: inserts take the heap path, reads walk one chain
# link (an extra remote atomic read under CAS/FAO-only consistency).
COLLISION_RATE = 0.5        # inserts hitting an occupied slot
READ_CHAIN_RATE = 0.5       # reads that traverse one overflow link


class FompiADHT:
    """Lock-free CAS/FAO DHT access (the paper's foMPI-A variant).

    `table_words`: window word indices of the victim volume's table;
    `heap_word`: the overflow heap's next-free pointer; `writer_mask`:
    the [P] roles `meta()` declares dead pcs by. The handlers read each
    lane's roles from the env (`Ctx.point_at_p("is_writer")`), so one
    run can hold several writer fractions as lanes (the env's "roles"
    lattice group); a single-point env must carry `writer_mask` itself.
    """

    n_regs = 2

    def __init__(self, table_words, heap_word: int, writer_mask):
        self.table_words = np.asarray(table_words, np.int64)
        self.heap_word = int(heap_word)
        self.writer_mask = np.asarray(writer_mask, bool)

    def init_pc(self, env: Env):
        return np.zeros(env.P, np.int32)

    def init_regs(self, env: Env):
        return np.zeros((env.P, self.n_regs), np.int32)

    def meta(self, env: Env) -> ProgramMeta:
        """Declared program shape (the reference's locklint contract).

        The table/heap words live in the window's scratch region, so
        SEG_SCRATCH is the allowed segment. There is no critical
        section: foMPI-A is the lock-free variant."""
        writers = self.writer_mask
        dead = set()
        if not writers.any():
            dead.add(A_OVERFLOW)
        if writers.all():
            dead.add(A_CHAIN)
        return ProgramMeta(
            name="fompi_a_dht", n_pcs=4, n_regs=self.n_regs,
            pc_names=("A_OP", "A_OVERFLOW", "A_DONE", "A_CHAIN"),
            dead_pcs=frozenset(dead),
            cs_enter_pcs=frozenset(),
            cs_exit_pcs=frozenset(),
            done_pcs=frozenset({A_DONE}),
            blocking_pcs=frozenset(),
            segments=(SEG_SCRATCH,))

    def build(self, env: Env) -> Program:
        if "roles" not in env.lanes and not np.array_equal(
                env.is_writer.cpu().numpy(), self.writer_mask):
            raise ValueError("the env's is_writer differs from the "
                             "program's writer_mask")
        table = torch.as_tensor(self.table_words, device=env.device)
        HW = self.heap_word
        nic = int(self.table_words[0])   # the victim NIC's atomic unit

        def a_op(c: Ctx):
            # draws: slot = randint(split(sub)[0], 0, n_slots), and k2 =
            # uniform(split(sub)[1]) in [0, 1) (the unit float itself).
            slot = table[c.draws["slot"]]
            w = c.point_at_p("is_writer")
            r = c.draws["k2"]
            # Both reads and inserts are remote atomics (CAS/FAO-only
            # synchronization); they serialize at the target's atomic unit.
            chain_read = ~w & (r < READ_CHAIN_RATE)
            collide = w & (r < COLLISION_RATE)
            return Effect(dur=c.lat_atomic(slot), hot=nic,
                          writes=(_w(w, slot, -1),),
                          next_pc=_w(collide, A_OVERFLOW,
                                     _w(chain_read, A_CHAIN, A_DONE)))

        def a_overflow(c: Ctx):
            # FAO on the heap pointer + Put of the element + second CAS
            # updating the last-element pointer (paper §5.3).
            return Effect(dur=2.0 * c.lat_atomic(HW) + c.lat_plain(HW),
                          hot=nic, writes=(HW,), next_pc=A_DONE)

        def a_done(c: Ctx):
            # Acquire accounting and think time: the engine's DONE kind.
            return Effect(next_pc=A_OP)

        def a_chain(c: Ctx):
            # Second atomic read for the overflow-chain link: its own
            # serialized slot in the target NIC's atomic unit.
            return Effect(dur=c.lat_atomic(nic), hot=nic, next_pc=A_DONE)

        return Program(env, (Instr(a_op), Instr(a_overflow),
                             Instr(a_done, DONE), Instr(a_chain)),
                       draws={"slot": len(self.table_words), "k2": True})

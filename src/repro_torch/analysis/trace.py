"""Replay of instruction handlers with footprint recording, many
replays as the lanes of one call.

Counterpart of `repro.analysis.trace`. The port's handlers read the
window only through `Ctx.win` and their own registers only through
`Ctx.reg` / `Ctx.reg_at`, so a recording Ctx (`engine.RecordingCtx`)
is the recorder: it notes each gather's raw per-lane index, before the
JAX-style wrap and clamp, under the handler that computed it. Other
processes' registers, read through `ctx.st.regs` slices, are not
recorded (the reference does not record them either).

A replay lane is one (canonical state, pc, process, step key). Every
handler of the program's full table runs on every lane, as in an event
step; a lane reads only the records and the `Effect` of the handler at
its pc:

  * observed window reads and register reads: the RecordingCtx log;
  * observed window writes: the word of every `stores` entry, whatever
    its `enable` flag (the reference's superset rule: an `.at` update
    on an untaken `jnp.where` branch is still recorded);
  * observed register writes: the `regs` keys and the `reg_at` index;
  * declared effects (exact): writes from `writes`, the hot word from
    `hot` (None is -1), the successor from `next_pc`, watch words from
    `block_a/b` (>= 0);
  * `entered_cs` from the instruction's kind (`Instr.kind == CS`) and
    `exited_cs` from a `cs_exit` that is not None or False (the
    reference notes a call to `cs_exit`, whatever its condition).

The reference's `patched` context manager has no counterpart: it
rebinds the `finish_instr` / `cs_enter` / `cs_exit` globals of each
program module to capture the declared effects, while the port's
handlers return those effects as an `Effect` and the shared tail is the
engine's `_apply`, not a global of the program modules.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.analysis.model import Canon, canon_state, step_draws

CH_WINDOW = engine.CH_WINDOW
CH_REGS = engine.CH_REGS


class Recorder:
    """One replayed instruction's observed + declared effects."""

    def __init__(self):
        self.window_reads = set()
        self.window_writes = set()
        self.reg_reads = set()
        self.reg_writes = set()
        # Declared effects (exact).
        self.hot_word = None
        self.declared_writes = []
        self.next_pc = None
        self.block_words = set()
        # The port's handlers pass no register row (see lints.check_bounds).
        self.regs_row_len = None
        self.entered_cs = False
        self.exited_cs = False
        self.finished = False


def record_steps(handlers: engine.Program, env: engine.Env, layout,
                 items) -> list:
    """Replay many instructions as the lanes of one call and return a
    Recorder per item. `items` are (canon, pc, p, key): a canonical
    model state (`repro_torch.analysis.model.Canon`) in which process p
    is at pc, and the [2] PRNG key used as the step key."""
    n = len(items)
    cols = Canon(*(np.stack([np.asarray(c[f]) for c, *_ in items])
                   for f in range(len(Canon._fields))))
    st = canon_state(env, cols)
    dev = env.device
    p = torch.as_tensor([int(it[2]) for it in items], device=dev)
    keys = torch.stack([torch.as_tensor(it[3]) for it in items])
    draws = step_draws(env, handlers, keys)
    instrs = handlers.instrs(True)
    ctx = engine.RecordingCtx(env, st, p, torch.zeros(n, device=dev), draws,
                              engine._consts(env, n), True)
    with torch.inference_mode():
        effs = ctx.evaluate(instrs)

    host = {}

    def lane_values(x):
        """x (a Python int or an [n] tensor) at every lane, as ints."""
        if not isinstance(x, torch.Tensor):
            return [int(x)] * n
        v = host.get(id(x))
        if v is None:
            v = host[id(x)] = x.expand(n).cpu().tolist()
        return v

    pcs = [int(it[1]) for it in items]
    wanted = set(pcs)
    log = {}
    for h, ch, i in ctx.log:
        if h in wanted:
            log.setdefault(h, []).append((ch, lane_values(i)))
    recs = []
    for lane, pc in enumerate(pcs):
        if not 0 <= pc < len(instrs):
            raise ValueError(f"pc {pc} outside the program's "
                             f"[0, {len(instrs)})")
        e = effs[pc]
        rec = Recorder()
        for ch, vals in log.get(pc, ()):
            (rec.window_reads if ch == CH_WINDOW
             else rec.reg_reads).add(vals[lane])
        rec.window_writes = {lane_values(s[0])[lane] for s in e.stores}
        rec.reg_writes = set(e.regs or {})
        if e.reg_at is not None:
            rec.reg_writes.add(lane_values(e.reg_at[0])[lane])
        rec.hot_word = -1 if e.hot is None else lane_values(e.hot)[lane]
        rec.declared_writes = [lane_values(w)[lane] for w in e.writes]
        rec.next_pc = lane_values(e.next_pc)[lane]
        for b in (e.block_a, e.block_b):
            if b is not None and lane_values(b)[lane] >= 0:
                rec.block_words.add(lane_values(b)[lane])
        rec.entered_cs = instrs[pc].kind == engine.CS
        rec.exited_cs = e.cs_exit is not None and e.cs_exit is not False
        rec.finished = True
        recs.append(rec)
    return recs


def record_step(handlers: engine.Program, env: engine.Env, layout, canon,
                pc: int, p: int, key) -> Recorder:
    """Replay one instruction and return its recorded effects: process
    `p` of model state `canon` runs the handler at `pc` under step key
    `key`."""
    return record_steps(handlers, env, layout, [(canon, pc, p, key)])[0]

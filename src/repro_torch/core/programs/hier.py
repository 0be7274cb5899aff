"""The paper's lock protocols as lane-batched instruction handlers.

One unified program implements the whole family (§3 of the paper):

  * RMA-RW   — has_readers=True, N >= 1 levels (DQ + DT + DC).
  * RMA-MCS  — has_readers=False, N >= 2 (DQ + DT, no DC; §3.5).
  * D-MCS    — has_readers=False, N == 1 (single root queue; §2.4).

Counterpart of `repro.core.programs.hier`, pc for pc and register for
register; each handler computes for every lane at once what the
reference handler computes for one, and returns an `engine.Effect`.
Program counters follow the paper's listings (4, 5, 7, 8, 9, 10 and the
counter helpers of Listing 6). Levels are 0-based with 0 = root (paper's
level 1) and N-1 = leaf (paper's level N). Queue entities at level
i < N-1 are per-element nodes (HMCS-style): `ent_of_p[i, p]` is the
entity that p acts as at level i.

Crash recovery (lease-based, `engine.FaultPlan`): REC_INHERIT,
REC_TAILFIX, REC_DRAIN and R_UNBAR re-validate their guard in the same
atomic step as the repair, so a race with a live release costs a
bounded retry, never a wrong write. The guards read other processes'
frozen pc/registers as well as window words: the lease service that
detects a crash is assumed to also publish each process's last
announced protocol phase.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (CS as CS_KIND, DONE, Effect, Env,
                                     Instr, Program, where as _w)
from repro_torch.core.programs.meta import (SEG_COUNTERS, SEG_QUEUES,
                                            ProgramMeta)
from repro_torch.core.window import (ACQUIRE_PARENT, ACQUIRE_START,
                                     MODE_CHANGE, NULL, WAIT, WRITE_FLAG)

NULL, WAIT, ACQUIRE_PARENT, MODE_CHANGE, ACQUIRE_START, WRITE_FLAG = (
    int(NULL), int(WAIT), int(ACQUIRE_PARENT), int(MODE_CHANGE),
    int(ACQUIRE_START), int(WRITE_FLAG))

# Registers.
L = 0          # current level during acquire/release descent
PRED = 1
STATUS = 2
NEXT_STAT = 3
CRESET = 4     # counters_reset flag (Listing 8)
K = 5          # counter-loop index (Listing 6 loops)
UL = 6         # unwind level during release
SUCC0 = 7      # SUCC0+lvl: successor observed at level lvl (max 4 levels)
BARRIER = 11   # reader barrier flag (Listing 9)
RET = 12       # reader FAO result
TMP = 13       # return-pc for the shared reset-counters loop
N_REGS = 16

# Writer PCs.
WA_PREP, WA_ENQ, WA_LINK, WA_SPIN, WA_START_PARENT = 0, 1, 2, 3, 4
W_SCTW_FLAG, W_SCTW_VERIFY = 5, 6
# (7 merged into WA_START_PARENT)
CS, WR_READ, WR_DECIDE = 8, 9, 10
ROOT_DECIDE, ROOT_RESET, ROOT_CAS, ROOT_WAITSUCC, ROOT_PASS = 11, 12, 13, 14, 15
UNW_CHECK, UNW_WAIT, UNW_PUT = 16, 17, 18
ROOT_GETSUCC = 19
DONE_ONE = 20
# Reader PCs (Listing 9/10).
R_BARRIER, R_FAO, R_CHECK_TAIL, R_BACKOFF, R_CS, R_RELEASE, R_RESET, R_DONE = (
    21, 22, 23, 24, 25, 26, 27, 28)
R_RECOVER = 29     # barred-reader self-reset (starvation recovery)
REC_INHERIT = 30   # waiter whose predecessor's node is abandoned
REC_TAILFIX = 31   # releaser whose successor died between FAO and link
REC_DRAIN = 32     # writer draining arrivals of dead readers
R_UNBAR = 33       # barred reader clearing dead writers' flags
N_PCS = 34

PC_NAMES = (
    "WA_PREP", "WA_ENQ", "WA_LINK", "WA_SPIN", "WA_START_PARENT",
    "W_SCTW_FLAG", "W_SCTW_VERIFY", "TRAP7", "CS", "WR_READ",
    "WR_DECIDE", "ROOT_DECIDE", "ROOT_RESET", "ROOT_CAS",
    "ROOT_WAITSUCC", "ROOT_PASS", "UNW_CHECK", "UNW_WAIT", "UNW_PUT",
    "ROOT_GETSUCC", "DONE_ONE", "R_BARRIER", "R_FAO", "R_CHECK_TAIL",
    "R_BACKOFF", "R_CS", "R_RELEASE", "R_RESET", "R_DONE", "R_RECOVER",
    "REC_INHERIT", "REC_TAILFIX", "REC_DRAIN", "R_UNBAR")


class HierProgram:
    """RMA-RW / RMA-MCS / D-MCS instruction program."""

    n_regs = N_REGS

    def __init__(self, has_readers: bool):
        self.has_readers = has_readers

    def init_pc(self, env: Env):
        pc = np.zeros(env.P, np.int32)
        if self.has_readers:
            pc[~env.is_writer.cpu().numpy()] = R_BARRIER
        return pc

    def init_regs(self, env: Env):
        regs = np.zeros((env.P, N_REGS), np.int32)
        regs[:, L] = env.N - 1
        return regs

    def meta(self, env: Env) -> ProgramMeta:
        """Declared program shape (the reference's locklint contract)."""
        Nlv = int(env.N)
        dead = {7}                      # merged into WA_START_PARENT
        if self.has_readers:
            segments = (SEG_QUEUES, SEG_COUNTERS)
        else:
            segments = (SEG_QUEUES,)
            dead |= {W_SCTW_FLAG, W_SCTW_VERIFY, ROOT_RESET,
                     R_BARRIER, R_FAO, R_CHECK_TAIL, R_BACKOFF, R_CS,
                     R_RELEASE, R_RESET, R_DONE, R_RECOVER,
                     REC_DRAIN, R_UNBAR}
        if Nlv == 1:
            dead |= {WR_READ, WR_DECIDE, UNW_WAIT, UNW_PUT}
        return ProgramMeta(
            name="rma_rw" if self.has_readers else
                 ("d_mcs" if Nlv == 1 else "rma_mcs"),
            n_pcs=N_PCS, n_regs=N_REGS, pc_names=PC_NAMES,
            dead_pcs=frozenset(dead),
            cs_enter_pcs=frozenset({CS, R_CS}),
            cs_exit_pcs=frozenset(
                {ROOT_DECIDE if Nlv == 1 else WR_READ, R_RELEASE}),
            done_pcs=frozenset({DONE_ONE, R_DONE}),
            blocking_pcs=frozenset({WA_SPIN, W_SCTW_VERIFY,
                                    ROOT_WAITSUCC, UNW_WAIT, R_BARRIER,
                                    REC_INHERIT, REC_TAILFIX}),
            segments=segments,
            recovery_pcs=frozenset(
                {REC_INHERIT, REC_TAILFIX, REC_DRAIN, R_UNBAR} - dead))

    def build(self, env: Env) -> Program:
        return Program(env, self._instrs(env, faults=True),
                       self._instrs(env, faults=False))

    def _instrs(self, env: Env, faults: bool):
        """The handler table; with `faults=False`, the crash-free
        variant (see `engine.Program`): every lease guard is constant
        False, and REC_INHERIT, REC_TAILFIX and R_UNBAR, which only such
        guards route to, are never selected."""
        RW = self.has_readers
        Nlv = env.N

        # ---- addressing (JAX clamp semantics via Ctx.tab) -------------
        def ent(c, lvl):                  # entity p acts as at level lvl
            return c.at_p("ent_rows", lvl)

        def nw(c, lvl, e):                # NEXT word of entity e
            return c.tab("next", lvl, e)

        def sw(c, lvl, e):                # STATUS word
            return c.tab("status", lvl, e)

        def tw(c, lvl):                   # TAIL word of p's element
            return c.at_p("tw_rows", lvl)

        # Per-step quantities several handlers share.
        def lvl_(c):
            return c.reg(L)

        def e_lvl(c):
            return c.memo("e_lvl", lambda: ent(c, lvl_(c)))

        def sw_lvl(c):
            return c.memo("sw_lvl", lambda: sw(c, lvl_(c), e_lvl(c)))

        def e0(c):
            return c.memo("e0", lambda: ent(c, 0))

        def tw0(c):
            return c.memo("tw0", lambda: tw(c, 0))

        def ctr_p(c):
            return c.memo("ctr_p", lambda: c.point_at_p("ctr_of_p"))

        def wa_p(c):
            return c.memo("wa_p", lambda: c.tab("arrive", ctr_p(c)))

        def wd_p(c):
            return c.memo("wd_p", lambda: c.tab("depart", ctr_p(c)))

        def wa_k(c):
            return c.memo("wa_k", lambda: c.tab("arrive", c.reg(K)))

        def wd_k(c):
            return c.memo("wd_k", lambda: c.tab("depart", c.reg(K)))

        regs_l = lambda c: c.memo("regs_l", lambda: c.st.regs[:, :, L])
        regs_pred = lambda c: c.memo("regs_pred",
                                     lambda: c.st.regs[:, :, PRED])

        # ---- crash-recovery guards (lease registry reads) -----------
        def entity_dead(c, lvl, e):
            """Every process that can act as entity `e` at `lvl` (other
            than p itself) is lease-expired or done, and at least one is
            expired. In the RW variant only writers count (a live reader
            of the entity does not keep its queue node alive)."""
            sel = (c.rows("ent_rows", lvl) == e[:, None]) & c.not_p
            if RW:
                sel = sel & c.point("is_writer")
            exp = c.expired
            return (sel & exp).any(1) & (~sel | exp | c.st.done).all(1)

        def no_live_enqueuer(c, lvl):
            """No live process sits between its tail-FAO and its link at
            this level."""
            mid = (c.pc_is(WA_LINK) & (regs_l(c) == lvl[:, None])
                   & ~c.st.crashed & ~c.st.done & c.not_p)
            return ~mid.any(1)

        def ghost_succ(c, lvl, e):
            """The expired process that crashed between its tail-FAO and
            its link at `lvl` with PRED == e — p's invisible immediate
            successor: (found, its entity, that entity's NEXT value)."""
            cand = (c.expired & c.pc_is(WA_LINK)
                    & (regs_l(c) == lvl[:, None])
                    & (regs_pred(c) == e[:, None]) & c.not_p)
            d = cand.to(torch.int8).argmax(1)
            e_d = c.at_p("ent_rows", lvl, d)
            return cand.any(1), e_d, c.win(nw(c, lvl, e_d))

        def ctr_quiescent(c, ctr):
            """No live reader assigned to counter `ctr` holds an
            unmatched arrival."""
            free = c.memo("rdr_free", lambda: (
                c.pc_is(R_BARRIER) | c.pc_is(R_FAO) | c.pc_is(R_DONE)
                | c.pc_is(R_RECOVER) | c.pc_is(R_UNBAR)
                | c.st.done | c.expired))
            rdr = ((~c.point("is_writer"))
                   & (c.point("ctr_of_p") == ctr[:, None]))
            return (~rdr | free).all(1)

        def writers_gone(c):
            """Some process is expired and every writer is done or
            expired (R_BARRIER / R_UNBAR guard)."""
            def f():
                exp = c.expired
                return exp.any(1) & (~c.point("is_writer") | c.st.done
                                     | exp).all(1)
            return c.memo("writers_gone", f)

        def dead_succ(c, lvl, succ):
            """A linked successor whose node is abandoned: it must be
            passed over (REC_TAILFIX), never granted."""
            return (succ != NULL) & entity_dead(c, lvl, succ.clamp(min=0))

        def reroute(c, lvl, e, succ, tail):
            """ROOT_WAITSUCC / UNW_WAIT's repair guard: the successor
            linked but its node is abandoned, or it is a ghost (died
            between its tail-FAO and its link) and no live enqueuer is
            mid-link. `tail()` gives p's TAIL word at `lvl`."""
            if not faults:
                return c.const(False)
            found, e_d, dn = ghost_succ(c, lvl, e)
            return (dead_succ(c, lvl, succ)
                    | ((succ == NULL) & found & no_live_enqueuer(c, lvl)
                       & ((dn != NULL) | (c.win(tail()) == e_d))))

        # ---- writer instructions ------------------------------------
        def wa_prep(c):
            """Listing 4/7 lines 2-3: reset own NEXT, STATUS at level L."""
            e = e_lvl(c)
            w = sw_lvl(c)
            return Effect(dur=2.0 * c.lat_plain(w), next_pc=WA_ENQ,
                          stores=((nw(c, lvl_(c), e), NULL), (w, WAIT)))

        def wa_enq(c):
            """Listing 4/7: FAO(p, tail, REPLACE) — enqueue; branch on pred."""
            lvl = lvl_(c)
            e = e_lvl(c)
            t = tw(c, lvl)
            pred = c.win(t)
            r = {PRED: pred, K: 0}
            # pred == own entity: the tail still held our own node from
            # an abandoned earlier enqueue — treat as an empty queue.
            no_pred = (pred == NULL) | (pred == e)
            pc_no_pred = (_w(lvl == 0, W_SCTW_FLAG, WA_START_PARENT) if RW
                          else WA_START_PARENT)
            return Effect(dur=c.lat_atomic(t), hot=t, writes=(t,),
                          next_pc=_w(no_pred, pc_no_pred, WA_LINK), regs=r,
                          stores=((t, e),))

        def wa_link(c):
            """Listing 4 line 8: Put(p, pred, NEXT)."""
            w = nw(c, lvl_(c), c.reg(PRED))
            return Effect(dur=c.lat_plain(w), writes=(w,), next_pc=WA_SPIN,
                          stores=((w, e_lvl(c)),))

        def wa_spin(c):
            """Listing 4 lines 10-12 / Listing 7 lines 10-17: local spin."""
            lvl = lvl_(c)
            w = sw_lvl(c)
            s = c.win(w)
            waiting = s == WAIT
            if RW:
                nxt = _w(waiting, WA_SPIN,
                         _w(s == ACQUIRE_PARENT, WA_START_PARENT,
                            _w((lvl == 0) & (s == MODE_CHANGE),
                               W_SCTW_FLAG, CS)))
            else:
                nxt = _w(waiting, WA_SPIN,
                         _w(s == ACQUIRE_PARENT, WA_START_PARENT, CS))
            spin = waiting
            if faults:
                # Dead predecessor: the grant may never flow here on its
                # own — take over in REC_INHERIT.
                pred_gone = waiting & entity_dead(c, lvl, c.reg(PRED))
                nxt = _w(pred_gone, REC_INHERIT, nxt)
                spin = waiting & ~pred_gone
            return Effect(dur=c.lat_plain(w), next_pc=nxt, regs={STATUS: s},
                          block_a=_w(spin, w, -1))

        def wa_start_parent(c):
            """Listing 4 line 22 (+ Listing 7 lines 17/22): STATUS :=
            ACQUIRE_START, then climb (or enter CS when at the root)."""
            lvl = lvl_(c)
            w = sw_lvl(c)
            at_root = lvl == 0
            r = {L: _w(at_root, lvl, lvl - 1)}
            return Effect(dur=c.lat_plain(w), writes=(w,),
                          next_pc=_w(at_root, CS, WA_PREP), regs=r,
                          stores=((w, ACQUIRE_START),))

        # Counter loops (Listing 6) are register-K state machines bounded
        # by the number of live counters.
        def w_sctw_flag(c):
            """Listing 6 set_counters_to_WRITE phase 1: flag counter K."""
            k = c.reg(K)
            w = wa_k(c)
            arr = c.win(w)
            last = k + 1 >= c.point("n_ctr")
            r = {K: _w(last, 0, k + 1)}
            # Set-if-unset: recovery may re-run the flagging loop over
            # counters the dead writer already flagged.
            return Effect(dur=c.lat_atomic(w), hot=w, writes=(w,),
                          next_pc=_w(last, W_SCTW_VERIFY, W_SCTW_FLAG),
                          regs=r, stores=((w, _w(arr >= WRITE_FLAG, arr,
                                                 arr + WRITE_FLAG)),))

        def w_sctw_verify(c):
            """§4.1: after flagging all counters, wait until no reader is
            active on counter K (arrived - WRITE_FLAG == departed)."""
            k = c.reg(K)
            wa, wd = wa_k(c), wd_k(c)
            clear = (c.win(wa) - WRITE_FLAG) == c.win(wd)
            stale = (~clear) & ctr_quiescent(c, k)
            last = k + 1 >= c.point("n_ctr")
            r = {K: _w(clear & ~last, k + 1, _w(clear & last, 0, k))}
            nxt = _w(~clear, _w(stale, REC_DRAIN, W_SCTW_VERIFY),
                     _w(last, WA_START_PARENT, W_SCTW_VERIFY))
            return Effect(dur=2.0 * c.lat_plain(wa), next_pc=nxt, regs=r,
                          block_a=_w(clear | stale, -1, wa),
                          block_b=_w(clear | stale, -1, wd))

        def cs_instr(c):
            """Critical section (workload depends on the benchmark)."""
            r = {L: Nlv - 1, UL: Nlv}  # reset for release
            return Effect(next_pc=ROOT_DECIDE if Nlv == 1 else WR_READ,
                          regs=r)

        def wr_read(c):
            """Listing 5 lines 3-4: read succ + status at level L."""
            lvl = lvl_(c)
            e = e_lvl(c)
            succ = c.win(nw(c, lvl, e))
            stat = c.win(sw_lvl(c))
            return Effect(dur=2.0 * c.lat_plain(sw_lvl(c)), next_pc=WR_DECIDE,
                          reg_at=(SUCC0 + lvl, succ), regs={STATUS: stat},
                          cs_exit=(lvl == Nlv - 1) if Nlv > 1 else False)

        def wr_decide(c):
            """Listing 5 lines 5-12: pass locally within the element, or
            release toward the root."""
            lvl = lvl_(c)
            succ = c.reg_at(SUCC0 + lvl)
            can_pass = ((succ != NULL)
                        & (c.reg(STATUS) < c.tab("T_L", lvl)) & (lvl > 0))
            if faults:
                # Never pass into an abandoned node; descend instead.
                can_pass = can_pass & ~dead_succ(c, lvl, succ)
            # Local pass: Put(status+1, succ, STATUS) (Listing 5 line 8).
            w = sw(c, lvl, succ * (succ != NULL))
            r2 = {L: _w(can_pass, lvl, lvl - 1),
                  UL: _w(can_pass, lvl + 1, c.reg(UL))}
            nxt = _w(can_pass, UNW_CHECK,
                     _w(lvl - 1 >= 1, WR_READ, ROOT_DECIDE))
            dur = _w(can_pass, c.lat_plain(w), 0.02)
            return Effect(dur=dur, writes=(w,), next_pc=nxt, regs=r2,
                          stores=((w, c.reg(STATUS) + 1, can_pass),))

        def root_decide(c):
            """Listing 8 lines 3-8 (RW) / root release (MCS): read own
            root STATUS; maybe hand the lock to the readers."""
            w = sw(c, 0, e0(c))
            stat = c.win(w)
            ns = stat + 1
            cols = {STATUS: stat, NEXT_STAT: ns, CRESET: 0}
            if RW:
                cols.update({K: 0, TMP: ROOT_GETSUCC})
                nxt = _w(ns >= c.point("T_W"), ROOT_RESET, ROOT_GETSUCC)
            else:
                nxt = ROOT_GETSUCC
            return Effect(dur=c.lat_plain(w), next_pc=nxt,
                          regs=cols, cs_exit=Nlv == 1)

        def root_reset(c):
            """Listing 6 reset_counters: reset counter K, looping over all
            counters; then NEXT_STAT := MODE_CHANGE (Listing 8 line 7)."""
            k = c.reg(K)
            wa, wd = wa_k(c), wd_k(c)
            arr, dep = c.win(wa), c.win(wd)
            sub_arr = -dep - _w(arr >= WRITE_FLAG, WRITE_FLAG, 0)
            last = k + 1 >= c.point("n_ctr")
            r = {
                K: _w(last, 0, k + 1),
                NEXT_STAT: _w(last, MODE_CHANGE, c.reg(NEXT_STAT)),
                CRESET: _w(last, 1, c.reg(CRESET))}
            return Effect(dur=2.0 * c.lat_plain(wa) + 2.0 * c.lat_atomic(wa),
                          hot=wa, writes=(wa, wd),
                          next_pc=_w(last, c.reg(TMP), ROOT_RESET), regs=r,
                          stores=((wa, arr + sub_arr), (wd, dep - dep)))

        def root_getsucc(c):
            """Listing 8 line 9: succ = Get(p, NEXT)."""
            w = nw(c, 0, e0(c))
            succ = c.win(w)
            if RW:
                need_reset = (succ == NULL) & (c.reg(CRESET) == 0)
                cols = {SUCC0: succ, K: 0, TMP: ROOT_CAS}
                nxt = _w(succ != NULL, ROOT_PASS,
                         _w(need_reset, ROOT_RESET, ROOT_CAS))
            else:
                cols = {SUCC0: succ}
                nxt = _w(succ != NULL, ROOT_PASS, ROOT_CAS)
            if faults:
                # A linked successor whose node is abandoned is passed
                # over in REC_TAILFIX (TMP carries the level 0).
                sdead = dead_succ(c, 0, succ)
                cols[TMP] = _w(sdead, 0, cols.get(TMP, c.reg(TMP)))
                nxt = _w(sdead, REC_TAILFIX, nxt)
            return Effect(dur=c.lat_plain(w), next_pc=nxt, regs=cols)

        def root_cas(c):
            """Listing 8 line 15 / Listing 3 line 5: CAS(∅, p, TAIL)."""
            t = tw0(c)
            cur = c.win(t)
            ok = cur == e0(c)
            return Effect(dur=c.lat_atomic(t), hot=t, writes=(t,),
                          next_pc=_w(ok, UNW_CHECK, ROOT_WAITSUCC),
                          regs={UL: 1},
                          stores=((t, _w(ok, NULL, cur)),))

        def root_waitsucc(c):
            """Listing 8 lines 18-20: wait for the successor to appear."""
            e = e0(c)
            w = nw(c, 0, e)
            succ = c.win(w)
            rec = reroute(c, c.const(0), e, succ, lambda: tw0(c))
            r = {SUCC0: succ, TMP: _w(rec, 0, c.reg(TMP))}
            return Effect(dur=c.lat_plain(w),
                          next_pc=_w(rec, REC_TAILFIX,
                                     _w(succ != NULL, ROOT_PASS,
                                        ROOT_WAITSUCC)),
                          regs=r, block_a=_w((succ == NULL) & ~rec, w, -1))

        def root_pass(c):
            """Listing 8 line 23: Put(next_stat, succ, STATUS)."""
            w = sw(c, 0, c.reg(SUCC0))
            return Effect(dur=c.lat_plain(w), writes=(w,), next_pc=UNW_CHECK,
                          regs={UL: 1},
                          stores=((w, c.reg(NEXT_STAT)),))

        def unw_check(c):
            """Listing 5 lines 13-17 at each level from the release floor
            back to the leaf: clear the tail or find the late successor."""
            ul = c.reg(UL)
            fin = ul > Nlv - 1
            ulc = ul.clamp(max=Nlv - 1)
            e = ent(c, ulc)
            succ = c.reg_at(SUCC0 + ulc)
            t = tw(c, ulc)
            cur = c.win(t)
            do_cas = (~fin) & (succ == NULL)
            cas_ok = do_cas & (cur == e)
            r = {UL: _w(fin | cas_ok, ul + _w(fin, 0, 1), ul)}
            linked_pc = UNW_PUT
            if faults:
                # A linked successor whose node is abandoned is passed
                # over in REC_TAILFIX, never granted.
                sdead = (~fin) & dead_succ(c, ulc, succ)
                r[TMP] = _w(sdead, ulc, c.reg(TMP))
                linked_pc = _w(sdead, REC_TAILFIX, UNW_PUT)
            nxt = _w(fin, DONE_ONE,
                     _w(succ != NULL, linked_pc,
                        _w(cas_ok, UNW_CHECK, UNW_WAIT)))
            dur = _w(do_cas, c.lat_atomic(t), 0.02)
            return Effect(dur=dur, hot=_w(do_cas, t, -1), writes=(t,),
                          next_pc=nxt, regs=r,
                          stores=((t, _w(cas_ok, NULL, cur)),))

        def unw_wait(c):
            """Listing 5 lines 18-20: wait for the late successor."""
            ul = c.reg(UL).clamp(max=Nlv - 1)
            e = ent(c, ul)
            w = nw(c, ul, e)
            succ = c.win(w)
            rec = reroute(c, ul, e, succ, lambda: tw(c, ul))
            return Effect(dur=c.lat_plain(w),
                          next_pc=_w(rec, REC_TAILFIX,
                                     _w(succ == NULL, UNW_WAIT, UNW_PUT)),
                          reg_at=(SUCC0 + ul, succ),
                          regs={TMP: _w(rec, ul, c.reg(TMP))},
                          block_a=_w((succ == NULL) & ~rec, w, -1))

        def unw_put(c):
            """Listing 5 line 23: Put(ACQUIRE_PARENT, succ, STATUS)."""
            ul = c.reg(UL).clamp(max=Nlv - 1)
            w = sw(c, ul, c.reg_at(SUCC0 + ul))
            return Effect(dur=c.lat_plain(w), writes=(w,), next_pc=UNW_CHECK,
                          regs={UL: ul + 1},
                          stores=((w, ACQUIRE_PARENT),))

        def done_one(c):
            return Effect(next_pc=WA_PREP, regs={L: Nlv - 1, CRESET: 0, K: 0})

        # ---- reader instructions (Listings 9 / 10) -------------------
        def r_barrier(c):
            wa = wa_p(c)
            t = tw0(c)
            barrier_on = c.reg(BARRIER) == 1
            over = barrier_on & (c.win(wa) >= c.point("T_R"))
            # Starvation recovery: a barred reader re-checks the tail and
            # resets the counter itself once it drains (R_RECOVER); crash
            # recovery takes priority (R_UNBAR).
            unbar = (over & writers_gone(c) & ctr_quiescent(c, ctr_p(c))
                     if faults else c.const(False))
            recover = over & ~unbar & (c.win(t) == NULL)
            barred = over & ~unbar & ~recover
            nxt = _w(unbar, R_UNBAR,
                     _w(recover, R_RECOVER, _w(barred, R_BARRIER, R_FAO)))
            dur = _w(barrier_on, c.lat_plain(wa) + c.lat_plain(t),
                     0.02)
            return Effect(dur=dur, next_pc=nxt,
                          block_a=_w(barred, wa, -1),
                          block_b=_w(barred, t, -1))

        def r_fao(c):
            """Listing 9 line 12: FAO(1, c(p), ARRIVE, SUM)."""
            wa = wa_p(c)
            ret = c.win(wa)
            got = ret < c.point("T_R")
            first = ret == c.point("T_R")
            r = {RET: ret, BARRIER: _w(got, c.reg(BARRIER), 1)}
            return Effect(dur=c.lat_atomic(wa), hot=wa, writes=(wa,),
                          next_pc=_w(got, R_CS,
                                     _w(first, R_CHECK_TAIL, R_BACKOFF)),
                          regs=r, stores=((wa, ret + 1),))

        def r_check_tail(c):
            """Listing 9 lines 15-21: first to reach T_R checks for
            waiting writers at the root tail."""
            t = tw0(c)
            return Effect(dur=c.lat_plain(t),
                          next_pc=_w(c.win(t) == NULL, R_RESET, R_BACKOFF))

        def r_backoff(c):
            """Listing 9 line 24: Accumulate(-1, c(p), ARRIVE)."""
            wa = wa_p(c)
            return Effect(dur=c.lat_atomic(wa), hot=wa, writes=(wa,),
                          next_pc=R_BARRIER, stores=((wa, c.win(wa) - 1),))

        def r_cs(c):
            return Effect(next_pc=R_RELEASE)

        def r_release(c):
            """Listing 10: Accumulate(1, c(p), DEPART)."""
            wd = wd_p(c)
            return Effect(dur=c.lat_atomic(wd), hot=wd, writes=(wd,),
                          next_pc=R_DONE, stores=((wd, c.win(wd) + 1),),
                          cs_exit=True)

        def reset_own_counter(c, nxt):
            """R_RESET / R_RECOVER: subtract the departed readers from
            both words of p's counter (a raced-in WRITE_FLAG survives)."""
            wa, wd = wa_p(c), wd_p(c)
            dep = c.win(wd)
            return Effect(dur=2.0 * c.lat_plain(wa) + 2.0 * c.lat_atomic(wa),
                          hot=wa, writes=(wa, wd), next_pc=nxt,
                          regs={BARRIER: 0},
                          stores=((wa, c.win(wa) - dep), (wd, dep - dep)))

        def r_reset(c):
            """Listing 9 line 20: reset own counter; clear barrier."""
            return reset_own_counter(c, R_BACKOFF)

        def r_recover(c):
            """Barred-reader self-reset; R_BACKOFF already removed our
            own arrival, so return to R_BARRIER directly."""
            return reset_own_counter(c, R_BARRIER)

        def r_done(c):
            return Effect(next_pc=R_BARRIER,
                          regs={BARRIER: 0})

        # ---- crash-recovery instructions ----------------------------
        def rec_inherit(c):
            """Take over an abandoned predecessor node (detected in
            WA_SPIN). The reference's seven-case ladder, re-validated
            atomically: consume a raced-in grant; inherit an unconsumed
            grant; adopt the dead's acquire continuation; take the CS;
            take over a pre-root-grant release; resume a mid-unwind
            climb; claim as sole live contender. Otherwise wait."""
            lvl = lvl_(c)
            e = e_lvl(c)
            pred = c.reg(PRED)
            my_w = sw_lvl(c)
            pred0 = pred.clamp(min=0)
            pw = sw(c, lvl, pred0)
            pnw = nw(c, lvl, pred0)
            own_s = c.win(my_w)
            sp = c.win(pw)
            exp = c.expired
            pred_dead = entity_dead(c, lvl, pred)
            dcand = exp & (c.rows("ent_rows", lvl) == pred[:, None]) & c.not_p
            if RW:
                dcand = dcand & c.point("is_writer")
            d1 = dcand.to(torch.int8).argmax(1)[:, None]
            dpc = c.st.pc.gather(1, d1)[:, 0]
            dregs = c.st.regs[c.lanes, d1[:, 0]]          # [L, R]
            dL = dregs[:, L]

            def dpc_in(*pcs):
                out = dpc == pcs[0]
                for q in pcs[1:]:
                    out = out | (dpc == q)
                return out

            own_granted = own_s != WAIT
            grant = (sp == ACQUIRE_PARENT) | (sp == MODE_CHANGE) | (sp >= 1)
            unconsumed = dpc_in(WA_SPIN, WA_START_PARENT) & (dL == lvl)
            inherit = ~own_granted & pred_dead & grant & unconsumed
            operating = ((dpc_in(WA_PREP, WA_ENQ, WA_LINK, WA_SPIN,
                                 WA_START_PARENT) & (dL < lvl))
                         | ((dpc == WA_START_PARENT) & (dL == lvl))
                         | dpc_in(W_SCTW_FLAG, W_SCTW_VERIFY))
            adopt = ~own_granted & pred_dead & ~inherit & operating
            take_cs = (~own_granted & pred_dead & ~inherit & ~adopt
                       & (dpc == CS))
            rel_pre = dpc_in(WR_READ, WR_DECIDE, ROOT_DECIDE, ROOT_RESET,
                             ROOT_GETSUCC, ROOT_CAS, ROOT_WAITSUCC,
                             ROOT_PASS)
            rel_unw = dpc_in(UNW_CHECK, UNW_WAIT, UNW_PUT)
            dUL = dregs[:, UL]
            rel_take = (~own_granted & pred_dead & rel_pre
                        & ~(inherit | adopt | take_cs))
            rel_climb = (~own_granted & pred_dead & rel_unw & (dUL <= lvl)
                         & ~(inherit | adopt | take_cs | rel_take))
            sole = (c.st.done | exp | ~c.not_p).all(1)
            claim = (~own_granted & pred_dead & sole
                     & ~(inherit | adopt | take_cs | rel_take | rel_climb))

            s_eff = _w(own_granted, own_s, sp)
            if RW:
                vroute = _w(s_eff == ACQUIRE_PARENT, WA_START_PARENT,
                            _w((lvl == 0) & (s_eff == MODE_CHANGE),
                               W_SCTW_FLAG, CS))
                claim_pc = _w(lvl == 0, W_SCTW_FLAG, WA_START_PARENT)
                take_pc = W_SCTW_FLAG
            else:
                vroute = _w(s_eff == ACQUIRE_PARENT, WA_START_PARENT, CS)
                claim_pc = WA_START_PARENT
                take_pc = CS
            nxt = _w(own_granted | inherit, vroute,
                     _w(adopt, dpc,
                        _w(take_cs, CS,
                           _w(rel_take, take_pc,
                              _w(rel_climb, WA_START_PARENT,
                                 _w(claim, claim_pc, REC_INHERIT))))))
            took = adopt | take_cs | rel_take | rel_climb | claim
            stat_new = _w(own_granted | inherit, s_eff,
                          _w(took, ACQUIRE_START, c.reg(STATUS)))
            r2 = {
                STATUS: stat_new,
                L: _w(adopt, dL, _w(rel_climb, dUL, _w(rel_take, 0, lvl))),
                PRED: _w(adopt, dregs[:, PRED], pred),
                K: _w(adopt, dregs[:, K], _w(rel_take, 0, c.reg(K)))}
            consume = inherit | adopt | take_cs | rel_take | rel_climb
            reclaim = ((inherit | took) & (pred != e))
            resolved = own_granted | inherit | took
            return Effect(
                dur=2.0 * c.lat_plain(my_w) + c.lat_atomic(pw),
                hot=_w(resolved, pw, -1), writes=(my_w, pw, pnw),
                next_pc=nxt, regs=r2,
                stores=((my_w, _w(inherit, s_eff, ACQUIRE_START), consume),
                        (pw, WAIT, reclaim), (pnw, NULL, reclaim)),
                block_a=_w(resolved, -1, pw), block_b=_w(resolved, -1, my_w),
                reclaimed=resolved & ~own_granted, retried=~resolved)

        def rec_tailfix(c):
            """Pass over (or unhook) a dead successor during release
            (TMP holds the level): a ghost (died between tail-FAO and
            link) or a linked successor whose node is abandoned. The
            dead node's own successor gets the grant; if the dead was
            the tail, the tail is cleared; if a live enqueuer is mid-link
            behind it, wait on the dead node's NEXT word."""
            lvl = c.reg(TMP).clamp(max=Nlv - 1)
            at_root = lvl == 0
            e = ent(c, lvl)
            my_next = c.win(nw(c, lvl, e))
            t = tw(c, lvl)
            cur = c.win(t)
            found, e_g, _ = ghost_succ(c, lvl, e)
            linked = ((my_next != NULL)
                      & entity_dead(c, lvl, my_next.clamp(min=0)))
            ghost = (my_next == NULL) & found & no_live_enqueuer(c, lvl)
            e_d = _w(linked, my_next, e_g)
            nwd = nw(c, lvl, e_d)
            dn = c.win(nw(c, lvl, e_d.clamp(min=0)))
            ok = linked | ghost
            skip = ok & (dn != NULL)
            fix = ok & ~skip & (cur == e_d)
            wait_mid = ok & ~skip & ~fix
            gval = _w(at_root, c.reg(NEXT_STAT), ACQUIRE_PARENT)
            wsucc = sw(c, lvl, dn.clamp(min=0))
            repaired = skip | fix
            back = _w(at_root, ROOT_WAITSUCC, UNW_WAIT)
            r = {UL: _w(repaired, torch.maximum(c.reg(UL), lvl + 1),
                        c.reg(UL))}
            return Effect(
                dur=c.lat_atomic(t) + c.lat_plain(wsucc),
                hot=_w(repaired, t, -1), writes=(t, wsucc, nwd),
                next_pc=_w(repaired, UNW_CHECK,
                           _w(wait_mid, REC_TAILFIX, back)),
                regs=r,
                stores=((wsucc, gval, skip), (nwd, NULL, skip),
                        (t, NULL, fix)),
                block_a=_w(wait_mid, nw(c, lvl, e_d.clamp(min=0)), -1),
                reclaimed=repaired, retried=~repaired)

        def rec_drain(c):
            """Zero dead readers' unmatched arrivals on counter K so
            W_SCTW_VERIFY can complete; our WRITE_FLAG is preserved."""
            k = c.reg(K)
            wa, wd = wa_k(c), wd_k(c)
            arr, dep = c.win(wa), c.win(wd)
            clear = (arr - WRITE_FLAG) == dep
            stale = (~clear) & ctr_quiescent(c, k)
            fixed = clear | stale
            last = k + 1 >= c.point("n_ctr")
            r = {K: _w(fixed & ~last, k + 1, _w(fixed & last, 0, k))}
            return Effect(dur=2.0 * c.lat_plain(wa) + c.lat_atomic(wa),
                          hot=wa, writes=(wa,),
                          next_pc=_w(fixed & last, WA_START_PARENT,
                                     W_SCTW_VERIFY),
                          regs=r,
                          stores=((wa, _w(stale, dep + WRITE_FLAG, arr)),),
                          reclaimed=stale, retried=~fixed)

        def r_unbar(c):
            """A barred reader clears a counter wedged by the dead:
            reset both words once every writer is done or expired and no
            live reader of this counter holds an arrival."""
            wa, wd = wa_p(c), wd_p(c)
            ok = writers_gone(c) & ctr_quiescent(c, ctr_p(c))
            arr, dep = c.win(wa), c.win(wd)
            r = {BARRIER: _w(ok, 0, c.reg(BARRIER))}
            return Effect(dur=2.0 * c.lat_plain(wa) + 2.0 * c.lat_atomic(wa),
                          hot=wa, writes=(wa, wd), next_pc=R_BARRIER, regs=r,
                          stores=((wa, _w(ok, 0, arr)), (wd, _w(ok, 0, dep))),
                          reclaimed=ok, retried=~ok)

        def trap(c):
            # pc 7 is unused: a self-loop shows up as a stuck process if
            # anything ever mis-routes here.
            return Effect(dur=1.0, next_pc=7)

        instrs = [Instr(trap)] * N_PCS
        instrs[WA_PREP] = Instr(wa_prep)
        instrs[WA_ENQ] = Instr(wa_enq)
        instrs[WA_LINK] = Instr(wa_link)
        instrs[WA_SPIN] = Instr(wa_spin)
        instrs[WA_START_PARENT] = Instr(wa_start_parent)
        instrs[W_SCTW_FLAG] = Instr(w_sctw_flag)
        instrs[W_SCTW_VERIFY] = Instr(w_sctw_verify)
        instrs[CS] = Instr(cs_instr, CS_KIND)
        instrs[WR_READ] = Instr(wr_read)
        instrs[WR_DECIDE] = Instr(wr_decide)
        instrs[ROOT_DECIDE] = Instr(root_decide)
        instrs[ROOT_RESET] = Instr(root_reset)
        instrs[ROOT_CAS] = Instr(root_cas)
        instrs[ROOT_WAITSUCC] = Instr(root_waitsucc)
        instrs[ROOT_PASS] = Instr(root_pass)
        instrs[UNW_CHECK] = Instr(unw_check)
        instrs[UNW_WAIT] = Instr(unw_wait)
        instrs[UNW_PUT] = Instr(unw_put)
        instrs[DONE_ONE] = Instr(done_one, DONE)
        instrs[ROOT_GETSUCC] = Instr(root_getsucc)
        instrs[R_BARRIER] = Instr(r_barrier)
        instrs[R_FAO] = Instr(r_fao)
        instrs[R_CHECK_TAIL] = Instr(r_check_tail)
        instrs[R_BACKOFF] = Instr(r_backoff)
        instrs[R_CS] = Instr(r_cs, CS_KIND)
        instrs[R_RELEASE] = Instr(r_release)
        instrs[R_RESET] = Instr(r_reset)
        instrs[R_DONE] = Instr(r_done, DONE)
        instrs[R_RECOVER] = Instr(r_recover)
        instrs[REC_INHERIT] = Instr(rec_inherit)
        instrs[REC_TAILFIX] = Instr(rec_tailfix)
        instrs[REC_DRAIN] = Instr(rec_drain)
        instrs[R_UNBAR] = Instr(r_unbar)
        if not faults:
            for pc in (REC_INHERIT, REC_TAILFIX, R_UNBAR):
                instrs[pc] = Instr(trap)
        return instrs


def rma_rw() -> HierProgram:
    return HierProgram(has_readers=True)


def rma_mcs() -> HierProgram:
    return HierProgram(has_readers=False)


d_mcs = rma_mcs  # D-MCS is RMA-MCS on a 1-level machine (single queue).

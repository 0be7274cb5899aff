"""The smaller pieces of locklint on the port against the JAX reference,
on the CPU: the layout lints (the lattice, and layouts broken on
purpose), the four seeded mutants (the same `Finding` strings, with
their counterexample traces), the IR of the spin lock, the runtime
sanitizer, the CLI and the deprecated per-kind shims."""
import contextlib
import dataclasses
import importlib
import io
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.analysis import lints as ref_lints  # noqa: E402
from repro.analysis import locklint as ref_locklint  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.cost import CostModel as RefCost  # noqa: E402
# The reference's recorder rebinds these names in each handler's module,
# so its mutants below must call them by these names.
from repro.core.engine import cs_exit, finish_instr  # noqa: E402
from repro.core.programs import fompi as ref_fompi  # noqa: E402
from repro.core.session import Session as RefSession  # noqa: E402
from repro.core.spec import LockSpec as RefSpec  # noqa: E402
from repro.core.spec import registered_kinds  # noqa: E402
from repro.core.topology import build_machine as ref_machine  # noqa: E402
from repro.core.window import build_layout as ref_layout  # noqa: E402
from repro_torch.analysis import ir, lints, locklint, mutants  # noqa: E402
from repro_torch.analysis.model import Explorer  # noqa: E402
from repro_torch.core import LockSpec, Session, engine  # noqa: E402
from repro_torch.core.cost import CostModel  # noqa: E402
from repro_torch.core.engine import DONE, Effect, Instr, Program  # noqa: E402
from repro_torch.core.programs.fompi import S_CS, S_REL, S_TRY  # noqa: E402
from repro_torch.core.topology import build_machine  # noqa: E402
from repro_torch.core.window import build_layout  # noqa: E402

RefSpin = ref_fompi.FompiSpin
S_DONE = ref_fompi.S_DONE


# ------------------------------------------------------------- layouts
def test_layout_lattice_clean_in_both():
    assert ref_locklint.check_layout_lattice() == []
    assert locklint.check_layout_lattice() == []


def _broken(layout_mod_build, machine_build, field, value):
    m = machine_build(8, (2,))
    lay = layout_mod_build(m, T_DC=2, extra_words=4, pad_counters_to=8)
    return dataclasses.replace(lay, **{field: value(lay)}), m


BROKEN = {
    # Two counters share a word: the tables alias.
    "aliased": ("depart_w", lambda lay: np.concatenate(
        [lay.arrive_w[:1], lay.depart_w[1:]])),
    # A counter word past the window, and a word left unallocated.
    "out_of_range": ("arrive_w", lambda lay: np.concatenate(
        [lay.arrive_w[:-1], [lay.W + 3]])),
    # The live-counter mask is not [True] * C + [False] * pad.
    "bad_ctr_mask": ("ctr_mask", lambda lay: lay.ctr_mask[::-1].copy()),
    # Scratch words are not the window's last ones.
    "scratch_moved": ("scratch_w", lambda lay: lay.scratch_w - 1),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_layout_gives_the_reference_findings(name):
    field, value = BROKEN[name]
    ref_lay, ref_m = _broken(ref_layout, ref_machine, field, value)
    lay, m = _broken(build_layout, build_machine, field, value)
    want = [str(f) for f in ref_lints.check_layout(ref_lay, ref_m, name)]
    got = [str(f) for f in lints.check_layout(lay, m, name)]
    assert want and got == want


# ------------------------------------------------------------- mutants
class RefDroppedExitSpin(RefSpin):
    def _build(self, env):
        h = list(super()._build(env))
        LW = env.scratch_w[self.lock_slot]

        def s_rel(p, now, key, st):
            win = st.window.at[LW].set(0)      # no cs_exit(...)
            return finish_instr(env, st, p, now, key,
                                dur=env.lat_atomic(p, LW), hot_word=LW,
                                writes=[LW], next_pc=S_DONE,
                                regs_row=st.regs[p], window=win)
        h[S_REL] = s_rel
        return tuple(h)


class RefStuckReleaseSpin(RefSpin):
    def _build(self, env):
        h = list(super()._build(env))

        def s_rel(p, now, key, st):
            st = cs_exit(env, st, p)           # accounting ok, word stuck
            return finish_instr(env, st, p, now, key,
                                dur=env.lat_atomic(
                                    p, env.scratch_w[self.lock_slot]),
                                hot_word=-1, writes=[], next_pc=S_DONE,
                                regs_row=st.regs[p])
        h[S_REL] = s_rel
        return tuple(h)


class RefMisaimedWakeSpin(RefSpin):
    def _build(self, env):
        h = list(super()._build(env))
        LW = env.scratch_w[self.lock_slot]
        WRONG = env.scratch_w[1]

        def s_try(p, now, key, st):
            cur = st.window[LW]
            got = cur == 0
            win = st.window.at[LW].set(jnp.where(got, 1, cur))
            return finish_instr(env, st, p, now, key,
                                dur=env.lat_atomic(p, LW), hot_word=LW,
                                writes=[LW],
                                next_pc=jnp.where(got, S_CS, S_TRY),
                                regs_row=st.regs[p], window=win,
                                block_a=jnp.where(got, ref_fompi._NOOP,
                                                  WRONG))
        h[S_TRY] = s_try
        return tuple(h)


class RefOutOfSegmentSpin(RefSpin):
    def _build(self, env):
        h = list(super()._build(env))
        orig = h[S_CS]

        def s_cs(p, now, key, st):
            _ = st.window[env.arrive_w[0]]     # recorded by the tracer
            return orig(p, now, key, st)
        h[S_CS] = s_cs
        return tuple(h)


MUTANTS = {
    "dropped_exit": (mutants.DroppedExitSpin, RefDroppedExitSpin),
    "stuck_release": (mutants.StuckReleaseSpin, RefStuckReleaseSpin),
    "misaimed_wake": (mutants.MisaimedWakeSpin, RefMisaimedWakeSpin),
    "out_of_segment": (mutants.OutOfSegmentSpin, RefOutOfSegmentSpin),
}


def _check_mutant(lockspec, session, program, **kw):
    s = session(lockspec(kind="fompi_spin", P=2), target_acq=2, cs_kind=0,
                think=False, **kw)
    mod = locklint if session is Session else ref_locklint
    return mod.check_config(program, s.env, s.layout,
                            program.meta(s.env), "mutant")[0]


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_mutant_caught_with_the_reference_findings(name):
    port_cls, ref_cls = MUTANTS[name]
    got = _check_mutant(LockSpec, Session, port_cls(), device="cpu")
    want = _check_mutant(RefSpec, RefSession, ref_cls())
    assert mutants.caught(port_cls, got), got
    assert [str(f) for f in got] == [str(f) for f in want]


# ----------------------------------------------------------------- IR
def test_ir_recovers_spin_lock_shape():
    s = Session(LockSpec(kind="fompi_spin", P=2), target_acq=2, cs_kind=0,
                think=False, device="cpu")
    meta = s.program.meta(s.env)
    res = Explorer(s.program, s.env, s.layout).explore()
    assert res.ok, res.findings
    pir = ir.extract(s.program, s.env, s.layout, res, meta=meta)
    LW = int(np.asarray(s.layout.scratch_w)[0])
    assert pir.instrs[S_TRY].atomic_words == {LW}
    assert LW in pir.instrs[S_REL].declared_writes
    assert pir.instrs[S_CS].enters_cs and pir.instrs[S_REL].exits_cs
    assert pir.cfg_successors(S_TRY) == {S_TRY, S_CS}
    assert pir.instrs[S_TRY].reads == {LW} == pir.instrs[S_TRY].writes


# ---------------------------------------------------- runtime sanitizer
SANITIZED_RW = dict(kind="rma_rw", P=4, fanout=(2,), T_DC=2, T_L=(1, 2),
                    T_R=2, writer_fraction=0.5)


def _equal(m, ref_m):
    for name, a in zip(m._fields, m):
        b = np.asarray(getattr(ref_m, name))
        if name == "mean_latency":
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_sanitizer_clean_run_and_batch():
    ref = RefSession(RefSpec(**SANITIZED_RW), target_acq=2, cs_kind=0,
                     think=False).run(seed=0)
    s = Session(LockSpec(**SANITIZED_RW), target_acq=2, cs_kind=0,
                think=False, device="cpu")
    with engine.runtime_checks(True):
        assert engine.checks_enabled()
        m = s.run(seed=0)
        mb = s.run_batch(seeds=np.arange(2))
    assert not engine.checks_enabled()
    assert bool(m.completed) and int(m.violations) == 0
    assert int(mb.violations.sum()) == 0 and bool(mb.completed.all())
    _equal(m, ref)
    _equal(engine.metrics_at(mb, 0), ref)


def test_sanitizer_follows_the_environment_variable(monkeypatch):
    monkeypatch.setenv("REPRO_CHECKS", "1")
    assert engine.checks_enabled()
    with engine.runtime_checks(False):
        assert not engine.checks_enabled()
    monkeypatch.setenv("REPRO_CHECKS", "0")
    assert not engine.checks_enabled()


def _dead_counter_reference() -> str:
    spec = RefSpec(kind="fompi_spin", P=2)
    machine = spec.machine()
    lay = ref_layout(machine, T_DC=1, pad_counters_to=machine.P + 2)
    env = ref_engine.make_env(machine, lay, is_writer=np.ones(2, bool),
                              target_acq=1)
    dead = int(np.asarray(lay.arrive_w)[-1])

    def bad(p, now, key, st):
        win = st.window.at[dead].add(1)
        return finish_instr(env, st, p, now, key, dur=1.0, hot_word=-1,
                            writes=[dead], next_pc=1,
                            regs_row=st.regs[p], window=win)

    def halt(p, now, key, st):
        return finish_instr(env, st, p, now, key, dur=0.0, hot_word=-1,
                            writes=[], next_pc=1, regs_row=st.regs[p],
                            extra=lambda s, f: s._replace(
                                done=s.done.at[p].set(True)))

    st0 = ref_engine.init_state(env, lay, np.zeros(2, np.int32), 1)
    with ref_engine.runtime_checks(True):
        with pytest.raises(Exception) as err:
            ref_engine._run((bad, halt), 1000, st0, 0)
    return str(err.value)


def _dead_counter_program(device="cpu"):
    machine = LockSpec(kind="fompi_spin", P=2).machine()
    lay = build_layout(machine, T_DC=1, pad_counters_to=machine.P + 2)
    env = engine.make_env(machine, lay, is_writer=np.ones(2, bool),
                          target_acq=1, device=device)
    dead = int(np.asarray(lay.arrive_w)[-1])

    def bad(c):
        return Effect(dur=1.0, writes=(dead,), next_pc=1,
                      stores=((dead, c.win(dead) + 1),))

    def halt(c):
        return Effect(dur=0.0, next_pc=1)

    prog = Program(env, (Instr(bad), Instr(halt, DONE)))
    return prog, engine.init_state(env, lay, np.zeros(2, np.int32), 1)


def test_sanitizer_traps_dead_counter_write_with_the_reference_message():
    want = _dead_counter_reference()
    prog, st0 = _dead_counter_program()
    with engine.runtime_checks(True):
        with pytest.raises(RuntimeError, match="dead counter") as err:
            engine.step_loop(prog, 1000, st0, [0])
    msg = str(err.value).split(";")[0]
    assert msg == "write word 8 is a padded dead counter slot"
    assert want.startswith(msg)
    # The same run is silent without the sanitizer.
    assert int(engine.step_loop(prog, 1000, st0, [0]).events[0]) > 0


@pytest.mark.parametrize("what,eff,message", [
    ("negative_duration", dict(dur=-1.0, next_pc=1),
     "negative instruction duration -1.0"),
    ("hot_outside", dict(dur=1.0, hot=99, next_pc=1),
     "hot word 99 outside [-1, W)"),
    ("window_gather", None,
     "out-of-bounds indexing for window gather of shape (13,): index 40 is "
     "out of bounds for axis 0 with size 13 (pc 0)"),
], ids=["negative_duration", "hot_outside", "window_gather"])
def test_sanitizer_other_checks(what, eff, message):
    prog, st0 = _dead_counter_program()
    env = prog.env

    def first(c):
        if eff is None:
            c.win(c.const(40))
            return Effect(dur=1.0, next_pc=1)
        return Effect(**eff)

    prog = Program(env, (Instr(first), prog.full[1]))
    with engine.runtime_checks(True):
        with pytest.raises(RuntimeError) as err:
            engine.step_loop(prog, 1000, st0, [0])
    assert str(err.value) == message + "; first at lane 0"


def test_crash_case_is_clean_under_checks():
    """tests/test_faults.py's rma_rw writer crash, under the sanitizer,
    against the reference's run."""
    kw = dict(kind="rma_rw", P=4, fanout=(2,), T_DC=2, T_L=(2, 2), T_R=4,
              writer_fraction=0.5)
    rs = RefSession(RefSpec(**kw), target_acq=3, max_events=400_000)
    ref = ref_engine.run_sim(rs.program, rs.env, rs.layout, seed=0,
                             max_events=400_000,
                             fault=ref_engine.FaultPlan.single(4, 0, 1.0))
    s = Session(LockSpec(**kw), target_acq=3, max_events=400_000,
                device="cpu")
    with engine.runtime_checks(True):
        m = engine.run_sim(s.program, s.env, s.layout, seed=0,
                           max_events=400_000,
                           fault=engine.FaultPlan.single(4, 0, 1.0))
    assert int(m.violations) == 0 and bool(m.completed)
    _equal(m, ref)


# ------------------------------------------------------------------ CLI
def _table(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    rows = [ln for ln in out.getvalue().splitlines() if " edges " in ln]
    return rc, rows, out.getvalue()


def test_cli_prints_the_reference_rows():
    rc, rows, text = _table(locklint.main, ["--kind", "fompi_spin",
                                            "--quick", "--device", "cpu"])
    ref_rc, ref_rows, _ = _table(ref_locklint.main,
                                 ["--kind", "fompi_spin", "--quick"])
    assert rc == ref_rc == 0
    assert rows == ref_rows and len(rows) == 2
    assert "locklint: clean (2 configs, 226 states explored)" in text
    assert "levels" in text and "s in all on cpu" in text


# ---------------------------------------------------------------- shims
def test_shim_module_warns_and_lists_every_kind():
    sys.modules.pop("repro_torch.core.api", None)
    with pytest.warns(DeprecationWarning,
                      match="repro_torch.core.LockSpec.*Session"):
        api = importlib.import_module("repro_torch.core.api")
    assert set(api.LOCKS) == set(registered_kinds())
    with pytest.warns(DeprecationWarning, match="kind='d_mcs'"):
        api.DMCSLock(P=2, device="cpu")


SHIM_ARGS = {
    "rma_rw": dict(P=4, fanout=(2,), T_DC=2, T_L=(2, 2), T_R=4,
                   writer_fraction=0.5),
    "rma_mcs": dict(P=4, fanout=(2,), T_L=(2, 2)),
    "d_mcs": dict(P=4),
    "fompi_spin": dict(P=4),
    "fompi_rw": dict(P=4, writer_fraction=0.5),
}


@pytest.mark.parametrize("kind", sorted(SHIM_ARGS))
def test_shim_run_equals_the_reference_shim(kind):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.core import api as ref_api
        from repro_torch.core import api
    ref = ref_api.LOCKS[kind](cost=RefCost(jitter=0.0), **SHIM_ARGS[kind])
    with pytest.warns(DeprecationWarning):
        lock = api.LOCKS[kind](cost=CostModel(jitter=0.0), device="cpu",
                               **SHIM_ARGS[kind])
    assert lock.kind == kind and lock.spec.kind == kind
    m = lock.run(target_acq=2, seed=0)
    _equal(m, ref.run(target_acq=2, seed=0))
    assert lock.layout.W == ref.layout.W
    np.testing.assert_array_equal(lock.is_writer, ref.is_writer)
    assert lock.make_env(target_acq=2).device.type == "cpu"

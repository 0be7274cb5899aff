"""The port's model checker (`repro_torch.analysis.model.Explorer`, one
engine call per breadth-first level) and its IR against the JAX
reference, on the CPU.

For every `--quick` configuration of the reference's locklint (the 10
lock configurations, with and without a crash victim, and the foMPI-A
DHT program under model seeds 0-3), plus five non-quick ones (P=3 and a
crash of p1 among them):

* the reachable states in insertion order (as `canon_key` bytes) and
  the edges, with their processes and order, equal the reference's
  (Gate B: the port's successor of every reachable canonical state, for
  every process, is the reference's);
* `n_states`, `n_edges`, `n_terminals`, `n_interleavings`, `capped`,
  `pc_reached`, `pc_successors`, `watch_words` and the samples' pcs and
  processes are equal, and neither finds anything;
* per pc, the IR's declared effects (`declared_writes`, `hot_words`,
  `successors`, `watch_words`, `enters_cs`, `exits_cs`) are equal; the
  observed footprints may differ (the reference loses accesses funneled
  through `jnp.where` and `lax.cond`), so the port's must hold the
  reference's, and the lints give the same findings on both.

`chip_smoke.LOCKLINT_EXPECTED`'s rows of these configurations equal the
reference's counts here; the whole pinned table (every `--all`
configuration) equals the port's own run on the CPU. Levels wider than
the Explorer's lane budget, run as several engine calls, give the
reference's states and edges too.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analysis.model as ref_model  # noqa: E402
from repro.analysis import ir as ref_ir  # noqa: E402
from repro.analysis import lints as ref_lints  # noqa: E402
from repro.analysis import locklint as ref_locklint  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.programs.dht import FompiADHT as RefADHT  # noqa: E402
from repro.core.session import Session as RefSession  # noqa: E402
from repro.core.spec import writer_mask as ref_writer_mask  # noqa: E402
import repro_torch.analysis.model as model  # noqa: E402
from repro_torch.analysis import ir, lints, locklint  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.programs.dht import FompiADHT  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.core.spec import LockSpec, writer_mask  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (kind, index into CONFIGS[kind]) of every quick config, then the
# non-quick configs the reference checks in a few seconds each:
# fompi_spin P=3, fompi_rw P=3, crash p1 and P=3 crash p0, rma_rw P=3.
CASES = [(k, i) for k, cfgs in sorted(locklint.CONFIGS.items())
         for i, c in enumerate(cfgs) if c.quick] + [
    ("fompi_spin", 1), ("fompi_rw", 1), ("fompi_rw", 3), ("fompi_rw", 4),
    ("rma_rw", 3)] + [("dht", s) for s in range(4)]
IDS = [f"{k}-{i}" if k != "dht" else f"dht-seed{i}" for k, i in CASES]
DECLARED = ("declared_writes", "hot_words", "successors", "watch_words",
            "enters_cs", "exits_cs", "n_samples")
OBSERVED = ("reads", "writes", "reg_reads", "reg_writes")


def _capture(mod):
    """A wrapper of mod._count_interleavings that keeps the last state
    graph an explore() built (every state in insertion order, since no
    run here is capped), and the box it keeps it in."""
    box = {}
    orig = mod._count_interleavings

    def counting(graph, root, terminals, **kw):
        box["graph"] = graph
        return orig(graph, root, terminals, **kw)
    return box, counting


def _dht(pkg_spec, engine_mod, adht, mask_fn, **env_kw):
    """locklint's check_dht wiring, with one package's classes."""
    spec = pkg_spec(kind="fompi_spin", P=3)
    machine = spec.machine()
    layout = spec.layout(machine, extra_words=5)
    W = layout.W
    mask = mask_fn(3, 0.34)
    program = adht(np.arange(W - 5, W - 1, dtype=np.int32), W - 1, mask)
    env = engine_mod.make_env(machine, layout, is_writer=mask,
                              target_acq=2, **env_kw)
    return program, env, layout


def _explore(mod, ir_mod, lints_mod, program, env, layout, *, seed,
             victim, box, **kw):
    res = mod.Explorer(program, env, layout, model_seed=seed,
                       crash_victim=victim, **kw).explore()
    graph = box.pop("graph")
    meta = program.meta(env)
    pir = ir_mod.extract(program, env, layout, res, meta=meta)
    crashed = victim is not None
    found = [str(f) for f in (
        lints_mod.check_bounds(pir, layout, meta, "c")
        + lints_mod.check_structure(pir, meta, "c")
        + lints_mod.check_wakeup(pir, meta, layout, "c")
        + lints_mod.check_recovery(pir, meta, crashed, "c"))]
    keys = list(graph)
    index = {k: i for i, k in enumerate(keys)}
    edges = [(index[k], p, index[s]) for k in keys for p, s in graph[k]]
    return {"res": res, "keys": keys, "edges": edges, "pir": pir,
            "lints": found}


def _run_case(case, ref: bool, box):
    kind, i = case
    mod = ref_model if ref else model
    if kind == "dht":
        if ref:
            args = _dht(ref_locklint.LockSpec, ref_engine, RefADHT,
                        ref_writer_mask)
        else:
            args = _dht(LockSpec, engine, FompiADHT, writer_mask,
                        device="cpu")
        seed, victim = i, None
    else:
        cfg = locklint.CONFIGS[kind][i]
        if ref:
            s = RefSession(ref_locklint.CONFIGS[kind][i].spec(),
                           target_acq=cfg.target_acq, cs_kind=0, think=False)
        else:
            s = Session(cfg.spec(), target_acq=cfg.target_acq, cs_kind=0,
                        think=False, device="cpu")
        args = (s.program, s.env, s.layout)
        seed, victim = 0, cfg.crash_victim
    return _explore(mod, ref_ir if ref else ir, ref_lints if ref else lints,
                    *args, seed=seed, victim=victim, box=box)


@pytest.fixture(scope="module")
def runs():
    """{case: (reference run, port run)}."""
    mp = pytest.MonkeyPatch()
    boxes = {}
    for mod in (ref_model, model):
        boxes[mod], counting = _capture(mod)
        mp.setattr(mod, "_count_interleavings", counting)
    try:
        return {case: (_run_case(case, True, boxes[ref_model]),
                       _run_case(case, False, boxes[model]))
                for case in CASES}
    finally:
        mp.undo()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_states_and_edges_equal_reference(runs, case):
    ref, port = runs[case]
    assert len(port["keys"]) == port["res"].n_states > 1
    assert port["keys"] == ref["keys"]
    assert port["edges"] == ref["edges"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_counts_and_observations_equal_reference(runs, case):
    ref_res, res = runs[case][0]["res"], runs[case][1]["res"]
    for f in ("n_states", "n_edges", "n_terminals", "n_interleavings",
              "interleavings_capped", "capped", "pc_reached",
              "pc_successors", "watch_words"):
        assert getattr(res, f) == getattr(ref_res, f), f
    assert ({pc: [p for _, p in v] for pc, v in res.samples.items()}
            == {pc: [p for _, p in v] for pc, v in ref_res.samples.items()})
    for pc, v in res.samples.items():
        assert [model.canon_key(c) for c, _ in v] == [
            ref_model.canon_key(c) for c, _ in ref_res.samples[pc]]
    assert res.findings == [] and ref_res.findings == []
    assert 0 < res.widest and res.levels > 1


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ir_declared_effects_equal_reference(runs, case):
    ref, port = runs[case][0]["pir"], runs[case][1]["pir"]
    assert sorted(port.instrs) == sorted(ref.instrs)
    assert port.pc_reached == ref.pc_reached
    assert port.pc_successors == ref.pc_successors
    for pc, a in ref.instrs.items():
        b = port.instrs[pc]
        assert b.name == a.name
        for f in DECLARED:
            assert getattr(b, f) == getattr(a, f), (pc, f)
        # The reference's TraceArray loses accesses read through
        # jnp.where / lax.cond outputs, the port records every one.
        for f in OBSERVED:
            assert getattr(a, f) <= getattr(b, f), (pc, f)
        assert b.regs_row_lens == set()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lints_agree_with_reference(runs, case):
    ref, port = runs[case]
    assert port["lints"] == ref["lints"] == []


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_locklint", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pinned_quick_rows_equal_reference(runs):
    expected = _chip_smoke().LOCKLINT_EXPECTED
    for kind, i in CASES:
        if kind == "dht":
            continue
        cfg = locklint.CONFIGS[kind][i]
        res = runs[(kind, i)][0]["res"]
        assert expected[(kind, cfg.label)] == (
            res.n_states, res.n_edges, res.n_interleavings, res.capped)
    dht = [runs[("dht", s)][0]["res"] for s in range(4)]
    assert expected[("fompi_a_dht", "P=3 table=4 wf=0.34")] == (
        sum(r.n_states for r in dht), sum(r.n_edges for r in dht),
        max(r.n_interleavings for r in dht), any(r.capped for r in dht))


def test_pinned_table_equals_the_ports_full_run():
    """Every `--all` configuration's counts (the reference's, pinned in
    chip_smoke.py) from the port's own checker on the CPU, and clean."""
    expected = _chip_smoke().LOCKLINT_EXPECTED
    stats, findings = [], []
    for kind in sorted(locklint.CONFIGS):
        f, st = locklint.check_kind(kind, device="cpu")
        findings += f
        stats += st
    f, st = locklint.check_dht(device="cpu")
    findings += f
    stats += st
    assert [str(f) for f in findings] == []
    got = {(st.kind, st.config): (st.n_states, st.n_edges,
                                  st.n_interleavings, st.capped)
           for st in stats}
    assert got == expected
    assert sum(v[0] for v in got.values()) == 126_736


@pytest.mark.parametrize("case, budget", [
    (("fompi_spin", 2), 7), (("rma_mcs", 3), 97)],
    ids=["fompi_spin-2-budget7", "rma_mcs-3-budget97"])
def test_chunked_levels_equal_reference(runs, monkeypatch, case, budget):
    """A level wider than the lane budget runs as several engine calls
    (as the P=4 livelock search's levels do at the default budget); the
    chunks' successors, concatenated, give the reference's states and
    edges, crash transitions included."""
    box, counting = _capture(model)
    monkeypatch.setattr(model, "_count_interleavings", counting)
    kind, i = case
    cfg = locklint.CONFIGS[kind][i]
    assert cfg.crash_victim is not None
    s = Session(cfg.spec(), target_acq=cfg.target_acq, cs_kind=0,
                think=False, device="cpu")
    port = _explore(model, ir, lints, s.program, s.env, s.layout, seed=0,
                    victim=cfg.crash_victim, box=box, lane_budget=budget)
    ref = runs[case][0]
    assert port["res"].widest > 2 * budget
    assert port["keys"] == ref["keys"]
    assert port["edges"] == ref["edges"]
    assert port["lints"] == ref["lints"] == []
    for f in ("n_states", "n_edges", "n_terminals", "n_interleavings",
              "pc_reached", "pc_successors", "watch_words"):
        assert getattr(port["res"], f) == getattr(ref["res"], f), f


@pytest.mark.parametrize("cap", [6, 7, 60])
def test_state_cap_stops_where_the_reference_stops(cap):
    """A capped search stops at the same edge as the reference's: the
    crash transition and the process steps of a state are inserted in
    the reference's order, and the edge is counted before the cap."""
    cfg = locklint.CONFIGS["fompi_spin"][2]        # crash_victim=0
    assert cfg.crash_victim == 0
    rs = RefSession(ref_locklint.CONFIGS["fompi_spin"][2].spec(),
                    target_acq=cfg.target_acq, cs_kind=0, think=False)
    s = Session(cfg.spec(), target_acq=cfg.target_acq, cs_kind=0,
                think=False, device="cpu")
    ref = ref_model.Explorer(rs.program, rs.env, rs.layout, max_states=cap,
                             crash_victim=0).explore()
    res = model.Explorer(s.program, s.env, s.layout, max_states=cap,
                         crash_victim=0).explore()
    assert ref.capped and res.capped and res.n_states == cap
    for f in ("n_states", "n_edges", "n_terminals", "n_interleavings",
              "interleavings_capped", "pc_reached", "pc_successors",
              "watch_words"):
        assert getattr(res, f) == getattr(ref, f), f
    assert ({pc: [(model.canon_key(c), p) for c, p in v]
             for pc, v in res.samples.items()}
            == {pc: [(ref_model.canon_key(c), p) for c, p in v]
                for pc, v in ref.samples.items()})


# The shortest counterexample the port's checker found for the P=4
# recovery livelock (`python -m repro_torch.launch.livelock`, target_acq
# 1): (process, pc it executes), CRASH_PC for process 3's crash.
LIVELOCK_TRACE = (
    (0, 0), (0, 1), (0, 4), (0, 0), (1, 0), (1, 1), (1, 2), (1, 3),
    (2, 0), (2, 1), (2, 4), (2, 0), (2, 1), (0, 1), (0, 2), (2, 4), (2, 8),
    (3, 0), (3, 1), (3, 2), (2, 9), (2, 10), (3, model.CRASH_PC), (2, 16),
    (2, 20), (0, 3))


def test_recovery_livelock_trace_is_stuck_in_both():
    """Replayed step by step, the trace reaches the same state in both
    packages, and there every survivor's only move leads back to it: a
    stuck state no schedule leaves, whatever the timing."""
    kw = dict(kind="rma_mcs", P=4, fanout=(2,), T_L=(2, 2))
    rs = RefSession(ref_locklint.LockSpec(**kw), target_acq=1, cs_kind=0,
                    think=False)
    s = Session(LockSpec(**kw), target_acq=1, cs_kind=0, think=False,
                device="cpu")
    ref_step = ref_model.make_stepper(rs.program.build(rs.env), rs.env,
                                      rs.layout)
    ex = model.Explorer(s.program, s.env, s.layout, crash_victim=3)

    def ref_next(c, p):
        return ref_model.Canon(*(x[p] for x in ref_step(c)[:10]))

    def port_next(c, p):
        cols = model.Canon(*(np.asarray(x)[None] for x in c))
        succ, _ = ex.successors(cols, np.array([p]))
        return model.Canon(*(x[0] for x in succ))

    ref_c = ref_model.Explorer(rs.program, rs.env, rs.layout).init_canon()
    c = ex.init_canon()
    for p, pc in LIVELOCK_TRACE:
        if pc == model.CRASH_PC:
            ref_c, c = ref_model.crash_canon(ref_c, p), model.crash_canon(c, p)
            continue
        assert int(c.pc[p]) == pc == int(ref_c.pc[p])
        ref_c, c = ref_next(ref_c, p), port_next(c, p)
        assert model.canon_key(c) == ref_model.canon_key(ref_c)
    waiting = [p for p in range(4) if not c.done[p] and not c.crashed[p]]
    assert waiting == [0, 1] and c.crashed[3] and c.done[2]
    key = model.canon_key(c)
    for p in waiting:
        assert model.canon_key(port_next(c, p)) == key
        assert ref_model.canon_key(ref_next(ref_c, p)) == key

"""The port's parameter-space sessions against the JAX reference, on the
CPU: `Session.sweep` on each of the four axes, `Session.grid`, the
`devices=` split and the reference's `ValueError`s.

Every Metrics leaf must equal the reference's bit for bit, and every
lattice point must equal a fresh per-point port session: a lattice run
stacks each point's tables (padded counter layouts for T_DC) and runs
every (point, seed) pair as a lane of one run, which must change no
dynamics. Uses the reference's P=8 `SMALL_RW` of tests/test_grid_tuner.py.

The reference compiles its simulator anew for each sweep axis (~20 s on
a CPU), but once per grid shape: its T_L and T_R sweeps are read off
one-axis grids of one shared session (`ref_sweep`), which the reference
holds bitwise equal to its sweeps and its fresh sessions, so the two
axes share one compile.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LockSpec as RefSpec  # noqa: E402
from repro.core import Session as RefSession  # noqa: E402
from repro_torch.core import (LockSpec, Session, engine,  # noqa: E402
                              metrics_at, resolve_devices)

MAX_EVENTS = 400_000
SEEDS = [0, 1]
SMALL_RW = dict(kind="rma_rw", P=8, fanout=(2,), T_DC=2, T_L=(2, 2), T_R=8,
                writer_fraction=0.25)
BASELINE = {k: dict(kind=k, P=8, T_DC=1, writer_fraction=None)
            for k in ("fompi_spin", "fompi_rw")}
SPECS = {"rma_rw": SMALL_RW, **BASELINE}

SWEEPS = [("rma_rw", "T_DC", [1, 2, 8]),
          ("fompi_spin", "T_DC", [1, 2, 8]),
          ("fompi_rw", "T_DC", [1, 2, 8]),
          ("rma_rw", "T_L", [(2, 2), (4, 1), (1, 8)]),
          ("rma_rw", "T_R", [2, 8, 64]),
          ("rma_rw", "writer_fraction", [0.125, 0.25, 0.5])]
GRID = ([1, 8], [(2, 2), (4, 1), None], [4, 16])


def assert_bitwise(got, want, ctx):
    """Every Metrics leaf of the port equals the reference's (numpy or
    torch) bit for bit, in the reference's dtype."""
    for name, g, w in zip(got._fields, got, want):
        w = w.cpu() if isinstance(w, torch.Tensor) else torch.from_numpy(
            np.array(w))
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), (ctx, name)


@pytest.fixture(scope="module")
def ref_sessions():
    """One reference session per spec (target_acq 3), shared."""
    return {k: RefSession(RefSpec(**kw), target_acq=3, max_events=MAX_EVENTS)
            for k, kw in SPECS.items()}


def ref_sweep(ref_session, axis, values):
    """The reference's sweep along `axis`, [len(values), len(SEEDS)]:
    for T_L and T_R, a one-axis grid of the session (one compiled shape
    for both axes); for the other axes, its sweep."""
    if axis not in ("T_L", "T_R"):
        return ref_session.sweep(axis, values, seeds=SEEDS)
    spec = ref_session.spec
    axes = {"T_DC": [spec.T_DC], "T_L": [spec.T_L], "T_R": [spec.T_R]}
    axes[axis] = values
    m = ref_session.grid(axes["T_DC"], axes["T_L"], axes["T_R"], seeds=SEEDS)
    return type(m)(*(np.asarray(leaf).reshape(
        (len(values),) + np.shape(leaf)[3:]) for leaf in m))


def session(kw, **replace) -> Session:
    return Session(LockSpec(**kw).replace(**replace), target_acq=3,
                   max_events=MAX_EVENTS, device="cpu")


@pytest.mark.parametrize("kind,axis,values", SWEEPS,
                         ids=[f"{k}-{a}" for k, a, _ in SWEEPS])
def test_sweep_matches_reference_and_fresh_sessions(ref_sessions, kind, axis,
                                                    values):
    m = session(SPECS[kind]).sweep(axis, values, seeds=SEEDS)
    assert m.events.shape == (len(values), len(SEEDS))
    assert_bitwise(m, ref_sweep(ref_sessions[kind], axis, values),
                   (kind, axis))
    assert int(m.violations.sum()) == 0 and bool(m.completed.all())
    for k, v in enumerate(values):
        fresh = session(SPECS[kind], **{axis: v}).run_batch(SEEDS)
        assert_bitwise(metrics_at(m, k), fresh, (kind, axis, v))


def test_grid_matches_reference_and_fresh_sessions():
    """Every point of one grid — padded T_DC=1 (C = P), the C=1 corner
    T_DC=P, unbounded T_L — equals the reference's grid and a fresh
    per-point session."""
    ref = RefSession(RefSpec(**SMALL_RW), target_acq=2,
                     max_events=MAX_EVENTS).grid(*GRID, seeds=SEEDS)
    sess = Session(LockSpec(**SMALL_RW), target_acq=2,
                   max_events=MAX_EVENTS, device="cpu")
    g = sess.grid(*GRID, seeds=SEEDS)
    assert g.events.shape == (2, 3, 2, 2)
    assert_bitwise(g, ref, "grid")
    for di, d in enumerate(GRID[0]):
        for li, tl in enumerate(GRID[1]):
            for ri, r in enumerate(GRID[2]):
                fresh = Session(LockSpec(**SMALL_RW).replace(
                    T_DC=d, T_L=tl, T_R=r), target_acq=2,
                    max_events=MAX_EVENTS, device="cpu").run_batch(SEEDS)
                assert_bitwise(metrics_at(g, di, li, ri), fresh, (d, tl, r))


def test_grid_is_one_run_with_tables_per_point(monkeypatch):
    """A grid is ONE step_loop whose env stacks its tables per distinct
    value of each group (2 layouts, 2 T_L, 3 T_R here), never per
    lane."""
    runs = []
    step_loop = engine.step_loop

    def counting(prog, *args):
        runs.append(prog.env)
        return step_loop(prog, *args)

    monkeypatch.setattr(engine, "step_loop", counting)
    sess = session(SMALL_RW)
    m = sess.grid([1, 2], [(2, 2), (2, 4)], [4, 8, 16], seeds=SEEDS)
    assert len(runs) == 1 and m.events.shape == (2, 2, 3, 2)
    env = runs[0]
    assert env.ext["plain_w"].shape[0] == 2 and env.ext["T_L"].shape[0] == 2
    assert tuple(env.T_R.shape) == (3,) and env.is_writer.dim() == 1
    assert set(env.lanes) == {"layout", "T_L", "T_R"}
    assert all(ix.shape == (24,) for ix in env.lanes.values())


@pytest.mark.parametrize("shape", ["grid", "sweep", "run_batch"])
def test_devices_split_equals_one_device(shape):
    """Two unequal chunks of the flattened batch (3 entries), run in
    turn, give the one-device run bit for bit; so does a
    constructor-level devices= default, and per-call None overrides it."""
    sess = session(SMALL_RW)
    run = {"grid": lambda **kw: sess.grid([1, 8], [(2, 2)], [4, 16, 64],
                                          **kw),
           "sweep": lambda **kw: sess.sweep("T_DC", [1, 2, 8], **kw),
           "run_batch": lambda **kw: sess.run_batch([0, 1, 2], **kw)}[shape]
    one = run()
    assert_bitwise(run(devices=["cpu"] * 2), one, shape)
    if shape == "run_batch":
        sess.devices = resolve_devices(["cpu"] * 2)
        assert_bitwise(run(), one, shape)
        assert_bitwise(run(devices=None), one, shape)


def _raises(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("bad", [
    ([], [(2, 2)], [4]), ([0], [(2, 2)], [4]), ([9], [(2, 2)], [4]),
    ([1], [(2, 2, 2)], [4]), ([1], [(2, 0)], [4]), ([1], [(2, 2)], [0])],
    ids=["empty", "tdc0", "tdc_gt_P", "tl_len", "tl0", "tr0"])
def test_grid_raises_the_reference_errors(ref_sessions, bad):
    sess = session(SMALL_RW)
    assert _raises(lambda: sess.grid(*bad)) == _raises(
        lambda: ref_sessions["rma_rw"].grid(*bad))


def test_sweep_and_devices_raise_the_reference_errors(ref_sessions):
    sess = session(SMALL_RW)
    for axis, values in (("fanout", [(2,)]), ("T_DC", [0]), ("T_R", [0])):
        assert _raises(lambda: sess.sweep(axis, values)) == _raises(
            lambda: ref_sessions["rma_rw"].sweep(axis, values))
    assert _raises(lambda: resolve_devices([])) == (
        "devices must be None, an int >= 1, or a non-empty device sequence")
    n = torch.cuda.device_count()
    assert "torch.cuda.device_count()" in _raises(
        lambda: resolve_devices(n + 1))
    assert "torch.cuda.device_count()" in _raises(lambda: resolve_devices(0))


def test_lattice_env_needs_layouts_that_share_their_words():
    spec = LockSpec(**SMALL_RW)
    m = spec.machine()
    from repro_torch.core.window import build_layout
    layouts = [build_layout(m, 1, 4), build_layout(m, 8, 4)]   # unpadded
    with pytest.raises(ValueError, match="C_pad"):
        engine.make_env(m, layouts, lanes={"layout": [0, 1]}, device="cpu")
    with pytest.raises(ValueError, match="lattice groups"):
        engine.make_env(m, layouts[0], lanes={"T_DC": [0]}, device="cpu")

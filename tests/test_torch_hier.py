"""The port's pod-local hierarchical training against the JAX reference,
on the CPU: int8 compression with error feedback and the two cross-pod
syncs bit for bit, `init_hier_state`'s layout, the hierarchical train
step continued from a converted reference state for T_pod 1 and 2 with
and without compression, the sync modes, and the launcher's `--hier`
lines.

Inputs are numpy arrays from fixed seeds handed to both packages; states
go across through `models.convert.hier_state_from_reference`. The
compression and the syncs are the reference's float32 ops in its order,
so they must equal the reference run op by op (`jax.disable_jit`) bit
for bit. (Under `jax.jit` XLA's CPU compiler contracts `acc - q * s`
into a fused multiply-add and divides by the constant 127 as a multiply
by its reciprocal, so the jitted reference differs from its own op-by-op
arithmetic in the last bits.) The train steps differ by summation order
only and are held at tests/test_torch_train.py's F32_TOL with both
packages computing in float32.
"""
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import batch_for  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.parallel import compression as ref_comp  # noqa: E402
from repro.parallel import hierarchical as ref_hier  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.parallel import compression, hierarchical  # noqa: E402
from tests.test_torch_train import F32_TOL, TINY, _close  # noqa: E402
from tests.test_system import TINY as REF_TINY  # noqa: E402

N_PODS, B, S, STEPS = 2, 4, 16, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (the suite runs files in parallel workers)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(ref_lm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "COMPUTE_DTYPE", torch.float32)


def _bits_equal(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8),
                                  np.atleast_1d(want).view(np.uint8))


def _trees(seed):
    """A seeded tree with an all-zero leaf (the 1e-12 scale floor), a
    leaf of exact .5 ties (max 127, so the scale is exactly 1) and a
    scalar, with an error-feedback tree of the same shapes."""
    rng = np.random.RandomState(seed)
    tree = {"a": rng.randn(3, 5).astype(np.float32),
            "b": np.zeros(7, np.float32),
            "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5,
                              -3.5], np.float32),
            "c/d": (rng.randn(2, 3, 4) * 1e-3).astype(np.float32),
            "e": np.float32(rng.randn())}
    err = {k: np.asarray(rng.randn(*np.shape(v)) * 1e-2, np.float32)
           for k, v in tree.items()}
    err["ties"] = np.zeros(8, np.float32)          # keep the ties exact
    return tree, err


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


# ---------------------------------------------------------- compression
@pytest.mark.parametrize("seed", [0, 1])
def test_compression_is_bit_equal_to_reference(seed):
    tree, err = _trees(seed)
    with jax.disable_jit():
        want_q, want_s = ref_comp.quantize_tree(tree)
        (want_cq, want_cs), want_e = ref_comp.compress_with_feedback(tree,
                                                                     err)
        want_deq = ref_comp.dequantize_tree(want_q, want_s)
    got_q, got_s = compression.quantize_tree(_t(tree))
    assert got_q["ties"].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
    assert float(got_s["b"]) == np.float32(1e-12) / np.float32(127.0)
    (got_cq, got_cs), got_e = compression.compress_with_feedback(
        _t(tree), _t(err))
    got_deq = compression.dequantize_tree(got_q, got_s)
    want_z = ref_comp.zeros_like_err(tree)
    got_z = compression.zeros_like_err(_t(tree))
    for k in tree:
        for got, want in ((got_q[k], want_q[k]), (got_s[k], want_s[k]),
                          (got_cq[k], want_cq[k]), (got_cs[k], want_cs[k]),
                          (got_e[k], want_e[k]), (got_deq[k], want_deq[k]),
                          (got_z[k], want_z[k])):
            _bits_equal(got, want)


@pytest.mark.parametrize("n_pods", [2, 3])
@pytest.mark.parametrize("compress", [False, True])
def test_syncs_are_bit_equal_to_reference(n_pods, compress):
    """Both syncs on identical podded inputs (each pod's params its own,
    the anchor the same on every pod, as after a sync): every output
    bit for bit, and every pod row the same after the sync."""
    rng = np.random.RandomState(n_pods)
    shapes = {"a": (3, 5), "b": (7,), "z": (4,), "c/d": (2, 3, 4)}
    anchor1 = {k: rng.randn(*s).astype(np.float32)
               for k, s in shapes.items()}
    params = {k: (a + rng.randn(n_pods, *a.shape) * 1e-2).astype(np.float32)
              for k, a in anchor1.items()}
    params["z"] = np.zeros((n_pods, 4), np.float32)
    anchor1["z"] = np.zeros(4, np.float32)
    if compress:
        anchor = {k: np.broadcast_to(a, (n_pods,) + a.shape).copy()
                  for k, a in anchor1.items()}
        err = {k: (rng.randn(n_pods, *s) * 1e-4).astype(np.float32)
               for k, s in shapes.items()}
        ref_fn, port_fn = ref_hier._compressed_sync, \
            hierarchical._compressed_sync
    else:
        anchor = {k: np.float32(0) for k in shapes}
        err = {k: np.float32(0) for k in shapes}
        ref_fn, port_fn = ref_hier._mean_sync, hierarchical._mean_sync
    with jax.disable_jit():
        want = ref_fn(params, anchor, err, n_pods)
    got = port_fn(_t(params), _t(anchor), _t(err), n_pods)
    for got_tree, want_tree in zip(got, want):
        for k in shapes:
            _bits_equal(got_tree[k], want_tree[k])
    for k in shapes:
        for row in got[0][k][1:]:
            assert torch.equal(row, got[0][k][0])


# ------------------------------------------------------------ the state
@pytest.mark.parametrize("compress", [False, True])
def test_init_hier_state_layout_matches_reference(compress):
    want = hierarchical.HierState(*convert.hier_state_from_reference(
        jax.tree.map(np.asarray, ref_hier.init_hier_state(
            REF_TINY, jax.random.PRNGKey(0), 3, compress=compress)),
        TINY, "cpu"))
    got = hierarchical.init_hier_state(TINY, torch.Generator().manual_seed(0),
                                       3, compress=compress, device="cpu")
    for name in ("params", "anchor", "err"):
        g, w = getattr(got, name), getattr(want, name)
        assert {k: (t.shape, t.dtype) for k, t in g.items()} == \
            {k: (t.shape, t.dtype) for k, t in w.items()}
    assert {k: t.shape for k, t in got.opt.m.items()} == \
        {k: t.shape for k, t in want.opt.m.items()}
    assert got.opt.step.tolist() == want.opt.step.tolist() == [0, 0, 0]
    assert got.step.dtype == want.step.dtype == torch.int32
    for k, p in got.params.items():          # every pod starts equal
        assert torch.equal(p[1], p[0]) and torch.equal(p[2], p[0])
        if compress:
            assert torch.equal(got.anchor[k], p)
            assert not bool(got.err[k].any())


# ------------------------------------------------------------ the steps
def _batches(step_):
    """(reference, port) podded batches [n_pods, B / n_pods, ...]."""
    np_b = {k: v.reshape((N_PODS, B // N_PODS) + v.shape[1:])
            for k, v in batch_for(REF_TINY, B, S, step_).items()}
    return (jax.tree.map(jnp.asarray, np_b),
            {k: torch.from_numpy(v) for k, v in np_b.items()})


def _state_close(got, want_np):
    want = convert.hier_state_from_reference(want_np, TINY, "cpu")
    for name in ("params", "anchor", "err"):
        g, w = getattr(got, name), getattr(want, name)
        assert set(g) == set(w)
        for k in w:
            _close(g[k], w[k].numpy(), F32_TOL)
    for k in want.opt.m:
        _close(got.opt.m[k], want.opt.m[k].numpy(), F32_TOL)
        _close(got.opt.v[k], want.opt.v[k].numpy(), F32_TOL)
    assert got.opt.step.tolist() == want.opt.step.tolist()
    assert int(got.step) == int(want.step)


@pytest.mark.parametrize("T_pod", [1, 2])
@pytest.mark.parametrize("compress", [False, True])
def test_hier_steps_continue_a_converted_reference_state(T_pod, compress,
                                                         f32):
    """One reference step (so AdamW's moments are not zero and the pods
    differ), the state converted, then four steps in each package on
    the same batches: metrics, `synced` exactly, and the whole state."""
    ref_fn = jax.jit(ref_hier.build_hier_train_step(
        REF_TINY, N_PODS, T_pod, compress=compress, remat="none"))
    port_fn = hierarchical.build_hier_train_step(
        TINY, N_PODS, T_pod, compress=compress, remat="none")
    rs = ref_hier.init_hier_state(REF_TINY, jax.random.PRNGKey(0), N_PODS,
                                  compress=compress)
    rs, _ = ref_fn(rs, _batches(0)[0])
    ps = convert.hier_state_from_reference(jax.tree.map(np.asarray, rs),
                                           TINY, "cpu")
    synced = []
    for i in range(1, 1 + STEPS):
        rb, tb = _batches(i)
        rs, want = ref_fn(rs, rb)
        ps, got = port_fn(ps, tb)
        assert set(got) == set(want) == {"loss", "grad_norm", "synced"}
        assert got["synced"].dtype == torch.int32
        assert int(got["synced"]) == int(want["synced"])
        synced.append(int(got["synced"]))
        _close(got["loss"], want["loss"], F32_TOL)
        _close(got["grad_norm"], want["grad_norm"], F32_TOL)
        same = [torch.equal(p[1], p[0]) for p in ps.params.values()]
        assert all(same) if synced[-1] else not any(same)
    assert synced == [int((i + 1) % T_pod == 0) for i in range(1, 5)]
    _state_close(ps, jax.tree.map(np.asarray, rs))


def test_sync_modes(f32):
    """"always" equals "cond" at T_pod 1 bit for bit; "never" keeps the
    pods apart and reports no sync; another mode raises."""
    out = {}
    _, tb = _batches(0)
    for mode in ("cond", "always", "never"):
        st = hierarchical.init_hier_state(TINY,
                                          torch.Generator().manual_seed(0),
                                          N_PODS, device="cpu")
        fn = hierarchical.build_hier_train_step(TINY, N_PODS, 1,
                                                remat="none", sync_mode=mode)
        st, m = fn(st, tb)
        out[mode] = (st, int(m["synced"]))
    assert out["cond"][1] == out["always"][1] == 1 and out["never"][1] == 0
    for k, p in out["cond"][0].params.items():
        assert torch.equal(p, out["always"][0].params[k])
    assert not all(torch.equal(p[0], p[1])
                   for p in out["never"][0].params.values())
    with pytest.raises(ValueError, match="sync_mode"):
        hierarchical.build_hier_train_step(TINY, N_PODS, 1, sync_mode="some")


def test_remat_keeps_the_pods_parameters_in_the_backward(f32):
    """remat "dots" recomputes each block's forward in the backward: it
    must read the pod's rows there too (not the step's meta-device
    model), so a step equals remat "none"'s."""
    out = {}
    _, tb = _batches(0)
    for remat in ("none", "dots"):
        st = hierarchical.init_hier_state(TINY,
                                          torch.Generator().manual_seed(0),
                                          N_PODS, device="cpu")
        fn = hierarchical.build_hier_train_step(TINY, N_PODS, 2, remat=remat)
        out[remat] = fn(st, tb)
    (a, ma), (b, mb) = out["none"], out["dots"]
    _close(mb["loss"], ma["loss"].numpy(), F32_TOL)
    for k, p in a.params.items():
        _close(b.params[k], p.numpy(), F32_TOL)


# ------------------------------------------------------------- launcher
def test_launch_hier_compress_prints_the_reference_lines(capsys,
                                                         monkeypatch):
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "12", "--batch",
            "4", "--seq", "32", "--hier", "2", "--compress"]
    state = launch_train.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    from repro.launch import train as ref_launch
    monkeypatch.setattr("sys.argv", ["train"] + argv)
    ref_launch.main()
    want = capsys.readouterr().out.splitlines()
    number = functools.partial(re.sub, r"loss \d+\.\d{4} ", "loss L ")
    assert [number(line) for line in got] == [number(line) for line in want]
    assert got == [line for line in got if line] and len(got) == 3
    assert got[0].startswith("step    0 loss ") and got[-1] == \
        "[train/hier] done"
    assert isinstance(state, hierarchical.HierState) and int(state.step) == 12
    for k, a in state.anchor.items():        # step 11 synced
        assert torch.equal(a[0], a[1]) and torch.equal(state.params[k], a)
    with pytest.raises(ValueError, match="does not split"):
        launch_train.main(argv[:6] + ["3", "--hier", "2", "--device", "cpu"])

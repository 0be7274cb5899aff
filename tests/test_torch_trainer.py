"""The port's Trainer, checkpoints and training entry points on the CPU,
as tests/test_system.py and tests/test_elastic.py hold the reference's:
the loss drops, a crash and restart reproduces the uninterrupted run bit
for bit, the async checkpointer and `latest_step`, a shape mismatch
raises, the restart budget and backoff, the launcher and the example.
Training and restoring on a mesh: tests/test_torch_elastic.py."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,  # noqa: E402
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.step import init_state  # noqa: E402

# tests/test_system.py's TINY (this file imports no JAX).
TINY = ArchConfig(
    name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, tie_embeddings=True,
    source="test")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test suite runs files in parallel
    pytest-xdist workers, and every small op that torch parallelises
    over all cores then waits on busy ones (test_training_reduces_loss
    took 243 s under six workers, 7 s alone)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ----------------------------------------------------------- train loop
def test_training_reduces_loss(tmp_path):
    tc = TrainerConfig(batch=8, seq=64, ckpt_every=1000, log_every=5,
                       warmup_steps=10,
                       opt=AdamWConfig(lr=1e-3, weight_decay=0.0))
    tr = Trainer(TINY, str(tmp_path), tc, device="cpu")
    state = tr.run(120)
    assert int(state.step) == 120
    recs = _records(tr.metrics_path)
    assert [r["step"] for r in recs] == list(range(0, 120, 5))
    assert set(recs[0]) == {"step", "dt_s", "loss", "aux", "grad_norm",
                            "lr_scale"}
    first = np.mean([r["loss"] for r in recs[:3]])
    last = np.mean([r["loss"] for r in recs[-3:]])
    assert last < first - 0.3, f"loss did not drop: {first} -> {last}"
    assert latest_step(tr.ckpt_dir) == 120       # the closing checkpoint


def test_checkpoint_resume_bitwise(tmp_path):
    """Crash + restart reproduces the uninterrupted run bitwise."""
    tc = TrainerConfig(batch=2, seq=16, ckpt_every=10, log_every=1)
    ref = Trainer(TINY, str(tmp_path / "ref"), tc, device="cpu")
    ref_state = ref.run(20)

    tc2 = TrainerConfig(batch=2, seq=16, ckpt_every=10, log_every=1,
                        fault_at_step=14)
    tr = Trainer(TINY, str(tmp_path / "crash"), tc2, device="cpu")
    delays = []
    state = tr.run_with_recovery(20, sleep=delays.append)

    assert delays == [0.5]
    assert int(state.step) == int(ref_state.step) == 20
    for a, b in zip(ref_state.params.parameters(), state.params.parameters()):
        assert torch.equal(a, b)
    for k in ref_state.opt.m:
        assert torch.equal(ref_state.opt.m[k], state.opt.m[k])
        assert torch.equal(ref_state.opt.v[k], state.opt.v[k])
    # Steps 10-13 ran twice (before the fault and after the restore from
    # step 10): every logged loss equals the uninterrupted run's.
    want = {r["step"]: r["loss"] for r in _records(ref.metrics_path)}
    got = _records(tr.metrics_path)
    assert [r["step"] for r in got] == list(range(14)) + list(range(10, 20))
    assert all(r["loss"] == want[r["step"]] for r in got)


def test_async_checkpointer_and_latest(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor(4, dtype=torch.int32)}}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.submit(3, tree)
    ck.submit(7, {"a": tree["a"] * 2, "b": tree["b"]})
    tree["a"].add_(100.0)         # after submit: the host copy is taken
    ck.close()
    assert latest_step(str(tmp_path)) == 7
    assert latest_step(str(tmp_path / "none")) is None
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros((), dtype=torch.int32)}}
    restored, manifest = load_checkpoint(str(tmp_path), 7, like)
    assert torch.equal(restored["a"], torch.arange(6.0).reshape(2, 3) * 2)
    assert restored["b"]["c"].dtype == torch.int32
    assert int(restored["b"]["c"]) == 4
    assert manifest["step"] == 7
    assert manifest["keys"] == ["a", "b/c"]
    assert manifest["dtypes"] == {"a": "float32", "b/c": "int32"}
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000007"]
    assert sorted(os.listdir(tmp_path / "step_00000003")) == [
        "arrays.npz", "manifest.json"]
    old, _ = load_checkpoint(str(tmp_path), 3, like)
    assert torch.equal(old["a"], torch.arange(6.0).reshape(2, 3))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4, 5)})
    # Restoring onto a mesh checks the shape before it places a leaf
    # (the elastic restore itself: tests/test_torch_elastic.py).
    with pytest.raises(ValueError, match="mismatch at w"):
        load_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4, 5)},
                        sharding_tree={"w": (None, ())})


def test_npz_members_read_directly_equal_np_load(tmp_path):
    """Restores read each array of `arrays.npz` from its offset in the
    file (`ckpt._Arrays`); every dtype, shape and memory order equals
    `np.load`'s."""
    from repro_torch.checkpoint.ckpt import _Arrays
    rng = np.random.RandomState(0)
    arrays = {"a": rng.rand(3, 5).astype(np.float32),
              "b/c": np.arange(7, dtype=np.int32), "s": np.array(4, np.int32),
              "f": np.asfortranarray(rng.rand(4, 6)),
              "e": np.zeros((0, 3), np.float32),
              "h": rng.rand(5).astype(np.float16),
              "u": rng.randint(0, 255, (2, 3, 4)).astype(np.uint8)}
    np.savez(tmp_path / "x.npz", **arrays)
    with _Arrays(str(tmp_path / "x.npz")) as got, \
            np.load(tmp_path / "x.npz") as want:
        for k in arrays:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_train_state_round_trips(tmp_path):
    """A whole train state under the port's keys; the model restored in
    place, the rest on the like's device."""
    state = init_state(TINY, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():
        for t in state.opt.m.values():
            t.add_(0.5)
    save_checkpoint(str(tmp_path), 5, state._replace(
        step=torch.tensor(5, dtype=torch.int32)), meta={"run": "x"})
    like = init_state(TINY, torch.Generator().manual_seed(2), "cpu")
    got, manifest = load_checkpoint(str(tmp_path), 5, like)
    assert got.params is like.params and int(got.step) == 5
    assert manifest["meta"] == {"run": "x"}
    assert "params/blocks/0/attn/wq" in manifest["keys"]
    assert "opt/m/embed/tok" in manifest["keys"]
    assert {"step", "opt/step"} <= set(manifest["keys"])
    for a, b in zip(state.params.parameters(), got.params.parameters()):
        assert torch.equal(a, b) and b.requires_grad
    for k in state.opt.m:
        assert torch.equal(state.opt.m[k], got.opt.m[k])


# ------------------------------------------------- restart budget/backoff
def test_run_with_recovery_exhausts_budget(tmp_path, monkeypatch):
    tr = Trainer(TINY, str(tmp_path), TrainerConfig(batch=2, seq=16),
                 device="cpu")
    calls = []

    def boom(num_steps):
        calls.append(num_steps)
        raise RuntimeError("persistent failure")
    monkeypatch.setattr(tr, "run", boom)
    delays = []
    with pytest.raises(RuntimeError, match="max restarts") as ei:
        tr.run_with_recovery(10, max_restarts=3, backoff_s=0.25,
                             sleep=delays.append)
    assert calls == [10, 10, 10, 10]          # 1 try + 3 restarts
    assert delays == [0.25, 0.5, 1.0]
    assert "persistent failure" in str(ei.value.__cause__)


def test_run_with_recovery_transient_failure(tmp_path, monkeypatch):
    tr = Trainer(TINY, str(tmp_path), TrainerConfig(batch=2, seq=16),
                 device="cpu")
    attempts = []

    def flaky(num_steps):
        attempts.append(num_steps)
        if len(attempts) < 3:
            raise RuntimeError("flaky")
        return "final-state"
    monkeypatch.setattr(tr, "run", flaky)
    delays = []
    out = tr.run_with_recovery(10, max_restarts=5, backoff_s=0.1,
                               backoff_factor=3.0, max_backoff_s=0.2,
                               sleep=delays.append)
    assert out == "final-state"
    assert delays == [0.1, 0.2]               # 0.3 capped at 0.2


class _Mesh:
    """What the Trainer reads of a DeviceMesh before it runs."""
    device_type = "cpu"


def test_trainer_refuses_a_mesh(tmp_path):
    """(Named when the port refused a mesh.) `mesh=` takes the mesh's
    device type, `shardings=` alone its tree's mesh; neither needs a
    process group until the run (tests/test_torch_elastic.py trains on
    a mesh of gloo ranks), and without them the Trainer is unchanged."""
    mesh = _Mesh()
    tr = Trainer(TINY, str(tmp_path / "m"), mesh=mesh)
    assert tr.mesh is mesh and tr.shardings is None
    assert tr.device == torch.device("cpu")
    tree = init_state(TINY, None, "meta")._replace(
        params={"embed.tok": (mesh, ())})
    tr = Trainer(TINY, str(tmp_path / "s"), shardings=tree)
    assert tr.mesh is mesh and tr.shardings is tree
    tr = Trainer(TINY, str(tmp_path / "d"), device="cpu")
    assert tr.mesh is None and tr._placements(None) is None


# ------------------------------------------------ launcher and example
def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    state = launch_train.main(["--arch", "mamba2-130m", "--smoke",
                               "--steps", "3", "--batch", "2", "--seq",
                               "32", "--ckpt-every", "2", "--workdir",
                               str(tmp_path), "--device", "cpu"])
    assert int(state.step) == 3
    assert latest_step(str(tmp_path / "ckpt")) == 3
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002",
                                                     "step_00000003"]
    assert "finished at step 3" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--hier", "4", "--batch", "3"],
                                  ["--compress"]])
def test_launch_train_refuses_pod_sync(tmp_path, flag):
    """The pod-local sync refuses a batch that does not split over the
    pods, and `--compress` without `--hier`."""
    with pytest.raises(ValueError, match="does not split|needs --hier"):
        launch_train.main(["--arch", "qwen2-0.5b", "--smoke", "--workdir",
                           str(tmp_path), "--device", "cpu"] + flag)


def test_example_train_lm_runs_two_steps(tmp_path, capsys):
    out = train_lm.main(["--steps", "2", "--batch", "1", "--seq", "16",
                         "--workdir", str(tmp_path), "--device", "cpu"])
    assert int(out["state"].step) == 2
    assert out["lines"][0] == "model: repro-110m, 79.5M params"
    assert out["lines"][-1].startswith("loss: step 0 -> ")
    printed = capsys.readouterr().out.splitlines()
    assert [line for line in printed if not line.startswith("[")] == \
        out["lines"]

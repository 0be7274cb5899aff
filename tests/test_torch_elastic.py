"""The port on a mesh of eight gloo ranks against one device and the JAX
reference, on the CPU: the elastic restore, a train step, the Trainer
and the pod-sharded hierarchical step with real collectives.

One subprocess, started by a module fixture, forks a gloo world of 8
ranks (one torch thread each, a `file://` store); a process group is
global state, so none is created in the pytest process. Every check
reads that one world's results:

- (a) The reference's TINY `init_state(PRNGKey(0))`, converted and saved
  by the port on one device, restored onto a (data 2, model 4) mesh:
  every leaf's `full_tensor()` bit-equal to the saved array, and its
  placements those of the reference's `param_spec_tree` on that mesh
  (m and v as their parameters, the step counters replicated).
- (b) One train step on that mesh (`batch_for(TINY, 4, 32, 0)`, remat
  none): the loss, and params, m and v as the mesh saves them, equal
  the reference's jitted one-device step.
- (c) `Trainer(mesh=)` resumes from a one-device checkpoint and takes 3
  steps: its logged losses and its closing checkpoint, restored on one
  device, equal the one-device Trainer's continuation.
- (d) The hierarchical step on a (pod 2, data 2, model 2) mesh of the
  same ranks, T_pod 2, exact and int8, 4 steps from `init_hier_state`:
  metrics, `synced` [0, 1, 0, 1] and the whole saved state equal the
  port's one-device `build_hier_train_step`.

Both packages compute in float32 (each `lm.COMPUTE_DTYPE` patched), and
every comparison is at tests/test_torch_train.py's F32_TOL: the mesh
sums in another order (its products split over ranks) and differs from
one device by <= 1e-5 relative.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import batch_for  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.parallel import sharding as ref_shd  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch.checkpoint import (latest_step, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.parallel import hierarchical  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.step import init_state  # noqa: E402
from tests.test_sharding import FakeMesh  # noqa: E402
from tests.test_system import TINY as REF_TINY  # noqa: E402
from tests.test_torch_train import F32_TOL, TINY, _close  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
RESTORE_STEP = 5                 # the reference test's checkpoint label
B, S = 4, 32                     # (b) and (c)
HIER_B, HIER_S, HIER_STEPS = 4, 16, 4
TC = dict(batch=B, seq=S, ckpt_every=2, log_every=1, warmup_steps=2,
          total_steps=8)
RESUME_AT, RUN_TO = 2, 5         # (c): 3 steps on the mesh

WORLD_SCRIPT = """
import json, os, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp

WORK = sys.argv[1]
TINY_KW, TC, RESTORE_STEP, B, S, RUN_TO, HIER = json.loads(sys.argv[2])


def run(rank):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint import (load_checkpoint, place_state,
                                        save_checkpoint)
    from repro_torch.checkpoint.ckpt import _leaves
    from repro_torch.configs.base import ArchConfig
    from repro_torch.data import batch_for
    from repro_torch.models import lm
    from repro_torch.parallel import hierarchical, sharding, spmd
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.train.step import build_train_step, init_state
    lm.COMPUTE_DTYPE = torch.float32
    cfg = ArchConfig(**TINY_KW)
    dist.init_process_group("gloo", init_method="file://" + WORK + "/store",
                            rank=rank, world_size=%d)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out = {}

    def placed(batch, mesh, spec_of):
        return {k: distribute_tensor(torch.from_numpy(v), mesh,
                                     sharding._placements(spec_of(v), mesh, k),
                                     src_data_rank=None)
                for k, v in batch.items()}

    # (a) the elastic restore.
    like = init_state(cfg, None, "meta")
    state, manifest = load_checkpoint(
        WORK + "/a", RESTORE_STEP, like,
        sharding_tree=sharding.state_placements(like, mesh))
    saved = np.load(WORK + "/a/step_%%08d/arrays.npz" %% RESTORE_STEP)
    differ, placements = [], {}
    for key, leaf in _leaves(state):
        got = np.atleast_1d(leaf.full_tensor().detach().numpy())
        want = np.atleast_1d(saved[key])
        if not (got.dtype == want.dtype and np.array_equal(
                got.view(np.uint8), want.view(np.uint8))):
            differ.append(key)
        placements[key] = [str(p) for p in leaf.placements]
    out["a"] = dict(step=manifest["step"], differ=differ, n=len(placements),
                    placements=placements)

    # (b) one train step on the mesh; the mesh saves the new state.
    batch = placed(batch_for(cfg, B, S, 0), mesh,
                   lambda v: ("data",) + (None,) * (v.ndim - 1))
    state, metrics = build_train_step(cfg, remat="none")(state, batch)
    save_checkpoint(WORK + "/b", 1, state)
    out["b"] = dict(loss=float(metrics["loss"]),
                    grad_norm=float(metrics["grad_norm"]))

    # (c) the Trainer on the mesh, resumed from a one-device checkpoint.
    Trainer(cfg, WORK + "/c_mesh", TrainerConfig(**TC), mesh=mesh).run(RUN_TO)

    # (d) the pod-sharded hierarchical step.
    pods = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    for compress in (False, True):
        st = hierarchical.init_hier_state(cfg, torch.Generator().manual_seed(0),
                                          2, compress=compress, device="cpu")
        departures = []
        st = place_state(st, sharding.state_placements(
            st, pods, cfg, departures=departures))
        fn = hierarchical.build_hier_train_step(cfg, 2, 2, compress=compress,
                                                remat="none")
        rec = {"loss": [], "grad_norm": [], "synced": [],
               "departures": departures}
        for i in range(HIER[2]):
            b = {k: v.reshape((2, v.shape[0] // 2) + v.shape[1:])
                 for k, v in batch_for(cfg, HIER[0], HIER[1], i).items()}
            st, m = fn(st, placed(b, pods, lambda v: ("pod", "data") +
                                  (None,) * (v.ndim - 2)))
            for k in ("loss", "grad_norm", "synced"):
                rec[k].append(spmd.full(m[k]).item())
        save_checkpoint(WORK + "/d%%d" %% compress, HIER[2], st)
        out["d%%d" %% compress] = rec
    if rank == 0:
        with open(WORK + "/result.json", "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


mp.start_processes(run, nprocs=%d, start_method="fork")
""" % (WORLD, WORLD)


def _f32():
    """Both packages' compute dtype set to float32; returns the undo."""
    saved = (ref_lm.COMPUTE_DTYPE, lm.COMPUTE_DTYPE)
    ref_lm.COMPUTE_DTYPE, lm.COMPUTE_DTYPE = jnp.float32, torch.float32

    def undo():
        ref_lm.COMPUTE_DTYPE, lm.COMPUTE_DTYPE = saved
    return undo


def _hier_batches(i):
    return {k: torch.from_numpy(v.reshape((2, HIER_B // 2) + v.shape[1:]))
            for k, v in batch_for(REF_TINY, HIER_B, HIER_S, i).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Starts the 8-rank world on the inputs it needs, computes the
    one-device and reference counterparts while it runs, and returns
    (its results, the work directory, the counterparts)."""
    work = tmp_path_factory.mktemp("world")
    saved_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    undo = _f32()
    proc = None
    try:
        ref0 = jax.jit(lambda k: ref_step.init_state(REF_TINY, k))(
            jax.random.PRNGKey(0))
        ref0 = jax.tree.map(np.asarray, ref0)
        save_checkpoint(str(work / "a"), RESTORE_STEP,
                        convert.state_from_reference(ref0, TINY, "cpu"))
        Trainer(TINY, str(work / "c_one"), TrainerConfig(**TC),
                device="cpu").run(RESUME_AT)
        shutil.copytree(work / "c_one" / "ckpt", work / "c_mesh" / "ckpt")
        args = json.dumps([dataclasses.asdict(TINY), TC, RESTORE_STEP, B, S, RUN_TO,
                           [HIER_B, HIER_S, HIER_STEPS]])
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        proc = subprocess.Popen(
            [sys.executable, "-c", WORLD_SCRIPT, str(work), args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=work)

        # The counterparts, while the world runs.
        ref_fn = jax.jit(ref_step.build_train_step(REF_TINY, remat="none"))
        ref1, ref_metrics = ref_fn(jax.tree.map(jnp.asarray, ref0),
                                   jax.tree.map(jnp.asarray,
                                                batch_for(REF_TINY, B, S, 0)))
        one = {"b": (jax.tree.map(np.asarray, ref1),
                     float(ref_metrics["loss"]))}
        one["c"] = Trainer(TINY, str(work / "c_one"), TrainerConfig(**TC),
                           device="cpu").run(RUN_TO)
        for compress in (False, True):
            st = hierarchical.init_hier_state(
                TINY, torch.Generator().manual_seed(0), 2, compress=compress,
                device="cpu")
            fn = hierarchical.build_hier_train_step(
                TINY, 2, 2, compress=compress, remat="none")
            metrics = []
            for i in range(HIER_STEPS):
                st, m = fn(st, _hier_batches(i))
                metrics.append({k: v.item() for k, v in m.items()})
            one[f"d{int(compress)}"] = (st, metrics)

        _, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-4000:]
        with open(work / "result.json") as f:
            got = json.load(f)
        yield got, work, one
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
        undo()
        torch.set_num_threads(saved_threads)


def _ref_placements(ref_specs, name):
    """The placements (as DTensor prints them) of the port parameter
    `name` under the reference's stacked spec tree: the stacked (layer)
    entries must be unsharded, the rest maps mesh axis -> tensor dim."""
    parts = name.split(".")
    depth = convert.stack_depth(TINY, parts[0])
    spec = ref_specs
    for k in [parts[0]] + parts[1 + depth:]:
        spec = spec[k]
    spec = tuple(spec)
    assert all(e is None for e in spec[:depth]), (name, spec)
    where = {}
    for dim, entry in enumerate(spec[depth:]):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            where[axis] = dim
    return [f"S({where[a]})" if a in where else "R" for a in ("data", "model")]


def test_restore_onto_the_mesh_is_bit_equal_with_the_reference_specs(world):
    got, work, _ = world
    a = got["a"]
    assert a["step"] == RESTORE_STEP and a["differ"] == []
    with np.load(work / "a" / f"step_{RESTORE_STEP:08d}" / "arrays.npz") as z:
        assert a["n"] == len(z.files)
    params = jax.eval_shape(lambda k: ref_lm.init_params(REF_TINY, k),
                            jax.random.PRNGKey(0))
    specs = ref_shd.param_spec_tree(params, FakeMesh({"data": 2,
                                                      "model": 4}))
    pl = a["placements"]
    names = [k for k, _ in init_state(TINY, None, "meta")
             .params.named_parameters()]
    sharded = 0
    for name in names:
        want = _ref_placements(specs, name)
        key = name.replace(".", "/")
        assert pl[f"params/{key}"] == want, name
        assert pl[f"opt/m/{key}"] == pl[f"opt/v/{key}"] == want, name
        sharded += want != ["R", "R"]
    assert sharded > len(names) // 2
    assert pl["step"] == pl["opt/step"] == ["R", "R"]


def _state_close(got, want):
    params = dict(want.params.named_parameters())
    for k, p in got.params.named_parameters():
        _close(p, params[k].detach().numpy(), F32_TOL)
    for k in want.opt.m:
        _close(got.opt.m[k], want.opt.m[k].numpy(), F32_TOL)
        _close(got.opt.v[k], want.opt.v[k].numpy(), F32_TOL)
    assert int(got.step) == int(want.step)
    assert int(got.opt.step) == int(want.opt.step)


def test_one_step_on_the_mesh_equals_the_reference_step(world):
    got, work, one = world
    ref1, ref_loss = one["b"]
    _close(np.float32(got["b"]["loss"]), ref_loss, F32_TOL)
    like = init_state(TINY, torch.Generator().manual_seed(1), "cpu")
    saved, _ = load_checkpoint(str(work / "b"), 1, like)
    _state_close(saved, convert.state_from_reference(ref1, TINY, "cpu"))
    assert int(saved.step) == 1


def test_trainer_on_the_mesh_resumes_and_restores_on_one_device(world):
    _, work, one = world

    def losses(run):
        with open(work / run / "metrics.jsonl") as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f)}
    mesh, single = losses("c_mesh"), losses("c_one")
    assert sorted(mesh) == list(range(RESUME_AT, RUN_TO))
    for s in mesh:
        _close(np.float32(mesh[s]), single[s], F32_TOL)
    ckpt = str(work / "c_mesh" / "ckpt")
    assert latest_step(ckpt) == RUN_TO
    like = init_state(TINY, torch.Generator().manual_seed(1), "cpu")
    saved, manifest = load_checkpoint(ckpt, RUN_TO, like)
    assert manifest["step"] == RUN_TO
    _state_close(saved, one["c"])


@pytest.mark.parametrize("compress", [False, True], ids=["exact", "int8"])
def test_pod_sharded_hier_step_equals_one_device(world, compress):
    got, work, one = world
    want_state, want = one[f"d{int(compress)}"]
    rec = got[f"d{int(compress)}"]
    assert rec["synced"] == [m["synced"] for m in want] == [0, 1, 0, 1]
    for k in ("loss", "grad_norm"):
        _close(np.float32(rec[k]), [m[k] for m in want], F32_TOL)
    # TINY's 2 layers divide by 'model' 2: the rule for the dense FFN
    # shards the stacked layer axis, replicated over 'model' here.
    assert rec["departures"] == ["blocks/ffn/w_gate", "blocks/ffn/w_up",
                                 "blocks/ffn/w_down"]
    like = hierarchical.init_hier_state(
        TINY, torch.Generator().manual_seed(1), 2, compress=compress,
        device="cpu")
    saved, _ = load_checkpoint(str(work / f"d{int(compress)}"), HIER_STEPS,
                               like)
    for name in ("params", "anchor", "err"):
        g, w = getattr(saved, name), getattr(want_state, name)
        assert set(g) == set(w)
        for k in w:
            _close(g[k], w[k].numpy(), F32_TOL)
    for k in want_state.opt.m:
        _close(saved.opt.m[k], want_state.opt.m[k].numpy(), F32_TOL)
        _close(saved.opt.v[k], want_state.opt.v[k].numpy(), F32_TOL)
    assert saved.opt.step.tolist() == want_state.opt.step.tolist() == [4, 4]
    assert int(saved.step) == int(want_state.step) == HIER_STEPS

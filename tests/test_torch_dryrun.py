"""The port's dry run (`repro_torch.launch.dryrun`) and roofline table
against the JAX reference, on the CPU.

- `plan_cell`'s metadata of every (arch x shape x mesh) record equals
  the reference record's: status and reason, fsdp, chips, tokens per
  step, MODEL_FLOPS per device and the state bytes per device, which
  the reference side computes here from `repro.parallel.sharding`'s
  specs on tests/test_sharding.py's `FakeMesh`es, the reference's
  `jax.eval_shape` trees and its byte formula (`repro.launch.dryrun`
  itself is not imported: it sets XLA_FLAGS when imported); likewise
  with `--decode-seq2d` on the decode cells and `fsdp_axes=("data",)`
  on the MoE archs' train cells.
- Subprocesses lower every family's SMOKE config through train,
  prefill and decode in a fake 8-rank world (a process group is global
  state: none is created in this process), serving on (pod, data,
  model) = (2, 2, 2) and training on (data, model) = (2, 2), with the
  kernels' meta paths and DTensor rule; a dense
  prefill's collectives are pinned against a count derived by hand;
  and on a one-rank gloo world the DTensor path's values equal the
  plain path's.
- `collective_stats` on the reference parser test's figures, the
  roofline table string for string against `benchmarks/roofline.py`,
  the kernels' meta paths and flop formulas, and the module's import
  hygiene.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from benchmarks import roofline as ref_roofline  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.optim.adamw import AdamWState  # noqa: E402
from repro.parallel import sharding as ref_shd  # noqa: E402
from repro.serve import steps as ref_steps  # noqa: E402
from repro.train import step as ref_train  # noqa: E402
from repro_torch.bench import roofline  # noqa: E402
from repro_torch.kernels import meta  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.models import lm as lm_port  # noqa: E402
from repro_torch.parallel import sharding as shd_port  # noqa: E402
from tests.test_sharding import MESH1, MESH2  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(ref_configs.ARCH_IDS)
SHAPES = list(ref_configs.SHAPES)
MOE_ARCHS = ["deepseek_v3_671b", "arctic_480b"]


# ------------------------------------------------------- the reference
@pytest.fixture(scope="module")
def ref_state():
    """arch -> (the reference's `jax.eval_shape` train state, (total,
    active) parameter counts), lazily."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = ref_configs.get_config(arch)
            state = jax.eval_shape(functools.partial(ref_train.init_state,
                                                     cfg),
                                   jax.random.PRNGKey(0))
            cache[arch] = (state, ref_lm.param_counts(cfg))
        return cache[arch]
    return get


def ref_sharded_bytes(tree, spec_tree, mesh) -> int:
    """The reference's `_sharded_bytes` (src/repro/launch/dryrun.py)."""
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree),
                          jax.tree.leaves(spec_tree,
                                          is_leaf=lambda x: isinstance(x, P))):
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        div = 1
        for axes in spec:
            div *= ref_shd.axis_size(mesh, axes)
        total += n * leaf.dtype.itemsize // max(div, 1)
    return total


def ref_record(ref_state, arch, shape_name, multi_pod, *,
               decode_seq2d=False, fsdp_axes=None):
    """The reference record's metadata, as its `lower_cell` builds it."""
    cfg = ref_configs.get_config(arch)
    shape = ref_configs.SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "pod2x16x16" if multi_pod else "pod16x16",
           "kind": shape.kind, "tag": ""}
    ok, reason = ref_configs.cell_supported(cfg, shape)
    if not ok:
        return dict(rec, status="skip", reason=reason)
    mesh = MESH2 if multi_pod else MESH1
    chips = int(np.prod(list(mesh.shape.values())))
    state_sds, (total, active) = ref_state(arch)
    fsdp = total > 20e9 and shape.kind == "train"
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        pspecs = ref_shd.param_spec_tree(state_sds.params, mesh, fsdp=fsdp,
                                         fsdp_axes=fsdp_axes)
        specs = ref_train.TrainState(
            params=pspecs, opt=AdamWState(step=P(), m=pspecs, v=pspecs),
            step=P())
        state = ref_sharded_bytes(state_sds, specs, mesh)
        tokens = B * S
    else:
        params = jax.tree.map(lambda l: jax.ShapeDtypeStruct(
            l.shape, jnp.bfloat16), state_sds.params)
        state = ref_sharded_bytes(params, ref_shd.param_spec_tree(params,
                                                                  mesh), mesh)
        tokens = B * S
        if shape.kind == "decode":
            cache = ref_steps.cache_shapes(cfg, B, S)
            seq_par = shape.name == "long_500k"
            sp_axes = (("data", "model") if (decode_seq2d and seq_par)
                       else None)
            cspecs = ref_shd.cache_specs(
                cache, mesh, seq_parallel=seq_par,
                seq_axis_2d="model" if (decode_seq2d and not seq_par)
                else None, seq_parallel_axes=sp_axes)
            state += ref_sharded_bytes(cache, cspecs, mesh)
            tokens = B
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    return dict(rec, status="ok", fsdp=fsdp, chips=chips,
                tokens_per_step=tokens, state_bytes_per_device=state,
                roofline={"model_flops_per_device":
                          mult * active * tokens / chips})


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_cell_equals_the_reference_record(arch, shape, multi_pod,
                                               ref_state):
    assert dr.plan_cell(arch, shape, multi_pod) == \
        ref_record(ref_state, arch, shape, multi_pod)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_cell_decode_seq2d_equals_the_reference(arch, shape, multi_pod,
                                                     ref_state):
    assert dr.plan_cell(arch, shape, multi_pod, decode_seq2d=True) == \
        ref_record(ref_state, arch, shape, multi_pod, decode_seq2d=True)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_plan_cell_fsdp_axes_equals_the_reference(arch, multi_pod,
                                                  ref_state):
    got = dr.plan_cell(arch, "train_4k", multi_pod, fsdp_axes=("data",))
    assert got == ref_record(ref_state, arch, "train_4k", multi_pod,
                             fsdp_axes=("data",))
    assert got["fsdp"]


def test_plan_cell_counts_the_supported_cells():
    recs = [dr.plan_cell(a, s, mp) for a in ARCHS for s in SHAPES
            for mp in (False, True)]
    assert len(recs) == 80
    assert sum(r["status"] == "ok" for r in recs) == 66
    assert sum(r["status"] == "skip" for r in recs) == 14


# ----------------------------------------------------------- lowering
# Every family's SMOKE config through the kinds it supports. Prefill and
# decode lower on (pod, data, model) = (2, 2, 2); the train steps on
# (data, model) = (2, 2), four of the world's ranks: DTensor plans an op
# several times faster on two mesh dims than on three, and the train
# step is most of the ops (the full dry run lowers train on both).
LOWER_KINDS = {"deepseek_v3_671b": ("train", "prefill", "decode"),
               "hubert_xlarge": ("train", "prefill"),
               "mamba2_130m": ("train", "prefill", "decode"),
               "arctic_480b": ("train", "prefill", "decode"),
               "zamba2_2p7b": ("train", "prefill", "decode"),
               "qwen2_0p5b": ("train", "prefill", "decode"),
               "internvl2_2b": ("train", "prefill", "decode")}

LOWER_SCRIPT = """
import json, sys, torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
out = {}
with dr.fake_world(8):
    meshes = {"pod2x2x2": init_device_mesh(
        "cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model")),
        "data2xmodel2": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                   mesh_dim_names=("data", "model"))}
    for arch, kinds in ARCHS.items():
        cfg = get_smoke_config(arch)
        for kind in kinds:
            shape = ShapeSpec(kind + "_smoke", 32, 8, kind)
            name = "data2xmodel2" if kind == "train" else "pod2x2x2"
            out[f"{arch}/{kind}"] = dr.lower_record(
                cfg, shape, meshes[name], header={
                    "arch": arch, "shape": shape.name, "mesh": name,
                    "kind": kind, "tag": ""})
    for compress in HIER:
        out[f"hier/{int(compress)}"] = dr.lower_hier_record(
            get_smoke_config("qwen2_0p5b"), ShapeSpec("train_smoke", 32, 8,
                                                      "train"),
            meshes["pod2x2x2"], 2, compress=compress, header={
                "arch": "qwen2_0p5b", "shape": "train_smoke",
                "mesh": "pod2x2x2", "mode": "hier_T2" + "_int8" * compress,
                "tag": "", "status": "ok", "chips": 8})
    out["launches"] = [flash_attention.launches, ssd_scan.launches]
if HIER:
    # `main(["--hier", ...])` end to end, on the SMOKE config at a small
    # shape on the production pod2x16x16 mesh.
    import contextlib, io, os
    dr.get_config = get_smoke_config
    dr.SHAPES = {"train_4k": ShapeSpec("train_4k", 32, 8, "train")}
    dr.RESULTS_DIR = os.getcwd()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rec = dr.main(["--hier", "2", "--compress", "--tag", "t"])
    out["main"] = {"printed": printed.getvalue(), "files": os.listdir("."),
                   "rec": rec}
print(json.dumps(out))
"""
# The DTensor path against the plain one with real values, on a
# one-rank gloo world (every collective the identity, every plan's local
# arithmetic run): prefill logits, the loss, a decode step (batch- and
# sequence-sharded caches) and the gradients.
ONE_RANK_ARCHS = ["qwen2_0p5b", "deepseek_v3_671b", "zamba2_2p7b"]
ONE_RANK_SCRIPT = """
import copy, json, sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.serve import grow_cache
from repro_torch.models import lm
from repro_torch.parallel import constrain as con, sharding as shd
from repro_torch.serve.steps import build_decode_step
dist.init_process_group("gloo", init_method="file://" + sys.argv[1] + "/store",
                        rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


def place(t, spec):
    return distribute_tensor(t, mesh, shd._placements(spec, mesh, "x"))


def sharded():
    stack = __import__("contextlib").ExitStack()
    for c in (con.logical_axis_rules(con.rules_single_pod()),
              implicit_replication(), dryrun._alltoall_as_alltoall()):
        stack.enter_context(c)
    return stack


out = {}
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    if cfg.family == "moe":        # no drops: the capacities differ
        cfg = cfg.scaled(capacity_factor=cfg.n_experts / cfg.top_k)
    g = torch.Generator().manual_seed(0)
    model = lm.make_trainable(lm.init_params(cfg, g, "cpu"))
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g,
                                     dtype=torch.int32)}
    dm = copy.deepcopy(model)
    pl = shd.layer_placements(dm, mesh, departures=[])
    for name, p in list(dm.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(dm.get_submodule(owner) if owner else dm, leaf,
                torch.nn.Parameter(distribute_tensor(p.detach(), mesh,
                                                     pl[name])))
    bs = shd.batch_specs(batch, mesh)
    db = {k: place(v, bs[k]) for k, v in batch.items()}
    rec = {}
    with torch.no_grad():
        want, cache = lm.prefill(model, cfg, batch)
        with sharded():
            got, _ = lm.prefill(dm, cfg, db)
    rec["prefill"] = torch.equal(got.full_tensor(), want)
    full = grow_cache(cfg, cache, 2, int(cache["len"]) + 8)
    tok = torch.randint(0, cfg.vocab, (2, 1), generator=g, dtype=torch.int32)
    dec = build_decode_step(cfg)
    for seq_par in (False, True):
        cw = {k: v.clone() for k, v in full.items()}
        wt, cw = dec(model, tok, cw)
        cs = shd.cache_specs(full, mesh, seq_parallel=seq_par)
        cd = {k: place(v.clone(), cs[k]) for k, v in full.items()}
        with sharded():
            gt, cd = dec(dm, place(tok, ("data", None)), cd)
        rec[f"decode{int(seq_par)}"] = torch.equal(gt.full_tensor(), wt) and \
            all(torch.equal(cd[k].full_tensor(), cw[k]) for k in cw)
    lw = lm.loss_fn(model, cfg, batch)[0]
    lw.backward()
    with sharded():
        lg = lm.loss_fn(dm, cfg, db)[0]
        lg.backward()
    rec["loss"] = [lw.item(), lg.full_tensor().item()]
    err = norm = 0.0
    for (k, a), (_, b) in zip(model.named_parameters(),
                              dm.named_parameters()):
        ga = a.grad if a.grad is not None else torch.zeros_like(a)
        gb = (b.grad.full_tensor() if b.grad is not None
              else torch.zeros_like(ga))
        err += float(((gb - ga).double() ** 2).sum())
        norm += float((ga.double() ** 2).sum())
    rec["grad"] = (err / norm) ** 0.5
    out[arch] = rec
dist.destroy_process_group()
print(json.dumps(out))
"""
# Three subprocesses (two lowering groups and the one-rank run), started
# before this module's first test, so that they run beside the plan
# tests.
LOWER_GROUPS = tuple({a: LOWER_KINDS[a] for a in group} for group in (
    list(LOWER_KINDS)[:3], list(LOWER_KINDS)[3:]))
# The hierarchical step (`lower_hier_record`, exact and int8) and
# `main(["--hier", ...])` lower in the first group.
LOWER_HIER = ((False, True), ())


@pytest.fixture(scope="module", autouse=True)
def _subprocesses(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    store = tmp_path_factory.mktemp("one_rank")
    scripts = [[LOWER_SCRIPT.replace("ARCHS", repr(group)).replace(
        "HIER", repr(hier))] for group, hier in zip(LOWER_GROUPS,
                                                    LOWER_HIER)]
    scripts.append([ONE_RANK_SCRIPT.replace("ARCHS", repr(ONE_RANK_ARCHS)),
                    str(store)])
    procs = [subprocess.Popen(
        [sys.executable, "-c", *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp_path_factory.mktemp("run")) for args in scripts]
    yield procs
    for p in procs:
        p.kill()
        p.communicate()


def _result(proc):
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def lowered(_subprocesses):
    out = {}
    for p in _subprocesses[:len(LOWER_GROUPS)]:
        got = _result(p)
        for key in [k for k in got if k.startswith(("hier/", "main"))]:
            out[key] = got.pop(key)
        launches = [a + b for a, b in zip(out.get("launches", [0, 0]),
                                          got.pop("launches"))]
        out.update(got, launches=launches)
    return out


@pytest.fixture(scope="module")
def one_rank(_subprocesses):
    return _result(_subprocesses[-1])


@pytest.mark.parametrize("arch,kind", [(a, k) for a, kinds in
                                       LOWER_KINDS.items() for k in kinds])
def test_smoke_lowering_is_ok(arch, kind, lowered):
    rec = lowered[f"{arch}/{kind}"]
    assert rec["status"] == "ok" and rec["chips"] == (4 if kind == "train"
                                                      else 8)
    assert rec["flops"] > 0 and rec["bytes"] > 0
    assert sum(rec["collectives"]["counts"].values()) > 0
    rf = rec["roofline"]
    assert rf["bound_s"] == max(rf["compute_s"], rf["memory_s"],
                                rf["collective_s"]) > 0
    assert rf["compute_s"] == rec["flops"] / dr.PEAK_FLOPS
    # The kernels ran their meta paths where the step has them.
    kernels = rec["kernels"]
    attn = arch != "mamba2_130m" and kind != "decode"
    ssd = arch in ("mamba2_130m", "zamba2_2p7b") and kind != "decode"
    assert ("flash_attention" in kernels) == attn
    assert ("ssd_scan" in kernels) == ssd
    assert ("flash_attention_backward" in kernels) == (attn and
                                                       kind == "train")
    # The lowered rank-0 state equals the plan where nothing departs.
    if "layout_departures" in rec:
        ffn = (["w_up", "w_down"] if arch == "hubert_xlarge"
               else ["w_gate", "w_up", "w_down"])
        assert rec["layout_departures"] == [f"blocks/ffn/{w}" for w in ffn]
        assert rec["state_bytes_per_device_lowered"] > \
            rec["state_bytes_per_device"]
    else:
        assert rec["state_bytes_per_device_lowered"] == \
            rec["state_bytes_per_device"]


@pytest.mark.parametrize("arch", ONE_RANK_ARCHS)
def test_dtensor_path_equals_the_plain_one_on_one_rank(arch, one_rank):
    """The per-rank plans' arithmetic on real values: prefill logits,
    the loss and a decode step (tokens and caches, batch- and
    sequence-sharded) bit-equal to the plain path; the gradients within
    bf16 rounding (the vocabulary-parallel loss rounds its logits'
    gradient in another order: norm-relative 2e-2, phase 8's bf16 gate
    is 5e-2)."""
    rec = one_rank[arch]
    assert rec["prefill"] and rec["decode0"] and rec["decode1"]
    assert rec["loss"][0] == rec["loss"][1]
    assert rec["grad"] < 2e-2


def test_smoke_lowering_launched_nothing(lowered):
    assert lowered["launches"] == [0, 0]


def test_dense_prefill_collectives_derived_by_hand(lowered):
    """Qwen2's SMOKE prefill (2 layers, d 64, 4 heads of 16 with 2 KV
    heads, d_ff 160, vocab 160, tied embeddings) on (pod, data, model) =
    (2, 2, 2), batch 8 x 32 sharded over (pod, data): each rank holds
    [2, 32, 64] bf16 activations, 8192 bytes.

    - The vocabulary-parallel embedding (tok [160, 64] over 'model') is
      Partial over 'model'; the embedding's constraint all-reduces it:
      one all-reduce of 8192 bytes.
    - Per layer, q/k/v are column-parallel over 'model' (4 and 2 heads
      divide by 2), so attention runs on each rank's heads, and the
      row-parallel wo's output is all-reduced over 'model': one
      all-reduce of 8192 bytes.
    - Per layer, the rules put the 2 stacked layers of the FFN over
      'model' (the departure: replicated there instead) and its width
      over 'data', where the tokens are sharded: each of w_gate, w_up
      [64, 160] and w_down [160, 64] is gathered over 'data' before its
      product (ZeRO-3): three all-gathers of 64 * 160 * 2 = 20480 bytes.
    - The tied head (tok^T, vocabulary over 'model') is column-parallel
      and the logits keep that sharding, as their constraint asks.

    So 1 + 2 = 3 all-reduces (24576 bytes) and 6 all-gathers (122880
    bytes); wire bytes 2 * 24576 + 122880 = 172032."""
    coll = lowered["qwen2_0p5b/prefill"]["collectives"]
    assert coll == {"counts": {"all-reduce": 3, "all-gather": 6},
                    "bytes_by_op": {"all-reduce": 24576.0,
                                    "all-gather": 122880.0},
                    "wire_bytes": 172032.0}


# ------------------------------------------------- collectives, table
def test_collective_stats_reference_figures():
    """tests/test_sharding.py's `test_collective_stats_parser` figures:
    all-reduce 2x on the wire, the rest 1x."""
    st = dr.collective_stats([
        ("all-reduce", 128 * 256 * 4), ("all-gather", 64 * 2),
        ("reduce-scatter", 32 * 4 + 16 * 4), ("collective-permute", 1024),
        ("all-reduce", 8 * 4)])
    assert st["counts"] == {"all-reduce": 2, "all-gather": 1,
                            "reduce-scatter": 1, "collective-permute": 1}
    assert st["bytes_by_op"]["all-reduce"] == 128 * 256 * 4 + 8 * 4
    assert st["bytes_by_op"]["all-gather"] == 64 * 2
    assert st["bytes_by_op"]["reduce-scatter"] == 32 * 4 + 16 * 4
    assert st["bytes_by_op"]["collective-permute"] == 1024
    assert st["wire_bytes"] == 2 * (128 * 256 * 4 + 32) + 128 + 192 + 1024


def test_markdown_table_equals_the_reference(lowered):
    recs = [dict(lowered[f"{a}/{k}"], mesh=m)
            for a, k, m in (("qwen2_0p5b", "train", "pod16x16"),
                            ("mamba2_130m", "decode", "pod2x16x16"),
                            ("deepseek_v3_671b", "prefill", "pod16x16"))]
    recs.append(dr.plan_cell("hubert_xlarge", "decode_32k", False))
    recs.append({"arch": "olmo_1b", "shape": "train_4k", "mesh": "pod16x16",
                 "status": "error", "tag": "", "error": "RuntimeError: x"})
    no_ratio = json.loads(json.dumps(recs[0]))
    no_ratio["roofline"]["useful_flops_ratio"] = None
    recs.append(no_ratio)
    for mesh in (None, "pod16x16", "pod2x16x16"):
        assert roofline.markdown_table(recs, mesh=mesh) == \
            ref_roofline.markdown_table(recs, mesh=mesh)
    assert roofline.fmt_float(0.5) == ref_roofline.fmt_float(0.5)


def test_load_records_skips_mode_and_other_tags(tmp_path):
    rows = {"a": {"arch": "a", "tag": ""}, "b": {"arch": "b", "tag": "x"},
            "c": {"arch": "c", "tag": "", "mode": "hier_T4"}}
    for name, r in rows.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(r))
    assert roofline.load_records(results=str(tmp_path)) == [rows["a"]]
    assert roofline.load_records("x", results=str(tmp_path)) == [rows["b"]]


# ------------------------------------------------ kernels on the meta
def test_kept_pairs_equal_the_mask_count():
    for Sq, Skv, causal, window in ((7, 7, True, None), (9, 9, True, 3),
                                    (5, 8, False, None), (8, 8, False, 2),
                                    (6, 6, True, 1)):
        q = torch.arange(Sq)[:, None]
        k = torch.arange(Skv)[None, :]
        keep = torch.ones(Sq, Skv, dtype=torch.bool)
        if causal:
            keep &= q >= k
        if window is not None:
            keep &= k > q - window
        assert meta.kept_pairs(Sq, Skv, causal, window) == int(keep.sum())


def test_kernels_on_the_meta_device_report_and_launch_nothing():
    calls = []
    q = torch.empty(2, 64, 4, 16, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 64, 2, 16, dtype=torch.bfloat16, device="meta")
    x = torch.empty(2, 64, 3, 8, device="meta")
    dt = torch.empty(2, 64, 3, device="meta")
    A = torch.empty(3, device="meta")
    Bm = torch.empty(2, 64, 5, device="meta")
    before = (flash_attention.launches, ssd_scan.launches)
    with meta.recording(lambda *a: calls.append(a)):
        o = flash_attention(q, kv, kv, causal=True, window=16)
        y, state = ssd_scan(x, dt, A, Bm, Bm, chunk=32)
        qg = q.clone().requires_grad_()
        flash_attention(qg, kv, kv, causal=True).sum().backward()
        xg = x.clone().requires_grad_()
        ssd_scan(xg, dt, A, Bm, Bm, chunk=32)[0].sum().backward()
    assert (flash_attention.launches, ssd_scan.launches) == before
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert y.shape == x.shape and state.shape == (2, 3, 8, 5)
    assert qg.grad.shape == q.shape and xg.grad.shape == x.shape
    attn = 4 * 16 * 2 * 4 * meta.kept_pairs(64, 64, True, 16)
    causal = 4 * 16 * 2 * 4 * (64 * 65 // 2)
    ssd = 2 * 2 * (5 * 32 * 33 + 3 * (8 * 32 * 33 + 4 * 32 * 5 * 8))
    assert [c[:2] for c in calls] == [
        ("flash_attention", attn), ("ssd_scan", ssd),
        ("flash_attention", causal),
        ("flash_attention_backward", meta.BACKWARD_FACTOR * causal),
        ("ssd_scan", ssd), ("ssd_scan_backward", meta.BACKWARD_FACTOR * ssd)]
    assert calls[0][2] == (2 * q.numel() + 2 * kv.numel()) * 2


# ----------------------------------------------------------- hygiene
def test_importing_the_dry_run_touches_no_group_and_no_environment():
    code = ("import os, json; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.bench.roofline; "
            "import torch.distributed as dist; "
            "print(json.dumps([dict(os.environ) == before, "
            "dist.is_initialized()]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, False]


# ------------------------------------------------------- lower_hier
# The reference record's keys (src/repro/launch/dryrun.py `lower_hier`),
# its `hlo_flops` / `hlo_bytes` under the port's names.
HIER_KEYS = {"arch", "shape", "mesh", "mode", "tag", "status", "chips",
             "collectives_never", "collectives_always", "wire_nosync",
             "wire_sync", "cross_pod_bytes_per_sync", "amortized_wire_bytes",
             "flops", "bytes", "bytes_basis", "roofline"}


def test_hier_is_not_ported_yet(lowered):
    """(Named when `--hier` raised.) `main(["--hier", "2", "--compress",
    "--tag", "t"])` lowers the hierarchical step, writes the reference's
    file name and prints the reference's line: here on the SMOKE config
    at a 32 x 8 train shape on the pod2x16x16 mesh (2 layers do not
    divide by 16: no layout departure)."""
    got = lowered["main"]
    rec = got["rec"]
    assert set(rec) == HIER_KEYS
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "cross_pod_s_per_sync"}
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["mode"], rec["tag"],
            rec["status"], rec["chips"], rec["bytes_basis"]) == (
        "qwen2_0p5b", "train_4k", "pod2x16x16", "hier_T2_int8", "t", "ok",
        512, "unfused")
    assert "qwen2_0p5b__hier_T2_int8__t.json" in got["files"]
    assert got["printed"] == dr.fmt_hier_line(rec, 2, True) + "\n"
    assert got["printed"].startswith("qwen2_0p5b         hier T=2 int8=True "
                                     "amortized_wire=")


def _hand_shard_bytes():
    """Per rank on (pod 2, data 2, model 2): the f32 bytes of its pod's
    parameter shards, the int8 payload's bytes, and the number of mesh
    dims that shard each parameter (the scale's max all-reduces: 'pod'
    and every axis of its spec), from the rules' specs on a mesh of
    axis sizes (the layer-axis departure: replicated over 'model')."""
    cfg = get_smoke_config("qwen2_0p5b")
    mesh = dr.AxisSizes({"pod": 2, "data": 2, "model": 2})
    model = lm_port.init_params(cfg, device="meta")
    specs = shd_port.layer_specs(model, mesh, departures=[])
    numel = reductions = 0
    for name, p in model.named_parameters():
        axes = [a for e in specs[name] if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        numel += p.numel() // int(np.prod([2 for _ in axes]))
        reductions += 1 + len(axes)
    return 4 * numel, numel, reductions


def test_hier_lowering_has_the_reference_keys(lowered):
    for compress in (0, 1):
        rec = lowered[f"hier/{compress}"]
        assert set(rec) == HIER_KEYS | {"layout_departures"}
        assert rec["layout_departures"] == ["blocks/ffn/w_gate",
                                            "blocks/ffn/w_up",
                                            "blocks/ffn/w_down"]
        rf = rec["roofline"]
        assert rf["compute_s"] == rec["flops"] / dr.PEAK_FLOPS > 0
        assert rf["memory_s"] == rec["bytes"] / dr.HBM_BW > 0
        assert rf["collective_s"] == rec["amortized_wire_bytes"] / dr.LINK_BW
        assert rf["cross_pod_s_per_sync"] == \
            rec["cross_pod_bytes_per_sync"] / dr.LINK_BW


def test_hier_step_without_a_sync_moves_nothing_across_pods(lowered):
    for compress in (0, 1):
        rec = lowered[f"hier/{compress}"]
        never, always = rec["collectives_never"], rec["collectives_always"]
        assert never["cross_pod_wire_bytes"] == 0
        assert never["wire_bytes"] == rec["wire_nosync"] > 0
        assert always["cross_pod_wire_bytes"] > 0
        # A pod's step is the same with or without the sync.
        assert rec["flops"] > 0 and rec["bytes"] > 0
        assert rec["amortized_wire_bytes"] == \
            rec["wire_nosync"] + rec["cross_pod_bytes_per_sync"] / 2


def test_hier_cross_pod_bytes_derived_by_hand(lowered):
    """One sync's wire, from each rank's local shards (`_hand_shard_bytes`):
    the exact sync is one f32 all-reduce over 'pod' per parameter (2x on
    the wire); the int8 one sends each int8 payload once to the other pod
    (1x) and all-reduces the 4-byte scale (max) over every mesh dim that
    shards the tensor (2x)."""
    f32, s8, reductions = _hand_shard_bytes()
    exact, int8 = lowered["hier/0"], lowered["hier/1"]
    assert exact["cross_pod_bytes_per_sync"] == 2 * f32
    assert exact["collectives_always"]["cross_pod_wire_bytes"] == 2 * f32
    assert int8["cross_pod_bytes_per_sync"] == s8 + 2 * 4 * reductions
    assert int8["collectives_always"]["counts"]["all-to-all"] == \
        int8["collectives_never"]["counts"].get("all-to-all", 0) + len(
            list(lm_port.init_params(get_smoke_config("qwen2_0p5b"),
                                     device="meta").parameters()))

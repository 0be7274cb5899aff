"""The port's sharding rules, `constrain` and mesh helpers against the JAX
reference, on the CPU.

The rules are pure metadata: every arch's params tree in the
reference's stacked layout (`reference_shape_tree`, built from the
port's model on the meta device) must equal the reference's
`jax.eval_shape` tree, and its specs must equal the reference's
`PartitionSpec`s leaf for leaf on a (16, 16) and a (2, 16, 16) mesh,
with and without FSDP; batch and cache specs likewise. The meshes are
tests/test_sharding.py's duck-typed `FakeMesh`es, and in a subprocess a
torch `DeviceMesh` of a fake 256-rank world. `constrain` is held to the
identity without a mapping and to its placements on a one-rank gloo mesh
(a process group is global state, so those run in subprocesses).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.parallel import sharding as ref_shd  # noqa: E402
from repro.serve import steps as ref_steps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel import constrain as con  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.serve import steps  # noqa: E402
from tests.test_sharding import MESH1, MESH2, FakeMesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(ref_configs.ARCH_IDS)
MESHES = {"16x16": MESH1, "2x16x16": MESH2}
FSDP = {"none": dict(fsdp=False), "fsdp": dict(fsdp=True),
        "fsdp_data": dict(fsdp=True, fsdp_axes=("data",))}


@pytest.fixture(scope="module")
def ref_shapes():
    """arch -> the reference's `jax.eval_shape` params tree (lazily)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = ref_configs.get_config(arch)
            cache[arch] = jax.eval_shape(lambda k: ref_lm.init_params(cfg, k),
                                         jax.random.PRNGKey(0))
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def port_shapes():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = shd.reference_shape_tree(configs.get_config(arch))
        return cache[arch]
    return get


def _flat(tree, is_leaf=None):
    """path string -> leaf of a nested tree (the reference's path_str)."""
    return {ref_shd.path_str(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _ref_specs(tree):
    return {k: tuple(v) for k, v in
            _flat(tree, lambda x: isinstance(x, P)).items()}


# ----------------------------------------------------------- the shapes
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_shape_tree_equals_eval_shape(arch, ref_shapes,
                                                port_shapes):
    want, got = ref_shapes(arch), port_shapes(arch)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in _flat(got).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(want).items()}


# ------------------------------------------------------------ the specs
@pytest.mark.parametrize("fsdp", list(FSDP))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh, fsdp, ref_shapes,
                                     port_shapes):
    m, kw = MESHES[mesh], FSDP[fsdp]
    want = _ref_specs(ref_shd.param_spec_tree(ref_shapes(arch), m, **kw))
    got = _flat(shd.param_spec_tree(port_shapes(arch), m, **kw),
                lambda x: isinstance(x, tuple))
    assert got == want


def test_fsdp_ties_follow_numpys_argsort():
    """[L, 896, 896] under FSDP: the dim picked among equal sizes is the
    one numpy's argsort puts first, as in the reference."""
    leaf = jax.ShapeDtypeStruct((24, 896, 896), "float32")
    for path in ("blocks/attn/q_down", "blocks/mixer/out_proj"):
        want = tuple(ref_shd._spec_for(path, leaf.shape, MESH1, ("data",),
                                       True))
        assert shd._spec_for(path, leaf.shape, MESH1, ("data",), True) == \
            want
    assert shd.axis_size(MESH2, ("pod", "data")) == 32
    assert shd.dp_axes(MESH2) == ("pod", "data") and \
        shd.dp_axes(MESH1) == ("data",)


CACHE_CASES = {
    "decode": dict(seq_parallel=False),
    "seq_parallel": dict(seq_parallel=True),
    "seq_axis_2d": dict(seq_parallel=False, seq_axis_2d="model"),
    "seq_parallel_axes": dict(seq_parallel=True,
                              seq_parallel_axes=("data", "model")),
}


@pytest.mark.parametrize("case", list(CACHE_CASES))
@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "starcoder2_7b",
                                  "deepseek_v3_671b", "zamba2_2p7b",
                                  "mamba2_130m"])
def test_cache_and_batch_specs_equal_reference(arch, case):
    ref_cfg = ref_configs.get_config(arch)
    cfg = configs.get_config(arch)
    for mesh in MESHES.values():
        for B, S in ((128, 1024), (1, 4096 * 16), (2, 64)):
            want = _ref_specs(ref_shd.cache_specs(
                ref_steps.cache_shapes(ref_cfg, B, S), mesh,
                **CACHE_CASES[case]))
            got = _flat(shd.cache_specs(steps.cache_shapes(cfg, B, S), mesh,
                                        **CACHE_CASES[case]),
                        lambda x: isinstance(x, tuple))
            assert got == want, (mesh.shape, B, S)
            batch = {"tokens": jax.ShapeDtypeStruct((B, S), "int32"),
                     "patches": jax.ShapeDtypeStruct((B, 256, 2048),
                                                     "float32")}
            port_batch = {k: torch.empty(v.shape, device="meta")
                          for k, v in batch.items()}
            assert _flat(shd.batch_specs(port_batch, mesh),
                         lambda x: isinstance(x, tuple)) == \
                _ref_specs(ref_shd.batch_specs(batch, mesh))


# ---------------------------------------------------- per-layer layout
def test_layer_placements_map_stacked_specs_onto_layers():
    from torch.distributed.tensor import Replicate, Shard
    model = lm.init_params(configs.get_config("qwen2-0.5b"), device="meta")
    pl = shd.layer_placements(model, MESH1)
    assert set(pl) == {k for k, _ in model.named_parameters()}
    # [D, H dh]: heads over 'model'; the data axis replicates.
    assert pl["blocks.3.attn.wq"] == (Replicate(), Shard(1))
    assert pl["blocks.3.attn.wo"] == (Replicate(), Shard(0))
    # Qwen2's 24 layers do not divide by 16: the FFN keeps the MoE rule's
    # width over 'data' and nothing else.
    assert pl["blocks.0.ffn.w_gate"] == (Shard(1), Replicate())
    assert pl["embed.tok"] == (Replicate(), Shard(0))
    assert pl["blocks.0.ln1.w"] == (Replicate(), Replicate())
    # FSDP on (pod, data, model): 'data' is taken by the FFN width, so
    # the free 'pod' shards the largest dim left.
    specs = shd.layer_specs(model, MESH2, fsdp=True)
    assert specs["blocks.0.ffn.w_down"] == ("data", "pod")
    pl2 = shd.layer_placements(model, MESH2, fsdp=True)
    assert pl2["embed.tok"] == (Shard(1), Shard(1), Shard(0))
    hybrid = lm.init_params(configs.get_config("zamba2-2.7b"), device="meta")
    assert shd.layer_specs(hybrid, MESH1)["blocks.8.5.mixer.in_proj"] == \
        (None, "model")


@pytest.mark.parametrize("arch", ["olmo-1b", "starcoder2-7b",
                                  "hubert-xlarge"])
def test_layer_placements_raise_where_the_layer_axis_is_sharded(arch):
    model = lm.init_params(configs.get_config(arch), device="meta")
    with pytest.raises(ValueError, match=r"blocks/ffn/w_(gate|up) .*stacked"):
        shd.layer_placements(model, MESH1)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-0.5b"])
def test_a_layer_axis_over_a_size_one_axis_is_not_split(arch):
    """On a (1, 1) mesh the rules put 'model' on the stacked FFN's layer
    axis (1 divides every layer count): a split over one rank is no
    split, so every leaf is placed, with no departure."""
    model = lm.init_params(configs.get_config(arch), device="meta")
    mesh = FakeMesh({"data": 1, "model": 1})
    assert shd.param_spec_tree(shd.reference_shape_tree(model.cfg), mesh)[
        "blocks"]["ffn"]["w_gate"][0] == "model"
    departures = []
    pl = shd.layer_placements(model, mesh, departures=departures)
    assert departures == []
    assert set(pl) == {k for k, _ in model.named_parameters()}
    assert all(len(p) == 2 for p in pl.values())


# ------------------------------------------------------------ constrain
def test_constrain_is_the_identity_without_a_mapping():
    x = torch.randn(2, 3, 4)
    assert con.constrain(x, "dp", None, "tp") is x
    with con.logical_axis_rules(con.rules_single_pod()):
        assert con._mapping() == {"dp": "data", "tp": "model", "sp": "data"}
        assert con.constrain(x, "dp", None, "tp") is x   # a plain tensor
        with con.logical_axis_rules(con.rules_multi_pod()):
            assert con._mapping()["dp"] == ("pod", "data")
        assert con._mapping()["dp"] == "data"
    assert con._mapping() is None
    cfg = configs.get_smoke_config("qwen2-0.5b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8),
                                     generator=torch.Generator())}
    with torch.no_grad():
        want = lm.forward(params, cfg, batch)
        with con.logical_axis_rules(con.rules_single_pod()):
            got = lm.forward(params, cfg, batch)
    assert torch.equal(got, want)


def _run(code: str, tmp_path) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_constrain_redistributes_a_dtensor_on_a_gloo_mesh(tmp_path):
    got = _run(f"""
import json, torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel import constrain as con
dist.init_process_group("gloo", init_method="file://{tmp_path}/store",
                        rank=0, world_size=1)
mesh = make_host_mesh(1, 1, device_type="cpu")
x = distribute_tensor(torch.arange(48.).reshape(4, 3, 4), mesh,
                      [Replicate(), Replicate()])
same = con.constrain(x, "dp", None, "tp") is x
with con.logical_axis_rules(con.rules_single_pod()):
    y = con.constrain(x, "dp", None, "tp")
    z = con.constrain(x, None, None, None)
out = dict(same=same, mesh=list(mesh.mesh_dim_names),
           y=[str(p) for p in y.placements], z=[str(p) for p in z.placements],
           equal=bool(torch.equal(y.full_tensor(), x.full_tensor())))
dist.destroy_process_group()
print(json.dumps(out))
""", tmp_path)
    assert got == {"same": True, "mesh": ["data", "model"],
                   "y": ["S(0)", "S(2)"], "z": ["R", "R"], "equal": True}


# ---------------------------------------------------------------- meshes
def test_production_mesh_on_a_fake_world(tmp_path):
    got = _run("""
import json, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding as shd
out = {}
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    m = make_production_mesh(multi_pod=multi, device_type="cpu")
    try:
        make_production_mesh(multi_pod=not multi, device_type="cpu")
    except ValueError as e:
        out[f"refused{world}"] = str(e)
    specs = shd.param_spec_tree(
        shd.reference_shape_tree(get_config("qwen2-0.5b")), m, fsdp=True)
    out[str(world)] = dict(names=list(m.mesh_dim_names), shape=list(m.shape),
                           wq=list(specs["blocks"]["attn"]["wq"]))
    dist.destroy_process_group()
print(json.dumps(out))
""", tmp_path)
    assert got["256"] == {"names": ["data", "model"], "shape": [16, 16],
                          "wq": [None, "data", "model"]}
    assert got["512"] == {"names": ["pod", "data", "model"],
                          "shape": [2, 16, 16],
                          "wq": [None, ["pod", "data"], "model"]}
    assert "the world size is 256" in got["refused256"]
    assert "the world size is 512" in got["refused512"]
    # The same rules on the duck-typed meshes.
    tree = shd.reference_shape_tree(configs.get_config("qwen2-0.5b"))
    assert shd.param_spec_tree(tree, MESH1, fsdp=True)["blocks"]["attn"][
        "wq"] == (None, "data", "model")


def test_meshes_refuse_a_world_of_another_size(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="world size is 1"):
        port_mesh.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        port_mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        port_mesh.make_host_mesh(2, 2, device_type="cpu")


def test_make_batch_mesh_is_the_device_list(monkeypatch):
    assert port_mesh.make_batch_mesh(["cpu"] * 3) == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="at least one device"):
        port_mesh.make_batch_mesh()
    with pytest.raises(ValueError, match="at least one device"):
        port_mesh.make_batch_mesh([])

"""Rules of the PyTorch port: no JAX and nothing of the JAX package in
`src/repro_torch` or `chip_smoke.py`, and entry points that run on CUDA
unless the caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import LockSpec, Session  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.dht import BatchedDHT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    assert len(PORT_FILES) > 10
    bad = {str(p.relative_to(ROOT)): sorted(
        r for r in set(_imported_roots(p)) if r in ("jax", "jaxlib", "repro"))
        for p in PORT_FILES}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.core, repro_torch.dht, "
            "repro_torch.kernels.ops, repro_torch.configs, repro_torch.data, "
            "repro_torch.models.lm, repro_torch.models.convert, "
            "repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.core.programs.dht, repro_torch.bench.dht, "
            "repro_torch.bench.faults, repro_torch.bench.kernels, "
            "repro_torch.bench.run, repro_torch.examples.quickstart, "
            "repro_torch.examples.lock_demo, repro_torch.examples.serve_kv, "
            "repro_torch.analysis.locklint, repro_torch.analysis.model, "
            "repro_torch.analysis.mutants, repro_torch.core.api, "
            "repro_torch.models.moe, repro_torch.models.mla, "
            "repro_torch.launch.smoke_models, repro_torch.optim, "
            "repro_torch.train, repro_torch.checkpoint, "
            "repro_torch.runtime, repro_torch.launch.train, "
            "repro_torch.examples.train_lm, repro_torch.parallel.compression, "
            "repro_torch.parallel.hierarchical, "
            "repro_torch.parallel.sharding, repro_torch.parallel.constrain, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.bench.roofline, repro_torch.parallel.spmd, "
            "repro_torch.kernels.meta; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_session_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Session(LockSpec(kind="d_mcs", P=4))
    assert Session(LockSpec(kind="d_mcs", P=4), device="cpu").device.type \
        == "cpu"


def test_batched_dht_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BatchedDHT(nb=2, TB=8, heap=8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        engine.resolve_device(None)


def test_lm_and_launcher_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import convert, lm

    cfg = get_smoke_config("qwen2-0.5b")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lm.make_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.from_reference({"embed": {}, "blocks": {}}, cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--arch", "qwen2-0.5b", "--smoke"])
    model = lm.init_params(cfg, torch.Generator(), device="cpu")
    assert model.embed.tok.device.type == "cpu"


def test_model_families_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.launch import serve, smoke_models
    from repro_torch.models import lm

    with pytest.raises(RuntimeError, match='device="cpu"'):
        smoke_models.main([])
    for arch in ("internvl2-2b", "deepseek-v3-671b", "zamba2-2.7b"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            serve.main(["--arch", arch, "--smoke"])
        with pytest.raises(RuntimeError, match='device="cpu"'):
            lm.make_cache(get_smoke_config(arch), 1, 4)
    assert set(smoke_models.main(["--device", "cpu"])) == set(ARCH_IDS)


def test_benchmarks_and_examples_default_to_cuda_and_raise_without_it(
        no_cuda):
    from repro_torch.bench import dht, faults, kernels, run
    from repro_torch.examples import lock_demo, quickstart, serve_kv

    for call in (lambda: dht.bench_dht(ps=(4,)),
                 lambda: dht.bench_batched_table(),
                 lambda: faults.bench_faults(quick=True),
                 lambda: faults.main(["--quick"]),
                 lambda: kernels.bench_kernels(),
                 lambda: run.main(["--only", "faults"]),
                 lambda: quickstart.main(), lambda: lock_demo.main(),
                 lambda: serve_kv.main()):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_locklint_and_shims_default_to_cuda_and_raise_without_it(no_cuda):
    import warnings

    from repro_torch.analysis import locklint
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.core import api

    for call in (lambda: locklint.check_kind("fompi_spin", quick=True),
                 lambda: locklint.check_dht(),
                 lambda: locklint.main(["--kind", "fompi_spin", "--quick"]),
                 lambda: api.RMARWLock(P=4, fanout=(2,)).run()):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_training_defaults_to_cuda_and_raises_without_it(no_cuda, tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    from repro_torch.models import convert
    from repro_torch.runtime import Trainer
    from repro_torch.train.step import init_state

    cfg = get_smoke_config("qwen2-0.5b")
    for call in (lambda: init_state(cfg, torch.Generator()),
                 lambda: Trainer(cfg, str(tmp_path)),
                 lambda: convert.state_from_reference(None, cfg),
                 lambda: train.main(["--arch", "qwen2-0.5b", "--smoke",
                                     "--workdir", str(tmp_path)]),
                 lambda: train_lm.main(["--workdir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert Trainer(cfg, str(tmp_path), device="cpu").device.type == "cpu"


def test_hier_training_defaults_to_cuda_and_raises_without_it(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.models import convert
    from repro_torch.parallel.hierarchical import init_hier_state

    cfg = get_smoke_config("qwen2-0.5b")
    for call in (lambda: init_hier_state(cfg, torch.Generator(), 2),
                 lambda: convert.hier_state_from_reference(None, cfg),
                 lambda: train.main(["--arch", "qwen2-0.5b", "--smoke",
                                     "--hier", "2", "--compress"])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_chip_smoke_fails_without_cuda_and_prints_no_result(no_cuda, capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_nocuda",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(SystemExit) as exit_info:
        mod.main([])
    assert exit_info.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out

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
            "repro_torch.kernels.ops; "
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

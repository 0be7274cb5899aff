"""The port's benchmark CLI (`python -m repro_torch.bench.run`), on the
CPU: `--quick --only faults` writes `faults_torch.csv` with the rows of
`bench_faults(quick=True)`; `coerce_scalars` turns numpy and 0-d torch
scalars into Python ones; asking for the roofline (not ported), an
unknown section or the CUDA-only kernels section on the CPU raises."""
import csv

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import faults, kernels, run  # noqa: E402


def test_quick_faults_section_writes_its_rows(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(run, "RESULTS", str(tmp_path))
    run.main(["--quick", "--only", "faults", "--device", "cpu"])
    with open(tmp_path / "faults_torch.csv", newline="") as f:
        got = list(csv.DictReader(f))
    want = faults.bench_faults(quick=True, device="cpu")["rows"]
    assert got == [{k: str(v) for k, v in r.items()} for r in want]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["faults_torch.csv"]
    assert "FAULTS: crash injection" in capsys.readouterr().out


def test_coerce_scalars_gives_python_values():
    rows = [{"a": np.float32(1.5), "b": np.int32(3), "c": torch.tensor(2.5),
             "d": torch.tensor(7, dtype=torch.int32), "e": "x",
             "f": torch.tensor([1, 2])}]
    got = run.coerce_scalars(rows)[0]
    assert got["a"] == 1.5 and type(got["a"]) is float
    assert got["b"] == 3 and type(got["b"]) is int
    assert got["c"] == 2.5 and type(got["c"]) is float
    assert got["d"] == 7 and type(got["d"]) is int
    assert got["e"] == "x" and got["f"] is rows[0]["f"]


@pytest.mark.parametrize("only,match", [
    ("roofline", "ROADMAP.md queue 1 item 7"),
    ("lb,roofline", "ROADMAP.md queue 1 item 7"),
    ("lb,nope", "unknown sections"),
    ("kernels", "CUDA device only")])
def test_sections_that_cannot_run_raise(only, match):
    with pytest.raises(ValueError, match=match):
        run.main(["--only", only, "--device", "cpu"])


def test_bench_kernels_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA device only"):
        kernels.bench_kernels(device="cpu")

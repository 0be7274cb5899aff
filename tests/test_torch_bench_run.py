"""The port's benchmark CLI (`python -m repro_torch.bench.run`), on the
CPU: `--quick --only faults` writes `faults_torch.csv` with the rows of
`bench_faults(quick=True)`; `coerce_scalars` turns numpy and 0-d torch
scalars into Python ones; `--only roofline` (alone or beside another
section) prints the dry run's pod16x16 table, or the hint to run the dry
run first; an unknown section or the CUDA-only kernels section on the
CPU raises."""
import csv
import json

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


RECORD = {"arch": "qwen2_0p5b", "shape": "train_4k", "mesh": "pod16x16",
          "kind": "train", "tag": "", "status": "ok",
          "state_bytes_per_device": 3 << 29,
          "roofline": {"compute_s": 0.5, "memory_s": 0.25,
                       "collective_s": 1.5, "bottleneck": "collective_s",
                       "useful_flops_ratio": 0.75,
                       "roofline_fraction": 1 / 3}}


@pytest.mark.parametrize("only", ["roofline", "lb,roofline"])
def test_roofline_section_runs(only, tmp_path, monkeypatch, capsys):
    from repro_torch.bench import locks, roofline
    monkeypatch.setattr(run, "RESULTS", str(tmp_path / "bench"))
    monkeypatch.setattr(roofline, "RESULTS", str(tmp_path / "dryrun"))
    # The lb section's own run is another test's; here it is a stub.
    monkeypatch.setattr(locks, "bench_latency", lambda ps, device: [
        {"bench": "lb", "kind": "rma_rw", "P": 16, "latency_us": 1.5}])
    run.main(["--quick", "--only", only, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "no dry-run artifacts; run python -m repro_torch.launch.dryrun" \
        in out
    (tmp_path / "dryrun").mkdir()
    for mesh in ("pod16x16", "pod2x16x16"):
        (tmp_path / "dryrun" / f"qwen2_0p5b__train_4k__{mesh}.json"
         ).write_text(json.dumps(dict(RECORD, mesh=mesh)))
    run.main(["--quick", "--only", only, "--device", "cpu"])
    out = capsys.readouterr().out
    assert ("| qwen2_0p5b | train_4k | pod16x16 | 5.000e-01 | 2.500e-01 | "
            "1.500e+00 | collective_s | 0.75 | 0.33 | 1.50 |") in out
    assert "pod2x16x16" not in out
    assert ("LB: acquire+release latency" in out) == ("lb" in only)


@pytest.mark.parametrize("only,match", [
    ("lb,nope", "unknown sections"),
    ("kernels", "CUDA device only")])
def test_sections_that_cannot_run_raise(only, match):
    with pytest.raises(ValueError, match=match):
        run.main(["--only", only, "--device", "cpu"])


def test_bench_kernels_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA device only"):
        kernels.bench_kernels(device="cpu")

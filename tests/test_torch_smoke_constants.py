"""`chip_smoke.py` checks the port on the card, which has no JAX, against
seed-0 constants it holds (events, total acquires, makespan as float32
bits). This pins the constants of its README- and paper-sized
configurations to the JAX reference (the P=16 configurations are
pinned in test_torch_engine.py). The script is imported, not run."""
import pytest

pytest.importorskip("torch")

from test_torch_engine import (P16, chip_smoke, ref_run0,  # noqa: E402
                               seed0_constants)

LARGE = [name for name in chip_smoke.SIM_CONFIGS if name not in P16]


def test_every_configuration_has_constants():
    assert set(chip_smoke.SIM_EXPECTED) == set(chip_smoke.SIM_CONFIGS)
    assert len(LARGE) == 3


@pytest.mark.parametrize("name", LARGE)
def test_chip_smoke_constants_match_reference(name):
    assert chip_smoke.SIM_EXPECTED[name] == seed0_constants(ref_run0(name))

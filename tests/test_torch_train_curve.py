"""Qwen2-0.5B's loss curve over six train steps, the port against the JAX
reference, on the CPU.

A 2-layer copy of Qwen2-0.5B at its published widths (d_model 896,
vocab 151936, tied embeddings) starts from one reference train state
converted to the port, then takes six steps in each package on the same
batches (a short sequence) with the training phase's schedule on the
card: warmup 2, total 6, AdamW at its defaults (lr 3e-4). Both compute
in float32 (a test-local patch of each `lm.COMPUTE_DTYPE`). Every step's
metrics and the final params, m and v agree at `F32_TOL`, relative to
each tensor's largest magnitude, as in tests/test_torch_train.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.train import step  # noqa: E402
from tests.test_torch_train import F32_TOL, _close, _params_close  # noqa: E402

B, S, STEPS = 2, 32, 6
SCHEDULE = dict(remat="none", warmup_steps=2, total_steps=STEPS)


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


def test_qwen2_six_step_loss_curve_matches_reference(f32):
    ref_cfg = dataclasses.replace(ref_configs.get_config("qwen2_0p5b"),
                                  n_layers=2)
    cfg = dataclasses.replace(configs.get_config("qwen2-0.5b"), n_layers=2)
    rs = jax.jit(lambda k: ref_step.init_state(ref_cfg, k))(
        jax.random.PRNGKey(0))
    ps = convert.state_from_reference(jax.tree.map(np.asarray, rs), cfg,
                                      "cpu")
    ref_fn = jax.jit(ref_step.build_train_step(ref_cfg, **SCHEDULE))
    port_fn = step.build_train_step(cfg, **SCHEDULE)
    want_curve, got_curve = [], []
    for i in range(STEPS):
        np_batch = ref_synthetic.batch_for(ref_cfg, B, S, i)
        rs, want = ref_fn(rs, jax.tree.map(jnp.asarray, np_batch))
        ps, got = port_fn(ps, {k: torch.from_numpy(v)
                               for k, v in np_batch.items()})
        for k in want:
            _close(got[k], want[k], F32_TOL)
        want_curve.append(float(want["loss"]))
        got_curve.append(float(got["loss"]))
    print(f"reference losses {want_curve}; port {got_curve}")
    assert int(ps.step) == int(rs.step) == int(ps.opt.step) == STEPS
    _params_close(ps.params, rs.params, cfg, F32_TOL)
    _params_close(ps.opt.m, rs.opt.m, cfg, F32_TOL)
    _params_close(ps.opt.v, rs.opt.v, cfg, F32_TOL)

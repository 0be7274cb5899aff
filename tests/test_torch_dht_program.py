"""The port's §5.3 DHT program (Fig. 6) against the JAX reference, on the
CPU.

* `prng.randint` equals `jax.random.randint(key, (), lo, hi)` bit for
  bit over 1000 seeds, for spans that are powers of 2 and not, up to
  2**31 - 1 (where JAX's uint32 products wrap), for minval > 0 and for
  maxval <= minval.
* The engine's key stream draws a program's declared `slot` and `k2`
  exactly as the reference's `a_op` does from each step's subkey, and
  leaves the draws of a program that declares nothing as they were.
* `FompiADHT` runs (the foMPI-A access of Fig. 6) give the reference's
  events, makespan bits, acquires (in all and per process), completion
  and violations, at jitter 0 and at the default jitter for seeds 0-3;
  its writer fractions run as the lanes of one run equal single runs
  bit for bit; its `meta()` equals the reference's.
* `bench_dht(ps=(16,))` gives the reference's rows exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import dht_bench as ref_bench  # noqa: E402
from repro.core import LockSpec as RefSpec  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.cost import CostModel as RefCost  # noqa: E402
from repro.core.programs.dht import FompiADHT as RefADHT  # noqa: E402
from repro_torch.bench import dht as bench  # noqa: E402
from repro_torch.core import LockSpec, engine, metrics_at, prng  # noqa: E402
from repro_torch.core import writer_mask  # noqa: E402
from repro_torch.core.cost import CostModel  # noqa: E402
from repro_torch.core.programs.dht import FompiADHT  # noqa: E402

SEEDS = np.arange(1000, dtype=np.int32)
SPANS = [1, 2, 3, 7, 64, 100, 1000, 2**20 + 3, 2**31 - 1]


@pytest.fixture(scope="module")
def jax_randint():
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(SEEDS))
    f = jax.jit(jax.vmap(lambda k, lo, hi: jax.random.randint(k, (), lo, hi),
                         in_axes=(0, None, None)))
    return lambda lo, hi: np.asarray(f(keys, lo, hi))


@pytest.mark.parametrize("n", SPANS)
def test_randint_matches_jax(jax_randint, n):
    got = prng.randint(prng.PRNGKey(SEEDS), 0, n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_randint(0, n))


@pytest.mark.parametrize("lo,hi", [(5, 17), (3, 2**31 - 1), (-100, -3),
                                   (-2**31, 2**31 - 1), (10, 10), (10, 3)],
                         ids=["lo5", "lo3_max", "negative", "full_int32",
                              "empty", "inverted"])
def test_randint_bounds_match_jax(jax_randint, lo, hi):
    got = prng.randint(prng.PRNGKey(SEEDS), lo, hi)
    np.testing.assert_array_equal(got.numpy(), jax_randint(lo, hi))


def test_key_stream_draws_what_a_program_declares():
    """Step t's declared draws are a_op's: k1, k2 = split(sub_t);
    slot = randint(k1, (), 0, n), k2's uniform. A program that declares
    nothing gets the same chunk with neither."""
    n_slots, steps, seeds = 64, 5, [0, 7]
    spec = LockSpec(kind="fompi_spin", P=4)
    m = spec.machine()
    env = engine.make_env(m, spec.layout(m), device="cpu")
    plain = engine._KeyStream(env, torch.tensor(seeds)).chunk(steps)
    drawn = engine._KeyStream(env, torch.tensor(seeds),
                              {"slot": n_slots, "k2": True}).chunk(steps)
    assert set(drawn) == set(plain) | {"slot", "k2"}
    for k in plain:
        assert torch.equal(drawn[k], plain[k])
    for lane, s in enumerate(seeds):
        key = jax.random.PRNGKey(s)
        for t in range(steps):
            key, sub = jax.random.split(key)
            k1, k2 = jax.random.split(sub)
            assert int(drawn["slot"][lane, t]) == int(
                jax.random.randint(k1, (), 0, n_slots))
            assert float(drawn["k2"][lane, t]) == float(
                jax.random.uniform(k2, ()))
    with pytest.raises(ValueError, match="slot"):
        engine.Program(env, (), draws={"lanes": 3})


# ------------------------------------------------------------ FompiADHT
P = 16
FWS = (0.0, 0.05, 0.20)
DHT_SEEDS = (0, 1, 2, 3)
EXACT = ("events", "makespan", "total_acquires", "per_proc_acq",
         "completed", "violations")


def _setup(spec_cls, cost, fw):
    """(machine, layout, table words, heap word, mask) as
    `benchmarks/dht_bench._run_fompi_a` builds them."""
    spec = spec_cls(kind="fompi_spin", P=P, **({} if cost is None
                                               else {"cost": cost}))
    machine = spec.machine()
    layout = spec.layout(machine, extra_words=bench.N_TABLE_WORDS + 1)
    W = layout.W
    table = np.arange(W - bench.N_TABLE_WORDS - 1, W - 1, dtype=np.int32)
    return machine, layout, table, W - 1, writer_mask(P, fw), spec.cost


def assert_same(ref, got, ctx):
    for f in EXACT:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).cpu().numpy()
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.astype(np.float32).view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=f"{ctx} {f}")


@pytest.mark.parametrize("fw", FWS)
@pytest.mark.parametrize("jitter", [0.0, None], ids=["jitter0", "default"])
def test_fompi_a_dht_matches_reference(jitter, fw):
    seeds = DHT_SEEDS[:1] if jitter == 0.0 else DHT_SEEDS
    m, lay, table, heap, mask, cost = _setup(
        RefSpec, None if jitter is None else RefCost(jitter=jitter), fw)
    env = ref_engine.make_env(m, lay, is_writer=mask, target_acq=4,
                              cost=cost)
    prog = RefADHT(table, heap, mask)
    ref = [ref_engine.run_sim(prog, env, lay, seed=s,
                              max_events=bench.MAX_EVENTS) for s in seeds]

    m, lay, table, heap, mask, cost = _setup(
        LockSpec, None if jitter is None else CostModel(jitter=jitter), fw)
    env = engine.make_env(m, lay, is_writer=mask, target_acq=4, cost=cost,
                          device="cpu")
    prog = FompiADHT(table, heap, mask)
    for s, want in zip(seeds, ref):
        got = engine.run_sim(prog, env, lay, seed=s,
                             max_events=bench.MAX_EVENTS)
        assert_same(want, got, (jitter, fw, s))
        assert int(got.violations) == 0 and bool(got.completed)


def test_writer_fractions_as_lanes_equal_single_runs():
    """`run_fompi_a` runs the F_W values as lanes of one run (the env's
    "roles" group); each lane equals a fresh single run bit for bit."""
    lanes = bench.run_fompi_a(P, FWS + (0.02,), 4, device="cpu")
    for i, fw in enumerate(FWS + (0.02,)):
        m, lay, table, heap, mask, cost = _setup(LockSpec, None, fw)
        env = engine.make_env(m, lay, is_writer=mask, target_acq=4,
                              device="cpu")
        single = engine.run_sim(FompiADHT(table, heap, mask), env, lay,
                                seed=0, max_events=bench.MAX_EVENTS)
        for name, a, b in zip(single._fields, metrics_at(lanes, i), single):
            assert a.dtype == b.dtype and torch.equal(a, b), (fw, name)


def test_program_refuses_an_env_with_other_roles():
    m, lay, table, heap, mask, _ = _setup(LockSpec, None, 0.20)
    env = engine.make_env(m, lay, is_writer=writer_mask(P, 0.0),
                          device="cpu")
    with pytest.raises(ValueError, match="writer_mask"):
        FompiADHT(table, heap, mask).build(env)


@pytest.mark.parametrize("fw", [0.0, 0.20, 1.0])
def test_meta_matches_reference(fw):
    m, lay, table, heap, mask, _ = _setup(LockSpec, None, fw)
    env = engine.make_env(m, lay, is_writer=mask, device="cpu")
    rm, rlay, *_ = _setup(RefSpec, None, fw)
    want = RefADHT(table, heap, mask).meta(ref_engine.make_env(
        rm, rlay, is_writer=mask))
    prog = FompiADHT(table, heap, mask)
    assert dataclasses.asdict(prog.meta(env)) == dataclasses.asdict(want)
    assert len(prog.build(env).full) == want.n_pcs


def test_bench_dht_rows_match_reference():
    got = bench.bench_dht(ps=(P,), device="cpu")
    assert got == ref_bench.bench_dht(ps=(P,))
    assert [r["F_W"] for r in got] == [0.0, 0.02, 0.05, 0.20]

"""The port's numpy substrate and PRNG against the JAX reference.

Layouts, level tables, counter assignment, roles, spec serialization
and spec validation must equal `repro.core`'s exactly over a lattice of
machines; the threefry PRNG must reproduce `jax.random`'s bits.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import spec as ref_spec  # noqa: E402
from repro.core import topology as ref_topo  # noqa: E402
from repro.core import window as ref_window  # noqa: E402
from repro_torch.core import prng, spec, topology, window  # noqa: E402

# (P, fanout, T_DC, padding): every valid combination of the axes.
LATTICE = [
    (P, fanout, T_DC, pad)
    for P, fanout, T_DC, pad in itertools.product(
        (4, 16, 64), ((1,), (2,), (4,), (2, 2)), (1, 4, 16), (None, 2))
    if P % int(np.prod(fanout)) == 0 and T_DC <= P
]


def _assert_same(a, b, what):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
        assert a.dtype == b.dtype, what
    else:
        assert a == b, what


@pytest.mark.parametrize("P,fanout,T_DC,pad", LATTICE)
def test_layout_tables_match_reference(P, fanout, T_DC, pad):
    m_ref, m = ref_topo.build_machine(P, fanout), topology.build_machine(P, fanout)
    for f in dataclasses.fields(m_ref):
        _assert_same(getattr(m_ref, f.name), getattr(m, f.name), f.name)
    np.testing.assert_array_equal(ref_topo.proc_distance_matrix(m_ref),
                                  topology.proc_distance_matrix(m))
    np.testing.assert_array_equal(ref_topo.counter_of_proc(m_ref, T_DC),
                                  topology.counter_of_proc(m, T_DC))
    C = len(ref_topo.counter_ranks(m_ref, T_DC))
    pad_to = None if pad is None else C + pad
    lay_ref = ref_window.build_layout(m_ref, T_DC, extra_words=4,
                                      pad_counters_to=pad_to)
    lay = window.build_layout(m, T_DC, extra_words=4, pad_counters_to=pad_to)
    for f in dataclasses.fields(lay_ref):
        _assert_same(getattr(lay_ref, f.name), getattr(lay, f.name), f.name)
    for attr in ("next_w", "status_w", "tail_w"):
        np.testing.assert_array_equal(
            ref_window.padded_level_table(lay_ref, attr),
            window.padded_level_table(lay, attr))


def test_pad_counters_below_real_count_raises_same_error():
    m_ref, m = ref_topo.build_machine(16, (2,)), topology.build_machine(16, (2,))
    with pytest.raises(ValueError) as e_ref:
        ref_window.build_layout(m_ref, 1, pad_counters_to=3)
    with pytest.raises(ValueError) as e:
        window.build_layout(m, 1, pad_counters_to=3)
    assert str(e.value) == str(e_ref.value)


@pytest.mark.parametrize("P,wf,seed", [
    (16, 0.25, 17), (64, 0.02, 17), (256, 0.02, 3), (8, 0.0, 17),
    (8, 1.0, 5), (100, 0.5, 0)])
def test_writer_mask_matches_reference(P, wf, seed):
    np.testing.assert_array_equal(ref_spec.writer_mask(P, wf, seed),
                                  spec.writer_mask(P, wf, seed))


SPECS = [
    dict(kind="rma_rw", P=64, fanout=(4,), T_DC=16, T_L=(1 << 20, 8),
         T_R=1024, writer_fraction=0.02),
    dict(kind="rma_mcs", P=16, fanout=(4,), T_L=(64, 4)),
    dict(kind="d_mcs", P=16, T_L=(8,)),
    dict(kind="fompi_spin", P=16, fanout=(4,)),
    dict(kind="fompi_rw", P=64, writer_fraction=0.02, T_L=(3,)),
    dict(kind="rma_rw", P=16, fanout=(2, 2), T_DC=4, T_L=(64, 4, 2)),
]


@pytest.mark.parametrize("kw", SPECS)
def test_spec_json_matches_reference(kw):
    s_ref, s = ref_spec.LockSpec(**kw), spec.LockSpec(**kw)
    assert s.to_json() == s_ref.to_json()
    assert spec.LockSpec.from_json(s.to_json()) == s
    np.testing.assert_array_equal(s.roles(), s_ref.roles())


@pytest.mark.parametrize("kind,P", [("rma_rw", 256), ("rma_mcs", 64),
                                    ("d_mcs", 32), ("fompi_rw", 64)])
def test_paper_default_matches_reference(kind, P):
    assert (spec.LockSpec.paper_default(kind, P).to_json()
            == ref_spec.LockSpec.paper_default(kind, P).to_json())


BAD_SPECS = [
    dict(kind="no_such_lock", P=4),
    dict(kind="rma_mcs", P=0),
    dict(kind="rma_mcs", P=8, fanout=(0,)),
    dict(kind="rma_mcs", P=6, fanout=(4,)),
    dict(kind="rma_rw", P=8, T_DC=0),
    dict(kind="rma_rw", P=8, T_DC=9),
    dict(kind="rma_rw", P=8, T_R=0),
    dict(kind="d_mcs", P=8, T_L=(4, 4)),
    dict(kind="rma_mcs", P=8, fanout=(2,), T_L=(4,)),
    dict(kind="rma_mcs", P=8, fanout=(2,), T_L=(0, 4)),
    dict(kind="rma_rw", P=8, writer_fraction=1.5),
]


@pytest.mark.parametrize("kw", BAD_SPECS)
def test_spec_validation_raises_same_errors(kw):
    with pytest.raises(ValueError) as e_ref:
        ref_spec.LockSpec(**kw)
    with pytest.raises(ValueError) as e:
        spec.LockSpec(**kw)
    assert str(e.value) == str(e_ref.value)


# ------------------------------------------------------------------- PRNG
SEEDS = np.arange(1000, dtype=np.int32)


@pytest.fixture(scope="module")
def jax_keys():
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(SEEDS))
    return keys, jax.vmap(jax.random.split)(keys)


def test_prng_key_and_split_bits_match_jax(jax_keys):
    keys, subkeys = jax_keys
    k = prng.PRNGKey(SEEDS)
    np.testing.assert_array_equal(k.numpy(), np.asarray(keys, np.int64))
    np.testing.assert_array_equal(prng.split(k).numpy(),
                                  np.asarray(subkeys, np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 0.08), (1.0, 4.0), (0.0, 1.0)])
def test_prng_uniform_bits_match_jax(jax_keys, lo, hi):
    _, subkeys = jax_keys
    ref = jax.vmap(lambda key: jax.random.uniform(
        key, (), jnp.float32, lo, hi))(subkeys[:, 1])
    got = prng.uniform(prng.split(prng.PRNGKey(SEEDS))[:, 1], lo, hi)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref).view(np.uint32))


@pytest.mark.parametrize("kw", SPECS + [dict(kind="fompi_rw", P=8,
                                             writer_fraction=0.0),
                                        dict(kind="fompi_rw", P=8,
                                             writer_fraction=1.0)])
def test_program_meta_matches_reference(kw):
    """Each program's declared shape (pc names, CS/done/blocking/dead
    and recovery pcs, segments) equals the reference's."""
    from repro.core import Session as RefSession
    from repro_torch.core import Session
    ref = RefSession(ref_spec.LockSpec(**kw))
    port = Session(spec.LockSpec(**kw), device="cpu")
    want = dataclasses.asdict(ref.program.meta(ref.env))
    assert dataclasses.asdict(port.program.meta(port.env)) == want
    assert len(port.handlers.full) == want["n_pcs"]

"""The port's DHT volume against the JAX reference, on the CPU.

On CPU tensors the kernel wrappers run their plain PyTorch versions;
those must equal the Pallas kernels (run in interpret mode) exactly, as
must the key routing, the routed CAS oracle and `BatchedDHT` started
from a reference state half-filled by the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.dht import BatchedDHT as RefDHT  # noqa: E402
from repro.kernels import dht_probe as ref_probe  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.dht import BatchedDHT, DHTState  # noqa: E402
from repro_torch.kernels import dht_probe, ops, ref  # noqa: E402


def _routed_batch(rng, nb, KB, fill):
    """[nb, KB] distinct positive keys (-1 padded) and values."""
    keys = np.full((nb, KB), -1, np.int32)
    pool = rng.permutation(50_000)[: nb * KB] + 1
    for b in range(nb):
        n = int(rng.rand() * fill * KB)
        keys[b, :n] = pool[b * KB: b * KB + n]
    vals = rng.randint(0, 1 << 20, (nb, KB)).astype(np.int32)
    return keys, vals


@pytest.mark.parametrize("nb,TB,KB,seed", [(2, 32, 8, 0), (4, 64, 48, 1),
                                           (3, 16, 40, 2), (8, 128, 100, 3)])
def test_plain_kernels_match_pallas(nb, TB, KB, seed):
    """Three inserts into one table (inserts, updates of earlier keys,
    overflows), each followed by a lookup of the batch."""
    rng = np.random.RandomState(seed)
    tk = np.full((nb, TB), -1, np.int32)
    tv = tk.copy()
    prev = None
    for _ in range(3):
        keys, vals = _routed_batch(rng, nb, KB, fill=1.0)
        if prev is not None:                  # re-insert earlier keys
            keys[:, : KB // 4] = prev[:, : KB // 4]
        prev = keys
        want = ref_probe.dht_insert(jnp.asarray(tk), jnp.asarray(tv),
                                    jnp.asarray(keys), jnp.asarray(vals),
                                    interpret=True)
        got = dht_probe.dht_insert(torch.from_numpy(tk), torch.from_numpy(tv),
                                   torch.from_numpy(keys),
                                   torch.from_numpy(vals))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        tk, tv = np.array(want[0]), np.array(want[1])
        lwant = ref_probe.dht_lookup(jnp.asarray(tk), jnp.asarray(tv),
                                     jnp.asarray(keys), interpret=True)
        lgot = dht_probe.dht_lookup(torch.from_numpy(tk), torch.from_numpy(tv),
                                    torch.from_numpy(keys))
        for w, g in zip(lwant, lgot):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,nb,TB,KB", [(300, 4, 64, 40), (64, 2, 32, 64),
                                        (1000, 16, 8, 512), (5, 3, 16, 8)])
def test_route_keys_matches_reference(n, nb, TB, KB):
    rng = np.random.RandomState(n)
    keys = (rng.permutation(100_000)[:n] + 1).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)
    want = ref_ops.route_keys(jnp.asarray(keys), jnp.asarray(vals), nb, TB, KB)
    got = ops.route_keys(torch.from_numpy(keys), torch.from_numpy(vals),
                         nb, TB, KB)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_insert_matches_routed_cas_oracle():
    """ops.dht_insert equals the sequential per-block CAS oracle in
    routed arrival order, including bucket-capacity overflow."""
    nb, TB, n = 4, 32, 120
    rng = np.random.RandomState(7)
    keys = torch.from_numpy((rng.permutation(50_000)[:n] + 1).astype(np.int32))
    vals = torch.arange(n, dtype=torch.int32) + 5
    tk = torch.full((nb, TB), -1, dtype=torch.int32)
    tv = tk.clone()
    tk2, tv2, status = ops.dht_insert(tk, tv, keys, vals)
    KB = ops.bucket_capacity(n)
    keys_r, vals_r, idx = ops.route_keys(keys, vals, nb, TB, KB)
    etk, etv = tk.clone(), tv.clone()
    est = torch.full(keys_r.shape, 3, dtype=torch.int32)
    for b in range(nb):
        live = keys_r[b] != -1
        rk, rv, s = ref.dht_insert_ref(etk[b], etv[b], keys_r[b][live],
                                       vals_r[b][live])
        etk[b], etv[b] = rk, rv
        est[b, : int(live.sum())] = s
    flat = torch.where(idx >= 0, est.reshape(-1)[idx.clamp(min=0)], 2)
    assert torch.equal(tk2, etk) and torch.equal(tv2, etv)
    assert torch.equal(status, flat.to(torch.int32))
    lv, lh = dht_probe.dht_lookup(tk2, tv2, keys_r)
    for b in range(nb):
        live = keys_r[b] != -1
        rv, rh = ref.dht_lookup_ref(etk[b], etv[b], keys_r[b][live])
        assert torch.equal(lv[b][live], rv) and torch.equal(lh[b][live], rh)


@pytest.mark.parametrize("heap", [1000, 60])
def test_batched_dht_continues_reference_state(heap):
    """A table half filled by the JAX package, then one more batch (half
    updates, half new keys) through both; heap=60 is smaller than the
    overflow, so the append drops slots while heap_ptr counts them."""
    nb, TB = 4, 64
    rng = np.random.RandomState(heap)
    keys = (rng.permutation(100_000)[:300] + 1).astype(np.int32)
    ref_dht = RefDHT(nb=nb, TB=TB, heap=heap, interpret=True)
    st_ref, _ = ref_dht.insert(ref_dht.init(), jnp.asarray(keys[:150]),
                               jnp.asarray(np.arange(150, dtype=np.int32)))
    dht = BatchedDHT(nb=nb, TB=TB, heap=heap, device="cpu")
    st = DHTState.from_numpy(st_ref, device="cpu")
    k2 = np.concatenate([keys[:75], keys[150:225]])
    v2 = np.arange(1000, 1150, dtype=np.int32)
    st_ref2, s_ref = ref_dht.insert(st_ref, jnp.asarray(k2), jnp.asarray(v2))
    st2, s = dht.insert(st, torch.from_numpy(k2), torch.from_numpy(v2))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    for k, v in st2.to_numpy().items():
        want = np.asarray(getattr(st_ref2, k))
        assert v.shape == want.shape, k
        np.testing.assert_array_equal(v, want, err_msg=k)
    if heap == 60:
        assert int(st2.heap_ptr) > heap
    q = np.concatenate([keys, (rng.permutation(1000)[:40] + 200_001)
                        .astype(np.int32)])
    want = ref_dht.lookup(st_ref2, jnp.asarray(q))
    got = dht.lookup(st2, torch.from_numpy(q))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_heap_lookup_returns_reference_max_with_negative_values():
    """The heap returns the reference's max(matching values, -1 for
    every non-matching entry), also for values below -1."""
    heap_keys = np.array([9, 5, 9, -1, 5, 7], np.int32)
    heap_vals = np.array([3, -7, 11, -1, -9, -4], np.int32)
    state = dict(table_keys=np.full((1, 8), -1, np.int32),
                 table_vals=np.full((1, 8), -1, np.int32),
                 heap_keys=heap_keys, heap_vals=heap_vals,
                 heap_ptr=np.int32(6))
    ref_dht = RefDHT(nb=1, TB=8, heap=6, interpret=True)
    q = np.array([9, 5, 7, 4, -1], np.int32)
    from repro.dht.table import DHTState as RefState
    want = ref_dht.lookup(RefState(*(jnp.asarray(state[k]) for k in
                                     RefState._fields)), jnp.asarray(q))
    dht = BatchedDHT(nb=1, TB=8, heap=6, device="cpu")
    got = dht.lookup(DHTState.from_numpy(state, device="cpu"),
                     torch.from_numpy(q))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_launch_counters_count_only_kernel_launches():
    """CPU tensors take the plain versions, which launch nothing."""
    before = (dht_probe.dht_insert.launches, dht_probe.dht_lookup.launches)
    tk = torch.full((2, 16), -1, dtype=torch.int32)
    keys = torch.tensor([[3, -1], [20, 37]], dtype=torch.int32)
    dht_probe.dht_insert(tk, tk.clone(), keys, keys)
    dht_probe.dht_lookup(tk, tk.clone(), keys)
    assert (dht_probe.dht_insert.launches,
            dht_probe.dht_lookup.launches) == before


def test_wrappers_validate_inputs():
    tk = torch.full((2, 16), -1, dtype=torch.int32)
    keys = torch.tensor([[3, -1], [20, 37]], dtype=torch.int64)
    with pytest.raises(ValueError):
        dht_probe.dht_insert(tk, tk, keys, keys)
    with pytest.raises(ValueError):
        dht_probe.dht_lookup(tk, tk[:1], keys.to(torch.int32))

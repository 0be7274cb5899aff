"""The port's examples (`python -m repro_torch.examples.<name>`) on the
CPU at their sizes: serve_kv serves every request (found through the
request DHT in its slot) while a background swap advances the store's
version, and the quickstart's DHT part gives the reference's counts
(the reference's `BatchedDHT` in interpret mode on the same keys)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dht import BatchedDHT as RefDHT  # noqa: E402
from repro_torch.examples import quickstart, serve_kv  # noqa: E402


def test_serve_kv_serves_every_request_across_a_swap(capsys):
    out = serve_kv.main("cpu")
    assert bool(out["found"].all())
    assert torch.equal(out["slots"], torch.arange(serve_kv.BATCH,
                                                  dtype=torch.int32))
    assert out["version"] == 1
    toks = out["tokens"]
    assert tuple(toks.shape) == (serve_kv.BATCH, serve_kv.DECODE_STEPS)
    assert bool(((toks >= 0) & (toks < out["vocab"])).all())
    assert out["lines"][-1] == (
        f"served {serve_kv.BATCH} requests x {serve_kv.DECODE_STEPS} "
        "tokens; store version now v1 (swapped mid-stream)")
    assert capsys.readouterr().out.splitlines() == out["lines"]


def test_quickstart_dht_demo_matches_reference():
    got = quickstart.dht_demo("cpu")
    dht = RefDHT(nb=8, TB=128, heap=1024, interpret=True)
    keys = np.random.RandomState(0).permutation(10_000)[:200] + 1
    vals = np.arange(200, dtype=np.int32)
    st, status = dht.insert(dht.init(), keys.astype(np.int32), vals)
    out, found = dht.lookup(st, keys.astype(np.int32))
    status = np.asarray(status)
    assert (got["inserted"], got["overflow"]) == (int((status == 0).sum()),
                                                  int((status == 2).sum()))
    assert got["all_found"] == bool(np.all(found)) is True
    assert got["values_ok"] == bool(np.all(np.asarray(out) == vals)) is True
    assert got["lines"] == [
        f"DHT:     inserted={got['inserted']}, overflow={got['overflow']}, "
        "all found=True, values ok=True"]

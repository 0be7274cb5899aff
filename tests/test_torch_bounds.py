"""The byte counts behind `chip_smoke.py`'s bounds, on the CPU:
`dht_lookup_bytes` against a brute force over lanes, on small tables with
padding lanes, misses, several lanes in one 32-byte sector, and lanes in
one slot."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def brute_force(nb, TB, keys, hit):
    """Sectors touched, lane by lane, with Python sets."""
    key_sectors, val_sectors = set(), set()
    for blk in range(nb):
        for lane, key in enumerate(keys[blk]):
            if key == -1:
                continue
            sector = (blk * TB + key % TB) * 4 // 32
            key_sectors.add(sector)
            if hit[blk, lane]:
                val_sectors.add(sector)
    return 32 * (len(key_sectors) + len(val_sectors)) + 9 * keys.size


def lookup_bytes(nb, TB, keys, hit):
    return chip_smoke.dht_lookup_bytes(
        (nb, TB), torch.from_numpy(keys.astype(np.int32)),
        torch.from_numpy(hit))


def test_lookup_bytes_hand_case():
    """Block 0: slots 1 and 5 share sector 0 (both hit), slot 9 is in
    sector 1 (a miss), one padding lane. Block 1 (from flat slot 16):
    two lanes in slot 3, sector 2 (one hits), a hit in slot 15, sector
    3, one padding lane. Keys touch sectors {0, 1, 2, 3}, values
    {0, 2, 3}."""
    nb, TB = 2, 16
    keys = np.array([[1, 21, 9, -1], [3, 19, 15, -1]])
    hit = np.array([[True, True, False, False], [True, False, True, False]])
    want = 32 * (4 + 3) + 9 * 8
    assert lookup_bytes(nb, TB, keys, hit) == want
    assert brute_force(nb, TB, keys, hit) == want


def test_lookup_bytes_one_lane_per_sector_is_the_scalar_count_in_sectors():
    """Lanes 8 slots apart touch a sector each: 32 bytes per valid lane
    and per hit lane, where a 4-byte count would charge 4."""
    nb, TB, KB = 3, 64, 8
    keys = np.tile(np.arange(0, TB, 8), (nb, 1))
    hit = np.zeros((nb, KB), bool)
    hit[:, ::2] = True
    valid, hits = keys.size, int(hit.sum())
    want = 32 * (valid + hits) + 9 * keys.size
    assert lookup_bytes(nb, TB, keys, hit) == want


def test_lookup_bytes_no_valid_lane():
    keys = -np.ones((4, 5), np.int64)
    hit = np.zeros((4, 5), bool)
    assert lookup_bytes(4, 32, keys, hit) == 9 * 20


@pytest.mark.parametrize("seed,nb,TB,KB", [(0, 4, 64, 40), (1, 8, 128, 100),
                                           (2, 2, 1024, 700)])
def test_lookup_bytes_matches_brute_force(seed, nb, TB, KB):
    """Random keys (some padding, some misses, many lanes per sector)."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 1 << 20, (nb, KB))
    keys[rng.rand(nb, KB) < 0.2] = -1
    hit = (rng.rand(nb, KB) < 0.6) & (keys != -1)
    assert lookup_bytes(nb, TB, keys, hit) == brute_force(nb, TB, keys, hit)


@pytest.mark.parametrize("causal,window,dtype,Sq,Skv", [
    (True, None, torch.bfloat16, 96, 96),         # MLA's call: no window
    (True, 40, torch.bfloat16, 96, 96),           # H2O-Danube's window
    (False, None, torch.bfloat16, 64, 80),        # HuBERT: non-causal
    (True, None, torch.float32, 50, 50)])
def test_attention_bound_counts_the_kept_pairs(causal, window, dtype, Sq,
                                               Skv):
    """4 dh operations per (query, key) pair the mask keeps, counted pair
    by pair; bytes: q, k, v read and the output written once."""
    B, H, KV, dh = 2, 4, 2, 24
    q = torch.zeros(B, Sq, H, dh, dtype=dtype)
    k = torch.zeros(B, Skv, KV, dh, dtype=dtype)
    kwargs = {"causal": causal} if window is None else {
        "causal": causal, "window": window}
    _, _, flops, nbytes = chip_smoke.attention_bound(q, k, k, **kwargs)
    kept = sum((not causal or kp <= qp) and (window is None
                                              or kp > qp - window)
               for qp in range(Sq) for kp in range(Skv))
    assert flops == 4 * dh * B * H * kept
    assert nbytes == (2 * q.numel() + 2 * k.numel()) * q.element_size()

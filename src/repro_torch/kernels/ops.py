"""Public DHT wrappers around the kernels: route a key batch to table
blocks, run the kernel, and map the per-lane results back to key order.

Counterpart of `repro.kernels.ops`' `route_keys`, `dht_insert` and
`dht_lookup`, with the same bucket capacity rule KB = min(max(K, 8),
512): a key whose bucket already holds KB keys of the batch is not
routed (idx = -1) and reports overflow (status 2) / a miss.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dht_probe

EMPTY = -1


def bucket_capacity(K: int) -> int:
    return min(max(int(K), 8), 512)


def route_keys(keys, vals, nb: int, TB: int, KB: int):
    """Route keys to table blocks: block = (k // TB) % nb, slot = k % TB.

    Returns (keys_routed [nb, KB], vals_routed [nb, KB], idx [K] position
    of each input key in the routed layout, or -1 if its bucket
    overflowed KB). A key's rank in its bucket is its arrival order; it
    comes from a stable sort on the block id, so memory stays O(K + nb).
    """
    K = keys.shape[0]
    dev = keys.device
    bid = torch.remainder(torch.div(keys, TB, rounding_mode="floor"),
                          nb).long()
    sorted_bid, order = torch.sort(bid, stable=True)
    counts = torch.bincount(bid, minlength=nb)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(K, device=dev) - starts[sorted_bid]
    ok = rank < KB
    flat = torch.where(ok, bid * KB + rank, nb * KB)     # nb*KB = drop slot
    keys_r = torch.full((nb * KB + 1,), EMPTY, dtype=torch.int32, device=dev)
    vals_r = torch.full((nb * KB + 1,), EMPTY, dtype=torch.int32, device=dev)
    keys_r.scatter_(0, flat, keys.to(torch.int32))
    vals_r.scatter_(0, flat, vals.to(torch.int32))
    idx = torch.where(ok, flat, -1)
    return keys_r[:-1].view(nb, KB), vals_r[:-1].view(nb, KB), idx


def _unroute(routed, idx, miss):
    flat = routed.reshape(-1)[idx.clamp(min=0)]
    return torch.where(idx >= 0, flat, miss)


def dht_insert(table_keys, table_vals, keys, vals):
    """Insert a batch of distinct keys into the blocked table.

    table_*: [nb, TB]; keys/vals: [K]. Returns (table_keys',
    table_vals', status [K]) with status 0=insert, 1=update,
    2=overflow (including bucket-capacity overflow)."""
    nb, TB = table_keys.shape
    KB = bucket_capacity(keys.shape[0])
    keys_r, vals_r, idx = route_keys(keys, vals, nb, TB, KB)
    tk, tv, status_r = dht_probe.dht_insert(table_keys, table_vals,
                                            keys_r, vals_r)
    return tk, tv, _unroute(status_r, idx, 2).to(torch.int32)


def dht_lookup(table_keys, table_vals, keys):
    """Look a key batch up in the table. Returns (vals [K], hit [K])."""
    nb, TB = table_keys.shape
    KB = bucket_capacity(keys.shape[0])
    keys_r, _, idx = route_keys(keys, keys, nb, TB, KB)
    vals_r, hit_r = dht_probe.dht_lookup(table_keys, table_vals, keys_r)
    return (_unroute(vals_r, idx, EMPTY).to(torch.int32),
            _unroute(hit_r, idx, False))

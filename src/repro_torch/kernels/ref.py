"""Sequential oracles for the DHT kernels (counterparts of the DHT part
of `repro.kernels.ref`)."""
from __future__ import annotations

import torch

EMPTY = -1


def dht_insert_ref(table_keys, table_vals, keys, vals):
    """Sequential CAS-semantics oracle for the paper's §5.3 insert into
    ONE table block (`table_*` [TB], keys/vals [K]): each key CASes its
    slot in arrival order. Winners (empty slot) write; a key equal to the
    incumbent updates the value; everyone else reports overflow. Returns
    (keys', vals', status) with 0 = inserted, 1 = updated, 2 = overflow."""
    TB = table_keys.shape[0]
    tk, tv = table_keys.clone(), table_vals.clone()
    status = torch.empty(keys.shape, dtype=torch.int32)
    for i, (k, v) in enumerate(zip(keys.tolist(), vals.tolist())):
        slot = k % TB
        cur = int(tk[slot])
        if cur == EMPTY:
            tk[slot], tv[slot], status[i] = k, v, 0
        elif cur == k:
            tv[slot], status[i] = v, 1
        else:
            status[i] = 2
    return tk, tv, status


def dht_lookup_ref(table_keys, table_vals, keys):
    """Oracle lookup in one block: the value at the key's slot if the
    key matches, else EMPTY (the caller then searches the overflow
    heap)."""
    slots = torch.remainder(keys, table_keys.shape[0]).long()
    hit = table_keys[slots] == keys
    return torch.where(hit, table_vals[slots], EMPTY).to(torch.int32), hit

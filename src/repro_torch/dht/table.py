"""Batched hashtable = the paper's "local volume" (fixed-size table +
overflow heap): the table hot path runs through the dht_probe CUDA
kernels, the overflow heap is an append buffer (§5.3: "the losing thread
places the element in the overflow list by atomically incrementing the
next free pointer").

Counterpart of `repro.dht.table`. Two pieces of glue change shape so
that they stay O(K + H) at deployment sizes and give the same answers:
the heap lookup sorts the heap and binary-searches it instead of a dense
[K, H] compare, and the heap append masks slots past the end explicitly
(the reference's scatter drops them while `heap_ptr` still counts them).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops

EMPTY = -1


class DHTState(NamedTuple):
    table_keys: torch.Tensor    # [nb, TB] int32
    table_vals: torch.Tensor    # [nb, TB] int32
    heap_keys: torch.Tensor     # [H] int32
    heap_vals: torch.Tensor     # [H] int32
    heap_ptr: torch.Tensor      # int32 [] next free heap slot

    @classmethod
    def from_numpy(cls, state, device=None) -> "DHTState":
        """A state from numpy arrays of a reference (JAX) `DHTState` — a
        mapping or any object with the five field attributes.
        `device=None` means CUDA."""
        device = resolve_device(device)
        get = (state.__getitem__ if isinstance(state, dict)
               else lambda k: getattr(state, k))
        return cls(*(torch.as_tensor(np.array(get(k), np.int32),
                                     device=device) for k in cls._fields))

    def to_numpy(self) -> dict:
        return {k: v.cpu().numpy() for k, v in self._asdict().items()}


class BatchedDHT:
    """nb table blocks of TB slots plus an overflow heap of `heap`
    entries, on `device` (None means CUDA)."""

    def __init__(self, nb: int = 16, TB: int = 256, heap: int = 4096,
                 device=None):
        self.nb, self.TB, self.heap = nb, TB, heap
        self.device = resolve_device(device)

    def init(self) -> DHTState:
        def full(shape):
            return torch.full(shape, EMPTY, dtype=torch.int32,
                              device=self.device)
        return DHTState(
            table_keys=full((self.nb, self.TB)),
            table_vals=full((self.nb, self.TB)),
            heap_keys=full((self.heap,)), heap_vals=full((self.heap,)),
            heap_ptr=torch.zeros((), dtype=torch.int32, device=self.device))

    def insert(self, st: DHTState, keys, vals
               ) -> Tuple[DHTState, torch.Tensor]:
        """Insert a batch of distinct keys (>0). Returns (state, status):
        0 inserted, 1 updated, 2 went to the overflow heap."""
        tk, tv, status = ops.dht_insert(st.table_keys, st.table_vals,
                                        keys, vals)
        # Overflow path: FAO on the heap pointer -> contiguous slots;
        # slots past the end are dropped, the pointer counts them.
        over = status == 2
        n_over = over.to(torch.int32)
        slot = st.heap_ptr + torch.cumsum(n_over, 0, dtype=torch.int32) - 1
        sink = self.heap
        slot = torch.where(over & (slot < sink), slot, sink).long()
        hk = torch.cat([st.heap_keys, st.heap_keys.new_zeros(1)])
        hv = torch.cat([st.heap_vals, st.heap_vals.new_zeros(1)])
        hk.scatter_(0, slot, keys.to(torch.int32))
        hv.scatter_(0, slot, vals.to(torch.int32))
        new_ptr = st.heap_ptr + n_over.sum(dtype=torch.int32)
        return DHTState(tk, tv, hk[:sink], hv[:sink], new_ptr), status

    def lookup(self, st: DHTState, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (vals, found). Table hit via the kernel; a miss takes
        the largest heap value stored under the key (a re-inserted key's
        latest value, when values grow), as the reference's max over a
        dense [K, H] compare — including its -1 floor from the
        non-matching entries."""
        vals, hit = ops.dht_lookup(st.table_keys, st.table_vals, keys)
        H = st.heap_keys.shape[0]
        keys = keys.to(torch.int32)
        # Heap sorted by (key, value): the last entry equal to a key
        # holds its largest value.
        by_val = torch.argsort(st.heap_vals, stable=True)
        perm = by_val[torch.argsort(st.heap_keys[by_val], stable=True)]
        hk, hv = st.heap_keys[perm], st.heap_vals[perm]
        last = torch.searchsorted(hk, keys, right=True) - 1
        first = torch.searchsorted(hk, keys, right=False)
        at = last.clamp(min=0)
        heap_hit = (last >= 0) & (hk[at] == keys)
        best = hv[at]
        # Non-matching entries contribute EMPTY to the reference's max.
        best = torch.where(last - first + 1 < H,
                           torch.clamp(best, min=EMPTY), best)
        found = hit | heap_hit
        out = torch.where(hit, vals, torch.where(heap_hit, best, EMPTY))
        return out.to(torch.int32), found

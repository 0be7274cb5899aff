"""Blocked hashtable insert/lookup for the §5.3 DHT volume: hand-written
CUDA kernels for Hopper plus their plain PyTorch versions.

Replaces the Pallas TPU kernels of `repro.kernels.dht_probe`
(`_insert_kernel` via `dht_insert`, `_lookup_kernel` via `dht_lookup`).
The kernels live in `csrc/dht_probe.cu`, are built with nvcc for
sm_90a at first use and called through ctypes on PyTorch's current
stream. What bounds them is bytes moved (a table-block copy plus a
gather/scatter of one word per lane); the insert resolves slot conflicts
with a shared-memory `atomicMin` of the lane index instead of the TPU
kernel's dense one-hot contractions (see the source's header).

Semantics, for DISTINCT keys within a batch (the caller's contract; the
TPU kernel sums the values of duplicate updating lanes, which nothing
here reproduces): table_* are [nb, TB] int32, keys/vals [nb, KB] int32
already routed to blocks, -1 = empty slot / padding lane, slot = key mod
TB. Per lane: status 3 padding; 1 update (the incumbent equals the
key); 0 insert (the slot is empty and no earlier valid lane of the block
has the same slot); else 2 overflow. Inserts write key and value,
updates the value.

Each wrapper takes its plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. `dht_insert.launches` and
`dht_lookup.launches` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

EMPTY = -1


def _check(name, tensors, ndim=2):
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() != ndim:
            raise ValueError(f"{name}: expected {ndim}-D int32 tensors, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _slots(keys: torch.Tensor, TB: int):
    """(valid lanes, flat slot index into the [nb * TB] table)."""
    nb = keys.shape[0]
    valid = keys != EMPTY
    slot = torch.where(valid, torch.remainder(keys, TB), 0).long()
    base = torch.arange(nb, device=keys.device)[:, None] * TB
    return valid, base + slot


def dht_insert_plain(table_keys, table_vals, keys, vals):
    """Plain PyTorch insert: the winner per slot is the lowest valid lane
    (`scatter_reduce` "amin"); memory stays O(nb * (TB + KB))."""
    nb, TB = table_keys.shape
    KB = keys.shape[1]
    valid, flat = _slots(keys, TB)
    lane = torch.arange(KB, device=keys.device).expand(nb, KB)
    win = torch.full((nb * TB,), KB, dtype=torch.int64, device=keys.device)
    win.scatter_reduce_(0, flat.reshape(-1),
                        torch.where(valid, lane, KB).reshape(-1), "amin")
    inc = table_keys.reshape(-1)[flat]
    occupied = inc != EMPTY
    update = valid & occupied & (inc == keys)
    insert = valid & ~occupied & (win[flat] == lane)
    status = torch.where(~valid, 3, torch.where(
        insert, 0, torch.where(update, 1, 2))).to(torch.int32)
    sink = nb * TB              # writes of other lanes land here, then go
    tk = torch.cat([table_keys.reshape(-1), table_keys.new_zeros(1)])
    tv = torch.cat([table_vals.reshape(-1), table_vals.new_zeros(1)])
    tk.scatter_(0, torch.where(insert, flat, sink).reshape(-1),
                keys.reshape(-1))
    tv.scatter_(0, torch.where(insert | update, flat, sink).reshape(-1),
                vals.reshape(-1))
    return tk[:sink].view(nb, TB), tv[:sink].view(nb, TB), status


def dht_lookup_plain(table_keys, table_vals, keys):
    """Plain PyTorch lookup: hit iff the key's slot holds the key."""
    TB = table_keys.shape[1]
    valid, flat = _slots(keys, TB)
    hit = valid & (table_keys.reshape(-1)[flat] == keys)
    vals = torch.where(hit, table_vals.reshape(-1)[flat], EMPTY)
    return vals.to(torch.int32), hit


def _lib():
    lib = build.load("dht_probe")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dht_insert_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        lib.dht_insert_launch.restype = i
        lib.dht_lookup_launch.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.dht_lookup_launch.restype = i
        lib._argtypes_set = True
    return lib


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def dht_insert(table_keys, table_vals, keys, vals):
    """Blocked insert. Returns (table_keys', table_vals', status
    [nb, KB]); the inputs are not modified."""
    dev = _check("dht_insert", (table_keys, table_vals, keys, vals))
    nb, TB = table_keys.shape
    KB = keys.shape[1]
    if (table_vals.shape != table_keys.shape or keys.shape[0] != nb
            or vals.shape != keys.shape):
        raise ValueError("dht_insert: shape mismatch")
    if dev.type == "cpu":
        return dht_insert_plain(table_keys, table_vals, keys, vals)
    tk = torch.empty_like(table_keys)
    tv = torch.empty_like(table_vals)
    status = torch.empty_like(keys)
    with torch.cuda.device(dev):
        err = _lib().dht_insert_launch(
            table_keys.data_ptr(), table_vals.data_ptr(), keys.data_ptr(),
            vals.data_ptr(), tk.data_ptr(), tv.data_ptr(), status.data_ptr(),
            nb, TB, KB, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "dht_insert")
    dht_insert.launches += 1
    return tk, tv, status


def dht_lookup(table_keys, table_vals, keys):
    """Blocked lookup. Returns (vals [nb, KB] int32, hit [nb, KB] bool)."""
    dev = _check("dht_lookup", (table_keys, table_vals, keys))
    nb, TB = table_keys.shape
    KB = keys.shape[1]
    if table_vals.shape != table_keys.shape or keys.shape[0] != nb:
        raise ValueError("dht_lookup: shape mismatch")
    if dev.type == "cpu":
        return dht_lookup_plain(table_keys, table_vals, keys)
    vals = torch.empty_like(keys)
    hit = torch.empty(keys.shape, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _lib().dht_lookup_launch(
            table_keys.data_ptr(), table_vals.data_ptr(), keys.data_ptr(),
            vals.data_ptr(), hit.data_ptr(), nb, TB, KB,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "dht_lookup")
    dht_lookup.launches += 1
    return vals, hit


dht_insert.launches = 0
dht_lookup.launches = 0

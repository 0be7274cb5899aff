"""Checkpoint save/restore (counterpart of `repro.checkpoint.ckpt`).

Format, the reference's: one directory per step, `step_<n>/arrays.npz`
+ `manifest.json` (step, treedef, keys, dtypes, user metadata), written
to a `.tmp_` directory and committed by `os.rename`, so a crash
mid-write never corrupts the latest checkpoint. Keys are `/`-joined
paths through the state: dict keys, NamedTuple fields, list indices and
a module's parameter names (`params/blocks/0/attn/wq`,
`opt/m/blocks/0/attn/wq`, `step`). Tensors are stored whole, in host
memory order.

`AsyncCheckpointer` keeps serialization off the training loop: `submit`
blocks only on the device-to-host copy, a background thread writes.

On a mesh (a state of DTensors) the format stays the same: every rank
gathers each leaf's `full_tensor()` (a collective, so every rank saves
the same tree in the same order), only global rank 0 writes and
commits, and the others wait at a barrier until it has. So a checkpoint
saved on a mesh restores on one device and the other way round.
`load_checkpoint(sharding_tree=)` places each leaf onto its mesh from
the checkpoint's whole array (`distribute_tensor`, every rank taking
its own shard: no collective), as the reference's `jax.device_put`;
`parallel.sharding.state_placements` gives such a tree for a train
state.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import tempfile
import threading
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.parallel.spmd import is_dtensor


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in order; leaves are tensors (a module's parameters
    too), numpy arrays or Python scalars."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield join(name.replace(".", "/")), p
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), join(name))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, join(str(k).replace(".", "/")))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, join(str(i)))
    else:
        yield prefix, tree


def _treedef(tree) -> str:
    """The structure, leaves as `*` (informative; load reads `like`)."""
    if isinstance(tree, nn.Module):
        return f"{type(tree).__name__}[{len(list(tree.parameters()))} *]"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_treedef(getattr(tree, f))}" for f in tree._fields) + ")"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(v)}"
                               for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "*"


def _distributed(tree) -> bool:
    """Whether any leaf of `tree` is a DTensor."""
    return any(is_dtensor(leaf) for _, leaf in _leaves(tree))


def _barrier(distributed: bool):
    """Every rank waits for global rank 0's write (on a mesh)."""
    if distributed:
        torch.distributed.barrier()


@torch.no_grad()
def _to_host(tree, distributed: bool
             ) -> Tuple[Optional[Dict[str, np.ndarray]], str]:
    """(key -> numpy copy, treedef): the device-to-host copy. A DTensor
    leaf is gathered whole on every rank; on a mesh only global rank 0
    keeps the copies (the others get None)."""
    keep = not distributed or torch.distributed.get_rank() == 0
    flat = {}
    for key, leaf in _leaves(tree):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        if keep:
            flat[key] = (leaf.detach().to("cpu", copy=True).numpy()
                         if isinstance(leaf, torch.Tensor)
                         else np.array(leaf))
    return (flat if keep else None), _treedef(tree)


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
           treedef: str, meta: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": int(step),
            "treedef": treedef,
            "keys": sorted(flat.keys()),
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                   # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    meta: Optional[dict] = None) -> str:
    """Writes `tree` as `step_<step>` under ckpt_dir; returns its path.
    On a mesh every rank calls it, rank 0 writes, and every rank
    returns once the checkpoint is committed."""
    distributed = _distributed(tree)
    flat, treedef = _to_host(tree, distributed)
    if flat is None:
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
    else:
        path = _write(ckpt_dir, step, flat, treedef, meta)
    _barrier(distributed)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _place(t: torch.Tensor, spec) -> torch.Tensor:
    """t (whole, on any device) as a DTensor under spec = (mesh,
    placements): every rank takes its own shard, no collective."""
    from torch.distributed.tensor import distribute_tensor
    mesh, placements = spec
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _shape(leaf):
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.shape(leaf)


def _restore(node, value, shard=None, prefix: str = ""):
    """`node` with every leaf replaced by value(key, leaf) (a tensor):
    as a new tensor on the leaf's device, a module's parameters
    overwritten in place (the module is returned); with `shard` (a tree
    of (mesh, placements) in node's structure, a module's node a dict by
    parameter name) every leaf is a DTensor placed by it instead, a
    module's parameters replaced by DTensor parameters."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(node, nn.Module):
        with torch.no_grad():
            for name, p in list(node.named_parameters()):
                new = value(join(name.replace(".", "/")), p)
                if shard is None:
                    p.copy_(new)
                    continue
                owner, _, leaf = name.rpartition(".")
                mod = node.get_submodule(owner) if owner else node
                setattr(mod, leaf, nn.Parameter(
                    _place(new, shard[name]), requires_grad=p.requires_grad))
        return node
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_restore(
            getattr(node, f), value,
            None if shard is None else getattr(shard, f), join(f))
            for f in node._fields))
    if isinstance(node, dict):
        return {k: _restore(v, value, None if shard is None else shard[k],
                            join(str(k).replace(".", "/")))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_restore(v, value,
                                   None if shard is None else shard[i],
                                   join(str(i)))
                          for i, v in enumerate(node))
    new = value(prefix, node)
    if shard is not None:
        return _place(new, shard)
    if isinstance(node, torch.Tensor):
        return new.to(node.device)
    return new.numpy()


class _Arrays:
    """The arrays of an `arrays.npz` by key, each read in one sequential
    read from its offset in the file (np.savez stores members
    uncompressed; `np.load`'s zip stream reads in small chunks and
    checksums them, ~2.5x slower); another member goes through
    `np.load`."""

    def __init__(self, path: str):
        self._npz = np.load(path)
        self._file = open(path, "rb")
        self._where = {}
        for info in self._npz.zip.infolist():
            if info.compress_type == zipfile.ZIP_STORED:
                self._where[info.filename[:-4]] = info.header_offset

    def __getitem__(self, key: str) -> np.ndarray:
        if key not in self._where:
            return self._npz[key]
        f = self._file
        f.seek(self._where[key])
        head = f.read(30)                       # the local file header
        f.seek(int.from_bytes(head[26:28], "little")
               + int.from_bytes(head[28:30], "little"), os.SEEK_CUR)
        major, _ = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if major == 1
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        if dtype.hasobject:
            return self._npz[key]
        arr = np.fromfile(f, dtype=dtype, count=int(np.prod(shape)))
        return (arr.reshape(shape[::-1]).T if fortran
                else arr.reshape(shape))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._file.close()
        self._npz.close()


def _array(data, key: str, shape) -> torch.Tensor:
    arr = data[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"checkpoint/model shape mismatch at {key}: "
                         f"{arr.shape} vs {tuple(shape)}")
    return torch.from_numpy(arr)


def load_checkpoint(ckpt_dir: str, step: int, like: Any,
                    sharding_tree: Any = None) -> Tuple[Any, dict]:
    """Restore into the structure of `like` (its tensors' devices; a
    module in it is restored in place). Returns (tree, manifest).

    With `sharding_tree` (a (DeviceMesh, placements) pair per leaf in
    like's structure, e.g. `parallel.sharding.state_placements(like,
    mesh)`) every leaf is restored as a DTensor from the checkpoint's
    whole array (the elastic restore onto any mesh); `like` only gives
    the structure and shapes (meta tensors will do)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with _Arrays(os.path.join(path, "arrays.npz")) as data:
        return _restore(like, lambda key, leaf: _array(data, key,
                                                       _shape(leaf)),
                        sharding_tree), manifest


def place_state(state: Any, sharding_tree: Any) -> Any:
    """`state` with every leaf distributed onto its mesh by
    `sharding_tree` (as `load_checkpoint` places a restored one): each
    rank keeps its own shard of its whole copy; a module's parameters
    are replaced in place."""
    return _restore(state, lambda key, leaf: torch.as_tensor(leaf).detach(),
                    sharding_tree)


class AsyncCheckpointer:
    """Background checkpoint writer (one in flight at a time)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._done = threading.Event()
        self._distributed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._done.set()
                return
            step, flat, treedef, meta = item
            try:
                _write(self.ckpt_dir, step, flat, treedef, meta)
            except BaseException as e:        # surfaced on next submit/close
                self._err = e

    def submit(self, step: int, tree: Any, meta: Optional[dict] = None):
        """Copies `tree` to the host (the only sync point; on a mesh a
        gather on every rank) and queues its write (rank 0's only)."""
        if self._err:
            raise self._err
        distributed = _distributed(tree)
        self._distributed |= distributed
        flat, treedef = _to_host(tree, distributed)
        if flat is not None:
            self._q.put((int(step), flat, treedef, meta))

    def close(self):
        """Waits for the writes; on a mesh every rank returns once rank
        0's are committed."""
        self._q.put(None)
        self._done.wait(timeout=60)
        _barrier(self._distributed)
        if self._err:
            raise self._err

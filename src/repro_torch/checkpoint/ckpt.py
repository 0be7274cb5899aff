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

Restoring onto another device layout (the reference's `sharding_tree`)
waits for training on a mesh of cards (ROADMAP.md queue 1 item 7e; the
per-layer placements are `parallel.sharding.layer_placements`).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn


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


def _to_host(tree) -> Tuple[Dict[str, np.ndarray], str]:
    """(key -> numpy copy, treedef): the device-to-host copy."""
    flat = {}
    for key, leaf in _leaves(tree):
        flat[key] = (leaf.detach().to("cpu", copy=True).numpy()
                     if isinstance(leaf, torch.Tensor) else np.array(leaf))
    return flat, _treedef(tree)


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
    return _write(ckpt_dir, step, *_to_host(tree), meta)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _restore(node, data, prefix: str = ""):
    """`node` with every leaf replaced by the checkpoint's array under
    its key: tensors as new tensors on the leaf's device, a module's
    parameters overwritten in place (the module is returned)."""
    if isinstance(node, nn.Module):
        with torch.no_grad():
            for key, p in _leaves(node, prefix):
                p.copy_(_array(data, key, p.shape))
        return node
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_restore(getattr(node, f), data, join(f))
                            for f in node._fields))
    if isinstance(node, dict):
        return {k: _restore(v, data, join(str(k).replace(".", "/")))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_restore(v, data, join(str(i)))
                          for i, v in enumerate(node))
    arr = _array(data, prefix, np.shape(node))
    if isinstance(node, torch.Tensor):
        return arr.to(node.device)
    return arr.numpy()


def _array(data, key: str, shape) -> torch.Tensor:
    arr = data[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"checkpoint/model shape mismatch at {key}: "
                         f"{arr.shape} vs {tuple(shape)}")
    return torch.from_numpy(arr)


def load_checkpoint(ckpt_dir: str, step: int, like: Any,
                    sharding_tree: Any = None) -> Tuple[Any, dict]:
    """Restore into the structure of `like` (its tensors' devices; a
    module in it is restored in place). Returns (tree, manifest)."""
    if sharding_tree is not None:
        raise NotImplementedError(
            "load_checkpoint: restoring onto a sharded layout needs "
            "training on a mesh of cards (ROADMAP.md queue 1 item 7e)")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return _restore(like, data), manifest


class AsyncCheckpointer:
    """Background checkpoint writer (one in flight at a time)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._done = threading.Event()
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
        if self._err:
            raise self._err
        flat, treedef = _to_host(tree)         # the only sync point
        self._q.put((int(step), flat, treedef, meta))

    def close(self):
        self._q.put(None)
        self._done.wait(timeout=60)
        if self._err:
            raise self._err

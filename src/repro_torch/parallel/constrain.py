"""Logical activation-sharding constraints (counterpart of
`repro.parallel.constrain`).

Model code annotates activations with logical axes ("dp", "tp", "sp");
a launcher maps them to mesh axes with `logical_axis_rules` and so turns
the constraints on. Without a mapping (tests, one-device runs, serving)
`constrain` returns its input, so model code never depends on a mesh.
With a mapping, a DTensor is redistributed to the spec's placements on
its own mesh; a plain tensor (no mesh to place it on) passes through
unchanged. The mapping is per thread.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def _mapping():
    return getattr(_state, "mapping", None)


@contextlib.contextmanager
def logical_axis_rules(mapping):
    """mapping: dict logical name -> mesh axis (str, tuple, or None)."""
    prev = _mapping()
    _state.mapping = dict(mapping)
    try:
        yield
    finally:
        _state.mapping = prev


def constrain(x, *logical_axes):
    """x with one logical axis (or a mesh axis, a tuple, or None) per
    dim: unchanged without a mapping or for a plain tensor; a DTensor
    redistributed to the mapped spec's placements."""
    m = _mapping()
    if m is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.parallel.sharding import _placements
    spec = tuple(m.get(a) if isinstance(a, str) else a for a in logical_axes)
    return x.redistribute(x.device_mesh,
                          _placements(spec, x.device_mesh, "constrain"))


# Standard rule sets.
def rules_single_pod():
    return {"dp": "data", "tp": "model", "sp": "data"}


def rules_multi_pod():
    return {"dp": ("pod", "data"), "tp": "model", "sp": ("pod", "data")}

"""Device meshes (counterpart of `repro.launch.mesh`).

Single pod: (data=16, model=16), 256 ranks. Multi-pod: (pod=2, data=16,
model=16), 512 ranks; the 'pod' axis is the slow inter-pod dimension,
where `parallel.hierarchical` spends its T_pod budget. Functions, not
module constants: importing this module touches no process group.

The meshes are `torch.distributed.device_mesh.DeviceMesh`es of the
current world (`init_device_mesh` starts the default process group from
the environment if none is up), on CUDA unless another device type is
asked for.
"""
from __future__ import annotations

import os

import numpy as np


def _world_size() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _mesh(shape, axes, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    world = _world_size()
    if world != int(np.prod(shape)):
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs "
                         f"{int(np.prod(shape))} ranks; the world size is "
                         f"{world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: 256 ranks as (data, model), or with
    multi_pod 512 as (pod, data, model). Raises a ValueError naming the
    world size when it is another."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A small (data, model) mesh over a world of data x model ranks
    (tests, examples)."""
    return _mesh((data, model), ("data", "model"), device_type)


def make_batch_mesh(devices=None):
    """The devices the lock substrate's exploration batch splits over
    (`Session.grid/sweep/run_batch(devices=)`): every CUDA device, or
    N, or an explicit sequence. The port splits such a batch into one
    chunk per device without a process group or a mesh
    (`core.session.resolve_devices`), so this returns that device list."""
    import torch

    from repro_torch.core.session import resolve_devices
    if devices is None:
        devices = torch.cuda.device_count()
    if not devices:
        raise ValueError("make_batch_mesh needs at least one device")
    return list(resolve_devices(devices))

"""Mesh definitions (the port of `repro.launch.mesh` on `DeviceMesh`).

Both are functions: building a mesh needs the default process group,
which the caller initializes (`torch.distributed.init_process_group`
with its address, world size and rank); importing this module touches
no device and no process group.
"""

from __future__ import annotations

from typing import Tuple


def _mesh(device_type: str, shape: Tuple[int, ...],
          names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) data×model on one pod (256 devices) or (2, 16, 16)
    pod×data×model across two pods (512).  Raises `ValueError` naming
    the world size it needs where the process group has another."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} {names} needs a "
                         f"world of {need} ranks; this process group has "
                         f"{world}")
    return _mesh(device_type, shape, names)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda"):
    """A small (data, model) mesh for tests and the smoke run; the
    process group's world size must be data × model."""
    return _mesh(device_type, (data, model), ("data", "model"))

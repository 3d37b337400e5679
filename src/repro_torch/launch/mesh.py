"""LM meshes: the world's ranks laid out on named axes.

Counterpart of ``repro/launch/mesh.py``.  There a mesh reshapes
``jax.devices()``; here it lays the ranks of the initialised
``torch.distributed`` world (one rank a device) onto a
``torch.distributed.device_mesh.DeviceMesh`` with named dims.  With no
process group initialised the world is this one process, and the mesh is a
:class:`~repro_torch.distributed.sharding.HostMesh` whose axes are all of
size 1.  Nothing here runs at import.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed.sharding import HostMesh
from repro_torch.kernels.backend import resolve_device


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if _initialised() else 1


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], dev):
    if not _initialised():
        return HostMesh(axes)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 = 256 ranks ("data", "model"); 2 pods (512) when multi_pod."""
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} devices, have {have}; launch {n} ranks and initialise "
            "torch.distributed (init_process_group) before building the mesh"
        )
    if have != n:
        raise RuntimeError(f"need exactly {n} ranks for this mesh, have {have}")
    return _mesh(shape, axes, dev)


def make_host_mesh(model: int = 1, *, device="cuda"):
    """Mesh over the world's ranks as ("data", "model"): ``world // model``
    data-parallel rows of ``model`` ranks.  Raises without a GPU unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    n = world_size()
    if model < 1 or n % model:
        raise ValueError(f"make_host_mesh: model={model} does not divide {n} rank(s)")
    return _mesh((n // model, model), ("data", "model"), dev)

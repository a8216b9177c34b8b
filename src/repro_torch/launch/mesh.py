"""Device grids and production meshes under the reference's names.

Two different things share the reference's module:

* ``make_dispatch_mesh`` and ``make_host_mesh`` give a ``core.grid.
  DeviceGrid``, a plain ``("data", "model")`` dataclass of
  ``torch.device``s: one process placing query blocks on several devices
  (``core.mesh_dispatch.MeshDispatcher``).
* ``make_production_mesh`` and ``make_mesh`` give a ``torch.distributed``
  ``DeviceMesh`` over the ranks of a process group: SPMD ranks, one a
  card, running one model whose tensors are ``DTensor``s placed by
  ``repro_torch.sharding`` (the reference's ``jax.make_mesh``).

A mesh needs a process group, which :func:`init_ranks` starts from the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) or a caller starts itself. There is no
fallback: a world that is not the mesh's size, a group that was never
started, or a backend this PyTorch lacks each raise.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch

from .. import _device
from ..core.grid import (AXES, DeviceGrid, canonical, make_dispatch_mesh,
                         make_host_mesh)

__all__ = ["AXES", "DeviceGrid", "canonical", "make_dispatch_mesh",
           "make_host_mesh", "init_ranks", "make_mesh",
           "make_production_mesh"]

#: the backend a device type's ranks talk over
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_ranks(backend: Optional[str] = None, device=None) -> torch.device:
    """Start the default process group from the environment (unless one is
    started) -> this rank's device: ``device``, by default
    ``cuda:LOCAL_RANK``, made current. ``backend`` defaults to NCCL for a
    card and gloo for the CPU; a backend this PyTorch lacks raises."""
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("this PyTorch has no torch.distributed")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = _device.resolve(device)
    backend = backend or BACKENDS.get(dev.type)
    if backend is None:
        raise ValueError(f"no default backend for device {dev}")
    if not dist.is_backend_available(backend):
        raise RuntimeError(f"this PyTorch has no {backend} backend")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        # NCCL binds the group to this rank's card, so its barriers and
        # communicators need not guess a device from the rank number
        dist.init_process_group(
            backend, device_id=dev if dev.type == "cuda" else None)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"not {backend}")
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group's ranks, row-major (the reference's elastic
    ``make_mesh``). Raises, as ``jax.make_mesh`` does, unless the world
    is the product of ``shape``; raises if no group was started."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call init_ranks() (or "
                           "torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh: ``("data", "model")`` of 16 x 16
    ranks, or ``("pod", "data", "model")`` of 2 x 16 x 16."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"),
                         device_type=device_type)
    return make_mesh((16, 16), ("data", "model"), device_type=device_type)

"""Device grids for the device-resident query dispatcher.

A ``("data", "model")`` grid of ``torch.device``s, a plain dataclass
rather than ``torch.distributed``'s ``DeviceMesh``, since one process
drives every device and there is no process group.
``core.mesh_dispatch.MeshDispatcher`` places tuple shards over ``data``
and groups of clouds over ``model``; ``launch.mesh`` gives the constructors
the reference's names.

A grid slot is a position, not a device: a grid may name one device in
several slots (``cuda:0`` four times is a 2 × 2 grid on one card), and
the dispatcher keeps its record of copies by slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import _device

AXES = ("data", "model")


def canonical(device) -> torch.device:
    """A device as the grid stores it: ``"cuda"`` becomes the current CUDA
    device with its index; anything else as ``_device.resolve`` makes it."""
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """``rows[r][g]``: the device of data row ``r``, model column ``g``."""
    rows: Tuple[Tuple[torch.device, ...], ...]

    def __post_init__(self):
        if not self.rows or not self.rows[0]:
            raise ValueError("a device grid needs at least one device")
        if len({len(r) for r in self.rows}) != 1:
            raise ValueError("every data row of a grid holds the same "
                             "number of model slots")

    @property
    def axis_names(self) -> Tuple[str, str]:
        return AXES

    @property
    def n_data(self) -> int:
        return len(self.rows)

    @property
    def n_model(self) -> int:
        return len(self.rows[0])

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def devices(self) -> List[torch.device]:
        """Every slot's device, row by row."""
        return [d for row in self.rows for d in row]

    def device(self, r: int, g: int) -> torch.device:
        return self.rows[r][g]


def make_dispatch_mesh(n_model: int = 1, *,
                       devices: Optional[Sequence] = None) -> DeviceGrid:
    """``devices`` (default: every visible CUDA device; raises without
    one) as a ``("data", "model")`` grid, filled row by row: tuple shards
    spread over ``data``, groups of the c clouds over ``model``.
    ``n_model`` must divide the device count; the default keeps every
    device on the data axis."""
    if devices is None:
        _device.resolve(None)                   # raises without a GPU
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [canonical(d) for d in devices]
    if n_model < 1 or len(devs) % n_model != 0:
        raise ValueError(f"n_model={n_model} does not divide the "
                         f"{len(devs)}-device platform")
    return DeviceGrid(tuple(tuple(devs[r * n_model:(r + 1) * n_model])
                            for r in range(len(devs) // n_model)))


def make_host_mesh(device=None) -> DeviceGrid:
    """A one-slot grid: ``device`` (default the current CUDA device)."""
    return DeviceGrid(((canonical(device),),))

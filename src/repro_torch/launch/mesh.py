"""Device grids under the reference's names.

The port's counterpart of ``repro.launch.mesh``'s ``make_dispatch_mesh``
and ``make_host_mesh``; the grid itself is ``core.grid.DeviceGrid``, a
plain ``("data", "model")`` dataclass of ``torch.device``s.
"""
from ..core.grid import (AXES, DeviceGrid, canonical, make_dispatch_mesh,
                         make_host_mesh)

__all__ = ["AXES", "DeviceGrid", "canonical", "make_dispatch_mesh",
           "make_host_mesh"]

"""Placement rules of secret-shared relations on a device grid.

The port's counterpart of ``repro.sharding.share_spec``; the reference's
model-parameter rules (``param_specs``, ``batch_spec``, ``cache_spec``,
``logits_spec``) have no counterpart yet.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

if TYPE_CHECKING:
    from .core.grid import DeviceGrid


def share_spec(grid: "DeviceGrid", shape: Tuple[int, ...]
               ) -> Tuple[Optional[str], ...]:
    """Placement of a raw share array ``(c, n, ...)`` of an outsourced
    relation, one entry per leading axis as a ``PartitionSpec`` has them.

    The cloud axis (the c Shamir shares, the paper's non-communicating
    clouds) splits over ``"model"`` into equal groups; the tuple axis
    splits over ``"data"``. An axis that the grid's axis does not divide
    stays whole (``None``): placement is layout and never constrains a
    relation's size or its share count. Trailing word and bit axes stay
    whole, inside one cloud's slice of one tuple.
    ``core.mesh_dispatch.MeshDispatcher`` splits the clouds as this says;
    its tuple shards follow the plane's shard boundaries, shard ``i`` on
    data row ``i % n_data``, whether or not the rows divide n.
    """
    c_ax = "model" if shape[0] % grid.n_model == 0 else None
    if len(shape) <= 1:
        return (c_ax,)
    return (c_ax, "data" if shape[1] % grid.n_data == 0 else None)

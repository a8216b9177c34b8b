"""Device-resident dispatcher: a plane's cloud steps on a list of devices.

The host dispatchers of :mod:`repro_torch.core.dataplane` (serial, thread
pool, MapReduce) run one thunk per shard and count every shard partial as
staged through the combine. :class:`MeshDispatcher` runs the same
:class:`~repro_torch.core.dataplane.DispatchSet` seam device-resident, as
the reference's ``repro.core.mesh_dispatch.MeshDispatcher`` does on a JAX
mesh:

* **Placement** — on first contact with a plane (``bind_plane``, called by
  ``QueryClient.attach`` and lazily from ``run_set``) each shard's tuple
  block is placed on its device, shard ``i`` on ``devices[i % len]``. A
  torch tensor cannot span devices as a JAX sharded array does, so the
  blocks follow the plane's shard boundaries. The placed bytes are charged
  to that plane's next ``DispatchStats.record``; after that every step
  records zero transfer bytes (the residency invariant). A block already
  on its device is not copied, but is charged as placed, as the
  reference charges its ``device_put``.
* **Reduce on the first device** — a ``"sum"`` step's per-shard mod-p
  partials are stacked on ``devices[0]`` and folded in int64 with ONE
  final ``% p``. F_p addition is exact, so the result is bit-identical to
  the serial chain of ``field.add`` for every shard count S. ``"concat"``
  and ``"list"`` steps combine as on the host dispatchers, on the device.
* **No host round trip** — nothing in ``run_set`` copies to the host or
  synchronizes; ``strict_transfers=True`` proves it on CUDA by running
  every cloud step under ``torch.cuda.set_sync_debug_mode("error")``
  (the analog of ``jax.transfer_guard``; it does nothing on the CPU).
* **Predicted cost** — :meth:`predicted_cost` counts every distinct
  reduction from its shapes: additions, bytes read and written, bytes
  copied between devices. There is no HLO to analyse, so the reference's
  ``hlo_texts`` has no counterpart.

Every entry of ``devices`` must be ONE device for now, and the default is
the current CUDA device: a shard's dispatch combines its block with query
operands made on the client's device, and those do not follow a block to
another device yet (``ROADMAP.md``, Queue 1). A list of distinct devices
is refused when the dispatcher is made. ``devices=["cpu", "cpu"]``
exercises the per-shard placement and the stacked reduce on one device.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import _device
from . import field
from .dataplane import Dispatcher, DispatchSet, ShardedRelation, _nbytes
from .engine import SecretSharedDB
from .shamir import Shares


def _canonical(device) -> torch.device:
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class MeshDispatcher(Dispatcher):
    """Run a plane's cloud steps device-resident on ``devices``.

    Parameters
    ----------
    devices:
        The devices shards are placed on, shard ``i`` on
        ``devices[i % len(devices)]``; ``None`` means the current CUDA
        device (and raises without one). Distinct devices raise
        ``NotImplementedError`` until query operands follow their shard.
    strict_transfers:
        Run every cloud step under ``torch.cuda.set_sync_debug_mode(
        "error")`` on CUDA, so a step that copies to the host or waits on
        the device raises. Explicit placement by ``bind_plane`` is exempt.
    """

    def __init__(self, devices: Optional[Sequence] = None, *,
                 strict_transfers: bool = False):
        if devices is None:
            devices = [None]                    # current GPU; raises without
        self.devices: List[torch.device] = [_canonical(d) for d in devices]
        if not self.devices:
            raise ValueError("MeshDispatcher needs at least one device")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                f"shards on {sorted(map(str, set(self.devices)))}: a shard's "
                f"query operands do not follow its block to another device "
                f"yet (ROADMAP.md, Queue 1)")
        self.strict_transfers = strict_transfers
        self._lock = threading.Lock()
        self._reductions: Dict[Tuple, Dict[str, int]] = {}

    # -- placement ----------------------------------------------------------
    def shard_devices(self, plane: ShardedRelation) -> List[torch.device]:
        """The device each of the plane's shards is placed on."""
        return [self.devices[sh.index % len(self.devices)]
                for sh in plane.shards]

    def bind_plane(self, plane: ShardedRelation) -> None:
        """Place the plane's share blocks on their devices, once.

        Idempotent per (plane, dispatcher); re-binding after an attach
        re-shard is a fresh placement. The placed bytes are charged to the
        plane's next ``DispatchStats.record``."""
        if getattr(plane, "_mesh_placed_by", None) is self:
            return
        home = self.devices[0]                   # one device (see __init__)
        db = plane.db

        def put(shares: Shares) -> Shares:
            return Shares(shares.values.to(home), shares.degree)

        placed = SecretSharedDB(
            relation=put(db.relation), codec=db.codec,
            column_names=db.column_names,
            numeric={c: put(s) for c, s in db.numeric.items()},
            numeric_bits=dict(db.numeric_bits),
            base_degree=db.base_degree)
        plane.db = placed
        plane._views.clear()
        nbytes = 0
        for sh in plane.shards:                  # every block, once
            view = plane.view(sh.index)
            nbytes += _nbytes(view.relation.values) + sum(
                _nbytes(s.values) for s in view.numeric.values())
        plane._mesh_unbilled_bytes = nbytes      # charged to THIS plane
        plane._mesh_placed_by = self

    # -- the dispatch seam --------------------------------------------------
    def _guard(self):
        if self.strict_transfers and self.devices[0].type == "cuda":
            return _sync_errors()
        return contextlib.nullcontext()

    def run_set(self, plane: ShardedRelation, ds: DispatchSet):
        self.bind_plane(plane)
        t0 = time.perf_counter()
        with self._guard():
            parts = [d.run() for d in ds.dispatches]
            if ds.reduce == "sum" and len(parts) > 1:
                out = self._device_sum(parts)
            else:
                out = ds.combine(parts)     # concat/list: on the device
        moved, plane._mesh_unbilled_bytes = plane._mesh_unbilled_bytes, 0
        plane.stats.record(len(ds.dispatches),
                           wall_s=time.perf_counter() - t0,
                           transfer_bytes=moved)
        return out

    # -- the mod-p reduction --------------------------------------------------
    def _device_sum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Fold the per-shard partials on the first device: an int64 sum
        of S values < 2^31 cannot wrap, and ONE final ``% p`` equals the
        serial ``field.add`` chain."""
        home = self.devices[0]
        first = parts[0]
        key = (len(parts), tuple(first.shape), str(first.dtype))
        with self._lock:
            if key not in self._reductions:
                n, item = first.numel(), first.element_size()
                self._reductions[key] = dict(
                    flops=len(parts) * n,        # S−1 additions + one fold
                    hbm_bytes=(len(parts) + 1) * n * item,
                    collective_bytes=sum(_nbytes(p) for p in parts
                                         if p.device != home))
        stacked = torch.stack([p.to(home) for p in parts])
        acc = torch.sum(stacked, dim=0, dtype=torch.int64)
        del stacked
        return torch.remainder(acc, field.P).to(first.dtype)

    # -- predicted cost -------------------------------------------------------
    def predicted_cost(self) -> Dict[str, float]:
        """Totals over every distinct reduction run so far (one entry per
        shard count, shape and dtype), counted from the shapes: ``flops``
        the additions and folds, ``hbm_bytes`` each partial read once and
        the result written once, ``collective_bytes`` the partials copied
        from other devices to the first one, ``programs`` the distinct
        reductions."""
        with self._lock:
            costs = list(self._reductions.values())
        return dict(flops=float(sum(c["flops"] for c in costs)),
                    hbm_bytes=float(sum(c["hbm_bytes"] for c in costs)),
                    collective_bytes=float(sum(c["collective_bytes"]
                                               for c in costs)),
                    programs=len(costs))


@contextlib.contextmanager
def _sync_errors():
    """CUDA sync debug mode "error" for the block, then the old mode.
    The mode is process-wide: another thread's synchronizing call inside
    the block raises too."""
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)

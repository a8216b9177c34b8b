"""Device-resident dispatcher: a plane's cloud steps on a grid of devices.

The host dispatchers of :mod:`repro_torch.core.dataplane` (serial, thread
pool, MapReduce) run one thunk per shard and count every shard partial as
staged through the combine. :class:`MeshDispatcher` runs the same
:class:`~repro_torch.core.dataplane.DispatchSet` seam device-resident on a
``("data", "model")`` :class:`~repro_torch.core.grid.DeviceGrid`, as the
reference's ``repro.core.mesh_dispatch.MeshDispatcher`` does on a JAX
mesh:

* **Blocks** — tuple shards go over ``data`` (shard ``i`` on data row
  ``i % n_data``) and the c clouds over ``model``, in ``n_model`` equal
  groups when ``c % n_model == 0`` (``repro_torch.sharding.share_spec``);
  otherwise the cloud axis stays whole, on model column 0. A
  :class:`Block` is one (shard, cloud group) pair on its slot
  ``(i % n_data, g)``, and each cloud step runs one dispatch a block.
* **Placement** — on first contact with a plane (``bind_plane``, called by
  ``QueryClient.attach`` and lazily when a step is built) each block's
  slice of the relation goes to its slot's device: a slice already on
  that device stays a view, so no device holds a second full copy. The
  placed bytes are charged to that plane's next ``DispatchStats.record``;
  after that every step records zero transfer bytes (the residency
  invariant), as the reference charges its ``device_put``.
* **Operands follow their block** — a dispatch brings every query operand
  it captured to its block through ``sh.take`` (the operand's own clouds,
  on the block's device) and reads the cloud count from its block's view.
* **Reduce per cloud group** — a ``"sum"`` step's partials of one cloud
  group are folded on that group's data-row-0 device in int64 with ONE
  final ``% p``; F_p addition is exact, so the result is bit-identical to
  the serial chain of ``field.add`` for every shard count and grid. The
  groups, and every ``"concat"`` and ``"list"`` result, are assembled
  along the cloud axis on the client's device: the user receiving each
  cloud's share.
* **The non-communicating clouds** — the clouds never exchange data
  (§2, footnote 3): a block reads only its view of the relation and the
  operands ``sh.take`` cut to its clouds. The dispatcher records every
  copy it makes by grid slot (:meth:`copies`): placement and operands
  from the client to a slot, a reduce's partials from a data row to row 0
  of the same cloud group, and each group's result to the client.
  :meth:`cross_group_bytes` sums the copies from one group's slot to
  another's; no path of the dispatcher makes one, so the record says
  where bytes went, not that a group's result ignores the other groups'
  shares. That is checked by changing every other group's shares and
  comparing group 0's clouds of each step's result
  (``tests/test_torch_mesh_grid.py``, ``chip_smoke.py`` slice 11). A grid
  that names one device in several slots keeps the record by slot all
  the same.
* **No host round trip** — ``strict_transfers=True`` runs every cloud
  step under ``torch.cuda.set_sync_debug_mode("error")`` when the grid
  holds a CUDA device (the analog of ``jax.transfer_guard``; the mode is
  process-wide, so it covers every device of the grid). A grid that mixes
  CUDA and host slots is refused in strict mode: its copies to the host
  wait on the device, as a CUDA grid's results do for a client on the
  host, whose first cloud step raises.
* **Predicted cost** — :meth:`predicted_cost` counts every distinct
  reduction from its shapes: additions, bytes read and written, and the
  partials copied between data rows within a cloud group. There is no
  HLO to analyse, so the reference's ``hlo_texts`` has no counterpart.

``MeshDispatcher(["cpu", "cpu"])`` puts two data rows on one device;
``MeshDispatcher(make_dispatch_mesh(2, devices=["cuda:0"] * 4))`` is a
2 × 2 grid on one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from .. import _tree, sharding
from . import field
from .dataplane import Dispatcher, DispatchSet, Shard, ShardedRelation, \
    _nbytes
from .engine import SecretSharedDB
from .grid import DeviceGrid, make_dispatch_mesh
from .shamir import Shares

#: the user's end of a copy in the record (grid slots are (row, column))
CLIENT = "client"
Slot = Union[Tuple[int, int], str]


@dataclasses.dataclass(frozen=True)
class Block(Shard):
    """One (tuple shard, cloud group) block: clouds [c_lo, c_hi) of the
    relation's ``n_shares`` for tuples [lo, hi), placed on grid slot
    ``slot`` = (data row, model column ``group``) on ``device``."""
    c_lo: int = 0
    c_hi: int = 0
    n_shares: int = 0
    group: int = 0
    slot: Tuple[int, int] = (0, 0)
    device: Optional[torch.device] = None
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def n_clouds(self) -> int:
        return self.c_hi - self.c_lo

    def take(self, x: Optional[torch.Tensor], *, clouds: bool = True
             ) -> Optional[torch.Tensor]:
        if x is None:
            return None
        if clouds:
            if x.shape[0] != self.n_shares:
                raise ValueError(
                    f"an operand of {x.shape[0]} clouds on a relation of "
                    f"{self.n_shares}: a share operand's axis 0 is its "
                    f"clouds")
            if self.n_clouds != self.n_shares:
                x = x[self.c_lo:self.c_hi]
        return self.mesh._bring(x, CLIENT, self.slot, "operand",
                                self.device)


class MeshDispatcher(Dispatcher):
    """Run a plane's cloud steps device-resident on a grid of devices.

    Parameters
    ----------
    mesh:
        A :class:`~repro_torch.core.grid.DeviceGrid`, or a list of
        devices (every one a data row of one model slot); ``None`` is
        ``launch.mesh.make_dispatch_mesh()``, every visible CUDA device on
        ``data`` (raises without one).
    strict_transfers:
        Run every cloud step under ``torch.cuda.set_sync_debug_mode(
        "error")`` when the grid holds a CUDA device, so a step that
        copies to the host or waits on the device raises. Explicit
        placement by ``bind_plane`` is exempt. A grid of CUDA and host
        slots raises ``ValueError``.
    """

    def __init__(self, mesh=None, *, strict_transfers: bool = False):
        if mesh is None:
            mesh = make_dispatch_mesh()
        elif not isinstance(mesh, DeviceGrid):
            mesh = make_dispatch_mesh(devices=list(mesh))
        self.grid: DeviceGrid = mesh
        kinds = {d.type == "cuda" for d in mesh.devices}
        if strict_transfers and kinds == {True, False}:
            raise ValueError(
                "strict_transfers on a grid of CUDA and host slots: a host "
                "slot's copies wait on the device")
        self.strict_transfers = strict_transfers
        self._lock = threading.Lock()
        self._reductions: Dict[Tuple, Dict[str, int]] = {}
        self._copies: Dict[Tuple[Slot, Slot, str], int] = {}

    @property
    def devices(self) -> List[torch.device]:
        """Every grid slot's device, row by row."""
        return self.grid.devices

    # -- placement ----------------------------------------------------------
    def groups(self, n_shares: int) -> List[Tuple[int, int]]:
        """The cloud ranges [c_lo, c_hi) of a relation of ``n_shares``
        clouds: ``n_model`` equal groups, or one when they do not divide."""
        if sharding.share_spec(self.grid, (n_shares,))[0] == "model":
            k = n_shares // self.grid.n_model
            return [(g * k, (g + 1) * k) for g in range(self.grid.n_model)]
        return [(0, n_shares)]

    def shard_devices(self, plane: ShardedRelation) -> List[torch.device]:
        """The device of each shard's first cloud group."""
        return [self.grid.device(sh.index % self.grid.n_data, 0)
                for sh in plane.shards]

    def blocks(self, plane: ShardedRelation) -> List[Block]:
        """The plane's blocks, shard by shard, each shard's cloud groups in
        order (placing them first if this dispatcher has not)."""
        self.bind_plane(plane)
        return list(plane._placed)

    def bind_plane(self, plane: ShardedRelation) -> None:
        """Place the plane's blocks on their slots' devices, once.

        Idempotent per (plane, dispatcher); re-binding after an attach
        re-shard is a fresh placement. The placed bytes are charged to the
        plane's next ``DispatchStats.record``."""
        if getattr(plane, "_mesh_placed_by", None) is self:
            return
        db = plane.db
        placed: Dict[Shard, SecretSharedDB] = {}
        nbytes = 0
        for sh in plane.shards:
            whole = plane.view(sh.index)
            for g, (lo, hi) in enumerate(self.groups(db.n_shares)):
                r = sh.index % self.grid.n_data
                blk = Block(sh.index, sh.lo, sh.hi, c_lo=lo, c_hi=hi,
                            n_shares=db.n_shares, group=g, slot=(r, g),
                            device=self.grid.device(r, g), mesh=self)

                def put(shares: Shares) -> Shares:
                    return Shares(self._bring(shares.values[lo:hi], CLIENT,
                                              blk.slot, "place",
                                              blk.device), shares.degree)

                view = SecretSharedDB(
                    relation=put(whole.relation), codec=db.codec,
                    column_names=db.column_names,
                    numeric={c: put(s) for c, s in whole.numeric.items()},
                    numeric_bits=dict(db.numeric_bits),
                    base_degree=db.base_degree)
                nbytes += _nbytes(view.relation.values) + sum(
                    _nbytes(s.values) for s in view.numeric.values())
                placed[blk] = view
        plane.place(placed)
        plane._mesh_unbilled_bytes = nbytes      # charged to THIS plane
        plane._mesh_placed_by = self

    # -- copies, by grid slot -------------------------------------------------
    def _bring(self, x: torch.Tensor, src: Slot, dst: Slot, why: str,
               device: torch.device) -> torch.Tensor:
        """``x`` on ``device``, recorded as ``why`` from ``src`` to
        ``dst``. A CUDA destination never makes the host wait (a host
        source is pinned first); a copy to the host waits."""
        if src != dst:
            with self._lock:
                key = (src, dst, why)
                self._copies[key] = self._copies.get(key, 0) + _nbytes(x)
        if x.device == device:
            return x
        if device.type == "cuda":
            if x.device.type == "cpu":
                x = x.pin_memory()
            return x.to(device, non_blocking=True)
        return x.to(device)

    def copies(self) -> List[Dict[str, Any]]:
        """Every kind of copy made so far: ``src`` and ``dst`` (a grid
        slot ``(row, column)`` or ``"client"``), ``why`` (``place``,
        ``operand``, ``reduce`` or ``gather``) and the bytes in all."""
        with self._lock:
            items = sorted(self._copies.items(), key=repr)
        return [dict(src=s, dst=d, why=w, bytes=b) for (s, d, w), b in items]

    def cross_group_bytes(self) -> int:
        """Bytes copied from one cloud group's slot to another group's."""
        return sum(c["bytes"] for c in self.copies()
                   if c["src"] != CLIENT and c["dst"] != CLIENT
                   and c["src"][1] != c["dst"][1])

    # -- the dispatch seam --------------------------------------------------
    def _guard(self):
        if self.strict_transfers and any(d.type == "cuda"
                                         for d in self.devices):
            return _sync_errors()
        return contextlib.nullcontext()

    def run_set(self, plane: ShardedRelation, ds: DispatchSet):
        self.bind_plane(plane)
        blocks = [d.shard for d in ds.dispatches]
        if not all(isinstance(b, Block) for b in blocks):
            raise TypeError("a dispatch set built on a plane that this "
                            "dispatcher has not split into blocks")
        t0 = time.perf_counter()
        with self._guard():
            parts = [d.run() for d in ds.dispatches]
            if ds.reduce == "sum":
                out = self._sum(blocks, parts, plane.device)
            elif ds.reduce == "concat":
                out = self._concat(blocks, parts, ds.axis, plane.device)
            else:
                out = ds.combine(self._gather(blocks, parts, plane.device))
        moved, plane._mesh_unbilled_bytes = plane._mesh_unbilled_bytes, 0
        plane.stats.record(len(ds.dispatches),
                           wall_s=time.perf_counter() - t0,
                           transfer_bytes=moved)
        return out

    def _concat(self, blocks: List[Block], parts: List[torch.Tensor],
                axis: int, home: torch.device) -> torch.Tensor:
        """A ``"concat"`` step on ``home``: shards along ``axis`` and cloud
        groups along axis 0, each block's part written once into the
        result."""
        moved = [self._to_client(p, b, home) for b, p in zip(blocks, parts)]
        if len({b.group for b in blocks}) == 1:
            return moved[0] if len(moved) == 1 else torch.cat(moved,
                                                              dim=axis)
        ax = axis % moved[0].ndim
        if ax == 0:
            raise ValueError("a concat step joins its shards along the "
                             "tuples, never along the clouds (axis 0)")
        offs, off = {}, 0
        for b, p in zip(blocks, moved):
            if b.index not in offs:
                offs[b.index] = off
                off += p.shape[ax]
        shape = list(moved[0].shape)
        shape[0], shape[ax] = blocks[0].n_shares, off
        out = torch.empty(shape, dtype=moved[0].dtype, device=home)
        for b, p in zip(blocks, moved):
            out[b.c_lo:b.c_hi].narrow(ax, offs[b.index],
                                      p.shape[ax]).copy_(p)
        return out

    def _gather(self, blocks: List[Block], parts: List[Any],
                home: torch.device) -> List[Any]:
        """Each shard's result with its cloud groups assembled along the
        cloud axis on ``home`` (index lists and ``None``s, equal in every
        group, are taken once)."""
        by_shard: Dict[int, List[Tuple[Block, Any]]] = {}
        for b, p in zip(blocks, parts):
            by_shard.setdefault(b.index, []).append((b, p))
        out = []
        for i in sorted(by_shard):
            moved = [_tree.map_leaves(
                lambda x, b=b: self._to_client(x, b, home), p)
                for b, p in by_shard[i]]
            out.append(moved[0] if len(moved) == 1
                       else _tree.map_leaves(_cat_clouds, *moved))
        return out

    def _to_client(self, x, b: Block, home: torch.device):
        """One output of block ``b`` on ``home``; a block of one cloud
        group among several must return its clouds on axis 0, where the
        groups are assembled."""
        if not isinstance(x, torch.Tensor):
            return x
        if b.n_clouds != b.n_shares and (x.ndim == 0
                                         or x.shape[0] != b.n_clouds):
            raise ValueError(
                f"a cloud step returned {tuple(x.shape)} from a block of "
                f"{b.n_clouds} clouds: every output has its clouds as "
                f"axis 0")
        return self._bring(x, b.slot, CLIENT, "gather", home)

    # -- the mod-p reduction --------------------------------------------------
    def _sum(self, blocks: List[Block], parts: List[torch.Tensor],
             home: torch.device) -> torch.Tensor:
        """Fold each cloud group's partials on its data-row-0 slot: an
        int64 sum of S values < 2^31 cannot wrap, and ONE final ``% p``
        equals the serial ``field.add`` chain. The groups are then
        assembled along the cloud axis on ``home``."""
        by_group: Dict[int, List[Tuple[Block, torch.Tensor]]] = {}
        for b, p in zip(blocks, parts):
            by_group.setdefault(b.group, []).append((b, p))
        outs, copied = [], 0
        for g in sorted(by_group):
            items = by_group[g]                    # shard 0 first: row 0
            root = items[0][0].slot
            dev = items[0][0].device
            if len(items) == 1:
                acc = items[0][1]
            else:
                staged = []
                for b, p in items:
                    if b.slot != root:
                        copied += _nbytes(p)
                    staged.append(self._bring(p, b.slot, root, "reduce", dev))
                stacked = torch.stack(staged)
                del staged
                acc = torch.remainder(torch.sum(stacked, dim=0,
                                                dtype=torch.int64),
                                      field.P).to(parts[0].dtype)
                del stacked
            outs.append(self._to_client(acc, items[0][0], home))
        if len(parts) > len(outs):
            self._note_reduction(len(parts) // len(outs), parts, copied)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def _note_reduction(self, n_shards: int, parts: List[torch.Tensor],
                        copied: int) -> None:
        n = sum(p.numel() for p in parts) // n_shards     # one whole result
        item = parts[0].element_size()
        key = (n_shards, n, str(parts[0].dtype), len(parts))
        with self._lock:
            self._reductions.setdefault(
                key, reduction_cost(n_shards, n, item, copied))

    # -- predicted cost -------------------------------------------------------
    def predicted_cost(self) -> Dict[str, float]:
        """Totals over every distinct reduction run so far (one entry per
        shard count, size, dtype and block count), counted from the
        shapes: ``flops`` the additions and folds, ``hbm_bytes`` each
        partial read once and the result written once,
        ``collective_bytes`` the partials copied between data rows within
        a cloud group, ``programs`` the distinct reductions."""
        with self._lock:
            costs = list(self._reductions.values())
        return dict(flops=float(sum(c["flops"] for c in costs)),
                    hbm_bytes=float(sum(c["hbm_bytes"] for c in costs)),
                    collective_bytes=float(sum(c["collective_bytes"]
                                               for c in costs)),
                    programs=len(costs))


def reduction_cost(n_shards: int, numel: int, itemsize: int,
                   copied: int) -> Dict[str, int]:
    """One mod-p reduction of ``n_shards`` partials of ``numel`` elements
    each: ``flops`` the S − 1 additions and one fold an element,
    ``hbm_bytes`` each partial read once and the result written once,
    ``collective_bytes`` the ``copied`` bytes of partials brought to the
    data-row-0 slot (at most every partial but row 0's)."""
    return dict(flops=n_shards * numel,
                hbm_bytes=(n_shards + 1) * numel * itemsize,
                collective_bytes=copied)


def _cat_clouds(first, *rest):
    """One leaf of a shard's result over its cloud groups: tensors
    concatenate along the clouds, anything else is equal in every group."""
    if isinstance(first, torch.Tensor):
        return torch.cat((first,) + rest, dim=0)
    if any(r != first for r in rest):
        raise ValueError(f"cloud groups disagree on {first!r} vs {rest!r}")
    return first


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


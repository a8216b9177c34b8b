"""Sharded dataplane: tuple-axis partitioning of a secret-shared relation.

A :class:`ShardedRelation` splits the share arrays of a
:class:`~repro_torch.core.engine.SecretSharedDB` into S contiguous
tuple-axis shards (views, never copies), and the round engine emits one
:class:`ShardDispatch` per shard per cloud step (per (shard, cloud
group) block on a ``MeshDispatcher``'s grid). A :class:`DispatchSet`
bundles one step's dispatches with the reduction that reassembles them:

  * ``"concat"`` — per-tuple outputs concatenate along the tuple axis;
  * ``"sum"``    — partial mod-p sums combine additively; F_p addition is
    exact, so results are bit-identical to the unsharded computation;
  * ``"list"``   — the raw per-shard results, for callers that thread
    shard-local state from one step to the next (the range ripple's
    per-shard carries).

Execution is a placement policy, not part of the protocol:
:class:`Dispatcher` runs shards inline, :class:`ThreadedDispatcher` fans
them out over a thread pool (the serving runtime), and
``repro_torch.api.executor.MapReduceDispatcher`` places each shard dispatch
as a fault-tolerant MapReduce task. Combining always happens on the
caller's thread in shard order, so results are bit-identical to serial.

Two multi-tenant refinements ride on the thread pool:

  * **Weighted fair quotas** — every :class:`PoolHandle` carries a
    ``weight``; dispatches submitted through a handle queue per handle and
    a deficit-round-robin picker admits them to the pool workers in
    weight-proportional order, FIFO within a handle.
  * **Fused waves** — :func:`fused_execute` runs several planes' cloud
    steps as ONE dispatch wave when their dispatchers share a pool; each
    step still combines in shard order.

Pool threads set no CUDA stream: every kernel launches on
``torch.cuda.current_stream(dev)``, which in a thread that set nothing is
the device's default stream, so shard thunks are ordered with the caller's
combine without events. Giving workers their own streams would need the
combine to wait on their events and ``record_stream`` on tensors freed
across streams; that is later work.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from . import field
from .engine import SecretSharedDB
from .partition import split_bounds
from .shamir import Shares


def _nbytes(part: Any) -> int:
    """Bytes of every tensor in one shard result (tuples and lists too)."""
    if isinstance(part, torch.Tensor):
        return part.numel() * part.element_size()
    if isinstance(part, (tuple, list)):
        return sum(_nbytes(p) for p in part)
    return 0


class Dispatcher:
    """Placement policy for one round's shard dispatches (serial default).

    Two seams: host dispatchers (serial, thread pool, MapReduce) override
    only :meth:`run_all`; a device-resident dispatcher
    (``repro_torch.core.mesh_dispatch.MeshDispatcher``) overrides
    :meth:`blocks` to split each shard into placed blocks and
    :meth:`run_set` to reduce the partials on the devices and count only
    its initial placement as transferred.
    """

    def blocks(self, plane: "ShardedRelation") -> Sequence["Shard"]:
        """The blocks one cloud step dispatches to: one whole shard each."""
        return plane.shards

    def run_all(self, thunks: Sequence[Callable[[], Any]]) -> List[Any]:
        return [t() for t in thunks]

    def run_set(self, plane: "ShardedRelation", ds: "DispatchSet"):
        """Execute + reduce one cloud step, recording telemetry."""
        t0 = time.perf_counter()
        parts = self.run_all([d.run for d in ds.dispatches])
        out = ds.combine(parts)
        plane.stats.record(len(ds.dispatches),
                           wall_s=time.perf_counter() - t0,
                           transfer_bytes=sum(_nbytes(p) for p in parts))
        return out


SERIAL = Dispatcher()


#: deficit-round-robin serves one shard dispatch per unit of deficit;
#: weights below this floor still accumulate credit (no starvation).
_MIN_WEIGHT = 1e-6


class ThreadedDispatcher(Dispatcher):
    """Run shard dispatches concurrently on a shared thread pool.

    Share-space cloud steps are pure, so concurrent execution is safe; the
    combine (concat / mod-p sum) happens on the caller's thread in shard
    order, keeping results bit-identical to serial execution.

    One pool can back many relations: :meth:`handle` returns a
    :class:`PoolHandle`, a per-relation view whose ``close()`` only
    detaches the view, so the global fan-out stays bounded by ONE
    ``max_workers``. Dispatches submitted through a handle queue per handle
    and are admitted by deficit round robin (:meth:`_pick_locked`): each
    rotation visit tops a handle's deficit up by its weight and serves one
    queued dispatch per unit of deficit — weight-proportional under
    contention, FIFO within a handle, work-conserving. Direct ``run_all``
    calls bypass the quotas (the single-tenant surface).
    """

    def __init__(self, max_workers: Optional[int] = None):
        # the cap doubles as the DRR in-flight bound: a concrete number
        self._cap = max_workers or min(32, (os.cpu_count() or 1) + 4)
        self._pool = ThreadPoolExecutor(max_workers=self._cap,
                                        thread_name_prefix="shard")
        self._closed = False
        self._dlock = threading.Lock()
        self._queues: Dict["PoolHandle", deque] = {}
        self._rr: deque = deque()           # handles with queued work
        self._deficits: Dict["PoolHandle", float] = {}
        self._granted: set = set()          # front handle already topped up
        self._inflight = 0

    def run_all(self, thunks: Sequence[Callable[[], Any]]) -> List[Any]:
        if self._closed or len(thunks) <= 1:
            return [t() for t in thunks]
        return list(self._pool.map(lambda t: t(), thunks))

    def handle(self, weight: float = 1.0) -> "PoolHandle":
        """A detachable per-relation view sharing this pool, with a
        deficit-round-robin share ``weight``."""
        return PoolHandle(self, weight=weight)

    # -- weighted fair admission (deficit round robin) ----------------------
    def enqueue(self, handle: "PoolHandle",
                thunks: Sequence[Callable[[], Any]]) -> List[Future]:
        """Queue thunks under ``handle``'s quota; returns their futures.
        Non-blocking: admission happens on whichever threads drive the
        queue (this caller now, pool workers as units finish)."""
        futures = [Future() for _ in thunks]
        with self._dlock:
            q = self._queues.get(handle)
            if q is None:
                q = self._queues[handle] = deque()
                self._rr.append(handle)
            for t, f in zip(thunks, futures):
                q.append((t, f))
        self._drive()
        return futures

    def _drop_locked(self, h: "PoolHandle") -> None:
        self._rr.popleft()
        self._queues.pop(h, None)
        self._deficits.pop(h, None)
        self._granted.discard(h)

    def _pick_locked(self) -> Optional[Tuple[Callable[[], Any], Future]]:
        """Next admissible unit under DRR; the caller holds ``_dlock``.
        The front handle's deficit is topped up by its weight once per
        rotation visit and spent one unit per served dispatch; when it runs
        dry (or drains) the rotation advances."""
        while self._rr:
            h = self._rr[0]
            q = self._queues.get(h)
            if not q:                       # drained: drop stale credit
                self._drop_locked(h)
                continue
            if h not in self._granted:
                self._granted.add(h)
                self._deficits[h] = (self._deficits.get(h, 0.0)
                                     + max(h.weight, _MIN_WEIGHT))
            if self._deficits[h] >= 1.0:
                self._deficits[h] -= 1.0
                unit = q.popleft()
                if not q:
                    self._drop_locked(h)
                return unit
            self._granted.discard(h)        # spent: the next visit re-grants
            self._rr.rotate(-1)
        return None

    def _drive(self) -> None:
        """Admit queued units while worker slots are free (submitters and
        finishing workers both drive; there is no dedicated thread)."""
        while True:
            with self._dlock:
                if not self._closed and self._inflight >= self._cap:
                    return
                unit = self._pick_locked()
                if unit is None:
                    return
                self._inflight += 1
                closed = self._closed
            if closed:
                self._run_unit(*unit)       # inline drain: never strand
            else:
                try:
                    self._pool.submit(self._run_unit, *unit)
                except RuntimeError:        # shut down mid-flight
                    self._run_unit(*unit)

    def _run_unit(self, thunk: Callable[[], Any], fut: Future) -> None:
        try:
            result = thunk()
        except BaseException as e:  # noqa: BLE001 — relayed to the waiter
            fut.set_exception(e)
        else:
            fut.set_result(result)
        with self._dlock:
            self._inflight -= 1
        self._drive()

    def close(self) -> None:
        """Release the pool; later dispatches run serially (correct, just
        unparallel). Units still queued under quotas drain inline, so no
        waiter blocks forever."""
        self._closed = True
        self._pool.shutdown(wait=False)
        self._drive()


class PoolHandle(Dispatcher):
    """Per-relation view of a shared :class:`ThreadedDispatcher` pool.

    ``run_all`` submits through the pool's weighted fair queue;
    ``close()`` detaches only this handle — later dispatches through it
    run serially while the pool keeps serving its other handles.
    """

    def __init__(self, pool: ThreadedDispatcher, weight: float = 1.0):
        if weight <= 0:
            raise ValueError(f"PoolHandle weight must be > 0, got {weight}")
        self._shared_pool = pool
        self.weight = float(weight)
        self._detached = False

    def run_all(self, thunks: Sequence[Callable[[], Any]]) -> List[Any]:
        pool = self._shared_pool
        if self._detached or pool._closed or len(thunks) <= 1:
            return [t() for t in thunks]
        return [f.result() for f in pool.enqueue(self, list(thunks))]

    def close(self) -> None:
        self._detached = True


@dataclasses.dataclass(frozen=True)
class Shard:
    """One contiguous tuple-axis slice [lo, hi) of the relation.

    A shard is also the block a host dispatcher's dispatch runs on: every
    cloud of the slice, where the relation lies. A device-resident
    dispatcher hands its dispatches smaller blocks
    (``core.mesh_dispatch.Block``: one group of clouds on one grid slot);
    a dispatch reads its own block from the ``sh`` it is given."""
    index: int
    lo: int
    hi: int

    @property
    def n_tuples(self) -> int:
        return self.hi - self.lo

    def take(self, x: Optional[torch.Tensor], *, clouds: bool = True
             ) -> Optional[torch.Tensor]:
        """A query operand that a dispatch captured, brought to its block:
        the cloud axis (axis 0 of every share operand) cut to the block's
        clouds unless ``clouds=False`` (weights, indices: no cloud axis),
        then moved to the block's device. A whole shard on the relation's
        own device takes every operand as it is; ``None`` stays ``None``."""
        return x


@dataclasses.dataclass(frozen=True)
class ShardDispatch:
    """One block's slice of a cloud step (a shard, or one cloud group of
    it on a grid): a zero-argument device thunk."""
    shard: Shard
    run: Callable[[], Any]


@dataclasses.dataclass(frozen=True)
class DispatchSet:
    """All shards' dispatches for one cloud step + the reduction rule."""
    dispatches: Tuple[ShardDispatch, ...]
    reduce: str = "concat"          # "concat" | "sum" | "list"
    axis: int = -1                  # concat axis

    def combine(self, parts: List[Any]):
        if self.reduce == "list":
            return parts
        if len(parts) == 1:
            return parts[0]
        if self.reduce == "concat":
            return torch.cat(parts, dim=self.axis)
        if self.reduce == "sum":
            acc = parts[0]
            for p in parts[1:]:
                acc = field.add(acc, p)
            return acc
        raise ValueError(f"unknown reduce mode {self.reduce!r}")


@dataclasses.dataclass
class DispatchStats:
    """Execution-side telemetry (never part of the protocol transcript)."""
    dispatches: int = 0             # shard dispatches executed
    steps: int = 0                  # cloud steps (DispatchSets) executed
    fused_steps: int = 0            # steps executed inside a fused wave
    dispatch_s: float = 0.0         # cumulative cloud-step host wall time
    transfer_bytes: int = 0         # bytes of shard partials combined

    def record(self, n_dispatches: int, wall_s: float = 0.0,
               transfer_bytes: int = 0, fused: bool = False) -> None:
        self.dispatches += n_dispatches
        self.steps += 1
        if fused:
            # the step ran inside a cross-plane fused_execute wave;
            # wall_s then covers the whole wave, not this step alone.
            self.fused_steps += 1
        self.dispatch_s += wall_s
        self.transfer_bytes += transfer_bytes


class ShardedRelation:
    """Tuple-axis partitioned view of one outsourced relation.

    ``shards=S`` splits [0, n) with :func:`split_bounds` (never an empty
    shard; S > n degrades to one tuple per shard). ``view(i)`` is shard i
    as a :class:`SecretSharedDB` of tensor views. Swapping the dispatcher
    never changes results.
    """

    def __init__(self, db: SecretSharedDB, shards: int = 1,
                 dispatcher: Dispatcher = None):
        if isinstance(db, ShardedRelation):
            db = db.db
        self.db = db
        bounds = split_bounds(0, db.n_tuples, max(1, shards))
        if not all(lo < hi for lo, hi in bounds):
            raise ValueError("empty shard bounds")
        self.shards: List[Shard] = [Shard(i, lo, hi)
                                    for i, (lo, hi) in enumerate(bounds)]
        self.dispatcher = dispatcher or SERIAL
        self.stats = DispatchStats()
        self._views: dict = {}
        self._placed: Dict[Shard, SecretSharedDB] = {}

    @property
    def device(self) -> torch.device:
        return self.db.device

    # -- SecretSharedDB delegation: the plane reads like its relation ------
    @property
    def relation(self) -> Shares:
        return self.db.relation

    @property
    def codec(self):
        return self.db.codec

    @property
    def column_names(self):
        return self.db.column_names

    @property
    def numeric(self):
        return self.db.numeric

    @property
    def numeric_bits(self):
        return self.db.numeric_bits

    @property
    def base_degree(self) -> int:
        return self.db.base_degree

    @property
    def n_shares(self) -> int:
        return self.db.n_shares

    @property
    def n_tuples(self) -> int:
        return self.db.n_tuples

    @property
    def n_attrs(self) -> int:
        return self.db.n_attrs

    def column(self, col: int) -> Shares:
        return self.db.column(col)

    def col_index(self, name: str) -> int:
        return self.db.col_index(name)

    # -- structure ----------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def max_shard_rows(self) -> int:
        return max((s.n_tuples for s in self.shards), default=0)

    def view(self, index: int, block: Optional[Shard] = None
             ) -> SecretSharedDB:
        """Shard ``index`` as a sliced SecretSharedDB (cached), or the
        placed copy of ``block`` when a dispatcher placed it (:meth:`place`).
        ``self.db`` stays the relation on the client's device, so shape
        reads of it hold whatever the placement."""
        if block is not None and block in self._placed:
            return self._placed[block]
        sh = self.shards[index]
        if sh.lo == 0 and sh.hi == self.db.n_tuples:
            return self.db
        if index not in self._views:
            db = self.db
            self._views[index] = SecretSharedDB(
                relation=Shares(db.relation.values[:, sh.lo:sh.hi],
                                db.relation.degree),
                codec=db.codec, column_names=db.column_names,
                numeric={c: Shares(s.values[:, sh.lo:sh.hi], s.degree)
                         for c, s in db.numeric.items()},
                numeric_bits=dict(db.numeric_bits),
                base_degree=db.base_degree)
        return self._views[index]

    def place(self, blocks: Dict[Shard, SecretSharedDB]) -> None:
        """Serve ``blocks`` (block -> its placed view) from :meth:`view`,
        in place of any earlier placement."""
        self._placed = dict(blocks)

    # -- dispatch -----------------------------------------------------------
    def dispatch_set(self, build: Callable[[SecretSharedDB, Shard], Any],
                     *, reduce: str = "concat", axis: int = -1
                     ) -> DispatchSet:
        """One cloud step: a dispatch descriptor per block of the
        dispatcher (per shard for a host dispatcher); ``build(view, sh)``
        gets the block's view and the block."""
        return DispatchSet(tuple(
            ShardDispatch(b, functools.partial(build, self.view(b.index, b),
                                               b))
            for b in self.dispatcher.blocks(self)), reduce=reduce, axis=axis)

    def execute(self, ds: DispatchSet):
        """Run one step through the placement policy and reduce it."""
        return self.dispatcher.run_set(self, ds)

    def run_concat(self, build, *, axis: int = -1):
        return self.execute(self.dispatch_set(build, reduce="concat",
                                              axis=axis))

    def run_sum(self, build):
        return self.execute(self.dispatch_set(build, reduce="sum"))

    def run_list(self, build) -> List[Any]:
        return self.execute(self.dispatch_set(build, reduce="list"))


RelationLike = Union[SecretSharedDB, ShardedRelation]


def _fusion_pool(plane: ShardedRelation) -> Optional[ThreadedDispatcher]:
    """The live shared pool a plane's cloud steps can fuse into, if any:
    planes whose dispatchers resolve to the SAME pool form one fusion
    domain; serial, detached, closed and MapReduce dispatchers fuse with
    nobody."""
    disp = plane.dispatcher
    if isinstance(disp, PoolHandle):
        if disp._detached or disp._shared_pool._closed:
            return None
        return disp._shared_pool
    if isinstance(disp, ThreadedDispatcher) and not disp._closed:
        return disp
    return None


def fused_execute(pairs: Sequence[Tuple[ShardedRelation, DispatchSet]]
                  ) -> List[Any]:
    """Execute one cloud step per (plane, set) pair, fusing shared pools.

    Steps whose planes share a live :class:`ThreadedDispatcher` run as ONE
    dispatch wave: every plane's shard thunks enqueue together, each under
    its own :class:`PoolHandle` (so weighted quotas still arbitrate), and
    each step's partials combine in shard order on this thread. Everything
    else executes through its own ``run_set``, unfused. Results come back
    in ``pairs`` order, bit-identical to executing each step alone."""
    results: List[Any] = [None] * len(pairs)
    groups: Dict[ThreadedDispatcher, List[int]] = {}
    for i, (plane, ds) in enumerate(pairs):
        pool = _fusion_pool(plane)
        if pool is None:
            results[i] = plane.execute(ds)
        else:
            groups.setdefault(pool, []).append(i)
    for pool, idxs in groups.items():
        if len(idxs) == 1:
            plane, ds = pairs[idxs[0]]
            results[idxs[0]] = plane.execute(ds)
            continue
        t0 = time.perf_counter()
        waves: List[Tuple[int, List[Future]]] = []
        for i in idxs:
            plane, ds = pairs[i]
            disp = plane.dispatcher
            handle = (disp if isinstance(disp, PoolHandle)
                      else pool.handle())       # transient, weight 1
            waves.append((i, pool.enqueue(handle,
                                          [d.run for d in ds.dispatches])))
        for i, futs in waves:
            plane, ds = pairs[i]
            parts = [f.result() for f in futs]
            results[i] = ds.combine(parts)
            plane.stats.record(len(ds.dispatches),
                               wall_s=time.perf_counter() - t0,
                               transfer_bytes=sum(_nbytes(p) for p in parts),
                               fused=True)
    return results


def as_dataplane(rel: RelationLike) -> ShardedRelation:
    """A plain db becomes its own single-shard dataplane."""
    if isinstance(rel, ShardedRelation):
        return rel
    return ShardedRelation(rel, shards=1)

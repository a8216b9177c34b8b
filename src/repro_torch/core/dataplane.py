"""Sharded dataplane: tuple-axis partitioning of a secret-shared relation.

A :class:`ShardedRelation` splits the share arrays of a
:class:`~repro_torch.core.engine.SecretSharedDB` into S contiguous
tuple-axis shards (views, never copies), and the round engine emits one
:class:`ShardDispatch` per shard per cloud step. A :class:`DispatchSet`
bundles one step's dispatches with the reduction that reassembles them:

  * ``"concat"`` — per-tuple outputs concatenate along the tuple axis;
  * ``"sum"``    — partial mod-p sums combine additively; F_p addition is
    exact, so results are bit-identical to the unsharded computation.

Execution is a placement policy, not part of the protocol. This slice has
the serial :class:`Dispatcher`; the threaded pool comes with serving.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, List, Sequence, Tuple, Union

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
    """Placement policy for one round's shard dispatches (serial)."""

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


@dataclasses.dataclass(frozen=True)
class Shard:
    """One contiguous tuple-axis slice [lo, hi) of the relation."""
    index: int
    lo: int
    hi: int

    @property
    def n_tuples(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass(frozen=True)
class ShardDispatch:
    """One shard's slice of a cloud step: a zero-argument device thunk."""
    shard: Shard
    run: Callable[[], Any]


@dataclasses.dataclass(frozen=True)
class DispatchSet:
    """All shards' dispatches for one cloud step + the reduction rule."""
    dispatches: Tuple[ShardDispatch, ...]
    reduce: str = "concat"          # "concat" | "sum"
    axis: int = -1                  # concat axis

    def combine(self, parts: List[Any]):
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
    dispatch_s: float = 0.0         # cumulative cloud-step host wall time
    transfer_bytes: int = 0         # bytes of shard partials combined

    def record(self, n_dispatches: int, wall_s: float = 0.0,
               transfer_bytes: int = 0) -> None:
        self.dispatches += n_dispatches
        self.steps += 1
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

    @property
    def device(self) -> torch.device:
        return self.db.device

    # -- structure ----------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def view(self, index: int) -> SecretSharedDB:
        """Shard ``index`` as a sliced SecretSharedDB (cached)."""
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

    # -- dispatch -----------------------------------------------------------
    def dispatch_set(self, build: Callable[[SecretSharedDB, Shard], Any],
                     *, reduce: str = "concat", axis: int = -1
                     ) -> DispatchSet:
        """One cloud step: a per-shard dispatch descriptor per shard."""
        return DispatchSet(tuple(
            ShardDispatch(sh, functools.partial(build, self.view(sh.index),
                                                sh))
            for sh in self.shards), reduce=reduce, axis=axis)

    def execute(self, ds: DispatchSet):
        """Run one step through the placement policy and reduce it."""
        return self.dispatcher.run_set(self, ds)

    def run_concat(self, build, *, axis: int = -1):
        return self.execute(self.dispatch_set(build, reduce="concat",
                                              axis=axis))

    def run_sum(self, build):
        return self.execute(self.dispatch_set(build, reduce="sum"))


RelationLike = Union[SecretSharedDB, ShardedRelation]


def fused_execute(pairs: Sequence[Tuple[ShardedRelation, DispatchSet]]
                  ) -> List[Any]:
    """Execute one cloud step per (plane, set) pair, in order. Serial planes
    do not fuse: each step runs through its own dispatcher."""
    return [plane.execute(ds) for plane, ds in pairs]


def as_dataplane(rel: RelationLike) -> ShardedRelation:
    """A plain db becomes its own single-shard dataplane."""
    if isinstance(rel, ShardedRelation):
        return rel
    return ShardedRelation(rel, shards=1)

"""MapReduce execution of the oblivious map phase (the paper's title).

:class:`MapReduceExecutor` wraps a :class:`~.backends.Backend` so each
cloud-side op fans out over input splits driven by the fault-tolerant
:class:`repro_torch.runtime.MapReduceRunner` — re-execution of lost tasks
and speculative straggler backups included. Share-space map tasks are pure,
so duplicate execution is safe, the property the MapReduce fault model
relies on.

The split axis is always a *data* axis (tuples or fetch rows), never the
cloud axis, so a worker only sees whole share-columns of its slice and the
non-communication property holds. Results are bit-identical to the unsplit
backend because every op is elementwise per tuple or a row block of a
matmul. Split results stay on the tensors' device and are joined with
``torch.cat``.

Two roles:

  * :meth:`MapReduceExecutor.wrap` — every split op of the backend splits
    its own data axis into ``n_splits`` runner tasks; ``share_onehot``
    (the embedding lookup's user-side sharing, no tuple axis) passes
    through unsplit, so a wrapped client launches the same kernel.
  * :class:`MapReduceDispatcher` — the runner as a placement policy of the
    sharded dataplane: each shard dispatch the round engine emits becomes
    one map task.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import torch

from ..core.dataplane import Dispatcher
from ..core.partition import split_bounds
from ..runtime.mapreduce import MapReduceRunner
from .backends import Backend


class MapReduceDispatcher(Dispatcher):
    """Run each shard dispatch as one MapReduce task (re-execution and
    speculative backups included; shard dispatches are pure)."""

    def __init__(self, runner: MapReduceRunner):
        self.runner = runner

    def run_all(self, thunks: Sequence[Callable[[], Any]]) -> List[Any]:
        if len(thunks) <= 1:
            return [t() for t in thunks]
        return self.runner.run(lambda t: t(), list(thunks))


def _narrow(starts: Sequence[int], lengths: Sequence[int], lo: int, hi: int
            ) -> Tuple[List[int], List[int]]:
    """Row blocks cut to output rows [lo, hi): block b's rows
    [starts[b] + lo, starts[b] + min(lengths[b], hi)), empty past its
    length (its start then stays inside the relation)."""
    return ([s + min(lo, ln) for s, ln in zip(starts, lengths)],
            [max(0, min(ln, hi) - lo) for ln in lengths])


@dataclasses.dataclass
class MapReduceExecutor:
    """Fan a backend's map phase out over ``runner`` with ``n_splits``."""
    runner: MapReduceRunner
    n_splits: int = 4

    def dispatcher(self) -> MapReduceDispatcher:
        """This executor as a dataplane placement policy."""
        return MapReduceDispatcher(self.runner)

    def _split(self, total: int, one: Callable[[int, int], Any]) -> list:
        """Run ``one(lo, hi)`` for every split of [0, total) as map tasks;
        the results come back in split order."""
        return self.runner.run(lambda s: one(*s),
                               split_bounds(0, total, self.n_splits))

    def _cat(self, total: int, dim: int,
             one: Callable[[int, int], torch.Tensor]) -> torch.Tensor:
        return torch.cat(self._split(total, one), dim=dim)

    def _cat2(self, total: int, one) -> Tuple[torch.Tensor, torch.Tensor]:
        parts = self._split(total, one)
        return (torch.cat([p[0] for p in parts], dim=-1),
                torch.cat([p[1] for p in parts], dim=-1))

    def wrap(self, base: Backend) -> Backend:
        """``base`` with every op that has a tuple or row axis split over
        the runner; an op ``base`` lacks stays absent."""

        def ss_matmul(a, b):
            # a: ([c,] M, K) — split the output rows M (fetch rows, tokens)
            rows = a.ndim - 2
            if a.shape[rows] == 0:
                return base.ss_matmul(a, b)
            return self._cat(a.shape[rows], rows, lambda lo, hi: (
                base.ss_matmul(a.narrow(rows, lo, hi - lo), b)))

        def tuples_dim2(op):
            # (c, B, n, ...) stacks: split the tuple axis n; the batch axis
            # stays fused inside each task
            def run(col, other):
                if col.shape[1] == 0 or col.shape[2] == 0:
                    return op(col, other)
                return self._cat(col.shape[2], 2, lambda lo, hi: (
                    op(col[:, :, lo:hi], other)))
            return run

        def rows_op(op):
            # relation (c, n, m, W, A) + per-row blocks -> (c, B, height,
            # ...): narrow every block to each task's output rows; the
            # relation is read in place, never stacked
            def run(rel, columns, starts, lengths, pat, height):
                if height == 0 or not len(columns):
                    return op(rel, columns, starts, lengths, pat, height)

                def one(lo, hi):
                    st, ln = _narrow(starts, lengths, lo, hi)
                    return op(rel, columns, st, ln, pat, hi - lo)
                return self._cat(height, 2, one)
            return run

        def ripple_segment(a, b, carry=None):
            # a: (..., lanes, k) bit planes — split the lanes; the whole
            # segment chains inside each task
            if a.ndim < 2 or a.shape[-2] == 0:
                return base.ripple_segment(a, b, carry)
            return self._cat2(a.shape[-2], lambda lo, hi: (
                base.ripple_segment(
                    a[..., lo:hi, :], b[..., lo:hi, :],
                    None if carry is None else carry[..., lo:hi])))

        def ripple_carry(a, b, carry=None):
            # a: (..., lanes) planes of one bit step
            if a.ndim < 1 or a.shape[-1] == 0:
                return base.ripple_carry(a, b, carry)
            return self._cat2(a.shape[-1], lambda lo, hi: (
                base.ripple_carry(a[..., lo:hi], b[..., lo:hi],
                                  None if carry is None
                                  else carry[..., lo:hi])))

        def match_matrix(bx, by):
            # bx: (c, nx, W, A) — split the left tuples
            if bx.shape[1] == 0:
                return base.match_matrix(bx, by)
            return self._cat(bx.shape[1], 1, lambda lo, hi: (
                base.match_matrix(bx[:, lo:hi], by)))

        def split(op, wrapped):
            return None if op is None else wrapped

        return Backend(
            name=f"{base.name}+mapreduce", ss_matmul=ss_matmul,
            aa_match_batch=tuples_dim2(base.aa_match_batch),
            aa_match_rows=rows_op(base.aa_match_rows),
            ripple_segment=split(base.ripple_segment, ripple_segment),
            ripple_carry=split(base.ripple_carry, ripple_carry),
            aa_slide_batch=split(base.aa_slide_batch,
                                 tuples_dim2(base.aa_slide_batch)),
            aa_slide_rows=split(base.aa_slide_rows,
                                rows_op(base.aa_slide_rows)),
            share_onehot=base.share_onehot,
            match_matrix=split(base.match_matrix, match_matrix),
            match_matrix_batch=split(base.match_matrix_batch,
                                     tuples_dim2(base.match_matrix_batch)))

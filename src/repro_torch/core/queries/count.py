"""Count query (paper §3.1, Algorithm 2; Theorem 1).

The user sends a secret-shared predicate (O(1) communication), each cloud
runs the accumulating automaton over the target attribute (nw work) and
returns ONE share; the user interpolates c' = deg+1 values. Prefer
``repro_torch.api.QueryClient.count``.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..costs import CostLedger
from ..dataplane import RelationLike
from . import rounds
from ._common import resolve_backend


def count_query(key, db: RelationLike, column: int, pattern: str, *,
                ledger: Optional[CostLedger] = None, backend=None
                ) -> Tuple[int, CostLedger]:
    """COUNT(*) WHERE col = pattern — oblivious, one round (the batched
    count phase at B = 1). ``key`` is a random-stream key
    (``repro_torch._device.Key``)."""
    ledger = ledger if ledger is not None else CostLedger()
    be = resolve_backend(backend)
    cnt = rounds.count_phase(
        be, db, [rounds.MatchJob(column, pattern, key, ledger)])[0]
    return cnt, ledger

"""Oblivious joins on secret-shares (paper §3.3).

``pkfk_join`` (§3.3.1): reducer *j* (one per child tuple) string-matches the
child's join value against ALL parent join values, multiplies the 0/1 share
into each parent tuple and sums — only the unique matching parent survives.
The match matrix is W chained ``ss_matmul`` launches (one per word
position, or one in the aggregate form), and the reducers' contraction is
a row block of the fused fetch ``ss_matmul``.

``equijoin`` (§3.3.2): two *layers* of c clouds. The user opens both join
columns, derives the common values and their tuple addresses; per common
value the first layer obliviously fetches the matching tuples (one-hot
fetch) and hands the still-shared results to its same-index second-layer
cloud, which emits the ℓx×ℓy concatenations. Clouds within a layer never
communicate.

Both are B = 1 wrappers over the batched round engine
(``repro_torch.core.queries.rounds``), so a join run here gives the same
rows and ``CostLedger`` as the same join inside a ``QueryClient.run_batch``
group. Prefer ``repro_torch.api.QueryClient.join``. ``pkfk_join`` is
key-first like the rest of the suite (the key re-randomizes the outgoing
shares so they cannot be linked to the stored relation); the key-less
positional form is still accepted. Keys are random-stream keys
(``repro_torch._device.Key``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..costs import CostLedger
from ..dataplane import RelationLike
from ..engine import SecretSharedDB
from . import rounds
from ._common import resolve_backend


def pkfk_join(*args, **kwargs) -> Tuple[List[List[str]], CostLedger]:
    """X ⋈ Y on X.col_x = Y.col_y, where col_x is a primary key of X.

    Canonical call: ``pkfk_join(key, dbX, dbY, col_x, col_y)``. The
    key-less form ``pkfk_join(dbX, dbY, col_x, col_y)`` (positional or with
    ``col_x=``/``col_y=`` keywords) skips the output re-randomization."""
    if args and isinstance(args[0], SecretSharedDB):     # key-less form
        args = (kwargs.pop("key", None),) + args
    return _pkfk_join(*args, **kwargs)


def _pkfk_join(key, dbX: RelationLike, dbY: SecretSharedDB, col_x: int,
               col_y: int, *, ledger: Optional[CostLedger] = None,
               backend=None) -> Tuple[List[List[str]], CostLedger]:
    ledger = ledger if ledger is not None else CostLedger()
    be = resolve_backend(backend)
    job = rounds.JoinJob(dbY, col_x, col_y, key, ledger)
    entries = rounds.join_match_round(be, dbX, [job])
    _, fetched = rounds.fetch_fusion(be, dbX, [], entries)
    return rounds.join_emit_round(dbX, [job], fetched)[0], ledger


def equijoin(key, dbX: RelationLike, dbY: SecretSharedDB, col_x: int,
             col_y: int, *, ledger: Optional[CostLedger] = None,
             padded_values: int = 0, backend=None
             ) -> Tuple[List[List[str]], CostLedger]:
    """General equijoin; join values may repeat in BOTH relations.
    ``padded_values`` adds fake (no-op) join values to hide k (the §3.3.2
    leakage discussion)."""
    ledger = ledger if ledger is not None else CostLedger()
    be = resolve_backend(backend)
    rows = rounds.equijoin_rounds(be, dbX, [
        rounds.EquiJob(dbY, col_x, col_y, key, ledger,
                       padded_values=padded_values)])[0]
    return rows, ledger

"""Selection queries on secret-shares (paper §3.2; Algorithms 3 & 4).

* ``select_one_tuple`` (§3.2.1, Alg 3) — match-bit × tuple summed over n;
  only the single satisfying tuple survives the sum.
* ``select_one_round`` (§3.2.2) — all n match bits in one round, then a
  shared ℓ'×n one-hot fetch matrix multiplied against the relation.
* ``select_tree`` (§3.2.2, Alg 4) — Q&A rounds of block counts; the user
  interpolates O(ℓ) values per round.

Thin wrappers over the batched round engine at B = 1; a query run here is
bit-identical (rows and ledger) to the same query inside a
``QueryClient.run_batch`` group. ``key`` arguments are random-stream keys
(``repro_torch._device.Key``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ... import _device
from ..costs import CostLedger
from ..dataplane import RelationLike
from . import rounds
from ._common import resolve_backend
from .count import count_query


class CardinalityError(ValueError):
    """A selection algorithm's ℓ precondition failed (one_tuple on a
    multi-match predicate). Carries the true ``count`` the aborted count
    phase learned, so callers can replan without re-counting."""

    def __init__(self, message: str, *, count: Optional[int] = None):
        super().__init__(message)
        self.count = count


def select_one_tuple(key, db: RelationLike, column: int, pattern: str, *,
                     ledger: Optional[CostLedger] = None,
                     skip_count_phase: bool = False, backend=None
                     ) -> Tuple[List[List[str]], CostLedger]:
    """SELECT * WHERE col = pattern, when the predicate hits exactly 1 tuple."""
    ledger = ledger if ledger is not None else CostLedger()
    be = resolve_backend(backend)
    k_count, k_sel = _device.split(key)
    if not skip_count_phase:                       # Phase 0 (Alg 3 line 1)
        ell, ledger = count_query(k_count, db, column, pattern, ledger=ledger,
                                  backend=be)
        if ell != 1:
            raise CardinalityError(
                f"select_one_tuple needs ℓ=1, predicate has {ell}"
                " — use select_one_round/select_tree", count=ell)
    row = rounds.one_tuple_round(
        be, db, [rounds.MatchJob(column, pattern, k_sel, ledger)])[0]
    return [row], ledger


def fetch_by_addresses(key, db: RelationLike, addresses: Sequence[int], *,
                       ledger: CostLedger, padded_rows: Optional[int] = None,
                       backend=None) -> List[List[str]]:
    """Fetch tuples at known addresses with an ℓ'×n shared one-hot matrix;
    ``padded_rows`` ≥ ℓ adds all-zero rows that fetch nothing."""
    be = resolve_backend(backend)
    return rounds.fetch_round(
        be, db, [rounds.FetchJob(key, list(addresses), ledger,
                                 padded_rows)])[0]


def select_one_round(key, db: RelationLike, column: int, pattern: str, *,
                     ledger: Optional[CostLedger] = None,
                     padded_rows: Optional[int] = None, backend=None
                     ) -> Tuple[List[List[str]], List[int], CostLedger]:
    """Phase 1: per-tuple match bits in ONE round. Phase 2: oblivious fetch."""
    ledger = ledger if ledger is not None else CostLedger()
    be = resolve_backend(backend)
    k_pat, k_fetch = _device.split(key)
    addresses = rounds.match_all_round(
        be, db, [rounds.MatchJob(column, pattern, k_pat, ledger)])[0]
    rows = rounds.fetch_round(
        be, db, [rounds.FetchJob(k_fetch, addresses, ledger,
                                 padded_rows)])[0]
    return rows, addresses, ledger


def select_tree(key, db: RelationLike, column: int, pattern: str, *,
                ledger: Optional[CostLedger] = None,
                branching: Optional[int] = None,
                padded_rows: Optional[int] = None,
                known_count: Optional[int] = None, backend=None
                ) -> Tuple[List[List[str]], List[int], CostLedger]:
    """Tree-based address discovery + oblivious fetch (Alg 4). Rounds ≤
    ⌊log_ℓ n⌋ + ⌊log₂ ℓ⌋ + 1 (Theorem 4). ``known_count`` skips the
    Phase-0 count when the caller already ran it."""
    ledger = ledger if ledger is not None else CostLedger()
    be = resolve_backend(backend)
    k_count, k_pat, k_fetch = _device.split(key, 3)
    if known_count is None:
        ell, ledger = count_query(k_count, db, column, pattern, ledger=ledger,
                                  backend=be)
    else:
        ell = known_count
    if ell == 0:
        return [], [], ledger
    addresses = rounds.tree_rounds(
        be, db, [rounds.TreeJob(column, pattern, k_pat, ledger,
                                ell=ell, branching=branching)])[0]
    rows = rounds.fetch_round(
        be, db, [rounds.FetchJob(k_fetch, addresses, ledger,
                                 padded_rows)])[0]
    return rows, addresses, ledger

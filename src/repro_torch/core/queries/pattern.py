"""Pattern-predicate queries (LIKE / prefix / suffix / substring) on
secret-shares — the §3.1 accumulating automaton generalised past exact
equality.

Lowering (``repro_torch.core.encoding.parse_like`` builds the spec):

* wildcard-free LIKE  → **exact**: not handled here; the client rewrites it
  onto the Eq path.
* ``J_hn%`` (masked)  → the full-width chain with a masked pattern
  encoding: wildcard positions share the all-ones vector, trailing
  positions the terminator one-hot. Rides the ``aa_match_batch`` stack.
* ``Jo%`` (prefix)    → a truncated k-chain over ``col[..., :k, :]``.
* ``%hn`` (suffix)    → sliding-window products (``aa_slide_batch``) × the
  terminator factor; windows are mutually exclusive for wildcard-free
  tiles, so the linear sum is the exact 0/1 bit.
* ``%oh%`` (contains) → the window count P ∈ {0..M}, one degree-reduction
  re-share (the family's only extra round), then the share-local zero
  test ``1 − Π_{j=1..M}(j−P)/M!``.

All four kinds keep the final match-bit degree at most the exact chain's
2tW, so a relation that supports equality selects supports pattern
selects. The free functions run the batch engine at B = 1; inside a
``QueryClient.run_batch`` group the same code runs fused.
:func:`match_phase_cost` is what the engine charges and what the planner
prices, so ``explain()`` is exact for pattern counts and one-round selects.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ... import _device
from .. import encoding
from ..costs import CostLedger
from ..dataplane import RelationLike
from . import rounds
from ._common import resolve_backend
from .rounds import match_phase_cost  # noqa: F401  (re-export)


def like_spec(codec: encoding.Codec, pattern: str
              ) -> Optional[encoding.PatternSpec]:
    """Lower a LIKE pattern string to its :class:`~.encoding.PatternSpec`,
    or ``None`` when it is wildcard-free (the exact-equality path). Raises
    ``ValueError`` for unsupported shapes (interior ``%``, ``_`` under a
    leading ``%``, empty body, k > word_length)."""
    kind, body, wild = encoding.parse_like(pattern)
    if kind == "exact":
        return None
    spec = encoding.PatternSpec(kind, body, wild, pattern)
    encoding.encode_pattern_tile(codec, spec)       # fail at lowering time
    return spec


def pattern_count(key, db: RelationLike, column: int,
                  spec: encoding.PatternSpec, *,
                  ledger: Optional[CostLedger] = None,
                  backend=None) -> Tuple[int, CostLedger]:
    """COUNT(*) WHERE col LIKE pattern — one round (two for CONTAINS).
    ``key`` is a random-stream key (``repro_torch._device.Key``)."""
    ledger = ledger if ledger is not None else CostLedger()
    cnt = rounds.count_phase(
        resolve_backend(backend), db,
        [rounds.MatchJob(column, spec.body, key, ledger, spec)])[0]
    return cnt, ledger


def pattern_select(key, db: RelationLike, column: int,
                   spec: encoding.PatternSpec, *, strategy: str = "one_round",
                   ell: Optional[int] = None,
                   padded_rows: Optional[int] = None,
                   ledger: Optional[CostLedger] = None, backend=None
                   ) -> Tuple[List[List[str]], List[int], CostLedger]:
    """SELECT * WHERE col LIKE pattern via ``one_round`` or ``tree``.

    ``tree`` needs the match cardinality ℓ (run :func:`pattern_count`
    first, as the Eq tree's Phase 0 does); ``one_round`` does not. The
    §3.2.1 one-tuple special case stays exact-equality only. Returns
    ``(rows, addresses, ledger)``."""
    ledger = ledger if ledger is not None else CostLedger()
    be = resolve_backend(backend)
    k_pat, k_fetch = _device.split(key)
    if strategy == "one_round":
        addresses = rounds.match_all_round(
            be, db,
            [rounds.MatchJob(column, spec.body, k_pat, ledger, spec)])[0]
    elif strategy == "tree":
        if ell is None:
            raise ValueError("tree strategy needs ell (run pattern_count)")
        if ell == 0:
            return [], [], ledger
        addresses = rounds.tree_rounds(
            be, db, [rounds.TreeJob(column, spec.body, k_pat, ledger, spec,
                                    ell=ell)])[0]
    else:
        raise ValueError(
            f"pattern selects support one_round/tree, not {strategy!r}")
    rows = rounds.fetch_round(
        be, db, [rounds.FetchJob(k_fetch, addresses, ledger,
                                 padded_rows)])[0]
    return rows, addresses, ledger

"""Cost-based selection-strategy planner (paper §3.2 / Table 1 formulas).

Static ``(bits, rounds, dispatches)`` estimates in the units ``CostLedger``
records (field elements × 31 bits), computed from the public relation
statistics (n, m, w, A, c) and the cardinality hint ℓ alone:

  one_tuple  (§3.2.1, Alg 3): count + pattern + one m·w·A tuple; 2 rounds.
  one_round  (§3.2.2):        pattern + n match bits + ℓ'×n fetch; 2 rounds.
  tree       (§3.2.2, Alg 4): count + pattern + per-round block counts +
               ℓ address fetches + ℓ'×n fetch;
               rounds ≤ ⌊log_ℓ n⌋ + ⌊log₂ ℓ⌋ + 1 (+ count + fetch).

The formulas are the reference planner's (``repro.api.planner``), so the
port picks the same strategy for the same statistics. ``dispatches`` prices
the per-shard device fan-out, an execution cost that never enters bits or
rounds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Mapping, Optional, Sequence, Tuple

from ..core.costs import WORD_BITS
from ..core.dataplane import ShardedRelation

#: ℓ assumed when a plan carries no ``expected_matches`` hint: the smallest
#: multi-match cardinality (keeps one_tuple out of the running).
DEFAULT_ELL = 2


class PlanNotSupported(TypeError):
    """A plan object no estimator/executor of this port knows."""

    def __init__(self, plan, context: str = "plan"):
        self.plan = plan
        super().__init__(
            f"unsupported {context}: {type(plan).__name__!r} "
            f"({plan!r}) is not a known logical plan class")


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Planner-side (bits, rounds, per-shard dispatches) prediction."""
    strategy: str
    bits: int
    rounds: int
    dispatches: int = 0

    def score(self, round_cost_bits: int = 0) -> int:
        """Total cost with rounds priced at ``round_cost_bits`` each."""
        return self.bits + round_cost_bits * self.rounds


@dataclasses.dataclass(frozen=True)
class DBStats:
    """The public statistics the planner works from (§2.3: n, m and the
    schema are public). ``shards`` scales dispatch estimates only."""
    n: int          # tuples
    m: int          # attributes
    c: int          # clouds / shares
    w: int          # word length
    a: int          # alphabet size
    shards: int = 1

    @classmethod
    def of(cls, db, shards: Optional[int] = None) -> "DBStats":
        if isinstance(db, ShardedRelation):
            shards = db.n_shards if shards is None else shards
            db = db.db
        return cls(n=db.n_tuples, m=db.n_attrs, c=db.n_shares,
                   w=db.codec.word_length, a=db.codec.alphabet_size,
                   shards=shards or 1)


def _shards(s: DBStats) -> int:
    return max(1, min(s.shards, max(s.n, 1)))


def _pattern_elems(s: DBStats) -> int:
    return s.c * s.w * s.a


def _count_elems(s: DBStats) -> int:
    # Alg 2: pattern up, one word per cloud down.
    return _pattern_elems(s) + s.c


def _fetch_elems(s: DBStats, ell: int, padded_rows: Optional[int]) -> int:
    # ℓ'×n one-hot matrix up, ℓ' tuples down.
    ellp = max(padded_rows or ell, ell)
    return s.c * ellp * s.n + s.c * ellp * s.m * s.w * s.a


def estimate_select_cost(strategy: str, stats: DBStats, *,
                         ell: int = DEFAULT_ELL,
                         padded_rows: Optional[int] = None) -> CostEstimate:
    """(bits, rounds, dispatches) for one §3.2 strategy at cardinality ℓ."""
    s = stats
    S = _shards(s)
    if strategy == "one_tuple":
        if ell != 1:
            raise ValueError("one_tuple requires ℓ = 1")
        elems = _count_elems(s) + _pattern_elems(s) + s.c * s.m * s.w * s.a
        return CostEstimate("one_tuple", elems * WORD_BITS, rounds=2,
                            dispatches=2 * S)    # count step + map step
    if strategy == "one_round":
        elems = _pattern_elems(s) + s.c * s.n + _fetch_elems(s, ell,
                                                             padded_rows)
        return CostEstimate("one_round", elems * WORD_BITS, rounds=2,
                            dispatches=2 * S)    # match step + fetch step
    if strategy == "tree":
        if ell <= 1:
            # Alg 4 line 2: count, one whole-table Address_fetch, fetch.
            elems = (_count_elems(s) + _pattern_elems(s) + s.c
                     + _fetch_elems(s, max(ell, 1), padded_rows))
            return CostEstimate("tree", elems * WORD_BITS, rounds=3,
                                dispatches=3 * S)
        qa_rounds = (math.floor(math.log(max(s.n, 2), ell))
                     + math.floor(math.log2(ell)) + 1)       # Theorem 4
        elems = (_count_elems(s) + _pattern_elems(s)
                 + qa_rounds * ell * s.c                     # block counts
                 + ell * s.c                                 # address fetches
                 + _fetch_elems(s, ell, padded_rows))
        return CostEstimate("tree", elems * WORD_BITS,
                            rounds=1 + qa_rounds + 1,
                            dispatches=(2 + qa_rounds + 1) * S)
    raise ValueError(f"unknown selection strategy {strategy!r}")


def estimate_count_cost(stats: DBStats) -> CostEstimate:
    """§3.1 Algorithm 2: one round, O(1) comm, one count step per shard."""
    return CostEstimate("count", _count_elems(stats) * WORD_BITS, rounds=1,
                        dispatches=_shards(stats))


def candidate_estimates(stats: DBStats, *, ell: Optional[int] = None,
                        padded_rows: Optional[int] = None
                        ) -> List[CostEstimate]:
    """All eligible strategies for cardinality hint ℓ (None = unknown)."""
    ell_eff = DEFAULT_ELL if ell is None else max(ell, 1)
    out = []
    if ell == 1 and not padded_rows:
        out.append(estimate_select_cost("one_tuple", stats, ell=1))
    for strat in ("one_round", "tree"):
        out.append(estimate_select_cost(strat, stats, ell=ell_eff,
                                        padded_rows=padded_rows))
    return out


def _riding_key(round_cost_bits: int,
                group_sizes: Optional[Mapping[str, int]],
                group_rounds: Optional[Mapping[str, int]]):
    """Batching-aware scoring: a strategy whose group is already running
    pays only its *marginal* rounds beyond the group's deepest member."""
    def key(e: CostEstimate):
        riding = bool(group_sizes) and group_sizes.get(e.strategy, 0) > 0
        if riding:
            depth = (group_rounds or {}).get(e.strategy)
            marginal_rounds = (0 if depth is None
                               else max(0, e.rounds - depth))
        else:
            marginal_rounds = e.rounds
        return (e.bits + round_cost_bits * marginal_rounds, e.rounds)
    return key


def choose_select_strategy(stats: DBStats, *, ell: Optional[int] = None,
                           padded_rows: Optional[int] = None,
                           round_cost_bits: int = 0,
                           group_sizes: Optional[Mapping[str, int]] = None,
                           group_rounds: Optional[Mapping[str, int]] = None
                           ) -> CostEstimate:
    """Pick the paper-optimal strategy: min bits, rounds as tie-break
    (``round_cost_bits`` prices a round). ``group_sizes``/``group_rounds``
    make the choice batching-aware: joining a running group of a
    ``run_batch`` costs only the rounds the rider adds beyond the group's
    deepest member. With ``round_cost_bits = 0`` the choice equals
    sequential planning."""
    cands = candidate_estimates(stats, ell=ell, padded_rows=padded_rows)
    return min(cands, key=_riding_key(round_cost_bits, group_sizes,
                                      group_rounds))


def estimate_batch_group_cost(stats: DBStats, strategy: str, *,
                              ells: Sequence[Optional[int]],
                              padded_rows: Optional[int] = None
                              ) -> CostEstimate:
    """Price a whole ``run_batch`` selection group: bits add up query by
    query; rounds and dispatches are the deepest member's."""
    ests = [estimate_select_cost(
        strategy, stats, ell=DEFAULT_ELL if e is None else max(e, 1),
        padded_rows=padded_rows) for e in ells]
    return CostEstimate(strategy,
                        bits=sum(e.bits for e in ests),
                        rounds=max((e.rounds for e in ests), default=0),
                        dispatches=max((e.dispatches for e in ests),
                                       default=0))


#: group families whose oblivious fetch rides the single cross-group
#: ``ss_matmul`` of ``run_batch`` (the batch pays the fetch step once).
FETCH_RIDERS = ("one_round", "tree")


@dataclasses.dataclass(frozen=True)
class GroupEstimate:
    """One ``run_batch`` group's predicted ledger."""
    family: str                 # count / one_tuple / one_round / tree
    size: int                   # member queries
    estimate: CostEstimate      # bits summed, rounds/dispatches fused


@dataclasses.dataclass(frozen=True)
class BatchExplanation:
    """Predicted ``run_batch`` ledger: bits sum over every member, rounds
    are the deepest group's, dispatches count the shared fetch once."""
    groups: Tuple[GroupEstimate, ...]
    bits: int
    rounds: int
    dispatches: int
    shards: int


def explain_batch_groups(stats: DBStats,
                         groups: Sequence[GroupEstimate]
                         ) -> BatchExplanation:
    """Assemble per-group estimates into the batch-level prediction."""
    S = _shards(stats)
    riders = sum(1 for g in groups
                 if g.family in FETCH_RIDERS and g.size > 0)
    dispatches = sum(g.estimate.dispatches for g in groups)
    if riders > 1:
        dispatches -= (riders - 1) * S      # ONE shared fetch dispatch set
    return BatchExplanation(
        groups=tuple(groups),
        bits=sum(g.estimate.bits for g in groups),
        rounds=max((g.estimate.rounds for g in groups), default=0),
        dispatches=dispatches, shards=S)

"""Cost-based selection-strategy planner (paper §3.2 / Table 1 formulas).

Static ``(bits, rounds, dispatches)`` estimates in the units ``CostLedger``
records (field elements × 31 bits), computed from the public relation
statistics (n, m, w, A, c) and the cardinality hint ℓ alone:

  one_tuple  (§3.2.1, Alg 3): count + pattern + one m·w·A tuple; 2 rounds.
  one_round  (§3.2.2):        pattern + n match bits + ℓ'×n fetch; 2 rounds.
  tree       (§3.2.2, Alg 4): count + pattern + per-round block counts +
               ℓ address fetches + ℓ'×n fetch;
               rounds ≤ ⌊log_ℓ n⌋ + ⌊log₂ ℓ⌋ + 1 (+ count + fetch).

Range plans (§3.4), aggregates (SUM/AVG/MIN/MAX), joins (§3.3) and
embedding lookups have one algorithm each; :func:`estimate_range_cost`,
:func:`estimate_aggregate_cost`, :func:`estimate_pkfk_cost`,
:func:`estimate_equijoin_cost` and :func:`estimate_embed_cost` price them
in the same units. A PK/FK join's match method (chain or aggregate, the
same secrets and ledger) is priced by launch count
(:func:`choose_match_method`).
Pattern predicates price their match phase with the round engine's own
``match_phase_cost`` (:func:`estimate_pattern_cost`) and choose between
one_round and tree only.

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
from ..core.encoding import PatternSpec
from ..core.queries.rounds import match_phase_cost

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
    schema are public). ``shards`` scales dispatch estimates only.
    ``relation`` names the registry entry these statistics describe: with
    several relations attached, every estimate is priced at the target
    relation's own n and shard count."""
    n: int          # tuples
    m: int          # attributes
    c: int          # clouds / shares
    w: int          # word length
    a: int          # alphabet size
    shards: int = 1
    relation: str = ""

    @classmethod
    def of(cls, db, shards: Optional[int] = None,
           relation: str = "") -> "DBStats":
        if isinstance(db, ShardedRelation):
            shards = db.n_shards if shards is None else shards
            db = db.db
        return cls(n=db.n_tuples, m=db.n_attrs, c=db.n_shares,
                   w=db.codec.word_length, a=db.codec.alphabet_size,
                   shards=shards or 1, relation=relation)


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


def estimate_pattern_cost(stats: DBStats, spec: Optional[PatternSpec], *,
                          select: Optional[str] = None,
                          ell: int = DEFAULT_ELL,
                          padded_rows: Optional[int] = None) -> CostEstimate:
    """Price a pattern COUNT (``select=None``) or SELECT (``select=
    "one_round" | "tree"``) from the atoms the round engine charges
    (``match_phase_cost``), so the prediction is exact against the
    measured ledger for pattern counts and one-round selects, and a
    Theorem-4-style bound for the tree.

    ``spec=None`` is a wildcard-free predicate lowered to the exact path:
    the estimate equals :func:`estimate_count_cost` /
    :func:`estimate_select_cost` field for field. The CONTAINS re-share
    adds its round and c² + n·M elements wherever the match phase runs
    (count, one_round Phase 1, and tree Phase 0 and prelude — twice for a
    CONTAINS tree)."""
    s = stats
    S = _shards(s)
    cost = match_phase_cost(spec, n=s.n, c=s.c, w=s.w, a=s.a)
    match_elems = cost["send"] + cost["reduce_send"]
    rr = cost["reduce_rounds"]
    if select is None:
        return CostEstimate("count", (match_elems + s.c) * WORD_BITS,
                            rounds=1 + rr, dispatches=S)
    ell = max(ell, 1)
    if select == "one_round":
        elems = match_elems + s.c * s.n + _fetch_elems(s, ell, padded_rows)
        return CostEstimate("one_round", elems * WORD_BITS,
                            rounds=2 + rr, dispatches=2 * S)
    if select == "tree":
        count_elems = match_elems + s.c          # Phase 0 runs the pattern
        if ell <= 1:
            elems = (count_elems + match_elems + s.c
                     + _fetch_elems(s, 1, padded_rows))
            return CostEstimate("tree", elems * WORD_BITS,
                                rounds=3 + 2 * rr, dispatches=3 * S)
        qa_rounds = (math.floor(math.log(max(s.n, 2), ell))
                     + math.floor(math.log2(ell)) + 1)       # Theorem 4
        elems = (count_elems + match_elems
                 + qa_rounds * ell * s.c                     # block counts
                 + ell * s.c                                 # address fetches
                 + _fetch_elems(s, ell, padded_rows))
        return CostEstimate("tree", elems * WORD_BITS,
                            rounds=1 + qa_rounds + 1 + 2 * rr,
                            dispatches=(2 + qa_rounds + 1) * S)
    raise ValueError(f"pattern selects support one_round/tree, "
                     f"not {select!r}")


def candidate_pattern_estimates(stats: DBStats,
                                spec: Optional[PatternSpec], *,
                                ell: Optional[int] = None,
                                padded_rows: Optional[int] = None
                                ) -> List[CostEstimate]:
    """Eligible strategies for a pattern select: ``one_round`` and
    ``tree`` only (``one_tuple`` is the exact-equality special case, even
    at an ℓ = 1 hint)."""
    ell_eff = DEFAULT_ELL if ell is None else max(ell, 1)
    return [estimate_pattern_cost(stats, spec, select=strat, ell=ell_eff,
                                  padded_rows=padded_rows)
            for strat in ("one_round", "tree")]


#: backend launches one PK/FK match-matrix evaluation takes per method:
#: the §3.1.2 chain walks the word one dot set per position; the aggregate
#: form flattens all W·A products into ONE contraction plus the equality
#: indicator (2 launches, any W).
MATCH_METHOD_LAUNCHES = {"chain": lambda w: w, "aggregate": lambda w: 2}


def estimate_match_method_launches(stats: DBStats, method: str) -> int:
    """Device launches for one match-matrix evaluation under ``method``."""
    try:
        return MATCH_METHOD_LAUNCHES[method](stats.w)
    except KeyError:
        raise ValueError(f"unknown match_method {method!r}; choose from "
                         f"('chain', 'aggregate')") from None


def choose_match_method(stats: DBStats, method: str = "auto") -> str:
    """Resolve a ``Join.match_method``. Both methods open the same match
    matrix at the same degree with identical ledgers, so bits and rounds
    never discriminate; AUTO takes the method with fewer launches
    (``aggregate`` whenever W > 2)."""
    if method != "auto":
        estimate_match_method_launches(stats, method)   # validate
        return method
    return min(("chain", "aggregate"),
               key=lambda m: estimate_match_method_launches(stats, m))


def estimate_range_cost(stats: DBStats, *, t_bits: int,
                        reduce_every: int = 0, want_addresses: bool = False,
                        ell: int = DEFAULT_ELL,
                        padded_rows: Optional[int] = None) -> CostEstimate:
    """§3.4 Algorithms 5/6: the SS-SUB ripple over a t-bit column.

    Both endpoints up (2·c·t elements), one 2c² re-share per
    degree-reduction boundary (two logical rounds each, one per
    subtraction), then the count (c) or the n indicator bits plus the
    oblivious fetch down. Dispatches: one ripple segment per boundary
    interval per shard, plus the fetch step."""
    s = stats
    S = _shards(s)
    n_red = (t_bits - 1) // reduce_every if reduce_every > 0 else 0
    elems = s.c * 2 * t_bits + n_red * 2 * s.c * s.c
    rounds = 1 + 2 * n_red
    dispatches = (n_red + 1) * S
    if want_addresses:
        elems += s.c * s.n + _fetch_elems(s, ell, padded_rows)
        rounds += 1
        dispatches += S                              # the oblivious fetch
        name = "range_select"
    else:
        elems += s.c
        name = "range_count"
    return CostEstimate(name, elems * WORD_BITS, rounds=rounds,
                        dispatches=dispatches)


def estimate_aggregate_cost(stats: DBStats, op: str, *, t_bits: int,
                            conditional: bool = False, verify: bool = False,
                            reduce_every: int = 0) -> CostEstimate:
    """Aggregation over a t-bit numeric column, exactly as it charges the
    ledger.

    sum:     one contraction round — pattern up (conditional only), the
             scalar sum share back from each cloud.
    avg:     the sum plus (conditional only) the §3.1 count round for the
             denominator; an unconditional AVG divides by the public n.
    min/max: ⌈log₂ n⌉ comparator levels — each pays its ``reduce_every``
             carry reductions (one c² re-share round each) and every level
             but the last one inter-level re-share; conditional jobs add
             the sentinel-mask re-share round and open the match count.
    verify:  +1 round and c checksum elements per opened tensor.
    """
    s = stats
    S = _shards(s)
    if op in ("sum", "avg"):
        elems = s.c + (s.c * s.w * s.a if conditional else 0)
        rounds, dispatches = 1, S
        if op == "avg" and conditional:
            elems += _count_elems(s)
            rounds += 1
            dispatches += S
        if verify:
            rounds += 1
            elems += s.c
        return CostEstimate(f"agg_{op}", elems * WORD_BITS, rounds=rounds,
                            dispatches=dispatches)
    if op in ("min", "max"):
        levels = math.ceil(math.log2(s.n)) if s.n > 1 else 0
        n_red = (t_bits - 1) // reduce_every if reduce_every > 0 else 0
        elems = (levels * n_red * s.c * s.c          # carry reductions
                 + max(levels - 1, 0) * s.c * s.c    # inter-level re-shares
                 + s.c * t_bits)                     # final value opening
        rounds = 1 + levels * n_red + max(levels - 1, 0)
        dispatches = levels * (n_red + 1)
        if conditional:
            elems += s.c * s.w * s.a + s.c * s.c + s.c
            rounds += 1
            dispatches += S
        if verify:
            rounds += 1
            elems += s.c * (2 if conditional else 1)
        return CostEstimate(f"agg_{op}", elems * WORD_BITS, rounds=rounds,
                            dispatches=dispatches)
    raise ValueError(f"unknown aggregate op {op!r}")


def estimate_embed_cost(stats: DBStats, *, n_tokens: int,
                        verify: bool = False) -> CostEstimate:
    """§3.2.1 as the LM embedding layer: one fused lookup round.

    The relation is the shared ``(c, V, D)`` table (``n`` = V vocab rows,
    ``m`` = D model dims). The step's ``n_tokens`` shared one-hots go up
    (c·n_tok·V), the picked embedding share rows come down (c·n_tok·D),
    all in ONE contraction — dispatches = S (one ``ss_matmul`` per shard).
    ``verify=`` adds the consistency round and c checksum elements.
    """
    s = stats
    elems = s.c * n_tokens * s.n + s.c * n_tokens * s.m
    rounds = 1
    if verify:
        rounds += 1
        elems += s.c
    return CostEstimate("embed", elems * WORD_BITS, rounds=rounds,
                        dispatches=_shards(s))


def estimate_pkfk_cost(stats: DBStats, right: DBStats) -> CostEstimate:
    """§3.3.1: the match-matrix step (per shard), the shared fetch, and one
    round shipping every reducer's (parent ⊕ child) concatenation."""
    s = stats
    elems = s.c * right.n * (s.m + right.m) * s.w * s.a
    return CostEstimate("pkfk", elems * WORD_BITS, rounds=1,
                        dispatches=2 * _shards(s))    # match + fetch steps


def estimate_equijoin_cost(stats: DBStats, right: DBStats, *,
                           values: int = 1,
                           fake_values: int = 0) -> CostEstimate:
    """§3.3.2 (Thm 6): the column-open round + 2 rounds per (fake) common
    value. ``values`` is the caller's guess at k (the true count is data
    the planner cannot see); value groups are assumed singletons.
    Dispatches: the X-side layer-1 matmul per shard, the Y side against
    the (unsharded) right relation."""
    s = stats
    k = max(0, values) + max(0, fake_values)
    elems = (s.c * s.n * s.w * s.a + right.c * right.n * s.w * s.a  # open
             + k * (s.c * s.n + right.c * right.n)       # layer-1 one-hots
             + k * s.c * (s.m + right.m) * s.w * s.a)    # layer-2 pairs
    return CostEstimate("equi", elems * WORD_BITS, rounds=1 + 2 * k,
                        dispatches=_shards(s) + 1)


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


def choose_pattern_strategy(stats: DBStats, spec: Optional[PatternSpec], *,
                            ell: Optional[int] = None,
                            padded_rows: Optional[int] = None,
                            round_cost_bits: int = 0,
                            group_sizes: Optional[Mapping[str, int]] = None,
                            group_rounds: Optional[Mapping[str, int]] = None
                            ) -> CostEstimate:
    """:func:`choose_select_strategy` for a pattern predicate: the same
    scoring over the pattern-eligible candidates (one_round / tree)."""
    cands = candidate_pattern_estimates(stats, spec, ell=ell,
                                        padded_rows=padded_rows)
    return min(cands, key=_riding_key(round_cost_bits, group_sizes,
                                      group_rounds))


def estimate_batch_group_cost(stats: DBStats, strategy: str, *,
                              ells: Sequence[Optional[int]],
                              padded_rows: Optional[int] = None,
                              specs: Optional[Sequence[
                                  Optional[PatternSpec]]] = None
                              ) -> CostEstimate:
    """Price a whole ``run_batch`` selection group: bits add up query by
    query; rounds and dispatches are the deepest member's. ``specs``
    aligns with ``ells`` and prices pattern members through
    :func:`estimate_pattern_cost` (``None`` is an exact member)."""
    specs = specs if specs is not None else [None] * len(ells)
    ests = [estimate_pattern_cost(
        stats, spec, select=strategy,
        ell=DEFAULT_ELL if e is None else max(e, 1),
        padded_rows=padded_rows)
        if spec is not None and strategy != "one_tuple"
        else estimate_select_cost(
            strategy, stats, ell=DEFAULT_ELL if e is None else max(e, 1),
            padded_rows=padded_rows)
        for e, spec in zip(ells, specs)]
    return CostEstimate(strategy,
                        bits=sum(e.bits for e in ests),
                        rounds=max((e.rounds for e in ests), default=0),
                        dispatches=max((e.dispatches for e in ests),
                                       default=0))


#: group families whose oblivious fetch rides the single cross-group
#: ``ss_matmul`` of ``run_batch`` (the batch pays the fetch step once).
FETCH_RIDERS = ("one_round", "tree", "range_select", "pkfk")


@dataclasses.dataclass(frozen=True)
class GroupEstimate:
    """One ``run_batch`` group's predicted ledger."""
    family: str                 # count/one_tuple/one_round/tree/range_*/…
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
    relation: str = ""


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
        dispatches=dispatches, shards=S, relation=stats.relation)


def _has_fetch(part: BatchExplanation) -> bool:
    return any(g.family in FETCH_RIDERS and g.size > 0 for g in part.groups)


@dataclasses.dataclass(frozen=True)
class MultiBatchExplanation:
    """Predicted ledgers for a fused multi-relation ``run_batch_multi``.

    The parts are the solo :class:`BatchExplanation`\\ s: fusion only
    co-schedules independent shard dispatches, so no relation's bits,
    rounds or dispatch fan-out moves. What fusion buys is waves: the
    ``fetch_parts`` relations that would each close with their own fetch
    wave share ONE (``fetch_waves``)."""
    parts: Tuple[BatchExplanation, ...]
    bits: int                   # Σ parts
    rounds: int                 # deepest part (waves run side by side)
    dispatches: int             # Σ parts
    fetch_parts: int            # relations riding the shared fetch wave
    fetch_waves: int            # 1 when >= 2 parts fuse, else fetch_parts


def explain_multi_batches(parts: Sequence[BatchExplanation]
                          ) -> MultiBatchExplanation:
    """Price a prospective ``run_batch_multi`` from its solo predictions."""
    fetch_parts = sum(1 for p in parts if _has_fetch(p))
    return MultiBatchExplanation(
        parts=tuple(parts), bits=sum(p.bits for p in parts),
        rounds=max((p.rounds for p in parts), default=0),
        dispatches=sum(p.dispatches for p in parts),
        fetch_parts=fetch_parts,
        fetch_waves=1 if fetch_parts > 1 else fetch_parts)

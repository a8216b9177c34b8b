"""QueryClient — the user-side facade over the secret-shared clouds.

One object owns the root random stream (per-query keys fold a counter into
the client seed, so identical plan sequences replay identically), the
backend (by default ``"cuda"``: the kernels on a GPU, their plain versions
on the CPU) and
the cost-based selection planner. Every query returns a
:class:`~.plans.QueryResult`.

Every plan runs through the batched round engine
(``repro_torch.core.queries.rounds``): :meth:`QueryClient.run_batch`
cost-plans each query, groups Count/Select plans by algorithm, stacks their
predicates so each protocol round runs once per group (one fused dispatch +
one interpolation), and sends every oblivious fetch of the batch through
ONE cross-group ``ss_matmul``. :meth:`QueryClient.run` is the B = 1 case,
so rows and ``CostLedger`` totals are identical between a batch and the
equivalent sequential calls.

This slice serves ``Count`` and ``Select`` over ``Eq``; any other plan
raises :class:`~.planner.PlanNotSupported`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .. import _device
from ..core.costs import CostLedger
from ..core.dataplane import ShardedRelation
from ..core.engine import SecretSharedDB
from ..core.queries import CardinalityError, rounds
from . import planner as _planner
from .backends import DEFAULT_BACKEND, BackendLike, get_backend
from .plans import (AUTO, ColumnRef, Count, Eq, Padding, Plan, QueryResult,
                    Select, resolve_column)


def _lower_match(db: SecretSharedDB, where, context: str) -> int:
    """Lower a Count/Select predicate -> column index (``Eq`` only)."""
    if isinstance(where, Eq):
        return resolve_column(db, where.column)
    raise _planner.PlanNotSupported(where, context)


@dataclasses.dataclass
class _Slot:
    """One plan's execution state inside a batch."""
    idx: int
    plan: Plan
    key: _device.Key
    ledger: CostLedger = dataclasses.field(default_factory=CostLedger)
    strategy: str = ""
    known_count: Optional[int] = None
    column: int = -1
    pattern: str = ""


class QueryClient:
    """Authorized-user facade over one outsourced relation.

    db:              the secret-shared relation (``core.outsource`` or
                     ``core.from_arrays``), or a ``ShardedRelation`` of it.
    seed:            root of the per-query random streams.
    backend:         registered backend name or ``Backend``; default
                     ``"cuda"``, which launches the kernels on a CUDA device
                     and runs their plain versions on the CPU.
    device:          where the queries run; default ``"cuda"``, which raises
                     without a GPU. Must be where ``db`` lives.
    round_cost_bits: planner latency weight (bits one extra round is worth).
    """

    def __init__(self, db: Union[SecretSharedDB, ShardedRelation],
                 seed: int = 0, *, backend: Optional[BackendLike] = None,
                 device=None, round_cost_bits: int = 0):
        dev = _device.resolve(device)
        self.rel = db
        self.db = db.db if isinstance(db, ShardedRelation) else db
        if self.db.device.type != dev.type:
            raise ValueError(f"relation lives on {self.db.device}, client "
                             f"asked for {dev}")
        self.device = dev
        self.backend = get_backend(backend if backend is not None
                                   else DEFAULT_BACKEND)
        self.round_cost_bits = round_cost_bits
        self._root = _device.as_key(seed)
        self._counter = itertools.count()

    def _next_key(self) -> _device.Key:
        return _device.fold(self._root, next(self._counter))

    # -- planning -----------------------------------------------------------
    def stats(self) -> _planner.DBStats:
        return _planner.DBStats.of(self.rel)

    def explain(self, plan: Union[Plan, Sequence[Plan]]):
        """Planner predictions without touching shares.

        One ``Select`` -> its eligible strategy estimates, cheapest first.
        A ``Count`` -> its batch-of-one :class:`~.planner.BatchExplanation`.
        A sequence of plans -> the :class:`~.planner.BatchExplanation` of
        the groups :meth:`run_batch` would form (bits sum, rounds and
        dispatches fuse, the cross-group fetch priced once).
        """
        if isinstance(plan, Select):
            _lower_match(self.db, plan.where, "Select predicate")
            cands = _planner.candidate_estimates(
                self.stats(), ell=plan.expected_matches,
                padded_rows=plan.padding.rows)
            return sorted(cands, key=lambda e: (e.score(self.round_cost_bits),
                                                e.rounds))
        if isinstance(plan, Plan):
            return self.explain([plan])
        try:
            plans = list(plan)
        except TypeError:
            raise _planner.PlanNotSupported(
                plan, "explain() argument") from None
        return self._explain_batch(plans)

    def _explain_batch(self, plans: List[Plan]) -> _planner.BatchExplanation:
        """Group ``plans`` as :meth:`run_batch` would and price each group."""
        stats = self.stats()
        sel_ells: Dict[str, List[Optional[int]]] = {
            s: [] for s in ("one_tuple", "one_round", "tree")}
        sel_pad: Dict[str, Optional[int]] = {s: None for s in sel_ells}
        group_sizes: Dict[str, int] = {s: 0 for s in sel_ells}
        group_rounds: Dict[str, int] = {}
        n_counts = 0
        auto_plans: List[Select] = []

        def add_select(plan: Select, strategy: str) -> None:
            ell = 1 if strategy == "one_tuple" else plan.expected_matches
            sel_ells[strategy].append(ell)
            sel_pad[strategy] = sel_pad[strategy] or plan.padding.rows
            group_sizes[strategy] += 1
            est = _planner.estimate_select_cost(
                strategy, stats,
                ell=_planner.DEFAULT_ELL if ell is None else max(ell, 1),
                padded_rows=plan.padding.rows)
            group_rounds[strategy] = max(group_rounds.get(strategy, 0),
                                         est.rounds)

        for plan in plans:
            if isinstance(plan, Count):
                _lower_match(self.db, plan.where, "Count predicate")
                n_counts += 1
            elif isinstance(plan, Select):
                _lower_match(self.db, plan.where, "Select predicate")
                if plan.strategy == AUTO:
                    auto_plans.append(plan)
                else:
                    add_select(plan, plan.strategy)
            else:
                raise _planner.PlanNotSupported(plan)
        for plan in auto_plans:
            add_select(plan, _planner.choose_select_strategy(
                stats, ell=plan.expected_matches,
                padded_rows=plan.padding.rows,
                round_cost_bits=self.round_cost_bits,
                group_sizes=group_sizes,
                group_rounds=group_rounds).strategy)

        groups: List[_planner.GroupEstimate] = []
        if n_counts:
            one = _planner.estimate_count_cost(stats)
            groups.append(_planner.GroupEstimate(
                "count", n_counts, _planner.CostEstimate(
                    "count", bits=n_counts * one.bits, rounds=one.rounds,
                    dispatches=one.dispatches)))
        for strategy, ells in sel_ells.items():
            if ells:
                groups.append(_planner.GroupEstimate(
                    strategy, len(ells), _planner.estimate_batch_group_cost(
                        stats, strategy, ells=ells,
                        padded_rows=sel_pad[strategy])))
        return _planner.explain_batch_groups(stats, groups)

    # -- execution ----------------------------------------------------------
    def run(self, plan: Plan) -> QueryResult:
        """Execute one logical plan (the B = 1 case of :meth:`run_batch`)."""
        return self.run_batch([plan])[0]

    def run_batch(self, plans: Sequence[Plan]) -> List[QueryResult]:
        """Execute B logical plans, fusing each protocol round per group.

        Per-plan keys derive from the client root in list order. Every plan
        is cost-planned exactly as :meth:`run` would plan it (AUTO
        selections see the batch's live group sizes), then Count/Select
        groups stack their predicates — each match, Q&A and address round
        is one fused dispatch + one interpolation — and every oblivious
        fetch of the batch (one_round and tree one-hots; a zero-match
        one_round query adds a 0-row block, a tree query that counted ℓ = 0
        skips the fetch) stacks into ONE cross-group ``ss_matmul``.

        A forced ``one_tuple`` whose predicate hits ℓ ≠ 1 tuples raises
        :class:`CardinalityError`; with ``strategy="auto"`` the query
        replans onto one_round/tree inside the batch, reusing the count.
        """
        db, rel = self.db, self.rel
        stats = self.stats()
        results: Dict[int, QueryResult] = {}
        count_grp: List[_Slot] = []
        sel_grp: Dict[str, List[_Slot]] = {"one_tuple": [], "one_round": [],
                                           "tree": []}
        auto_slots: List[_Slot] = []
        group_sizes: Dict[str, int] = {s: 0 for s in sel_grp}
        group_rounds: Dict[str, int] = {}

        def join_group(slot: _Slot, strategy: str,
                       ell: Optional[int]) -> None:
            """Track a group's size and deepest member's estimated rounds
            so later AUTO riders are priced at their marginal depth."""
            slot.strategy = strategy
            group_sizes[strategy] += 1
            ell_eff = (1 if strategy == "one_tuple" else
                       _planner.DEFAULT_ELL if ell is None else max(ell, 1))
            est = _planner.estimate_select_cost(
                strategy, stats, ell=ell_eff,
                padded_rows=slot.plan.padding.rows)
            group_rounds[strategy] = max(group_rounds.get(strategy, 0),
                                         est.rounds)
            sel_grp[strategy].append(slot)

        for idx, plan in enumerate(plans):
            slot = _Slot(idx, plan, self._next_key())
            if isinstance(plan, Count):
                slot.column = _lower_match(db, plan.where, "Count predicate")
                slot.pattern = plan.where.pattern
                count_grp.append(slot)
            elif isinstance(plan, Select):
                slot.column = _lower_match(db, plan.where, "Select predicate")
                slot.pattern = plan.where.pattern
                if plan.strategy == AUTO:
                    auto_slots.append(slot)   # assigned once groups known
                    continue
                if plan.strategy == "one_tuple" and plan.padding.rows:
                    raise ValueError(
                        "one_tuple returns the single tuple directly and "
                        "cannot pad its output size — use one_round/tree "
                        "(or auto, which excludes one_tuple when padding is "
                        "requested)")
                join_group(slot, plan.strategy, plan.expected_matches)
            else:
                raise _planner.PlanNotSupported(plan)

        for slot in auto_slots:
            chosen = _planner.choose_select_strategy(
                stats, ell=slot.plan.expected_matches,
                padded_rows=slot.plan.padding.rows,
                round_cost_bits=self.round_cost_bits,
                group_sizes=group_sizes, group_rounds=group_rounds).strategy
            join_group(slot, chosen, slot.plan.expected_matches)

        be = self.backend
        fetch_jobs: List[rounds.FetchJob] = []
        fetch_meta: List[Tuple[_Slot, str, List[int]]] = []

        if count_grp:
            counts = rounds.count_phase(be, rel, [
                rounds.MatchJob(s.column, s.pattern, s.key, s.ledger)
                for s in count_grp])
            for s, cnt in zip(count_grp, counts):
                results[s.idx] = QueryResult(plan=s.plan, ledger=s.ledger,
                                             strategy="count", count=cnt)

        # -- one_tuple: batched count phase, then the Alg 3 map round -------
        if sel_grp["one_tuple"]:
            group = sel_grp["one_tuple"]
            keys = [_device.split(s.key) for s in group]
            ells = rounds.count_phase(be, rel, [
                rounds.MatchJob(s.column, s.pattern, kc, s.ledger)
                for s, (kc, _) in zip(group, keys)])
            verified: List[Tuple[_Slot, _device.Key]] = []
            for s, (_, k_sel), ell in zip(group, keys, ells):
                if ell == 1:
                    verified.append((s, k_sel))
                    continue
                if s.plan.strategy != AUTO:
                    raise CardinalityError(
                        f"select_one_tuple needs ℓ=1, predicate has {ell}"
                        " — use select_one_round/select_tree", count=ell)
                # the hint was wrong: replan with the learned ℓ on a fresh
                # key; the ledger keeps the aborted count-phase cost.
                chosen = _planner.choose_select_strategy(
                    stats, ell=ell, padded_rows=s.plan.padding.rows,
                    round_cost_bits=self.round_cost_bits,
                    group_sizes=group_sizes,
                    group_rounds=group_rounds).strategy
                s.key, s.known_count = self._next_key(), ell
                join_group(s, chosen, ell)
            if verified:
                rows = rounds.one_tuple_round(be, rel, [
                    rounds.MatchJob(s.column, s.pattern, k_sel, s.ledger)
                    for s, k_sel in verified])
                for (s, _), row in zip(verified, rows):
                    results[s.idx] = QueryResult(
                        plan=s.plan, ledger=s.ledger, strategy="one_tuple",
                        rows=[row])

        # -- one_round: fused Phase 1; fetch joins the cross-group matmul ---
        if sel_grp["one_round"]:
            group = sel_grp["one_round"]
            keys = [_device.split(s.key) for s in group]
            addrs = rounds.match_all_round(be, rel, [
                rounds.MatchJob(s.column, s.pattern, kp, s.ledger)
                for s, (kp, _) in zip(group, keys)])
            for s, (_, kf), a in zip(group, keys, addrs):
                fetch_jobs.append(rounds.FetchJob(kf, a, s.ledger,
                                                  s.plan.padding.rows))
                fetch_meta.append((s, "one_round", a))

        # -- tree: batched count phase, lockstep Q&A rounds -----------------
        if sel_grp["tree"]:
            group = sel_grp["tree"]
            keys = [_device.split(s.key, 3) for s in group]
            need = [(s, kc) for s, (kc, _, _) in zip(group, keys)
                    if s.known_count is None]
            ells = rounds.count_phase(be, rel, [
                rounds.MatchJob(s.column, s.pattern, kc, s.ledger)
                for s, kc in need])
            for (s, _), ell in zip(need, ells):
                s.known_count = ell
            live = []
            for s, (_, kp, kf) in zip(group, keys):
                if s.known_count == 0:
                    results[s.idx] = QueryResult(
                        plan=s.plan, ledger=s.ledger, strategy="tree",
                        rows=[], addresses=[])
                else:
                    live.append((s, kp, kf))
            if live:
                addrs = rounds.tree_rounds(be, rel, [
                    rounds.TreeJob(s.column, s.pattern, kp, s.ledger,
                                   ell=s.known_count,
                                   branching=s.plan.branching)
                    for s, kp, _ in live])
                for (s, _, kf), a in zip(live, addrs):
                    fetch_jobs.append(rounds.FetchJob(kf, a, s.ledger,
                                                      s.plan.padding.rows))
                    fetch_meta.append((s, "tree", a))

        rows_list, _ = rounds.fetch_fusion(be, rel, fetch_jobs)
        for (s, strat, a), r in zip(fetch_meta, rows_list):
            results[s.idx] = QueryResult(plan=s.plan, ledger=s.ledger,
                                         strategy=strat, rows=r, addresses=a)
        return [results[i] for i in range(len(plans))]

    # -- conveniences (build the plan, run it) ------------------------------
    def count(self, column: ColumnRef, pattern: str) -> QueryResult:
        return self.run(Count(Eq(column, pattern)))

    def select(self, column: ColumnRef, pattern: str, *,
               strategy: str = AUTO, expected_matches: Optional[int] = None,
               padding: Padding = Padding.NONE,
               branching: Optional[int] = None) -> QueryResult:
        return self.run(Select(Eq(column, pattern), strategy=strategy,
                               expected_matches=expected_matches,
                               padding=padding, branching=branching))

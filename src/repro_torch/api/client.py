"""QueryClient — the user-side facade over the secret-shared clouds.

One object owns the root random stream (per-query keys fold a counter into
the client seed, so identical plan sequences replay identically), the
backend (by default ``"cuda"``: the kernels on a GPU, their plain versions
on the CPU) and
the cost-based selection planner. Every query returns a
:class:`~.plans.QueryResult`.

Every plan runs through the batched round engine
(``repro_torch.core.queries.rounds``): :meth:`QueryClient.run_batch`
cost-plans each query, groups Count/Select plans by algorithm, ranges by
(bit width, ``reduce_every``) and aggregates by family, stacks their
predicates so each protocol round runs once per group (one fused dispatch +
one interpolation), and sends every oblivious fetch of the batch (one_round,
tree and range selects, and the PK/FK joins' match rows) through ONE
cross-group ``ss_matmul``.
:meth:`QueryClient.run` is the B = 1 case, so rows and ``CostLedger``
totals are identical between a batch and the equivalent sequential calls.

The port serves ``Count``/``Select`` over ``Eq`` and the pattern
predicates ``Like``/``Prefix``/``Suffix``/``Contains``, ``RangeCount``/
``RangeSelect`` over ``Between``, ``Aggregate`` (with an ``Eq``
predicate), ``Join`` (PK/FK and general equijoins, §3.3) and
``EmbedLookup`` over an embedding-table relation
(``models.private_embed.as_embed_relation``); any other plan or predicate
raises :class:`~.planner.PlanNotSupported`.

The client fronts a *registry* of attached relations (§2: the owner
outsources a database — plural relations — once). ``QueryClient(db)``
registers ``db`` under :data:`DEFAULT_RELATION`; ``attach(other, name=,
shards=S)`` registers more, each with its own dataplane and its own key
stream, so one relation's transcript never depends on traffic to another.
:meth:`QueryClient.run_batch_multi` runs several relations' batches with
their fetches in one dispatch wave.
"""
from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from .. import _device
from ..core import encoding
from ..core.costs import CostLedger
from ..core.dataplane import Dispatcher, RelationLike, ShardedRelation
from ..core.engine import SecretSharedDB
from ..core.queries import (CardinalityError, EmbedJob, aggregate,
                             embed_phase, like_spec, rounds)
from ..core.shamir import Shares
from . import planner as _planner
from .backends import DEFAULT_BACKEND, BackendLike, get_backend
from .executor import MapReduceExecutor
from .plans import (AUTO, Aggregate, Between, ColumnRef, Contains, Count,
                    EmbedLookup, Eq, Join, Like, Padding, Plan, Prefix,
                    QueryResult, RangeCount, RangeSelect, Select, Suffix,
                    resolve_column)

#: registry name a bare ``QueryClient(db)`` attaches its relation under.
DEFAULT_RELATION = "default"

#: explanations kept per client (FIFO eviction): a serving frontend explains
#: a bounded set of recurring plan shapes; anything beyond recomputes.
EXPLAIN_CACHE_MAX = 128


@dataclasses.dataclass
class AttachedRelation:
    """One registered relation: its shares, dataplane and key stream."""
    name: str
    db: SecretSharedDB
    dataplane: Optional[ShardedRelation]
    root_key: _device.Key
    counter: Iterator[int]

    @property
    def rel(self) -> RelationLike:
        """What the round engine executes against (the plane if any)."""
        return self.dataplane if self.dataplane is not None else self.db

    @property
    def n_shards(self) -> int:
        return self.dataplane.n_shards if self.dataplane is not None else 1


#: surface shapes of the literal-tile predicates (for error display).
_TILE_SOURCES = {Prefix: "{0}%", Suffix: "%{0}", Contains: "%{0}%"}


def _lower_match(db: SecretSharedDB, where, context: str
                 ) -> Tuple[int, str, Optional[encoding.PatternSpec]]:
    """Lower a Count/Select predicate -> (column, body, spec).

    ``Eq`` and any wildcard-free ``Like`` lower to the exact path
    (``spec=None``); the other shapes build their
    :class:`~repro_torch.core.encoding.PatternSpec` and validate it against
    the relation's codec here, at plan time, so malformed patterns
    (interior ``%``, ``_`` under a shifted window, tiles longer than the
    word, empty bodies, characters outside the alphabet) raise a typed
    :class:`~.planner.PlanNotSupported` before any share moves."""
    if isinstance(where, Eq):
        return resolve_column(db, where.column), where.pattern, None
    if isinstance(where, Like):
        try:
            spec = like_spec(db.codec, where.pattern)
            column = resolve_column(db, where.column)
        except (KeyError, ValueError) as e:
            raise _planner.PlanNotSupported(
                where, f"{context} ({e})") from None
        return column, where.pattern if spec is None else spec.body, spec
    if isinstance(where, (Prefix, Suffix, Contains)):
        source = _TILE_SOURCES[type(where)].format(where.literal)
        try:
            spec = encoding.PatternSpec(type(where).__name__.lower(),
                                        where.literal, (), source)
            encoding.encode_pattern_tile(db.codec, spec)
        except (KeyError, ValueError) as e:
            raise _planner.PlanNotSupported(
                where, f"{context} ({e})") from None
        return resolve_column(db, where.column), where.literal, spec
    raise _planner.PlanNotSupported(where, context)


def _lower_eq(db: SecretSharedDB, where, context: str) -> int:
    """An aggregate's predicate -> column index (``Eq`` only)."""
    if isinstance(where, Eq):
        return resolve_column(db, where.column)
    raise _planner.PlanNotSupported(where, context)


def _refuse_pattern_one_tuple(plan: Select,
                              spec: Optional[encoding.PatternSpec]) -> None:
    if spec is not None and plan.strategy == "one_tuple":
        raise _planner.PlanNotSupported(
            plan.where, "one_tuple select (the §3.2.1 single-tuple map is "
            "the exact-equality special case — pattern predicates run "
            "one_round or tree)")


def _binary_column(db: SecretSharedDB, column: ColumnRef) -> int:
    """Resolve a range/aggregate value column, which must have been
    outsourced in binary form (as the round engine would insist)."""
    col = resolve_column(db, column)
    if col not in db.numeric_bits:
        raise ValueError(f"column {col} was not outsourced in binary form")
    return col


def _validate_join(plan: Join) -> None:
    if plan.padding.rows:
        raise ValueError("joins take Padding.fake_values (fake join "
                         "values), not Padding.rows")
    if plan.kind == "pkfk" and plan.padding.values:
        raise ValueError(
            "pkfk_join's output size is always n_y (one reducer per child "
            "tuple) — nothing to hide; Padding.fake_values applies to "
            "kind='equi' only")


def _plan_signature(plan: Plan) -> tuple:
    """Structural cache key of one plan (a Join's right relation keys by
    identity: two share sets are two plans even if their values agree)."""
    if isinstance(plan, Join):
        return ("Join", id(plan.right), tuple(plan.on), plan.kind,
                plan.padding.rows, plan.padding.values, plan.match_method)
    if not dataclasses.is_dataclass(plan):
        raise _planner.PlanNotSupported(plan)
    return (type(plan).__name__,) + tuple(
        getattr(plan, f.name) for f in dataclasses.fields(plan))


def _fused_group(family: str, ests: Sequence[_planner.CostEstimate]
                 ) -> _planner.GroupEstimate:
    """A lockstep group's estimate: bits add up, rounds and dispatches are
    the deepest member's."""
    return _planner.GroupEstimate(family, len(ests), _planner.CostEstimate(
        family, bits=sum(e.bits for e in ests),
        rounds=max(e.rounds for e in ests),
        dispatches=max(e.dispatches for e in ests)))


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
    spec: Optional[encoding.PatternSpec] = None
    pred_column: Optional[int] = None
    fetch_key: Optional[_device.Key] = None


@dataclasses.dataclass
class _BatchWork:
    """One relation's in-flight ``run_batch`` state, split at the fetch:
    ``_prepare_batch`` runs every pre-fetch round and parks the cross-group
    fetch jobs here, ``_finish_batch`` consumes the fetch output and runs
    the post-fetch rounds, so :meth:`QueryClient.run_batch_multi` can fuse
    several relations' fetches into one dispatch wave."""
    plans: Sequence[Plan]
    db: SecretSharedDB
    rel: RelationLike
    results: Dict[int, QueryResult]
    fetch_jobs: List[rounds.FetchJob]
    fetch_meta: List[Tuple[_Slot, str, List[int]]]
    join_jobs: List[rounds.JoinJob]
    join_entries: Optional[List[rounds.FetchEntry]]
    pkfk_grp: List[_Slot]
    equi_grp: List[_Slot]


class QueryClient:
    """Authorized-user facade over the outsourced relation registry.

    db:              the secret-shared relation (``core.outsource`` or
                     ``core.from_arrays``), or a ``ShardedRelation`` of it,
                     registered under :data:`DEFAULT_RELATION`; ``None``
                     starts with an empty registry (``attach(..., name=)``
                     then registers relations).
    seed:            root of the per-query random streams; the default
                     relation's stream is this root itself.
    backend:         registered backend name or ``Backend``; default
                     ``"cuda"``, which launches the kernels on a CUDA device
                     and runs their plain versions on the CPU.
    executor:        a :class:`MapReduceExecutor` fans every cloud-side
                     map phase out over its fault-tolerant splits.
    device:          where the queries run; default ``"cuda"``, which raises
                     without a GPU. Every relation must live there.
    round_cost_bits: planner latency weight (bits one extra round is worth).
    """

    def __init__(self, db: Union[SecretSharedDB, ShardedRelation,
                                 None] = None,
                 seed: int = 0, *, backend: Optional[BackendLike] = None,
                 executor: Optional[MapReduceExecutor] = None,
                 device=None, round_cost_bits: int = 0):
        self.device = _device.resolve(device)
        self._root = _device.as_key(seed)
        self._relations: Dict[str, AttachedRelation] = {}
        # signature -> (BatchExplanation, the Join right relations pinned
        # so their id() in the signature cannot be reused)
        self._explanations: Dict[tuple, tuple] = {}
        if db is not None:
            plane = db if isinstance(db, ShardedRelation) else None
            self._relations[DEFAULT_RELATION] = AttachedRelation(
                DEFAULT_RELATION, self._on_device(db), plane, self._root,
                itertools.count())
        self.backend = get_backend(backend if backend is not None
                                   else DEFAULT_BACKEND)
        if executor is not None:
            self.backend = executor.wrap(self.backend)
        self.executor = executor
        self.round_cost_bits = round_cost_bits

    def _on_device(self, rel: RelationLike) -> SecretSharedDB:
        db = rel.db if isinstance(rel, ShardedRelation) else rel
        if db.device.type != self.device.type:
            raise ValueError(f"relation lives on {db.device}, client "
                             f"asked for {self.device}")
        return db

    # -- registry -----------------------------------------------------------
    @property
    def relations(self) -> Tuple[str, ...]:
        """Attached relation names, in registration order."""
        return tuple(self._relations)

    def _entry(self, relation: Optional[str] = None) -> AttachedRelation:
        if relation is None:
            ent = self._relations.get(DEFAULT_RELATION)
            if ent is not None:
                return ent
            if len(self._relations) == 1:
                return next(iter(self._relations.values()))
            if not self._relations:
                raise ValueError("no relation attached — pass a db to "
                                 "QueryClient(...) or call attach(db, "
                                 "name=...)")
            raise ValueError(f"several relations attached "
                             f"({list(self._relations)}) and none is "
                             f"{DEFAULT_RELATION!r} — pass relation=")
        try:
            return self._relations[relation]
        except KeyError:
            raise KeyError(f"unknown relation {relation!r}; attached: "
                           f"{list(self._relations)}") from None

    def _default(self) -> Optional[AttachedRelation]:
        return (self._relations.get(DEFAULT_RELATION)
                or next(iter(self._relations.values()), None))

    @property
    def db(self) -> Optional[SecretSharedDB]:
        """The default relation's shares (None with an empty registry)."""
        ent = self._default()
        return ent.db if ent is not None else None

    @property
    def dataplane(self) -> Optional[ShardedRelation]:
        """The default relation's dataplane (None until sharded/attached)."""
        ent = self._default()
        return ent.dataplane if ent is not None else None

    def dataplane_of(self, relation: str) -> Optional[ShardedRelation]:
        return self._entry(relation).dataplane

    def _next_key(self, ent: AttachedRelation) -> _device.Key:
        return _device.fold(ent.root_key, next(ent.counter))

    def attach(self, relation: Union[SecretSharedDB, ShardedRelation,
                                     None] = None, *,
               name: Optional[str] = None, shards: int = 1,
               dispatcher: Optional[Dispatcher] = None,
               key=None) -> ShardedRelation:
        """Attach (or re-shard) a relation as a sharded dataplane.

        ``name`` addresses the registry slot (default
        :data:`DEFAULT_RELATION`). A new name registers ``relation`` as one
        more tenant with its own key stream: ``key`` (an int seed or a key)
        seeds it explicitly, so a multi-tenant server can replay a solo
        client; otherwise the stream derives from the client root and the
        name alone, so attach order never matters. ``relation`` may be
        omitted to re-shard an attached name.

        Every cloud step of later queries against the relation fans out as
        one dispatch per tuple-axis shard, run by ``dispatcher`` (serial by
        default; a ``ThreadedDispatcher`` or a shared pool's ``handle()``
        for concurrent shards, ``MapReduceExecutor.dispatcher()`` for
        fault-tolerant placement). Rows, opened values and ledgers stay
        bit-identical to the unsharded relation.

        Re-attaching clears the explanation cache: its dispatch estimates
        were priced at the old shard count.
        """
        name = DEFAULT_RELATION if name is None else name
        ent = self._relations.get(name)
        if relation is None:
            if ent is None:
                raise ValueError(f"no relation registered under {name!r} — "
                                 f"pass the db to attach")
            rel = ent.rel
        else:
            rel = relation
        if isinstance(rel, ShardedRelation):
            if shards <= 1 and dispatcher is None:
                plane = rel                      # adopt as it is
            else:
                # re-shard only on an explicit shards > 1: a new dispatcher
                # alone keeps the partitioning
                plane = ShardedRelation(
                    rel.db, shards=shards if shards > 1 else rel.n_shards,
                    dispatcher=dispatcher or rel.dispatcher)
        else:
            plane = ShardedRelation(rel, shards=shards,
                                    dispatcher=dispatcher)
        # a device-resident dispatcher (MeshDispatcher) places the share
        # blocks on its grid now; plane.db stays the relation on the
        # client's device (the blocks may sit on several devices), and
        # every later round's dispatches run on the placed blocks
        bind = getattr(plane.dispatcher, "bind_plane", None)
        if bind is not None:
            bind(plane)
        db = self._on_device(plane)
        if ent is None:
            if key is not None:
                root = _device.as_key(key)
            else:
                # two independent 31-bit CRC folds of the NAME alone; the
                # protocol's masking randomness must be independent across
                # tenants, so a collision is refused, never shared
                raw = name.encode()
                root = _device.fold(
                    _device.fold(self._root, zlib.crc32(raw) & 0x7fffffff),
                    zlib.crc32(raw[::-1] + b"\x00") & 0x7fffffff)
                for other in self._relations.values():
                    if other.root_key == root:
                        raise ValueError(
                            f"derived key stream for {name!r} collides "
                            f"with relation {other.name!r} — pass an "
                            f"explicit key= for one of them")
            self._relations[name] = AttachedRelation(
                name, db, plane, root, itertools.count())
        else:
            ent.db, ent.dataplane = db, plane
            if key is not None:                  # explicit re-key: restart
                ent.root_key = _device.as_key(key)
                ent.counter = itertools.count()
        self._explanations.clear()
        return plane

    # -- planning -----------------------------------------------------------
    def stats(self, relation: Optional[str] = None) -> _planner.DBStats:
        ent = self._entry(relation)
        return _planner.DBStats.of(ent.db, shards=ent.n_shards,
                                   relation=ent.name)

    def explain(self, plan: Union[Plan, Sequence[Plan]], *,
                relation: Optional[str] = None):
        """Planner predictions without touching shares.

        One ``Select`` -> its eligible strategy estimates, cheapest first.
        Any other plan -> its batch-of-one
        :class:`~.planner.BatchExplanation`.
        A sequence of plans -> the :class:`~.planner.BatchExplanation` of
        the groups :meth:`run_batch` would form (bits sum, rounds and
        dispatches fuse, the cross-group fetch priced once), cached per
        (relation, plan signatures) until the next :meth:`attach`.
        """
        ent = self._entry(relation)
        if isinstance(plan, Select):
            spec = _lower_match(ent.db, plan.where, "Select predicate")[2]
            _refuse_pattern_one_tuple(plan, spec)
            stats = self.stats(ent.name)
            if spec is not None:
                cands = _planner.candidate_pattern_estimates(
                    stats, spec, ell=plan.expected_matches,
                    padded_rows=plan.padding.rows)
            else:
                cands = _planner.candidate_estimates(
                    stats, ell=plan.expected_matches,
                    padded_rows=plan.padding.rows)
            return sorted(cands, key=lambda e: (e.score(self.round_cost_bits),
                                                e.rounds))
        if isinstance(plan, Plan):
            return self.explain([plan], relation=ent.name)
        try:
            plans = list(plan)
        except TypeError:
            raise _planner.PlanNotSupported(
                plan, "explain() argument") from None
        sig = (ent.name, tuple(_plan_signature(p) for p in plans))
        hit = self._explanations.get(sig)
        if hit is not None:
            return hit[0]
        exp = self._explain_batch(plans, ent)
        if len(self._explanations) >= EXPLAIN_CACHE_MAX:
            self._explanations.pop(next(iter(self._explanations)))
        self._explanations[sig] = (exp, tuple(
            p.right for p in plans if isinstance(p, Join)))
        return exp

    def explain_multi(self, batches: Sequence[
            Tuple[Optional[str], Sequence[Plan]]]
            ) -> _planner.MultiBatchExplanation:
        """Predicted ledgers of a prospective :meth:`run_batch_multi`: each
        ``(relation, plans)`` batch priced as :meth:`explain` prices it
        alone, plus the shared fetch wave."""
        return _planner.explain_multi_batches(
            [self.explain(list(plans), relation=relation)
             for relation, plans in batches])

    def _explain_batch(self, plans: List[Plan], ent: AttachedRelation
                       ) -> _planner.BatchExplanation:
        """Group ``plans`` as :meth:`run_batch` would and price each group."""
        db = ent.db
        stats = self.stats(ent.name)
        sel_ells: Dict[str, List[Optional[int]]] = {
            s: [] for s in ("one_tuple", "one_round", "tree")}
        sel_specs: Dict[str, List[Optional[encoding.PatternSpec]]] = {
            s: [] for s in sel_ells}
        sel_pad: Dict[str, Optional[int]] = {s: None for s in sel_ells}
        group_sizes: Dict[str, int] = {s: 0 for s in sel_ells}
        group_rounds: Dict[str, int] = {}
        count_ests: List[_planner.CostEstimate] = []
        auto_plans: List[Tuple[Select, Optional[encoding.PatternSpec]]] = []
        range_grps: Dict[Tuple[int, int], List[Tuple[bool, Optional[int]]]] \
            = {}
        agg_grps: Dict[tuple, List[_planner.CostEstimate]] = {}
        embed_ests: List[_planner.CostEstimate] = []
        joins: Dict[str, List[Join]] = {"pkfk": [], "equi": []}

        def add_select(plan: Select, strategy: str,
                       spec: Optional[encoding.PatternSpec]) -> None:
            ell = 1 if strategy == "one_tuple" else plan.expected_matches
            sel_ells[strategy].append(ell)
            sel_specs[strategy].append(spec)
            sel_pad[strategy] = sel_pad[strategy] or plan.padding.rows
            group_sizes[strategy] += 1
            group_rounds[strategy] = max(
                group_rounds.get(strategy, 0),
                self._select_estimate(stats, strategy, spec, ell,
                                      plan.padding.rows).rounds)

        for plan in plans:
            if isinstance(plan, Count):
                spec = _lower_match(db, plan.where, "Count predicate")[2]
                count_ests.append(_planner.estimate_pattern_cost(stats, spec))
            elif isinstance(plan, Select):
                spec = _lower_match(db, plan.where, "Select predicate")[2]
                _refuse_pattern_one_tuple(plan, spec)
                if plan.strategy == AUTO:
                    auto_plans.append((plan, spec))
                else:
                    add_select(plan, plan.strategy, spec)
            elif isinstance(plan, (RangeCount, RangeSelect)):
                col = _binary_column(db, plan.where.column)
                want = isinstance(plan, RangeSelect)
                range_grps.setdefault(
                    (db.numeric_bits[col], plan.reduce_every), []
                ).append((want, plan.padding.rows if want else None))
            elif isinstance(plan, Aggregate):
                col = _binary_column(db, plan.column)
                if plan.where is not None:
                    _lower_eq(db, plan.where, "Aggregate predicate")
                t_bits = db.numeric_bits[col]
                est = _planner.estimate_aggregate_cost(
                    stats, plan.op, t_bits=t_bits,
                    conditional=plan.where is not None,
                    verify=plan.verify, reduce_every=plan.reduce_every)
                # as run_batch groups: SUM/AVG per bit width, MIN/MAX per
                # (bit width, reduce_every)
                gk = (("agg_sum", t_bits) if plan.op in ("sum", "avg")
                      else ("agg_minmax", t_bits, plan.reduce_every))
                agg_grps.setdefault(gk, []).append(est)
            elif isinstance(plan, EmbedLookup):
                embed_ests.append(_planner.estimate_embed_cost(
                    stats, n_tokens=len(plan.tokens), verify=plan.verify))
            elif isinstance(plan, Join):
                _validate_join(plan)
                joins[plan.kind].append(plan)
            else:
                raise _planner.PlanNotSupported(plan)
        for plan, spec in auto_plans:
            add_select(plan, self._choose(
                stats, spec, plan.expected_matches, plan.padding.rows,
                group_sizes, group_rounds), spec)

        groups: List[_planner.GroupEstimate] = []
        if count_ests:
            groups.append(_fused_group("count", count_ests))
        for strategy, ells in sel_ells.items():
            if ells:
                groups.append(_planner.GroupEstimate(
                    strategy, len(ells), _planner.estimate_batch_group_cost(
                        stats, strategy, ells=ells,
                        padded_rows=sel_pad[strategy],
                        specs=sel_specs[strategy])))
        for (t_bits, reduce_every), members in range_grps.items():
            ests = [_planner.estimate_range_cost(
                stats, t_bits=t_bits, reduce_every=reduce_every,
                want_addresses=want, padded_rows=pad)
                for want, pad in members]
            family = ("range_select" if any(w for w, _ in members)
                      else "range_count")
            groups.append(_fused_group(family, ests))
        for ests in agg_grps.values():
            groups.append(_fused_group("aggregate", ests))
        if embed_ests:          # one fused contraction: dispatches don't stack
            groups.append(_fused_group("embed", embed_ests))
        if joins["pkfk"]:       # one group: batched match matrices
            groups.append(_fused_group("pkfk", [
                _planner.estimate_pkfk_cost(stats,
                                            _planner.DBStats.of(p.right))
                for p in joins["pkfk"]]))
        if joins["equi"]:       # phases fuse; per-value rounds stay per job
            groups.append(_fused_group("equi", [
                _planner.estimate_equijoin_cost(
                    stats, _planner.DBStats.of(p.right),
                    fake_values=p.padding.values) for p in joins["equi"]]))
        return _planner.explain_batch_groups(stats, groups)

    @staticmethod
    def _select_estimate(stats, strategy: str,
                         spec: Optional[encoding.PatternSpec],
                         ell: Optional[int], padded_rows: Optional[int]
                         ) -> _planner.CostEstimate:
        """One select's estimate in its group (the group tracks the
        deepest member's rounds)."""
        ell_eff = (1 if strategy == "one_tuple" else
                   _planner.DEFAULT_ELL if ell is None else max(ell, 1))
        if spec is not None:
            return _planner.estimate_pattern_cost(
                stats, spec, select=strategy, ell=ell_eff,
                padded_rows=padded_rows)
        return _planner.estimate_select_cost(strategy, stats, ell=ell_eff,
                                             padded_rows=padded_rows)

    def _choose(self, stats, spec: Optional[encoding.PatternSpec],
                ell: Optional[int], padded_rows: Optional[int],
                group_sizes, group_rounds) -> str:
        """AUTO's strategy: pattern predicates choose among their eligible
        strategies only."""
        kw = dict(ell=ell, padded_rows=padded_rows,
                  round_cost_bits=self.round_cost_bits,
                  group_sizes=group_sizes, group_rounds=group_rounds)
        if spec is not None:
            return _planner.choose_pattern_strategy(stats, spec,
                                                    **kw).strategy
        return _planner.choose_select_strategy(stats, **kw).strategy

    # -- execution ----------------------------------------------------------
    def run(self, plan: Plan, *,
            relation: Optional[str] = None) -> QueryResult:
        """Execute one logical plan (the B = 1 case of :meth:`run_batch`)."""
        return self.run_batch([plan], relation=relation)[0]

    def run_batch(self, plans: Sequence[Plan], *,
                  relation: Optional[str] = None) -> List[QueryResult]:
        """Execute B logical plans, fusing each protocol round per group.

        ``relation`` picks the registry entry (the default relation when
        omitted); per-plan keys derive from THAT relation's stream in list
        order. Every plan is cost-planned exactly as :meth:`run` would plan
        it (AUTO selections see the batch's live group sizes), then
        Count/Select groups stack their predicates — each match, Q&A and
        address round is one fused dispatch + one interpolation — and every
        oblivious fetch of the batch (one_round and tree one-hots; a
        zero-match one_round query adds a 0-row block, a tree query that
        counted ℓ = 0 skips the fetch) stacks into ONE cross-group
        ``ss_matmul``.

        Range plans group by (bit width, ``reduce_every``): the group's
        SS-SUB bit-vectors ripple in ONE ``(c, 2B, n, t)`` carry chain, and
        a RangeSelect's fetch joins the cross-group ``ss_matmul``.
        SUM/AVG numerators share ONE contraction per bit width (a
        conditional AVG's denominator rides the batch's count phase);
        MIN/MAX tournaments march in lockstep per (bit width,
        ``reduce_every``). Every ``EmbedLookup`` of the batch shares its
        one-hots in ONE ``share_onehot`` launch and contracts in ONE
        ``ss_matmul`` per shard. PK/FK joins whose right relations have
        equal size and match method stack into one batched match (W
        ``ss_matmul`` launches per shard for the chain, one for the
        aggregate form) whose rows ride the cross-group fetch; equijoins
        fuse per phase (one column open, one X-side layer-1 matmul per
        shard, the Y side per distinct right relation).

        A forced ``one_tuple`` whose predicate hits ℓ ≠ 1 tuples raises
        :class:`CardinalityError`; with ``strategy="auto"`` the query
        replans onto one_round/tree inside the batch, reusing the count.
        """
        (out,) = self.run_batch_multi([(relation, plans)])
        return out

    def run_batch_multi(self, batches: Sequence[
            Tuple[Optional[str], Sequence[Plan]]]) -> List[List[QueryResult]]:
        """Execute several relations' batches with ONE fused fetch wave.

        ``batches`` is a sequence of ``(relation, plans)`` pairs. Each batch
        runs exactly as :meth:`run_batch` would (its relation's key stream,
        its own grouping and ledgers; batches never mix), but all batches
        advance to the cross-group fetch first, and their fetch
        ``ss_matmul`` dispatches execute as ONE wave when the relations'
        dataplanes share a dispatch pool
        (:func:`~repro_torch.core.queries.rounds.fetch_fusion_multi`).
        Results and ledgers are bit-identical to running the batches back
        to back; one result list per batch, in order."""
        works = [self._prepare_batch(list(plans), self._entry(relation))
                 for relation, plans in batches]
        fetched = rounds.fetch_fusion_multi(
            self.backend,
            [(w.rel, w.fetch_jobs, w.join_entries) for w in works])
        for w in works:
            w.join_entries = None   # the match rows: 10.74 GB at full size
        return [self._finish_batch(w, f) for w, f in zip(works, fetched)]

    def _prepare_batch(self, plans: Sequence[Plan],
                       ent: AttachedRelation) -> _BatchWork:
        """Group, plan and run every pre-fetch round of one batch."""
        db, rel = ent.db, ent.rel
        stats = self.stats(ent.name)
        results: Dict[int, QueryResult] = {}
        count_grp: List[_Slot] = []
        sel_grp: Dict[str, List[_Slot]] = {"one_tuple": [], "one_round": [],
                                           "tree": []}
        range_grps: Dict[Tuple[int, int], List[_Slot]] = {}
        agg_sum_grps: Dict[int, List[_Slot]] = {}
        agg_mm_grps: Dict[Tuple[int, int], List[_Slot]] = {}
        embed_grp: List[_Slot] = []
        pkfk_grp: List[_Slot] = []
        equi_grp: List[_Slot] = []
        auto_slots: List[_Slot] = []
        group_sizes: Dict[str, int] = {s: 0 for s in sel_grp}
        group_rounds: Dict[str, int] = {}

        def join_group(slot: _Slot, strategy: str,
                       ell: Optional[int]) -> None:
            """Track a group's size and deepest member's estimated rounds
            so later AUTO riders are priced at their marginal depth."""
            slot.strategy = strategy
            group_sizes[strategy] += 1
            group_rounds[strategy] = max(
                group_rounds.get(strategy, 0),
                self._select_estimate(stats, strategy, slot.spec, ell,
                                      slot.plan.padding.rows).rounds)
            sel_grp[strategy].append(slot)

        for idx, plan in enumerate(plans):
            slot = _Slot(idx, plan, self._next_key(ent))
            if isinstance(plan, Count):
                slot.column, slot.pattern, slot.spec = _lower_match(
                    db, plan.where, "Count predicate")
                count_grp.append(slot)
            elif isinstance(plan, Select):
                slot.column, slot.pattern, slot.spec = _lower_match(
                    db, plan.where, "Select predicate")
                _refuse_pattern_one_tuple(plan, slot.spec)
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
            elif isinstance(plan, (RangeCount, RangeSelect)):
                slot.column = resolve_column(db, plan.where.column)
                gk = (db.numeric_bits.get(slot.column, -1),
                      plan.reduce_every)
                range_grps.setdefault(gk, []).append(slot)
            elif isinstance(plan, Aggregate):
                slot.column = resolve_column(db, plan.column)
                if plan.where is not None:
                    slot.pred_column = _lower_eq(db, plan.where,
                                                 "Aggregate predicate")
                    slot.pattern = plan.where.pattern
                t_bits = db.numeric_bits.get(slot.column, -1)
                if plan.op in ("sum", "avg"):
                    agg_sum_grps.setdefault(t_bits, []).append(slot)
                else:
                    agg_mm_grps.setdefault((t_bits, plan.reduce_every),
                                           []).append(slot)
            elif isinstance(plan, EmbedLookup):
                embed_grp.append(slot)
            elif isinstance(plan, Join):
                _validate_join(plan)
                (pkfk_grp if plan.kind == "pkfk" else equi_grp).append(slot)
            else:
                raise _planner.PlanNotSupported(plan)

        for slot in auto_slots:
            chosen = self._choose(stats, slot.spec,
                                  slot.plan.expected_matches,
                                  slot.plan.padding.rows, group_sizes,
                                  group_rounds)
            join_group(slot, chosen, slot.plan.expected_matches)

        be = self.backend
        fetch_jobs: List[rounds.FetchJob] = []
        fetch_meta: List[Tuple[_Slot, str, List[int]]] = []

        # conditional AVG denominators ride the batch's §3.1 count phase:
        # their MatchJobs fuse into the same dispatch as explicit Counts.
        avg_cnt_slots: List[_Slot] = []
        for group in agg_sum_grps.values():
            for s in group:
                if s.plan.op == "avg" and s.plan.where is not None:
                    s.key, s.fetch_key = _device.split(s.key)
                    avg_cnt_slots.append(s)

        if count_grp or avg_cnt_slots:
            counts = rounds.count_phase(be, rel, [
                rounds.MatchJob(s.column, s.pattern, s.key, s.ledger, s.spec)
                for s in count_grp] + [
                rounds.MatchJob(s.pred_column, s.pattern, s.fetch_key,
                                s.ledger) for s in avg_cnt_slots])
            for s, cnt in zip(count_grp, counts):
                results[s.idx] = QueryResult(plan=s.plan, ledger=s.ledger,
                                             strategy="count", count=cnt)
            for s, cnt in zip(avg_cnt_slots, counts[len(count_grp):]):
                s.known_count = cnt

        # -- embedding lookups: every job's one-hots share in one launch and
        # the whole group contracts in ONE ss_matmul per shard ---------------
        if embed_grp:
            embs = embed_phase(be, rel, [
                EmbedJob(tokens=s.plan.tokens, key=s.key, ledger=s.ledger,
                         verify=s.plan.verify) for s in embed_grp])
            for s, emb in zip(embed_grp, embs):
                results[s.idx] = QueryResult(plan=s.plan, ledger=s.ledger,
                                             strategy="embed",
                                             embeddings=emb)

        # -- aggregation: SUM/AVG numerators fuse per bit width, MIN/MAX
        # tournaments per (bit width, reduce_every) ------------------------
        for group in agg_sum_grps.values():
            sums = aggregate.agg_sum_phase(be, rel, [
                aggregate.SumJob(
                    value_column=s.column, key=s.key, ledger=s.ledger,
                    pred_column=s.pred_column,
                    pattern=s.pattern if s.plan.where is not None else None,
                    verify=s.plan.verify) for s in group])
            for s, total in zip(group, sums):
                if s.plan.op == "sum":
                    results[s.idx] = QueryResult(
                        plan=s.plan, ledger=s.ledger, strategy="agg_sum",
                        value=total)
                elif s.plan.where is not None:
                    results[s.idx] = QueryResult(
                        plan=s.plan, ledger=s.ledger, strategy="agg_avg",
                        value=(total / s.known_count
                               if s.known_count else None),
                        count=s.known_count)
                else:                   # the denominator is the public n
                    results[s.idx] = QueryResult(
                        plan=s.plan, ledger=s.ledger, strategy="agg_avg",
                        value=total / db.n_tuples if db.n_tuples else None)
        for (_, reduce_every), group in agg_mm_grps.items():
            outs = aggregate.agg_minmax_rounds(be, rel, [
                aggregate.MinMaxJob(
                    value_column=s.column, key=s.key, ledger=s.ledger,
                    pred_column=s.pred_column,
                    pattern=s.pattern if s.plan.where is not None else None,
                    verify=s.plan.verify, op=s.plan.op,
                    reduce_every=reduce_every) for s in group])
            for s, (val, cnt) in zip(group, outs):
                results[s.idx] = QueryResult(
                    plan=s.plan, ledger=s.ledger,
                    strategy=f"agg_{s.plan.op}", value=val, count=cnt)

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
                s.key, s.known_count = self._next_key(ent), ell
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
                rounds.MatchJob(s.column, s.pattern, kp, s.ledger, s.spec)
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
                rounds.MatchJob(s.column, s.pattern, kc, s.ledger, s.spec)
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
                    rounds.TreeJob(s.column, s.pattern, kp, s.ledger, s.spec,
                                   ell=s.known_count,
                                   branching=s.plan.branching)
                    for s, kp, _ in live])
                for (s, _, kf), a in zip(live, addrs):
                    fetch_jobs.append(rounds.FetchJob(kf, a, s.ledger,
                                                      s.plan.padding.rows))
                    fetch_meta.append((s, "tree", a))

        # -- ranges: one fused ripple per (bit width, reduce_every) group ---
        for (_, reduce_every), group in range_grps.items():
            jobs = []
            for s in group:
                k_ind = s.key
                if isinstance(s.plan, RangeSelect):
                    k_ind, s.fetch_key = _device.split(s.key)
                jobs.append(rounds.RangeJob(
                    s.column, s.plan.where.lo, s.plan.where.hi, k_ind,
                    s.ledger, reduce_every=reduce_every,
                    want_addresses=isinstance(s.plan, RangeSelect)))
            for s, out in zip(group, rounds.range_rounds(be, rel, jobs)):
                if isinstance(s.plan, RangeCount):
                    results[s.idx] = QueryResult(
                        plan=s.plan, ledger=s.ledger,
                        strategy="range_count", count=out)
                else:
                    fetch_jobs.append(rounds.FetchJob(
                        s.fetch_key, out, s.ledger, s.plan.padding.rows))
                    fetch_meta.append((s, "range_select", out))

        # -- pkfk joins: match matrices become rows of the shared fetch -----
        join_jobs = [rounds.JoinJob(
            s.plan.right, resolve_column(db, s.plan.on[0]),
            resolve_column(s.plan.right, s.plan.on[1]), s.key, s.ledger,
            match_method=_planner.choose_match_method(
                stats, s.plan.match_method)) for s in pkfk_grp]
        join_entries = rounds.join_match_round(be, rel, join_jobs)
        return _BatchWork(plans=plans, db=db, rel=rel, results=results,
                          fetch_jobs=fetch_jobs, fetch_meta=fetch_meta,
                          join_jobs=join_jobs, join_entries=join_entries,
                          pkfk_grp=pkfk_grp, equi_grp=equi_grp)

    def _finish_batch(self, work: _BatchWork,
                      fetched: Tuple[List[List[List[str]]], List[Shares]]
                      ) -> List[QueryResult]:
        """Consume the fused fetch output and run the post-fetch rounds."""
        db, results = work.db, work.results
        rows_list, extra = fetched
        for (s, strat, a), r in zip(work.fetch_meta, rows_list):
            results[s.idx] = QueryResult(plan=s.plan, ledger=s.ledger,
                                         strategy=strat, rows=r, addresses=a)
        if work.pkfk_grp:
            join_rows = rounds.join_emit_round(db, work.join_jobs, extra)
            for s, r in zip(work.pkfk_grp, join_rows):
                results[s.idx] = QueryResult(plan=s.plan, ledger=s.ledger,
                                             strategy="pkfk", rows=r)

        # -- equijoins: phases fused across the group -----------------------
        if work.equi_grp:
            equi_rows = rounds.equijoin_rounds(self.backend, work.rel, [
                rounds.EquiJob(
                    s.plan.right, resolve_column(db, s.plan.on[0]),
                    resolve_column(s.plan.right, s.plan.on[1]), s.key,
                    s.ledger, padded_values=s.plan.padding.values)
                for s in work.equi_grp])
            for s, r in zip(work.equi_grp, equi_rows):
                results[s.idx] = QueryResult(plan=s.plan, ledger=s.ledger,
                                             strategy="equi", rows=r)
        return [results[i] for i in range(len(work.plans))]

    # -- conveniences (build the plan, run it) ------------------------------
    def count(self, column: ColumnRef, pattern: str, *,
              relation: Optional[str] = None) -> QueryResult:
        return self.run(Count(Eq(column, pattern)), relation=relation)

    def select(self, column: ColumnRef, pattern: str, *,
               strategy: str = AUTO, expected_matches: Optional[int] = None,
               padding: Padding = Padding.NONE,
               branching: Optional[int] = None,
               relation: Optional[str] = None) -> QueryResult:
        return self.run(Select(Eq(column, pattern), strategy=strategy,
                               expected_matches=expected_matches,
                               padding=padding, branching=branching),
                        relation=relation)

    def like(self, column: ColumnRef, pattern: str, *,
             count_only: bool = False, strategy: str = AUTO,
             expected_matches: Optional[int] = None,
             padding: Padding = Padding.NONE,
             relation: Optional[str] = None) -> QueryResult:
        """``column LIKE pattern``: a pattern Select (or Count with
        ``count_only=True``). Wildcard-free patterns lower to the exact Eq
        path; ``lit%``/``%lit``/``%lit%``/``l_t`` run the prefix / suffix /
        substring / masked matchers."""
        where = Like(column, pattern)
        if count_only:
            return self.run(Count(where), relation=relation)
        return self.run(Select(where, strategy=strategy,
                               expected_matches=expected_matches,
                               padding=padding), relation=relation)

    def range_count(self, column: ColumnRef, lo: int, hi: int, *,
                    reduce_every: int = 0,
                    relation: Optional[str] = None) -> QueryResult:
        return self.run(RangeCount(Between(column, lo, hi),
                                   reduce_every=reduce_every),
                        relation=relation)

    def range_select(self, column: ColumnRef, lo: int, hi: int, *,
                     reduce_every: int = 0,
                     padding: Padding = Padding.NONE,
                     relation: Optional[str] = None) -> QueryResult:
        return self.run(RangeSelect(Between(column, lo, hi),
                                    reduce_every=reduce_every,
                                    padding=padding), relation=relation)

    def aggregate(self, op: str, column: ColumnRef, *,
                  where: Optional[Eq] = None, verify: bool = False,
                  reduce_every: int = 0,
                  relation: Optional[str] = None) -> QueryResult:
        return self.run(Aggregate(op, column, where=where, verify=verify,
                                  reduce_every=reduce_every),
                        relation=relation)

    def join(self, right: SecretSharedDB, on: Tuple[ColumnRef, ColumnRef], *,
             kind: str = "pkfk", padding: Padding = Padding.NONE,
             relation: Optional[str] = None) -> QueryResult:
        return self.run(Join(right=right, on=on, kind=kind, padding=padding),
                        relation=relation)

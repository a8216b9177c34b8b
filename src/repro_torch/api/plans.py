"""Logical query plans — the user-facing half of the client API.

A plan is a small frozen dataclass describing *what* to compute (predicate,
columns by name, padding policy); :class:`repro_torch.api.QueryClient`
decides *how* (strategy, backend, random streams) and returns a uniform
:class:`QueryResult`. The port carries the count and selection families
over equality and pattern predicates (``Like``/``Prefix``/``Suffix``/
``Contains``), range count/selection over ``Between``, SUM/AVG/MIN/MAX
aggregation and PK/FK and general equijoins (``Join``).

Padding is a security knob: fetching ``Padding.rows`` fake rows
(selection) or running ``Padding.values`` fake join values (equijoin)
hides the true result size from the clouds (the §3.2.2 / §3.3.2
output-size attack).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

from ..core.costs import CostLedger
from ..core.engine import SecretSharedDB

ColumnRef = Union[str, int]

AUTO = "auto"
SELECT_STRATEGIES = ("one_tuple", "one_round", "tree")
JOIN_KINDS = ("pkfk", "equi")
MATCH_METHODS = ("chain", "aggregate")
AGG_OPS = ("sum", "avg", "min", "max")


def resolve_column(db, column: ColumnRef) -> int:
    """Name-or-index -> validated column index of ``db``."""
    names = list(db.column_names)
    if isinstance(column, int):
        if not 0 <= column < db.n_attrs:
            raise IndexError(f"column index {column} out of range "
                             f"(relation has {db.n_attrs} attributes)")
        return column
    try:
        return names.index(column)
    except ValueError:
        raise KeyError(f"unknown column {column!r}; relation has "
                       f"{names}") from None


@dataclasses.dataclass(frozen=True)
class Eq:
    """Equality predicate: ``column = pattern`` (exact word, §3.1.2)."""
    column: ColumnRef
    pattern: str


@dataclasses.dataclass(frozen=True)
class Between:
    """Inclusive range predicate: ``lo <= column <= hi`` (§3.4)."""
    column: ColumnRef
    lo: int
    hi: int

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty range: lo={self.lo} > hi={self.hi}")


@dataclasses.dataclass(frozen=True)
class Like:
    """SQL-ish pattern predicate: ``column LIKE pattern`` (§3.1 general AA).

    ``%`` matches any run of characters at either end of the pattern
    (``lit%`` / ``%lit`` / ``%lit%``); ``_`` matches any ONE symbol —
    including the pad terminator, so ``_`` is a don't-care, not a length
    constraint (a documented deviation from SQL). A wildcard-free pattern
    lowers to the exact-match :class:`Eq` path; interior ``%`` runs and
    ``_`` under a ``%``-shifted window raise ``PlanNotSupported``.
    """
    column: ColumnRef
    pattern: str


@dataclasses.dataclass(frozen=True)
class Prefix:
    """``column`` starts with ``literal`` (verbatim, no wildcards; use
    :class:`Like` for ``_``). Lowers to a truncated k-position AA chain."""
    column: ColumnRef
    literal: str


@dataclasses.dataclass(frozen=True)
class Suffix:
    """``column`` ends with ``literal`` (verbatim). Lowers to the
    sliding-window automata step with a terminator factor."""
    column: ColumnRef
    literal: str


@dataclasses.dataclass(frozen=True)
class Contains:
    """``column`` contains ``literal`` (verbatim). Lowers to the
    sliding-window automata step, a degree-reduction re-share and the
    window-count zero test."""
    column: ColumnRef
    literal: str


#: predicate classes the pattern engine lowers (besides plain Eq).
PATTERN_PREDICATES = (Like, Prefix, Suffix, Contains)
#: every predicate class Count/Select accept.
MATCH_PREDICATES = (Eq,) + PATTERN_PREDICATES


@dataclasses.dataclass(frozen=True)
class Padding:
    """Output-size-attack resistance.

    rows:   pad the oblivious fetch to this many rows (≥ true ℓ); the extra
            rows are all-zero one-hots and fetch nothing.
    values: fake (no-op) equijoin values, hiding the number of common join
            values k.
    """
    rows: Optional[int] = None
    values: int = 0

    def __post_init__(self):
        if self.rows is not None and self.rows < 0:
            raise ValueError("Padding.rows must be >= 0")
        if self.values < 0:
            raise ValueError("Padding.values must be >= 0")

    @classmethod
    def to_rows(cls, rows: int) -> "Padding":
        return cls(rows=rows)

    @classmethod
    def fake_values(cls, values: int) -> "Padding":
        return cls(values=values)


Padding.NONE = Padding()


class Plan:
    """Marker base class for logical plans."""


@dataclasses.dataclass(frozen=True)
class Count(Plan):
    """COUNT(*) WHERE <predicate> (§3.1, Algorithm 2): ``where`` is
    :class:`Eq` or any pattern predicate; other predicate types raise
    ``PlanNotSupported`` at plan time."""
    where: Union[Eq, Like, Prefix, Suffix, Contains]


@dataclasses.dataclass(frozen=True)
class Select(Plan):
    """SELECT * WHERE col = pattern (§3.2, Algorithms 3 & 4).

    strategy: ``"auto"`` lets the cost-based planner pick among the paper's
    three algorithms, or force ``"one_tuple" | "one_round" | "tree"``.
    ``expected_matches`` is the planner's cardinality hint (ℓ); one_tuple
    is eligible only when the hint says ℓ = 1 (the algorithm verifies).
    A pattern predicate runs ``one_round`` or ``tree`` (``one_tuple`` is
    the §3.2.1 exact-equality special case).
    """
    where: Union[Eq, Like, Prefix, Suffix, Contains]
    strategy: str = AUTO
    expected_matches: Optional[int] = None
    padding: Padding = Padding.NONE
    branching: Optional[int] = None     # tree fan-out override

    def __post_init__(self):
        if self.strategy not in (AUTO,) + SELECT_STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; choose "
                             f"from {(AUTO,) + SELECT_STRATEGIES}")
        if self.expected_matches is not None and self.expected_matches < 0:
            raise ValueError("expected_matches must be >= 0")
        _refuse_fake_values(self.padding)


def _refuse_fake_values(padding: Padding) -> None:
    if padding.values:
        raise ValueError("selection hides the result size with "
                         "Padding.rows (fake fetch rows); "
                         "Padding.fake_values applies to equijoins")


@dataclasses.dataclass(frozen=True)
class RangeCount(Plan):
    """COUNT(*) WHERE lo <= col <= hi (§3.4, Algorithm 5). reduce_every > 0
    inserts a degree-reduction (re-sharing) round every that many SS-SUB
    bit positions, trading rounds for the clouds an opening needs."""
    where: Between
    reduce_every: int = 0


@dataclasses.dataclass(frozen=True)
class RangeSelect(Plan):
    """Fetch all tuples with col in [lo, hi] (§3.4 + the §3.2 fetch)."""
    where: Between
    reduce_every: int = 0
    padding: Padding = Padding.NONE

    def __post_init__(self):
        _refuse_fake_values(self.padding)


@dataclasses.dataclass(frozen=True)
class Join(Plan):
    """Oblivious join of the client's relation with ``right`` (§3.3).

    on:   (left column, right column) — names or indices.
    kind: ``"pkfk"`` (§3.3.1, the left column is a primary key) or
          ``"equi"`` (§3.3.2, join values may repeat on both sides).
    match_method: how the PK/FK match matrix is evaluated — ``"chain"``
          (W per-position dot sets, §3.1.2, one ``ss_matmul`` launch
          each), ``"aggregate"`` (ONE flattened W·A dot + the equality
          indicator) or ``"auto"`` (the planner's pick by launch count).
          Both give the same secrets at the same degree.
    """
    right: SecretSharedDB
    on: Tuple[ColumnRef, ColumnRef]
    kind: str = "pkfk"
    padding: Padding = Padding.NONE
    match_method: str = "chain"

    def __post_init__(self):
        if self.kind not in JOIN_KINDS:
            raise ValueError(f"unknown join kind {self.kind!r}; choose from "
                             f"{JOIN_KINDS}")
        if len(self.on) != 2:
            raise ValueError("Join.on must be a (left, right) column pair")
        if self.match_method not in (AUTO,) + MATCH_METHODS:
            raise ValueError(
                f"unknown match_method {self.match_method!r}; choose from "
                f"{(AUTO,) + MATCH_METHODS}")


@dataclasses.dataclass(frozen=True)
class Aggregate(Plan):
    """SUM/AVG/MIN/MAX(column) [WHERE col = pattern] (OBSCURE-style).

    column: the numeric value column (outsourced in binary form via
            ``numeric_columns``).
    where:  optional equality predicate restricting the aggregate to the
            matching tuples (None = the whole relation).
    verify: run the consistency round on every opened aggregate tensor and
            raise ``VerificationError`` on an inconsistent cloud share;
            needs c >= degree + 2 clouds.
    reduce_every: MIN/MAX only — a degree-reduction round every this many
            comparator bit positions (the range plans' knob).
    """
    op: str
    column: ColumnRef
    where: Optional[Eq] = None
    verify: bool = False
    reduce_every: int = 0

    def __post_init__(self):
        if self.op not in AGG_OPS:
            raise ValueError(f"unknown aggregate op {self.op!r}; choose "
                             f"from {AGG_OPS}")
        if self.reduce_every < 0:
            raise ValueError("reduce_every must be >= 0")
        if self.reduce_every and self.op in ("sum", "avg"):
            raise ValueError("reduce_every is a MIN/MAX comparator knob; "
                             "SUM/AVG run in one contraction round")


@dataclasses.dataclass(frozen=True)
class EmbedLookup(Plan):
    """Oblivious embedding lookup of a step's token ids (§3.2.1 as an LM
    layer; the embedding-table relation is built with
    ``repro_torch.models.private_embed.as_embed_relation``).

    tokens: the step's token ids (batch×seq, flattened to a tuple — plans
            are plain hashable data; the result keeps the flat order).
    verify: consistency round over the opened embeddings (needs
            c >= degree+3 clouds); priced in ``explain()``.
    """
    tokens: Tuple[int, ...]
    verify: bool = False

    def __post_init__(self):
        object.__setattr__(self, "tokens",
                           tuple(int(t) for t in self.tokens))
        if not self.tokens:
            raise ValueError("EmbedLookup needs at least one token id")
        if min(self.tokens) < 0:
            raise ValueError("token ids must be >= 0")


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Uniform result: ``rows``/``addresses`` are None for counts; ``count``
    is the number of satisfying tuples whenever it is known; ``value`` is
    an aggregate's opened scalar (int for SUM/MIN/MAX, float for AVG; None
    when a conditional MIN/MAX/AVG matched nothing); ``embeddings`` an
    ``EmbedLookup``'s opened float32 ``(n_tokens, D)`` numpy matrix;
    ``strategy`` echoes the executed algorithm and ``plan`` the logical
    plan."""
    plan: Plan
    ledger: CostLedger
    strategy: str
    rows: Optional[List[List[str]]] = None
    count: Optional[int] = None
    addresses: Optional[List[int]] = None
    value: Optional[float] = None
    embeddings: Optional[object] = None     # np.ndarray; typed loosely to
    #                                         keep plans free of numpy

    def __post_init__(self):
        if self.count is None and self.rows is not None:
            object.__setattr__(self, "count", len(self.rows))

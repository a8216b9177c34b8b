"""Logical query plans — the user-facing half of the client API.

A plan is a small frozen dataclass describing *what* to compute (predicate,
columns by name, padding policy); :class:`repro_torch.api.QueryClient`
decides *how* (strategy, backend, random streams) and returns a uniform
:class:`QueryResult`. This slice carries the count and selection families
over equality predicates.

Padding is a security knob: fetching ``Padding.rows`` fake rows hides the
true result size ℓ from the clouds (§3.2.2 output-size attack).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

from ..core.costs import CostLedger

ColumnRef = Union[str, int]

AUTO = "auto"
SELECT_STRATEGIES = ("one_tuple", "one_round", "tree")


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
class Padding:
    """Output-size-attack resistance: pad the oblivious fetch to ``rows``
    rows (≥ true ℓ); the extra rows are all-zero one-hots."""
    rows: Optional[int] = None

    def __post_init__(self):
        if self.rows is not None and self.rows < 0:
            raise ValueError("Padding.rows must be >= 0")

    @classmethod
    def to_rows(cls, rows: int) -> "Padding":
        return cls(rows=rows)


Padding.NONE = Padding()


class Plan:
    """Marker base class for logical plans."""


@dataclasses.dataclass(frozen=True)
class Count(Plan):
    """COUNT(*) WHERE <predicate> (§3.1, Algorithm 2)."""
    where: Eq


@dataclasses.dataclass(frozen=True)
class Select(Plan):
    """SELECT * WHERE col = pattern (§3.2, Algorithms 3 & 4).

    strategy: ``"auto"`` lets the cost-based planner pick among the paper's
    three algorithms, or force ``"one_tuple" | "one_round" | "tree"``.
    ``expected_matches`` is the planner's cardinality hint (ℓ); one_tuple
    is eligible only when the hint says ℓ = 1 (the algorithm verifies).
    """
    where: Eq
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


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Uniform result: ``rows``/``addresses`` are None for counts; ``count``
    is the number of satisfying tuples whenever it is known; ``strategy``
    echoes the executed algorithm and ``plan`` the logical plan."""
    plan: Plan
    ledger: CostLedger
    strategy: str
    rows: Optional[List[List[str]]] = None
    count: Optional[int] = None
    addresses: Optional[List[int]] = None

    def __post_init__(self):
        if self.count is None and self.rows is not None:
            object.__setattr__(self, "count", len(self.rows))

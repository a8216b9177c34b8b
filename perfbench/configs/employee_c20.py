"""The paper's Employee relation: its rows from the seed, and the plain
reference that answers every query of a mix over them.

The rows are a frozen copy of ``chip_smoke.make_rows``: EmployeeId
unique, FirstName over 300 words and LastName over 500, Salary in
hundreds of dollars (100..2000), Department over 8, with FirstName's
planted ℓ = 3 (Zorro) and ℓ = 16 (Quinn). Beside them, from a second
stream of the seed, rare values that selects with 1 to 16 matches ask
for: first names, small departments and executives' salaries above 2000,
each held by 1 to 16 tuples (``rare`` in the configuration's file).

Plain numpy over the plaintext; nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

NAMES = ["EmployeeId", "FirstName", "LastName", "Salary", "Department"]
PLANT = {"one_round": "Zorro", "tree": "Quinn", "absent": "Nobody"}
ELL = {"Zorro": 3, "Quinn": 16}
DEPARTMENTS = ["Sale", "Design", "Research", "Finance", "Legal", "Support",
               "Ops", "HR"]


def _words(rng, k: int, lo: int, hi: int, taken) -> np.ndarray:
    """k distinct capitalised words of lo..hi letters, none in ``taken``."""
    low = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    up = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    out = set()
    while len(out) < k:
        n = int(rng.integers(lo, hi + 1))
        w = up[rng.integers(26)] + "".join(low[rng.integers(0, 26, n - 1)])
        if w not in taken:
            out.add(w)
    return np.array(sorted(out))


def base_rows(n: int, seed: int) -> np.ndarray:
    """(n, 5) str array, as ``chip_smoke.make_rows``."""
    rng = np.random.default_rng(seed)
    taken = set(PLANT.values())
    first = _words(rng, 300, 3, 8, taken)
    last = _words(rng, 500, 4, 8, taken)
    dept = np.array(DEPARTMENTS)
    rows = np.empty((n, 5), dtype=object)
    rows[:, 0] = [f"E{i:07d}" for i in rng.permutation(n)]
    rows[:, 1] = first[rng.integers(0, len(first), n)]
    rows[:, 2] = last[rng.integers(0, len(last), n)]
    rows[:, 3] = [str(v) for v in rng.integers(100, 2001, n)]
    rows[:, 4] = dept[rng.integers(0, len(dept), n)]
    planted = rng.choice(n, ELL["Zorro"] + ELL["Quinn"], replace=False)
    rows[planted[:ELL["Zorro"]], 1] = "Zorro"
    rows[planted[ELL["Zorro"]:], 1] = "Quinn"
    return rows


def make_rows(sizes: dict, seed: int) -> np.ndarray:
    """The relation of ``sizes["n"]`` tuples with ``sizes["rare"]``'s rare
    values planted, the i-th of a column on 1 + i mod ``sizes["rare_most"]``
    tuples that hold no other planted value: the words and the tuples are
    the seed's, the multiplicities the same for every seed."""
    n = sizes["n"]
    rows = base_rows(n, seed)
    rng = np.random.default_rng([seed, 2])
    rare = sizes["rare"]
    most = sizes["rare_most"]
    taken = set(rows[:, 1]) | set(rows[:, 2]) | set(rows[:, 4]) \
        | set(PLANT.values())
    values = {
        "FirstName": list(_words(rng, rare["FirstName"], 3, 8, taken)),
        "Department": list(_words(rng, rare["Department"], 3, 8, taken)),
        "Salary": [str(v) for v in 2001 + rng.choice(
            sizes["salary_rare_span"], rare["Salary"], replace=False)],
    }
    free = iter(rng.permutation(n))
    for col, vals in values.items():
        j = NAMES.index(col)
        for i, v in enumerate(vals):
            # every seed plants the same multiplicities: 1, 2, .., most, 1..
            for _ in range(1 + i % most):
                rows[next(free), j] = v
    return rows


class Data:
    """The plaintext columns the traffic draws its predicates from."""

    def __init__(self, rows: np.ndarray, numeric: Dict[str, int]):
        self.rows = rows
        self.columns = {c: rows[:, j].astype(str)
                        for j, c in enumerate(NAMES)}
        self.numeric = {c: rows[:, NAMES.index(c)].astype(np.int64)
                        for c in numeric}


@dataclasses.dataclass
class Answer:
    count: Optional[int] = None
    addresses: Optional[List[int]] = None
    rows: Optional[List[List[str]]] = None
    value: Optional[float] = None


class Reference:
    """Answers queries over ``rows`` with numpy; answers are cached by
    query, since Zipf-skewed traffic repeats them."""

    def __init__(self, data: Data, word_length: int):
        self.data = data
        self.w = word_length
        self._cache = {}

    def _hits(self, q) -> np.ndarray:
        if q.predicate == "between":
            vals = self.data.numeric[q.column]
            return (vals >= q.lo) & (vals <= q.hi)
        return self.data.columns[q.column] == q.value

    def answer(self, q) -> Answer:
        if q in self._cache:
            return self._cache[q]
        if q.plan == "aggregate":
            vals = self.data.numeric[q.column]
            value = {"sum": lambda: int(vals.sum()),
                     "avg": lambda: int(vals.sum()) / len(vals),
                     "min": lambda: int(vals.min()),
                     "max": lambda: int(vals.max())}[q.op]()
            out = Answer(value=value)
        else:
            addrs = [int(i) for i in np.flatnonzero(self._hits(q))]
            out = Answer(count=len(addrs))
            if q.plan in ("select", "range_select"):
                out.addresses = addrs
                out.rows = [list(self.data.rows[a]) for a in addrs]
        self._cache[q] = out
        return out


def agrees(q, got: Answer, want: Answer) -> bool:
    """Whether an opened result says what the reference says: the count,
    every row (in any order) and the addresses where the result gives
    them, or the aggregate's value, exactly."""
    if q.plan == "aggregate":
        return got.value == want.value
    if got.count != want.count:
        return False
    if want.rows is not None:
        if got.rows is None or sorted(got.rows) != sorted(want.rows):
            return False
        if got.addresses is not None and \
                sorted(got.addresses) != want.addresses:
            return False
    return True


def control_reference(data: Data, word_length: int) -> Reference:
    """The control: the reference in the program's place with one
    guarantee broken, every tuple answering. It answers over the first of
    the relation's two shards only, as a plane that left out the other
    shard's partial results would."""
    half = len(data.rows) // 2
    part = Data(data.rows[:half], list(data.numeric))
    return Reference(part, word_length)

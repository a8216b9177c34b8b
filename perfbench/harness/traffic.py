"""The one traffic generator: it reads a mix's data file and the seed.

A query mix (``"kind": "queries"``) lists weighted entries, each a kind of
plan and how its predicate is drawn; every client thread of the closed
loop (``"loop": "closed"``, the only loop there is) draws its own endless
stream of :class:`Query` from the seed. Predicate values come from the
relation's plaintext values, Zipf-skewed over a seeded order of them, so
a few values are asked most.

A generation mix (``"kind": "generation"``) gives the batch and the
log-normal laws of the prompt and output lengths. Every seed serves the
same lengths: batch ``i`` has the ``i``-th prompt length of a fixed
ladder of the prompt law's quantiles, and its requests the output law's
``batch`` quantiles, in an order drawn from the seed; the prompt ids are
drawn from the seed and the batch's index.

Queries are plain data: the query loop turns them into the program's plans and
the configuration's reference answers them.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Iterator, List, Sequence, Tuple

import numpy as np

#: streams of one seed: the shared orders of the values, each client's
#: window stream, the warm-up's queries, each generated batch, the
#: warm-up's batch
POOLS, CLIENT, WARMUP, BATCH, BATCH_WARMUP = 11, 12, 13, 21, 22


@dataclasses.dataclass(frozen=True)
class Query:
    """One query as plain data."""
    plan: str                   # count | select | range_count |
    #                             range_select | aggregate
    column: str
    predicate: str = "eq"       # eq | between | none
    value: str = ""             # the word
    strategy: str = "auto"      # a select's: auto | one_tuple | ...
    lo: int = 0
    hi: int = 0
    op: str = ""                # an aggregate's: sum | avg | min | max
    reduce_every: int = 0


#: the order of sizes that every seed's Zipf ranks and prompt ladder follow
SIZE_ORDER = 20260
#: the loops the query loop implements
LOOPS = ("closed",)


class Zipf:
    """Draws items Zipf-skewed (exponent ``s``) over a seeded order.

    With ``sizes`` (the work an item asks for, such as its matches), the
    ranks follow one order of the sizes that is the same for every seed,
    and the seed orders only the items of equal size: where every seed's
    data hold the same sizes, every seed asks for the same work at each
    rank, in another order of values."""

    def __init__(self, items: Sequence, s: float, rng, sizes=None):
        if not len(items):
            raise ValueError("a Zipf pool needs at least one item")
        order = rng.permutation(len(items))
        if sizes is not None:
            by_size = order[np.argsort(np.asarray(sizes)[order],
                                       kind="stable")]
            order = by_size[np.random.default_rng(SIZE_ORDER).permutation(
                len(items))]
        self.items = [items[i] for i in order]
        w = 1.0 / np.arange(1, len(items) + 1, dtype=np.float64) ** s
        self.cdf = np.cumsum(w / w.sum())

    def draw(self, rng):
        i = int(np.searchsorted(self.cdf, rng.random(), side="right"))
        return self.items[min(i, len(self.items) - 1)]


def _distinct(values: np.ndarray):
    uniq, counts = np.unique(values, return_counts=True)
    return uniq, counts


class _Entry:
    """One weighted entry of a query mix, with its pools of values."""

    def __init__(self, spec: dict, data, s: float, rng):
        self.spec = spec
        self.plan = spec["plan"]
        self.pools: List[tuple] = []          # (column, Zipf)
        cols = spec.get("columns") or [spec["column"]]
        for col in cols:
            if self.plan in ("range_count", "aggregate"):
                vals = data.numeric[col]
                self.pools.append((col, (int(vals.min()), int(vals.max()))))
                continue
            sizes = None
            if self.plan == "range_select":
                items, sizes = _windows(data.numeric[col], *spec["matches"])
            else:
                uniq, counts = _distinct(data.columns[col])
                if "matches" in spec:
                    lo, hi = spec["matches"]
                    keep = (counts >= lo) & (counts <= hi)
                    uniq, sizes = uniq[keep], counts[keep]
                items = list(uniq)
            self.pools.append((col, Zipf(items, s, rng, sizes)))

    def draw(self, rng) -> Query:
        spec = self.spec
        col, pool = self.pools[int(rng.integers(len(self.pools)))]
        if self.plan == "range_count":
            lo, hi = sorted(int(v) for v in rng.integers(pool[0], pool[1] + 1,
                                                         2))
            return Query("range_count", col, "between", lo=lo, hi=hi,
                         reduce_every=spec.get("reduce_every", 0))
        if self.plan == "range_select":
            lo, hi = pool.draw(rng)
            return Query("range_select", col, "between", lo=lo, hi=hi,
                         reduce_every=spec.get("reduce_every", 0))
        if self.plan == "aggregate":
            ops = spec["ops"]
            op = ops[int(rng.integers(len(ops)))]
            every = spec.get("reduce_every", 0) if op in ("min", "max") else 0
            return Query("aggregate", col, "none", op=op, reduce_every=every)
        return Query(self.plan, col, "eq", value=str(pool.draw(rng)),
                     strategy=spec.get("strategy", "auto"))


def _windows(values: np.ndarray, lo: int, hi: int):
    """Ranges that each hold the tuples of one value whose multiplicity is
    ``lo`` to ``hi``: from past its lower neighbour to short of its upper
    one (or the value alone at an end), with those multiplicities."""
    uniq, counts = _distinct(values)
    items, sizes = [], []
    for i in np.flatnonzero((counts >= lo) & (counts <= hi)):
        low = int(uniq[i - 1]) + 1 if i > 0 else int(uniq[i])
        high = int(uniq[i + 1]) - 1 if i + 1 < len(uniq) else int(uniq[i])
        items.append((low, high))
        sizes.append(int(counts[i]))
    return items, sizes


class QueryMix:
    """A query mix's entries and pools for one seed."""

    def __init__(self, mix: dict, data, seed: int):
        if mix["kind"] != "queries":
            raise ValueError(f"not a query mix: {mix['kind']}")
        if mix["loop"] not in LOOPS:
            raise ValueError(f"loop {mix['loop']!r} is not implemented; "
                             f"the query loop runs {LOOPS}")
        self.mix = mix
        self.seed = seed
        rng = np.random.default_rng([seed, POOLS])
        self.entries = [_Entry(e, data, mix.get("zipf_s", 1.0), rng)
                        for e in mix["mix"]]
        w = np.array([e["weight"] for e in mix["mix"]], dtype=np.float64)
        self.cdf = np.cumsum(w / w.sum())

    def stream(self, client: int) -> Iterator[Query]:
        """Client ``client``'s endless stream of queries."""
        rng = np.random.default_rng([self.seed, CLIENT, client])
        while True:
            i = int(np.searchsorted(self.cdf, rng.random(), side="right"))
            yield self.entries[min(i, len(self.entries) - 1)].draw(rng)


def lognormal_levels(law: dict, k: int) -> List[int]:
    """The ``k`` quantiles at (i + 1/2) / k, i < k, of the log-normal law
    ``law`` (its ``median`` and ``sigma``), as whole tokens of at least
    1 and, where the law has one, at most its ``max``."""
    z = statistics.NormalDist()
    out = [max(1, round(law["median"] * float(np.exp(
        law["sigma"] * z.inv_cdf((i + 0.5) / k))))) for i in range(k)]
    return [min(v, law["max"]) for v in out] if "max" in law else out


class GenerationMix:
    """A generation mix's batches for one seed."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        if mix["kind"] != "generation":
            raise ValueError(f"not a generation mix: {mix['kind']}")
        self.batch, self.vocab, self.seed = mix["batch"], vocab, seed
        ladder = lognormal_levels(mix["prompt"], mix["prompt"]["levels"])
        order = np.random.default_rng(SIZE_ORDER).permutation(len(ladder))
        self.prompt_lens = [ladder[i] for i in order]
        self.outputs = lognormal_levels(mix["output"], self.batch)
        #: the cache positions the longest batch needs
        self.max_len = max(ladder) + max(self.outputs) - 1

    def batch_at(self, index: int, warmup: bool = False
                 ) -> Tuple[np.ndarray, List[int]]:
        """Batch ``index``'s (batch, prompt length) int32 prompt ids,
        uniform over the vocabulary, and each request's new tokens
        (``warmup``: the warm-up's stream)."""
        rng = np.random.default_rng([self.seed,
                                     BATCH_WARMUP if warmup else BATCH,
                                     index])
        t = self.prompt_lens[index % len(self.prompt_lens)]
        ids = rng.integers(0, self.vocab, (self.batch, t),
                           dtype=np.int64).astype(np.int32)
        return ids, [int(v) for v in rng.permutation(self.outputs)]


def warmup_queries(mix: QueryMix, per_entry: int) -> List[Query]:
    """``per_entry`` queries of every entry of the mix (every family the
    window sends), from the warm-up stream."""
    rng = np.random.default_rng([mix.seed, WARMUP])
    return [e.draw(rng) for e in mix.entries for _ in range(per_entry)]

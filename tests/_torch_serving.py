"""Shared data of the port's serving tests (MapReduce, threaded dataplane,
multi-relation client, QueryServer): small relations outsourced once by the
JAX reference and carried over to the port with ``from_arrays``, so both
packages query identical shares, plus one plan list per query family built
from either package's plan classes.

Sizes are small: n = 12 tuples, W = 4, a 20-symbol alphabet, t = 8 bits,
c = 20 clouds. Opened values, rows and ledgers are exact, so every
comparison has tolerance 0; shares are never compared (the generators
differ)."""
import numpy as np

ALPHABET = "\0abcdefgh0123456789-"
W = 4
C = 20
T = 8
NAMES = ["Id", "Nm", "Dept", "V", "U"]
KID_NAMES = ["Id", "Task"]
TAG_NAMES = ["Nm", "Tag"]


def _rows():
    rng = np.random.default_rng(19)
    nm = rng.choice(["ab", "cab", "bab", "ef"], 12)
    dept = rng.choice(["g", "h"], 12)
    v = rng.integers(-60, 61, 12)
    u = rng.integers(0, 51, 12)
    return [[f"e{k:02d}", str(a), str(d), str(x), str(y)]
            for k, (a, d, x, y) in enumerate(zip(nm, dept, v, u))]


ROWS = _rows()
IDS = [r[0] for r in ROWS]
# a PK/FK child relation (repeats allowed, "h99" dangles) and an equijoin
# right side whose names "cab" and "ef" are common with ROWS
KIDS = [[IDS[3], "a"], [IDS[0], "bb"], [IDS[3], "c"], ["h99", "d"],
        [IDS[11], "ee"], [IDS[7], "f"]]
TAGS = [["cab", "a"], ["gh", "b"], ["ef", "c"], ["cab", "d"], ["hhh", "e"]]
FAMILIES = ["count", "select", "pattern", "range", "aggregate", "join"]


def pair(jax, seed, rows, names, numeric=None, alphabet=ALPHABET,
         word_length=W):
    """(reference DB, port DB) over identical shares."""
    from repro.core import Codec as JCodec
    from repro.core import outsource as joutsource
    from repro_torch.core import from_arrays
    jdb = joutsource(jax.random.PRNGKey(seed), rows, column_names=names,
                     codec=JCodec(alphabet=alphabet,
                                  word_length=word_length),
                     n_shares=C, degree=1, numeric_columns=numeric)
    tdb = from_arrays(np.asarray(jdb.relation.values),
                      degree=jdb.relation.degree, alphabet=alphabet,
                      word_length=word_length, column_names=names,
                      numeric={c: np.asarray(s.values)
                               for c, s in jdb.numeric.items()},
                      numeric_bits=jdb.numeric_bits,
                      base_degree=jdb.base_degree, device="cpu")
    return jdb, tdb


def relations(jax):
    """{"X": main, "K": PK/FK children, "T": equijoin right}, each a
    (reference DB, port DB) pair."""
    return {"X": pair(jax, 41, ROWS, NAMES, numeric={3: T, 4: T}),
            "K": pair(jax, 42, KIDS, KID_NAMES),
            "T": pair(jax, 43, TAGS, TAG_NAMES)}


def plans(m, family, kids=None, tags=None):
    """The family's plans from module ``m`` (``repro.api`` or
    ``repro_torch.api``); joins take the right relations of that package.
    Two columns in one count stack take the row-block matcher, a tree
    select its block rounds, suffix/contains the sliding window."""
    if family == "count":
        return [m.Count(m.Eq("Nm", "ab")), m.Count(m.Eq("Dept", "g"))]
    if family == "select":
        return [m.Select(m.Eq("Id", IDS[2]), strategy="one_tuple"),
                m.Select(m.Eq("Nm", "cab"), strategy="one_round"),
                m.Select(m.Eq("Dept", "h"), strategy="tree")]
    if family == "pattern":
        return [m.Count(m.Suffix("Nm", "ab")), m.Count(m.Contains("Id", "1")),
                m.Select(m.Prefix("Nm", "b"), strategy="one_round"),
                m.Select(m.Contains("Nm", "a"), strategy="tree")]
    if family == "range":
        return [m.RangeCount(m.Between("V", -10, 20), reduce_every=2),
                m.RangeSelect(m.Between("V", 0, 30), reduce_every=2)]
    if family == "aggregate":
        return [m.Aggregate("sum", "V"),
                m.Aggregate("avg", "U", where=m.Eq("Dept", "g")),
                m.Aggregate("max", "U", where=m.Eq("Nm", "ab"))]
    if family == "join":
        return [m.Join(right=kids, on=("Id", "Id")),
                m.Join(right=tags, on=("Nm", "Nm"), kind="equi",
                       padding=m.Padding.fake_values(1))]
    raise ValueError(family)


def mixed(m, rels, side, families=FAMILIES):
    """One batch of the families' plans for package ``m`` over
    ``relations()`` (side 0 = the reference's DBs, 1 = the port's)."""
    kids, tags = rels["K"][side], rels["T"][side]
    return [p for f in families for p in plans(m, f, kids, tags)]


def raising_backend():
    """The port's default backend with an ``ss_matmul`` that fails as a
    kernel launch does."""
    from repro_torch.api import backends
    base = backends.get_backend("cuda")

    def ss_matmul(a, b):
        raise RuntimeError("ss_matmul kernel launch failed: CUDA error 700")

    return backends.Backend(
        "raising", ss_matmul=ss_matmul, aa_match_batch=base.aa_match_batch,
        aa_match_rows=base.aa_match_rows, ripple_segment=base.ripple_segment,
        ripple_carry=base.ripple_carry, aa_slide_batch=base.aa_slide_batch,
        aa_slide_rows=base.aa_slide_rows, share_onehot=base.share_onehot,
        match_matrix=base.match_matrix,
        match_matrix_batch=base.match_matrix_batch)


def same(a, b):
    """Two results (of either package) agree field for field."""
    assert a.strategy == b.strategy
    assert a.count == b.count
    assert a.addresses == b.addresses
    assert a.rows == b.rows
    assert a.value == b.value
    assert a.ledger.as_dict() == b.ledger.as_dict()

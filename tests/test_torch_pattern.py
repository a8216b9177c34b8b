"""Pattern predicates through the port's QueryClient against the reference.

The reference's 8-word fixture (``tests/test_pattern.py``) and a small
Employee relation are outsourced by the JAX package and carried over with
``from_arrays``, so both packages query identical shares. One reference
``run_batch`` per relation (a module fixture) covers every LIKE shape, the
Prefix/Suffix/Contains classes, one_round / tree / AUTO selects, distinct
columns, padding, a wildcard-free LIKE on the one_tuple path and an Eq
count and a range count beside them. The port must open the same counts,
addresses and rows, choose the same strategies and charge the same
``CostLedger``, field for field — each plan run alone, and the whole batch
at S ∈ {1, 2, 3} shards — and every answer must equal a plaintext oracle.
Opened values are exact, so the tolerance is 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import Codec as JCodec  # noqa: E402
from repro.core import encoding as jencoding  # noqa: E402
from repro.core import outsource as joutsource  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api.client import _lower_match  # noqa: E402
from repro_torch.core import ShardedRelation, from_arrays  # noqa: E402
from repro_torch.core.costs import CostLedger  # noqa: E402
from repro_torch.core.encoding import DEFAULT_ALPHABET, PatternSpec  # noqa: E402,E501
from repro_torch.core.queries import pattern, rounds  # noqa: E402

W = 8
ROWS = [
    ["banana", "x", "1"], ["bandana", "y", "2"], ["an", "z", "3"],
    ["nab", "x", "4"], ["ban", "y", "5"], ["anna", "z", "6"],
    ["cab", "x", "7"], ["cabana", "y", "8"],
]
WORDS = [r[0] for r in ROWS]
EMP_NAMES = ["EmployeeId", "FirstName", "LastName", "Salary", "Department"]
EMPLOYEES = [
    ["E0100000", "Zorro", "Adams", "50", "Sale"],
    ["E0120000", "Quinn", "Smith", "12", "Legal"],
    ["E0012300", "Quincy", "Quinn", "77", "Ops"],
    ["E0107777", "Zoaro", "Finn", "7", "Legal"],
    ["E1234567", "Robin", "Zorro", "31", "HR"],
    ["E0012345", "Quinn", "Binns", "9", "Sale"],
    ["E7777777", "Anna", "Quinn", "5", "Ops"],
    ["E0000001", "Zorro", "Lee", "64", "Design"],
]


def _like(word: str, pat: str) -> bool:
    """Plaintext oracle of the engine's LIKE (``_`` also matches past the
    end of the word, the documented deviation from SQL)."""
    kind, body, wild = jencoding.parse_like(pat)
    if kind == "exact":
        return word == body
    if kind == "contains":
        return body in word
    if kind == "suffix":
        return word.endswith(body)
    padded = word + "\0" * W
    ok = all(i in wild or padded[i] == ch for i, ch in enumerate(body))
    return ok if kind == "prefix" else ok and all(
        padded[i] == "\0" for i in range(len(body), W))


def _source(where) -> str:
    """A predicate's LIKE pattern (Eq as a wildcard-free LIKE)."""
    for cls, fmt in ((japi.Prefix, "{}%"), (japi.Suffix, "%{}"),
                     (japi.Contains, "%{}%")):
        if isinstance(where, cls):
            return fmt.format(where.literal)
    return where.pattern


def _truth(rows, names, where):
    col = where.column if isinstance(where.column, int) \
        else names.index(where.column)
    return [i for i, r in enumerate(rows) if _like(r[col], _source(where))]


def _port(obj):
    """The reference plan or predicate's twin in the port's API."""
    if isinstance(obj, (japi.Count, japi.Select)):
        where = _port(obj.where)
        if isinstance(obj, japi.Count):
            return api.Count(where)
        return api.Select(where, strategy=obj.strategy,
                          expected_matches=obj.expected_matches,
                          padding=api.Padding(rows=obj.padding.rows),
                          branching=obj.branching)
    if isinstance(obj, japi.RangeCount):
        return api.RangeCount(api.Between(obj.where.column, obj.where.lo,
                                          obj.where.hi))
    return getattr(api, type(obj).__name__)(*vars(obj).values())


LIKE_PATTERNS = ["ban%", "%ana", "%an%", "b_n%", "banana", "b_nd_na",
                 "%na", "nab", "%a%", "c%", "_an%"]


def _ell(pat):
    return sum(_like(w, pat) for w in WORDS)


def _sel(where, strategy, **kw):
    return japi.Select(where, strategy=strategy, **kw)


PLANS = {f"count-{p}": japi.Count(japi.Like(0, p)) for p in LIKE_PATTERNS}
PLANS.update({
    "count-prefix": japi.Count(japi.Prefix(0, "ba")),
    "count-suffix": japi.Count(japi.Suffix(0, "ana")),
    "count-contains": japi.Count(japi.Contains(0, "an")),
    "count-contains-overlap": japi.Count(japi.Contains(0, "ana")),
    "count-eq": japi.Count(japi.Eq(1, "x")),
    "range": japi.RangeCount(japi.Between(2, 2, 6)),
    "one_tuple-like-exact": _sel(japi.Like(0, "banana"), "one_tuple",
                                 expected_matches=1),
    "one_round-prefix-padded": _sel(japi.Prefix(0, "ba"), "one_round",
                                    padding=japi.Padding.to_rows(5)),
    "one_round-contains-col1": _sel(japi.Contains(1, "y"), "one_round"),
    "tree-suffix-branching": _sel(japi.Suffix(0, "na"), "tree",
                                  expected_matches=_ell("%na"), branching=2),
})
for _s, _pats in (("one_round", ("%an%", "%na", "b_n%", "ca%")),
                  ("tree", ("%an%", "b_n%")), ("auto", ("%na", "ca%"))):
    for _p in _pats:
        PLANS[f"{_s}-{_p}"] = _sel(japi.Like(0, _p), _s,
                                   expected_matches=_ell(_p))

EMP_PLANS = {
    "masked": japi.Count(japi.Like("FirstName", "Zo_ro")),
    "prefix": japi.Count(japi.Like("FirstName", "Qu%")),
    "suffix": japi.Count(japi.Suffix("LastName", "inn")),
    "contains": japi.Count(japi.Contains("FirstName", "inn")),
    "exact-like": japi.Count(japi.Like("Department", "Legal")),
    "select-masked": _sel(japi.Like("EmployeeId", "E01_0000"), "one_round"),
    "select-suffix": _sel(japi.Suffix("EmployeeId", "7777"), "one_round"),
    "select-tree-contains": _sel(japi.Contains("EmployeeId", "12345"),
                                 "tree", expected_matches=2),
    "select-auto": _sel(japi.Contains("LastName", "inn"), "auto",
                        expected_matches=3),
}


def _carry(jdb, alphabet=DEFAULT_ALPHABET):
    return from_arrays(np.asarray(jdb.relation.values),
                       degree=jdb.relation.degree, alphabet=alphabet,
                       word_length=W, column_names=jdb.column_names,
                       numeric={c: np.asarray(s.values)
                                for c, s in jdb.numeric.items()},
                       numeric_bits=jdb.numeric_bits,
                       base_degree=jdb.base_degree, device="cpu")


@pytest.fixture(scope="module")
def dbs():
    jdb = joutsource(jax.random.PRNGKey(0), ROWS, codec=JCodec(word_length=W),
                     n_shares=20, numeric_columns={2: 8})
    return jdb, _carry(jdb)


@pytest.fixture(scope="module")
def emp_dbs():
    jdb = joutsource(jax.random.PRNGKey(1), EMPLOYEES,
                     column_names=EMP_NAMES, codec=JCodec(word_length=W),
                     n_shares=20)
    return jdb, _carry(jdb)


@pytest.fixture(scope="module")
def reference(dbs):
    plans = list(PLANS.values())
    return dict(zip(PLANS, japi.QueryClient(dbs[0], key=3, backend="jnp")
                    .run_batch(plans)))


@pytest.fixture(scope="module")
def emp_reference(emp_dbs):
    plans = list(EMP_PLANS.values())
    return dict(zip(EMP_PLANS, japi.QueryClient(
        emp_dbs[0], key=4, backend="jnp").run_batch(plans)))


def _same(jr, tr, rows, names, plan):
    """Reference and port results agree field for field, and with the
    plaintext oracle."""
    assert tr.strategy == jr.strategy
    assert tr.count == jr.count
    assert tr.addresses == jr.addresses
    assert tr.rows == jr.rows
    assert tr.ledger.as_dict() == jr.ledger.as_dict()
    if isinstance(plan, japi.RangeCount):
        return
    want = _truth(rows, names, plan.where)
    assert tr.count == len(want)
    if tr.addresses is not None:
        assert tr.addresses == want
    if tr.rows is not None:
        assert sorted(tr.rows) == sorted(rows[a] for a in want)


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_matches_reference(dbs, reference, name):
    plan = PLANS[name]
    res = api.QueryClient(dbs[1], 3, device="cpu").run(_port(plan))
    _same(reference[name], res, ROWS, ["0", "1", "2"], plan)


@pytest.mark.parametrize("name", list(EMP_PLANS))
def test_employee_plan_matches_reference(emp_dbs, emp_reference, name):
    plan = EMP_PLANS[name]
    res = api.QueryClient(emp_dbs[1], 4, device="cpu").run(_port(plan))
    _same(emp_reference[name], res, EMPLOYEES, EMP_NAMES, plan)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_run_batch_matches_reference(dbs, reference, shards):
    rel = ShardedRelation(dbs[1], shards=shards) if shards > 1 else dbs[1]
    outs = api.QueryClient(rel, 3, device="cpu").run_batch(
        [_port(p) for p in PLANS.values()])
    for name, res in zip(PLANS, outs):
        _same(reference[name], res, ROWS, ["0", "1", "2"], PLANS[name])


def test_batch_equals_sequential_runs(emp_dbs):
    plans = [_port(p) for p in EMP_PLANS.values()]
    batch = api.QueryClient(emp_dbs[1], 8, device="cpu").run_batch(plans)
    for p, b in zip(plans, batch):
        solo = api.QueryClient(emp_dbs[1], 8, device="cpu").run(p)
        assert (solo.rows, solo.addresses, solo.count, solo.strategy) \
            == (b.rows, b.addresses, b.count, b.strategy)
        assert solo.ledger.as_dict() == b.ledger.as_dict()


def test_wildcard_free_like_lowers_to_eq(dbs):
    _, tdb = dbs
    assert _lower_match(tdb, api.Like(0, "banana"), "t") == (0, "banana",
                                                            None)
    stats = api.DBStats.of(tdb)
    assert api.estimate_pattern_cost(stats, None) == \
        api.estimate_count_cost(stats)
    for strat in ("one_round", "tree"):
        assert api.estimate_pattern_cost(stats, None, select=strat, ell=3) \
            == api.estimate_select_cost(strat, stats, ell=3)
    a = api.QueryClient(tdb, 5, device="cpu").run(
        api.Count(api.Like(0, "banana")))
    b = api.QueryClient(tdb, 5, device="cpu").run(
        api.Count(api.Eq(0, "banana")))
    assert a.count == b.count == 1
    assert a.ledger.as_dict() == b.ledger.as_dict()
    res = api.QueryClient(tdb, 5, device="cpu").run(api.Select(
        api.Like(0, "banana"), strategy="one_tuple", expected_matches=1))
    assert res.strategy == "one_tuple" and res.rows[0][0] == "banana"


def test_explain_matches_reference_and_measured_ledgers(dbs):
    jdb, tdb = dbs
    jc = japi.QueryClient(jdb, key=11, backend="jnp")
    tc = api.QueryClient(tdb, 11, device="cpu")
    for plan in (japi.Count(japi.Contains(0, "an")),
                 japi.Count(japi.Suffix(0, "ana")),
                 japi.Count(japi.Like(0, "b_n%")),
                 japi.Count(japi.Prefix(0, "c")),
                 _sel(japi.Suffix(0, "na"), "one_round",
                      expected_matches=_ell("%na")),
                 _sel(japi.Contains(0, "an"), "one_round",
                      expected_matches=_ell("%an%"))):
        want, got = jc.explain([plan]), tc.explain([_port(plan)])
        assert (got.bits, got.rounds, got.dispatches) == \
            (want.bits, want.rounds, want.dispatches)
        res = tc.run(_port(plan))
        assert got.bits == res.ledger.communication_bits
        assert got.rounds == res.ledger.rounds
    for name in ("tree-b_n%", "auto-%na", "one_round-ca%"):
        plan = PLANS[name]
        want = [(e.strategy, e.bits, e.rounds, e.dispatches)
                for e in jc.explain(plan)]
        got = [(e.strategy, e.bits, e.rounds, e.dispatches)
               for e in tc.explain(_port(plan))]
        assert got == want
    plans = list(PLANS.values())
    want, got = jc.explain(plans), tc.explain([_port(p) for p in plans])
    assert (got.bits, got.rounds, got.dispatches) == \
        (want.bits, want.rounds, want.dispatches)

    def groups(exp):
        return [(g.family, g.size, g.estimate.strategy, g.estimate.bits,
                 g.estimate.rounds, g.estimate.dispatches)
                for g in exp.groups]
    assert groups(got) == groups(want)


def test_planner_pattern_choice_matches_reference():
    specs = [None, ("prefix", "Qu", ()), ("suffix", "inn", ()),
             ("contains", "inn", ()), ("masked", "Zo_ro", (2,))]
    for n in (8, 4096, 131072):
        js = japi.DBStats(n=n, m=5, c=20, w=8, a=69)
        ts = api.DBStats(n=n, m=5, c=20, w=8, a=69)
        for sp in specs:
            jspec = None if sp is None else jencoding.PatternSpec(*sp)
            tspec = None if sp is None else PatternSpec(*sp)
            for ell in (None, 1, 3, 40):
                want = japi.choose_pattern_strategy(js, jspec, ell=ell)
                got = api.choose_pattern_strategy(ts, tspec, ell=ell)
                assert (got.strategy, got.bits, got.rounds,
                        got.dispatches) == (want.strategy, want.bits,
                                            want.rounds, want.dispatches)
            want = japi.estimate_batch_group_cost(
                js, "tree", ells=[3, None], specs=[jspec, None])
            got = api.estimate_batch_group_cost(
                ts, "tree", ells=[3, None], specs=[tspec, None])
            assert (got.bits, got.rounds, got.dispatches) == \
                (want.bits, want.rounds, want.dispatches)


class _UnknownPredicate:
    column = 0
    pattern = "x"       # duck-typed fields must not be enough


@pytest.mark.parametrize("plan", [
    api.Count(api.Between(2, 1, 3)),
    api.Select(api.Between(2, 1, 3)),
    api.Count(_UnknownPredicate()),
    api.Count(api.Like(0, "a%b%")),                     # interior %
    api.Count(api.Like(0, "%a_b")),                     # _ under a shift
    api.Count(api.Like(0, "%%")),                       # empty body
    api.Count(api.Suffix(0, "waytoolongword")),         # k > W
    api.Count(api.Prefix(0, "é")),                      # not in the alphabet
    api.Select(api.Like(0, "ban%"), strategy="one_tuple"),
    api.Aggregate("sum", 2, where=api.Like(0, "ban%")),
])
def test_plan_not_supported(dbs, plan):
    tc = api.QueryClient(dbs[1], 1, device="cpu")
    with pytest.raises(api.PlanNotSupported):
        tc.run(plan)
    with pytest.raises(api.PlanNotSupported):
        tc.explain(plan if isinstance(plan, api.Select) else [plan])


def test_plan_not_supported_names_the_pattern(dbs):
    with pytest.raises(api.PlanNotSupported, match="Like"):
        api.QueryClient(dbs[1], 1, device="cpu").run(
            api.Count(api.Like(0, "a%b%")))


def test_like_convenience_and_free_functions(dbs):
    _, tdb = dbs
    tc = api.QueryClient(tdb, 1, device="cpu")
    assert tc.like(0, "%an%", count_only=True).count == _ell("%an%")
    assert sorted(r[0] for r in tc.like(0, "ban%").rows) == \
        ["ban", "banana", "bandana"]
    spec = pattern.like_spec(tdb.codec, "%na")
    assert pattern.like_spec(tdb.codec, "nab") is None
    cnt, led = pattern.pattern_count((2,), tdb, 0, spec)
    assert cnt == _ell("%na")
    solo = api.QueryClient(tdb, 2, device="cpu").run(
        api.Count(api.Suffix(0, "na")))
    assert led.as_dict() == solo.ledger.as_dict()
    for strategy in ("one_round", "tree"):
        rows, addrs, _ = pattern.pattern_select(
            (3,), tdb, 0, spec, strategy=strategy, ell=cnt)
        assert addrs == [i for i, w in enumerate(WORDS) if w.endswith("na")]
        assert [r[0] for r in rows] == [WORDS[a] for a in addrs]
    with pytest.raises(ValueError):
        pattern.pattern_select((3,), tdb, 0, spec, strategy="one_tuple")


def test_backend_without_slide_op_raises(dbs):
    _, tdb = dbs
    plain = api.get_backend("torch")
    bare = api.Backend("bare", ss_matmul=plain.ss_matmul,
                       aa_match_batch=plain.aa_match_batch,
                       aa_match_rows=plain.aa_match_rows)
    tc = api.QueryClient(tdb, 1, backend=bare, device="cpu")
    assert tc.run(api.Count(api.Prefix(0, "ba"))).count == 3
    with pytest.raises(ValueError, match="aa_slide_batch"):
        tc.run(api.Count(api.Suffix(0, "na")))
    with pytest.raises(ValueError):
        rounds.one_tuple_round(plain, tdb, [rounds.MatchJob(
            0, "ba", (0,), CostLedger(), PatternSpec("prefix", "ba"))])

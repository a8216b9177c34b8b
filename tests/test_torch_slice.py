"""The port's main path end to end against the JAX reference, on the CPU.

A reference ``outsource`` DB is carried over to the port with
``from_arrays``, so both packages query identical shares. The JAX
``QueryClient(backend="jnp")`` and the port's ``QueryClient(device="cpu")``
must then agree on every count, address list, decoded row, chosen strategy
and ``CostLedger`` field — for each selection strategy, AUTO planning and a
mixed ``run_batch``. Opened values are exact, so the tolerance is 0.
Sizes are small: W = 4, a 9-symbol alphabet, n = 48, c = 2W + 2 clouds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import Codec as JCodec  # noqa: E402
from repro.core import outsource as joutsource  # noqa: E402
from repro.core.costs import CostLedger as JLedger  # noqa: E402
from repro.core.queries import select as jselect  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import Codec, ShardedRelation, from_arrays, outsource  # noqa: E402,E501
from repro_torch.core import shamir  # noqa: E402
from repro_torch.core.costs import CostLedger  # noqa: E402
from repro_torch.core.queries import CardinalityError, rounds  # noqa: E402
from repro_torch.core.queries import select as tselect  # noqa: E402

ALPHABET = "\0abcdefgh"
W = 4
C = 2 * W + 2
NAMES = ["Id", "Name", "Dept"]
# Name multiplicities: "ab" once, "cab" twice, "hag" 3x, "dd" 5x, "hh" never.
PLANTED = {"ab": 1, "cab": 2, "hag": 3, "dd": 5}


def _rows():
    rng = np.random.default_rng(0)
    letters = list("abcdefgh")
    ids = set()
    while len(ids) < 48:
        ids.add("".join(rng.choice(letters, 3)))
    names = list(rng.choice(["ef", "fe", "gh", "bed", "ceg"], 48))
    pos = rng.permutation(48)
    off = 0
    for word, k in PLANTED.items():
        for p in pos[off:off + k]:
            names[p] = word
        off += k
    depts = rng.choice(["a", "b", "c"], 48)
    return [[i, str(nm), str(d)] for i, nm, d in zip(sorted(ids), names,
                                                     depts)]


ROWS = _rows()


@pytest.fixture(scope="module")
def dbs():
    jdb = joutsource(jax.random.PRNGKey(3), ROWS, column_names=NAMES,
                     codec=JCodec(alphabet=ALPHABET, word_length=W),
                     n_shares=C, degree=1)
    tdb = from_arrays(np.asarray(jdb.relation.values),
                      degree=jdb.relation.degree, alphabet=ALPHABET,
                      word_length=W, column_names=NAMES,
                      base_degree=jdb.base_degree, device="cpu")
    return jdb, tdb


def _truth(col: str, pat: str):
    j = NAMES.index(col)
    return [i for i, r in enumerate(ROWS) if r[j] == pat]


def _same(jr, tr, plaintext=None):
    """Reference and port results agree field for field."""
    assert tr.strategy == jr.strategy
    assert tr.count == jr.count
    assert tr.addresses == jr.addresses
    assert tr.rows == jr.rows
    assert tr.ledger.as_dict() == jr.ledger.as_dict()
    if plaintext is not None:
        assert tr.count == len(plaintext)
        if tr.rows is not None:
            assert sorted(tr.rows) == sorted(ROWS[a] for a in plaintext)


def _port_plan(plan):
    """The reference plan's twin in the port's API."""
    if isinstance(plan, japi.Count):
        return api.Count(api.Eq(plan.where.column, plan.where.pattern))
    return api.Select(api.Eq(plan.where.column, plan.where.pattern),
                      strategy=plan.strategy,
                      expected_matches=plan.expected_matches,
                      padding=api.Padding(rows=plan.padding.rows),
                      branching=plan.branching)


def _J(col, pat, **kw):
    return japi.Select(japi.Eq(col, pat), **kw)


SCENARIOS = {
    "count": japi.Count(japi.Eq("Name", "dd")),
    "count-absent": japi.Count(japi.Eq("Name", "hh")),
    "one_tuple": _J("Name", "ab", strategy="one_tuple"),
    "one_tuple-id": _J("Id", ROWS[17][0], strategy="one_tuple"),
    "one_round": _J("Name", "dd", strategy="one_round"),
    "one_round-absent": _J("Name", "hh", strategy="one_round"),
    "one_round-padded": _J("Name", "cab", strategy="one_round",
                           padding=japi.Padding.to_rows(4)),
    "tree": _J("Name", "dd", strategy="tree"),
    "tree-ell1": _J("Name", "ab", strategy="tree"),
    "tree-absent": _J("Name", "hh", strategy="tree"),
    "tree-branching": _J("Name", "hag", strategy="tree", branching=2),
    "tree-padded": _J("Name", "cab", strategy="tree",
                      padding=japi.Padding.to_rows(5)),
    "auto": _J("Name", "hag"),
    "auto-hint1": _J("Id", ROWS[5][0], expected_matches=1),
    "auto-wrong-hint": _J("Name", "cab", expected_matches=1),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_plan_matches_reference(dbs, name):
    jdb, tdb = dbs
    plan = SCENARIOS[name]
    jres = japi.QueryClient(jdb, key=11, backend="jnp").run(plan)
    tres = api.QueryClient(tdb, 11, device="cpu").run(_port_plan(plan))
    _same(jres, tres, _truth(plan.where.column, plan.where.pattern))


def _mixed_batch():
    return [japi.Count(japi.Eq("Name", "dd")),
            japi.Count(japi.Eq("Dept", "b")),
            _J("Id", ROWS[3][0], strategy="one_tuple"),
            _J("Name", "cab", expected_matches=1),       # replans
            _J("Name", "hag", strategy="one_round"),
            _J("Name", "hh", strategy="one_round"),      # 0-row fetch block
            _J("Name", "dd", strategy="tree", padding=japi.Padding.to_rows(6)),
            _J("Name", "hag", strategy="tree", branching=3),
            _J("Name", "hh", strategy="tree")]           # ℓ = 0: no fetch


@pytest.fixture(scope="module")
def reference_batch(dbs):
    return japi.QueryClient(dbs[0], key=5, backend="jnp").run_batch(
        _mixed_batch())


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_run_batch_matches_reference(dbs, reference_batch, shards):
    _, tdb = dbs
    plans = _mixed_batch()
    jres = reference_batch
    rel = ShardedRelation(tdb, shards=shards) if shards > 1 else tdb
    tres = api.QueryClient(rel, 5, device="cpu").run_batch(
        [_port_plan(p) for p in plans])
    for p, jr, tr in zip(plans, jres, tres):
        _same(jr, tr, _truth(p.where.column, p.where.pattern))


def test_batch_equals_sequential_runs(dbs):
    _, tdb = dbs
    plans = [_port_plan(p) for p in _mixed_batch()]
    batch = api.QueryClient(tdb, 5, device="cpu").run_batch(plans)
    for p, b in zip(plans, batch):
        solo = api.QueryClient(tdb, 5, device="cpu").run(p)
        assert (solo.rows, solo.addresses, solo.count, solo.strategy) \
            == (b.rows, b.addresses, b.count, b.strategy)
        assert solo.ledger.as_dict() == b.ledger.as_dict()


def test_explain_matches_reference(dbs):
    jdb, tdb = dbs
    jc = japi.QueryClient(jdb, key=1, backend="jnp")
    tc = api.QueryClient(tdb, 1, device="cpu")
    for plan in SCENARIOS.values():
        if not isinstance(plan, japi.Select):
            continue
        want = [(e.strategy, e.bits, e.rounds, e.dispatches)
                for e in jc.explain(plan)]
        got = [(e.strategy, e.bits, e.rounds, e.dispatches)
               for e in tc.explain(_port_plan(plan))]
        assert got == want
    plans = _mixed_batch()
    want = jc.explain(plans)
    got = tc.explain([_port_plan(p) for p in plans])
    assert (got.bits, got.rounds, got.dispatches) \
        == (want.bits, want.rounds, want.dispatches)

    def groups(exp):
        return [(g.family, g.size, g.estimate.bits, g.estimate.rounds,
                 g.estimate.dispatches) for g in exp.groups]
    assert groups(got) == groups(want)


@pytest.mark.parametrize("ell,rows", [(None, None), (1, None), (1, 3),
                                      (7, None), (40, 50)])
def test_planner_picks_the_reference_strategy(ell, rows):
    for n in (48, 4096, 131072):
        js = japi.DBStats(n=n, m=5, c=20, w=8, a=69)
        ts = api.DBStats(n=n, m=5, c=20, w=8, a=69)
        want = japi.choose_select_strategy(js, ell=ell, padded_rows=rows)
        got = api.choose_select_strategy(ts, ell=ell, padded_rows=rows)
        assert (got.strategy, got.bits, got.rounds, got.dispatches) == \
            (want.strategy, want.bits, want.rounds, want.dispatches)


def test_forced_one_tuple_on_multi_match_raises_like_reference(dbs):
    jdb, tdb = dbs
    with pytest.raises(jselect.CardinalityError) as je:
        japi.QueryClient(jdb, key=2, backend="jnp").select(
            "Name", "dd", strategy="one_tuple")
    with pytest.raises(CardinalityError) as te:
        api.QueryClient(tdb, 2, device="cpu").select("Name", "dd",
                                                      strategy="one_tuple")
    assert te.value.count == je.value.count == 5


def test_free_functions_match_reference(dbs):
    jdb, tdb = dbs
    key = jax.random.PRNGKey(4)
    jrows, jaddr, jled = jselect.select_tree(key, jdb, 1, "dd",
                                             backend="jnp", branching=3)
    trows, taddr, tled = tselect.select_tree((4,), tdb, 1, "dd",
                                             branching=3)
    assert (trows, taddr, tled.as_dict()) == (jrows, jaddr, jled.as_dict())
    jrows, jled = jselect.select_one_tuple(key, jdb, 0, ROWS[9][0],
                                           backend="jnp")
    trows, tled = tselect.select_one_tuple((4,), tdb, 0, ROWS[9][0])
    assert (trows, tled.as_dict()) == (jrows, jled.as_dict())
    led_j, led_t = JLedger(), CostLedger()
    got = tselect.fetch_by_addresses((4,), tdb, [2, 40], ledger=led_t,
                                     padded_rows=5)
    want = jselect.fetch_by_addresses(key, jdb, [2, 40], ledger=led_j,
                                      padded_rows=5, backend="jnp")
    assert got == want == [ROWS[2], ROWS[40]]
    assert led_t.as_dict() == led_j.as_dict()


def test_port_outsource_opens_to_the_reference_encoding():
    db = outsource(ROWS, n_shares=C, column_names=NAMES,
                   codec=Codec(alphabet=ALPHABET, word_length=W), seed=9,
                   device="cpu")
    opened = shamir.interpolate(db.relation).numpy()
    np.testing.assert_array_equal(
        opened, JCodec(alphabet=ALPHABET, word_length=W).encode_relation(ROWS))
    res = api.QueryClient(db, 3, device="cpu").count("Name", "hag")
    assert res.count == 3


def test_entry_points_default_to_cuda(dbs):
    _, tdb = dbs
    if torch.cuda.is_available():
        with pytest.raises(ValueError):            # relation is on the CPU
            api.QueryClient(tdb)
    else:
        with pytest.raises(RuntimeError):
            api.QueryClient(tdb)
        with pytest.raises(RuntimeError):
            outsource(ROWS[:2], n_shares=3)


def test_unsupported_plans_and_predicates_raise(dbs):
    _, tdb = dbs
    tc = api.QueryClient(tdb, 0, device="cpu")
    with pytest.raises(api.PlanNotSupported):
        tc.run(object())
    with pytest.raises(api.PlanNotSupported):
        tc.run(api.Count(where=("Name", "dd")))
    with pytest.raises(api.PlanNotSupported):
        tc.explain(42)
    with pytest.raises(NotImplementedError):
        rounds.count_phase(tc.backend, tdb, [rounds.MatchJob(
            1, "d%", (0,), CostLedger(), spec="prefix")])
    with pytest.raises(ValueError):
        tc.select("Name", "ab", strategy="one_tuple",
                  padding=api.Padding.to_rows(2))

"""Range queries and aggregation through the port against the JAX reference.

A reference ``outsource`` DB with two binary-form columns is carried over
to the port with ``from_arrays``, so both packages query identical shares.
The reference ``QueryClient(backend="jnp")`` runs ONE mixed batch (range
count/select at ``reduce_every`` 1, 2 and 3 with padding, SUM/AVG/MIN/MAX
conditional and not, an empty predicate, ``verify=True``, a count and a
selection); the port must open the same counts, addresses, rows and values
and charge the same ``CostLedger``, field for field, in that batch at
S ∈ {1, 2, 3} shards and in each plan run on its own. Opened values are
exact, so the tolerance is 0. Sizes are small: n = 12 tuples (a tournament
with an odd leftover), W = 4, t = 8 bits, c = 20 clouds. Reference runs
reuse the batch's shapes, which keeps JAX's compile time down.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import Codec as JCodec  # noqa: E402
from repro.core import outsource as joutsource  # noqa: E402
from repro.core.costs import CostLedger as JLedger  # noqa: E402
from repro.core.queries import aggregate as jagg  # noqa: E402
from repro.core.queries import range_query as jrange  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import (ShardedRelation, field, from_arrays,  # noqa: E402
                              outsource, shamir)
from repro_torch.core.costs import CostLedger  # noqa: E402
from repro_torch.core.queries import aggregate, range_query, rounds  # noqa: E402,E501
from repro_torch.core.shamir import Shares  # noqa: E402

ALPHABET = "\0abcdefgh0123456789-"
W = 4
C = 20
T = 8
NAMES = ["Id", "Nm", "Dept", "V", "U"]


def _rows():
    rng = np.random.default_rng(4)
    v = rng.integers(-60, 61, 12)
    u = rng.integers(0, 51, 12)
    v[[2, 9]] = 17                                  # a planted duplicate
    nm = rng.choice(["ab", "cd", "ef"], 12)
    dept = rng.choice(["g", "h"], 12)
    return [[f"e{k:02d}", str(a), str(d), str(x), str(y)]
            for k, (a, d, x, y) in enumerate(zip(nm, dept, v, u))]


ROWS = _rows()


def _col(name):
    j = NAMES.index(name)
    return np.array([r[j] for r in ROWS])


@pytest.fixture(scope="module")
def dbs():
    jdb = joutsource(jax.random.PRNGKey(6), ROWS, column_names=NAMES,
                     codec=JCodec(alphabet=ALPHABET, word_length=W),
                     n_shares=C, degree=1, numeric_columns={3: T, 4: T})
    tdb = from_arrays(np.asarray(jdb.relation.values),
                      degree=jdb.relation.degree, alphabet=ALPHABET,
                      word_length=W, column_names=NAMES,
                      numeric={c: np.asarray(s.values)
                               for c, s in jdb.numeric.items()},
                      numeric_bits=jdb.numeric_bits,
                      base_degree=jdb.base_degree, device="cpu")
    return jdb, tdb


def _plans(m):
    """The mixed batch, built from the plan classes of module ``m``."""
    return [
        m.RangeCount(m.Between("V", -10, 20), reduce_every=1),
        m.RangeSelect(m.Between("V", 0, 30), reduce_every=2,
                      padding=m.Padding.to_rows(6)),
        m.RangeCount(m.Between("U", 10, 30), reduce_every=2),
        m.RangeSelect(m.Between("V", 17, 17), reduce_every=3),
        m.Aggregate("sum", "V"),
        m.Aggregate("sum", "U", where=m.Eq("Nm", "ab")),
        m.Aggregate("avg", "V", where=m.Eq("Dept", "g")),
        m.Aggregate("avg", "U"),
        m.Aggregate("min", "V"),
        m.Aggregate("max", "V", where=m.Eq("Nm", "cd"), verify=True),
        m.Aggregate("min", "U", where=m.Eq("Dept", "gg")),
        m.Count(m.Eq("Nm", "ef")),
        m.Select(m.Eq("Nm", "ab"), strategy="one_round"),
    ]


PLAN_IDS = ["rcount-r1", "rselect-r2-pad", "rcount-r2", "rselect-r3",
            "sum", "sum-where", "avg-where", "avg", "min",
            "max-where-verify", "min-empty", "count", "select"]


def _truth(plan):
    """Plaintext answer: (count, addresses, value)."""
    if isinstance(plan, (api.RangeCount, api.RangeSelect)):
        x = _col(plan.where.column).astype(int)
        addr = [int(i) for i in np.nonzero((x >= plan.where.lo)
                                           & (x <= plan.where.hi))[0]]
        return len(addr), addr, None
    if isinstance(plan, (api.Count, api.Select)):
        addr = [int(i) for i in np.nonzero(
            _col(plan.where.column) == plan.where.pattern)[0]]
        return len(addr), addr, None
    x = _col(plan.column).astype(int)
    mask = (np.ones(len(x), bool) if plan.where is None
            else _col(plan.where.column) == plan.where.pattern)
    sel = x[mask]
    if plan.op == "sum":
        value = int(sel.sum())
    elif not len(sel):
        value = None
    else:
        value = {"avg": float(sel.mean()), "min": int(sel.min()),
                 "max": int(sel.max())}[plan.op]
    return int(mask.sum()), None, value


def _same(jr, tr, plan):
    assert tr.strategy == jr.strategy
    assert tr.count == jr.count
    assert tr.addresses == jr.addresses
    assert tr.rows == jr.rows
    assert tr.value == jr.value
    assert tr.ledger.as_dict() == jr.ledger.as_dict()
    cnt, addr, value = _truth(plan)
    if isinstance(plan, api.Aggregate):
        assert tr.value == (pytest.approx(value) if plan.op == "avg"
                            else value)
        if plan.where is not None and plan.op != "sum":
            assert tr.count == cnt
    else:
        assert tr.count == cnt
        if tr.addresses is not None:
            assert tr.addresses == addr
            assert tr.rows == [ROWS[a] for a in addr]


@pytest.fixture(scope="module")
def reference_batch(dbs):
    return japi.QueryClient(dbs[0], key=5, backend="jnp").run_batch(
        _plans(japi))


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_run_batch_matches_reference(dbs, reference_batch, shards):
    tdb = dbs[1]
    rel = ShardedRelation(tdb, shards=shards) if shards > 1 else tdb
    got = api.QueryClient(rel, 5, device="cpu").run_batch(_plans(api))
    for plan, jr, tr in zip(_plans(api), reference_batch, got):
        _same(jr, tr, plan)


@pytest.mark.parametrize("i", range(len(PLAN_IDS)), ids=PLAN_IDS)
def test_each_plan_alone_matches_the_reference_batch(dbs, reference_batch,
                                                     i):
    """A plan run on its own opens and charges what it did in the batch
    (the reference holds its batches equal to sequential runs)."""
    plan = _plans(api)[i]
    got = api.QueryClient(dbs[1], 5, device="cpu").run(plan)
    _same(reference_batch[i], got, plan)


def test_explain_matches_reference_and_measured_ledgers(dbs):
    jdb, tdb = dbs
    jc = japi.QueryClient(jdb, key=1, backend="jnp")
    tc = api.QueryClient(tdb, 1, device="cpu")

    def groups(exp):
        return [(g.family, g.size, g.estimate.bits, g.estimate.rounds,
                 g.estimate.dispatches) for g in exp.groups]

    for jp, tp in zip(_plans(japi), _plans(api)):
        want, got = jc.explain([jp]), tc.explain([tp])
        assert groups(got) == groups(want)
        if isinstance(tp, (api.Aggregate, api.RangeCount)):
            led = api.QueryClient(tdb, 1, device="cpu").run(tp).ledger
            assert (got.bits, got.rounds) == (led.communication_bits,
                                              led.rounds)
    want, got = jc.explain(_plans(japi)), tc.explain(_plans(api))
    assert groups(got) == groups(want)
    assert (got.bits, got.rounds, got.dispatches) \
        == (want.bits, want.rounds, want.dispatches)
    sharded = api.QueryClient(ShardedRelation(tdb, shards=3), 1,
                              device="cpu").explain(_plans(api))
    assert sharded.shards == 3 and sharded.dispatches > got.dispatches


@pytest.mark.parametrize("reduce_every", [1, 2, 3])
def test_minmax_reduce_every_against_plaintext_and_reference_pricing(
        dbs, reduce_every):
    """MIN/MAX tournaments with carry reductions inside each level: values
    equal the plaintext, and the ledger equals the reference planner's
    exact prediction (and the port's)."""
    jdb, tdb = dbs
    plans = [api.Aggregate("min", "V", reduce_every=reduce_every),
             api.Aggregate("max", "U", where=api.Eq("Nm", "cd"),
                           reduce_every=reduce_every, verify=True)]
    got = api.QueryClient(tdb, 4, device="cpu").run_batch(plans)
    jc = japi.QueryClient(jdb, key=4, backend="jnp")
    tc = api.QueryClient(tdb, 4, device="cpu")
    for plan, res in zip(plans, got):
        cnt, _, value = _truth(plan)
        assert res.value == value
        if plan.where is not None:
            assert res.count == cnt
        want = jc.explain([japi.Aggregate(
            plan.op, plan.column, where=None if plan.where is None else
            japi.Eq(plan.where.column, plan.where.pattern),
            verify=plan.verify, reduce_every=reduce_every)])
        mine = tc.explain([plan])
        assert (mine.bits, mine.rounds, mine.dispatches) \
            == (want.bits, want.rounds, want.dispatches) \
            == (res.ledger.communication_bits, res.ledger.rounds,
                mine.dispatches)


def test_free_functions_match_reference(dbs):
    """``range_count`` / ``range_select`` at B = 1, at the shapes of the
    batch's one-job range groups."""
    jdb, tdb = dbs
    key = jax.random.PRNGKey(8)
    jl, tl = JLedger(), CostLedger()
    want = jrange.range_count(key, jdb, 3, -10, 20, reduce_every=1,
                              ledger=jl, backend="jnp")[0]
    got = range_query.range_count((8,), tdb, 3, -10, 20, reduce_every=1,
                                  ledger=tl)[0]
    assert got == want == _truth(api.RangeCount(
        api.Between("V", -10, 20)))[0]
    assert tl.as_dict() == jl.as_dict()
    jrows, jaddr, jl = jrange.range_select(key, jdb, 3, 17, 17,
                                           reduce_every=3, padded_rows=4,
                                           backend="jnp")
    trows, taddr, tl = range_query.range_select((8,), tdb, 3, 17, 17,
                                                reduce_every=3,
                                                padded_rows=4)
    assert (trows, taddr) == (jrows, jaddr) == ([ROWS[2], ROWS[9]], [2, 9])
    assert tl.as_dict() == jl.as_dict()


@pytest.mark.parametrize("reduce_every", [0, 1, 2, 3])
def test_ss_sub_opens_the_sign_of_the_difference(dbs, reduce_every):
    """The single-subtraction reference: sign(B − A) bit per tuple, for
    every ``reduce_every``, equal to the fused engine's indicator."""
    tdb = dbs[1]
    x = tdb.numeric[3]                                  # (c, n, t) shares
    lo = -5
    a = shamir.share(torch.from_numpy(np.tile(
        np.asarray([(lo >> i) & 1 for i in range(T)], np.int32),
        (len(ROWS), 1))), n_shares=C, generator=torch.Generator())
    led = CostLedger()
    sign = range_query.ss_sub((3,), a, x, reduce_every=reduce_every,
                              ledger=led)
    got = field.to_numpy(shamir.interpolate(sign))
    v = _col("V").astype(int)
    np.testing.assert_array_equal(got, (v < lo).astype(np.uint32))
    n_red = (T - 1) // reduce_every if reduce_every else 0
    assert led.rounds == n_red
    ind = rounds.range_phase(api.get_backend("torch"), tdb, [
        rounds.RangeJob(3, lo, 60, (3,), CostLedger(),
                        reduce_every=reduce_every)])
    np.testing.assert_array_equal(
        field.to_numpy(shamir.interpolate(ind))[0], (v >= lo).astype(int))


def test_batch_equals_sequential_runs_on_the_port(dbs):
    tdb = dbs[1]
    plans = _plans(api)
    batch = api.QueryClient(tdb, 9, device="cpu").run_batch(plans)
    for p, b in zip(plans, batch):
        solo = api.QueryClient(tdb, 9, device="cpu").run(p)
        assert (solo.rows, solo.addresses, solo.count, solo.value,
                solo.strategy) == (b.rows, b.addresses, b.count, b.value,
                                   b.strategy)
        assert solo.ledger.as_dict() == b.ledger.as_dict()


def test_conveniences_build_the_plans(dbs):
    tc = api.QueryClient(dbs[1], 2, device="cpu")
    assert tc.range_count("V", 0, 30, reduce_every=2).count \
        == _truth(api.RangeCount(api.Between("V", 0, 30)))[0]
    res = tc.range_select("V", 17, 17, reduce_every=3,
                          padding=api.Padding.to_rows(3))
    assert res.addresses == [2, 9] and res.strategy == "range_select"
    res = tc.aggregate("avg", "V", where=api.Eq("Nm", "ab"))
    assert res.value == pytest.approx(_truth(api.Aggregate(
        "avg", "V", where=api.Eq("Nm", "ab")))[2])


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------

def test_verify_detects_a_tampered_sum_share(dbs):
    base = api.get_backend("torch")

    def bad_matmul(a, b):
        out = base.ss_matmul(a, b).clone()
        out[3] = field.add(out[3], torch.full_like(out[3], 5))
        return out

    be = dataclasses.replace(base, name="torch+tamper", ss_matmul=bad_matmul)
    plan = api.Aggregate("sum", "V", where=api.Eq("Nm", "ab"))
    with pytest.raises(api.VerificationError, match="SUM verification"):
        api.QueryClient(dbs[1], 7, backend=be, device="cpu").run(
            dataclasses.replace(plan, verify=True))
    honest = api.QueryClient(dbs[1], 7, device="cpu").run(plan)
    tampered = api.QueryClient(dbs[1], 7, backend=be, device="cpu").run(plan)
    assert tampered.value != honest.value


def test_verify_detects_a_tampered_minmax_share(dbs):
    base = api.get_backend("torch")

    def bad_segment(a, b, carry=None):
        rb, co = base.ripple_segment(a, b, carry)
        if a.shape[-2] == 1:                   # final level: one pair
            rb = rb.clone()
            rb[2] = field.add(rb[2], torch.ones_like(rb[2]))
        return rb, co

    be = dataclasses.replace(base, name="torch+tamper",
                             ripple_segment=bad_segment)
    with pytest.raises(api.VerificationError, match="MIN verification"):
        api.QueryClient(dbs[1], 7, backend=be, device="cpu").run(
            api.Aggregate("min", "V", reduce_every=2, verify=True))


def test_verify_needs_redundant_clouds():
    db = outsource([[f"i{k}", str(10 * k)] for k in range(4)], n_shares=2,
                   column_names=["Id", "V"], numeric_columns={1: 8},
                   seed=4, device="cpu")
    tc = api.QueryClient(db, 1, device="cpu")
    assert tc.aggregate("sum", "V").value == 60
    with pytest.raises(api.VerificationError, match="degree\\+2"):
        tc.aggregate("sum", "V", verify=True)


# ---------------------------------------------------------------------------
# the reference's errors
# ---------------------------------------------------------------------------

def _with_bits(db, bits):
    """The same shares with other declared bit widths (the guards look at
    the metadata before any share is read)."""
    return dataclasses.replace(db, numeric_bits={**db.numeric_bits, **bits})


def test_non_binary_columns_raise_like_the_reference(dbs):
    jdb, tdb = dbs
    for m, db, kw in ((japi, jdb, dict(key=1, backend="jnp")),
                      (api, tdb, dict(seed=1, device="cpu"))):
        cl = m.QueryClient(db, **kw)
        for plan in (m.Aggregate("sum", "Nm"),
                     m.RangeCount(m.Between("Id", 0, 3))):
            with pytest.raises(ValueError, match="binary form"):
                cl.run(plan)
            with pytest.raises(ValueError, match="binary form"):
                cl.explain([plan])


def test_sum_half_range_and_minmax_width_guards_like_the_reference(dbs):
    jdb, tdb = dbs
    for m, db, kw in ((japi, jdb, dict(key=1, backend="jnp")),
                      (api, tdb, dict(seed=1, device="cpu"))):
        with pytest.raises(ValueError, match="half-range"):
            m.QueryClient(_with_bits(db, {3: 28}), **kw).run(
                m.Aggregate("sum", "V"))
        with pytest.raises(ValueError, match=">= 2-bit"):
            m.QueryClient(_with_bits(db, {3: 1}), **kw).run(
                m.Aggregate("min", "V"))


def test_mixed_bit_widths_must_group_like_the_reference(dbs):
    jdb, tdb = dbs
    jdb, tdb = _with_bits(jdb, {4: 10}), _with_bits(tdb, {4: 10})
    jjobs = [jagg.SumJob(value_column=c, key=jax.random.PRNGKey(c),
                         ledger=JLedger()) for c in (3, 4)]
    tjobs = [aggregate.SumJob(value_column=c, key=(c,), ledger=CostLedger())
             for c in (3, 4)]
    with pytest.raises(ValueError, match="uniform"):
        jagg.agg_sum_phase(japi.get_backend("jnp"), jdb, jjobs)
    with pytest.raises(ValueError, match="uniform"):
        aggregate.agg_sum_phase(api.get_backend("torch"), tdb, tjobs)
    with pytest.raises(ValueError, match="uniform"):
        rounds.range_phase(api.get_backend("torch"), tdb, [
            rounds.RangeJob(c, 0, 1, (c,), CostLedger()) for c in (3, 4)])


def test_plan_validation_like_the_reference():
    for m in (japi, api):
        with pytest.raises(ValueError, match="unknown aggregate op"):
            m.Aggregate("median", "V")
        with pytest.raises(ValueError, match="reduce_every"):
            m.Aggregate("sum", "V", reduce_every=2)
        with pytest.raises(ValueError, match="reduce_every"):
            m.Aggregate("min", "V", reduce_every=-1)
        with pytest.raises(ValueError, match="empty range"):
            m.Between("V", 3, 2)
    with pytest.raises(ValueError, match="'min' or 'max'"):
        aggregate.MinMaxJob(value_column=3, key=(0,), ledger=CostLedger(),
                            op="sum")


def test_aggregate_predicate_must_be_eq(dbs):
    tc = api.QueryClient(dbs[1], 1, device="cpu")
    with pytest.raises(api.PlanNotSupported):
        tc.run(api.Aggregate("sum", "V", where=("Nm", "ab")))


def test_mul_public_keeps_the_degree():
    s = shamir.share(torch.tensor([3, 5], dtype=torch.int32), n_shares=4,
                     degree=2, generator=torch.Generator().manual_seed(0))
    twice = s.mul_public(2)
    assert twice.degree == 2
    assert shamir.interpolate(twice).tolist() == [6, 10]
    assert isinstance(twice, Shares)

"""PK/FK joins and equijoins (§3.3) through the port against the reference.

Every relation — the parent, three child relations and an equijoin right
side — is outsourced by the JAX package and carried over with
``from_arrays``, so both packages join identical shares. The port must open
the same rows in the same order and charge the same ``CostLedger``, field
for field: the reference's own join tests, each plan run alone, and one
``run_batch`` mixing PK/FK joins of every match method, equijoins (padded
and not), selects and a count at S ∈ {1, 2, 3} shards. The match matrices
(chain and aggregate, one pair and a stacked group), the PK/FK fetch rows
of ``join_match_round`` at S ∈ {1, 2, 3} and a re-randomization with the
reference's coefficients are compared share for share. Opened values and
shares are exact, so the tolerance is 0. Sizes are small: W = 4, a
9-symbol alphabet, 24 parent tuples, c = 2W + 2 clouds (a fetched join row
has degree 2W + 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import Codec as JCodec  # noqa: E402
from repro.core import automata as jautomata  # noqa: E402
from repro.core import field as jfield  # noqa: E402
from repro.core import outsource as joutsource  # noqa: E402
from repro.core.costs import CostLedger as JCostLedger  # noqa: E402
from repro.core.dataplane import ShardedRelation as JSharded  # noqa: E402
from repro.core.queries import equijoin as jequijoin  # noqa: E402
from repro.core.queries import pkfk_join as jpkfk_join  # noqa: E402
from repro.core.queries import rounds as jrounds  # noqa: E402
from repro.core.shamir import Shares as JShares  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import (ShardedRelation, automata,  # noqa: E402
                              from_arrays, shamir)
from repro_torch.core.costs import CostLedger  # noqa: E402
from repro_torch.core.queries import equijoin, pkfk_join, rounds  # noqa: E402
from repro_torch.core.queries._common import match_matrix_shares  # noqa: E402,E501
from repro_torch.core.shamir import Shares  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ALPHABET = "\0abcdefgh"
W = 4
C = 2 * W + 2
CODEC = JCodec(alphabet=ALPHABET, word_length=W)


def _parent():
    """24 tuples (Id, Name, Dept): unique Ids; Names repeat."""
    rng = np.random.default_rng(0)
    ids = set()
    while len(ids) < 24:
        ids.add("".join(rng.choice(list("abcdefgh"), 3)))
    names = rng.choice(["ab", "cab", "hag", "dd", "ef"], 24)
    depts = rng.choice(["a", "b", "c"], 24)
    return [[i, str(n), str(d)] for i, n, d in zip(sorted(ids), names,
                                                   depts)]


PARENT = _parent()
PIDS = [r[0] for r in PARENT]
# children (Id, Task): repeats allowed (a foreign key), "hhhh" dangles
KIDS1 = [[PIDS[3], "a"], [PIDS[0], "bb"], [PIDS[3], "c"], ["hhhh", "d"],
         [PIDS[23], "ee"], [PIDS[7], "f"]]
KIDS2 = [[PIDS[5], "g"], ["gggg", "h"], [PIDS[5], "ab"], [PIDS[11], "b"],
         [PIDS[2], "cc"], [PIDS[19], "d"]]
KIDS3 = [[PIDS[9], "e"], [PIDS[9], "f"], ["hhh", "g"], [PIDS[1], "h"]]
# equijoin right side (Name, Tag): "cab" and "dd" are common with PARENT
TAGS = [["cab", "a"], ["gh", "b"], ["dd", "c"], ["cab", "d"], ["hhh", "e"]]
NO_COMMON = [["gh", "a"], ["hhh", "b"]]


def _pair(key, rows, names, n_shares=C, codec=CODEC):
    """(reference DB, port DB) over identical shares."""
    jdb = joutsource(jax.random.PRNGKey(key), rows, column_names=names,
                     codec=codec, n_shares=n_shares, degree=1)
    tdb = from_arrays(np.asarray(jdb.relation.values), degree=1,
                      alphabet=codec.alphabet, word_length=codec.word_length,
                      column_names=names, base_degree=1, device="cpu")
    return jdb, tdb


@pytest.fixture(scope="module")
def rels():
    return {"X": _pair(1, PARENT, ["Id", "Name", "Dept"]),
            "Y1": _pair(2, KIDS1, ["Id", "Task"]),
            "Y2": _pair(3, KIDS2, ["Id", "Task"]),
            "Y3": _pair(4, KIDS3, ["Id", "Hours"]),
            "Z": _pair(5, TAGS, ["Name", "Tag"]),
            "N": _pair(6, NO_COMMON, ["Name", "Tag"])}


def _pkfk_truth(kids):
    by_id = {r[0]: r for r in PARENT}
    return [by_id[k[0]] + [k[1]] for k in kids if k[0] in by_id]


def _equi_truth(right):
    return sorted(tuple(x + [y[1]]) for x in PARENT for y in right
                  if x[1] == y[0])


def _same_result(jr, tr):
    assert tr.strategy == jr.strategy
    assert tr.rows == jr.rows
    assert tr.count == jr.count
    assert tr.addresses == jr.addresses
    assert tr.ledger.as_dict() == jr.ledger.as_dict()


# ---------------------------------------------------------------------------
# the reference's own join tests, both packages on one set of shares
# ---------------------------------------------------------------------------

_C6 = JCodec(word_length=6)
PAPER_X = [["a1", "b1"], ["a2", "b2"], ["a3", "b3"]]
PAPER_Y = [["b1", "c1"], ["b2", "c2"], ["b2", "c3"], ["b2", "c4"]]
PAPER = {
    "pkfk-paper": ("pkfk", PAPER_X, PAPER_Y, 0,
                   [["a1", "b1", "c1"], ["a2", "b2", "c2"],
                    ["a2", "b2", "c3"], ["a2", "b2", "c4"]]),
    "pkfk-dangling": ("pkfk", [["a1", "b1"]], [["b1", "c1"], ["b9", "c2"]],
                      0, [["a1", "b1", "c1"]]),
    "equi-multi": ("equi", [["a1", "b1"], ["a2", "b2"], ["a3", "b2"]],
                   [["b2", "c1"], ["b2", "c2"], ["b9", "c3"]], 0,
                   sorted([["a2", "b2", "c1"], ["a2", "b2", "c2"],
                           ["a3", "b2", "c1"], ["a3", "b2", "c2"]])),
    "equi-padded": ("equi", [["a1", "b1"]], [["b1", "c1"]], 3,
                    [["a1", "b1", "c1"]]),
}


@pytest.mark.parametrize("case", sorted(PAPER))
def test_paper_examples_match_reference(case):
    kind, x, y, pad, want = PAPER[case]
    jx, tx = _pair(11, x, ["A", "B"], n_shares=16, codec=_C6)
    jy, ty = _pair(12, y, ["B", "C"], n_shares=16, codec=_C6)
    if kind == "pkfk":
        jrows, jled = jpkfk_join(jx, jy, 1, 0)
        trows, tled = pkfk_join(tx, ty, 1, 0)
        assert jled.rounds == 1
    else:
        jrows, jled = jequijoin(jax.random.PRNGKey(7), jx, jy, 1, 0,
                                padded_values=pad)
        trows, tled = equijoin((7,), tx, ty, 1, 0, padded_values=pad)
        k = len({r[1] for r in x} & {r[0] for r in y})
        assert tled.rounds == 1 + 2 * (k + pad)
        trows, jrows = sorted(trows), sorted(jrows)
    assert trows == jrows == want
    assert tled.as_dict() == jled.as_dict()


def test_join_plan_validation(rels):
    _, tx = rels["X"]
    with pytest.raises(ValueError):
        api.Join(right=tx, on=("Id", "Id"), kind="hash")
    with pytest.raises(ValueError):
        api.Join(right=tx, on=("Id",))
    with pytest.raises(ValueError):
        api.Join(right=tx, on=("Id", "Id"), match_method="bogus")
    with pytest.raises(ValueError):
        api.Padding(values=-2)
    with pytest.raises(ValueError):
        api.Select(api.Eq("Name", "ab"), padding=api.Padding.fake_values(1))
    with pytest.raises(ValueError):
        api.RangeSelect(api.Between("Name", 1, 2),
                        padding=api.Padding.fake_values(1))
    assert api.Padding.fake_values(2) == api.Padding(values=2)


def test_unsupported_join_padding_raises(rels):
    _, tx = rels["X"]
    _, ty = rels["Y1"]
    client = api.QueryClient(tx, seed=1, device="cpu")
    with pytest.raises(ValueError):
        client.join(ty, on=("Id", "Id"), kind="pkfk",
                    padding=api.Padding.fake_values(2))
    with pytest.raises(ValueError):
        client.join(ty, on=("Id", "Id"), kind="equi",
                    padding=api.Padding.to_rows(3))
    with pytest.raises(ValueError):
        client.explain([api.Join(right=ty, on=("Id", "Id"),
                                 padding=api.Padding.fake_values(1))])


def test_pkfk_join_keyword_call_forms():
    _, tx = _pair(3, [["a1", "b1"]], ["A", "B"], n_shares=16, codec=_C6)
    _, ty = _pair(4, [["b1", "c1"]], ["B", "C"], n_shares=16, codec=_C6)
    want = [["a1", "b1", "c1"]]
    assert pkfk_join(tx, ty, 1, 0)[0] == want
    assert pkfk_join(tx, ty, col_x=1, col_y=0)[0] == want
    assert pkfk_join((5,), tx, ty, 1, 0)[0] == want
    assert pkfk_join(key=(5,), dbX=tx, dbY=ty, col_x=1, col_y=0)[0] == want
    with pytest.raises(TypeError):
        pkfk_join(tx, ty, 1)                        # missing col_y
    with pytest.raises(TypeError):
        pkfk_join(tx, ty, 1, 0, col_x=1)            # duplicate col_x
    with pytest.raises(TypeError):
        pkfk_join((5,), tx, ty, 1, 0, key=(6,))     # duplicate key


def test_client_join_matches_legacy():
    _, tx = _pair(1, PAPER_X, ["A", "B"], n_shares=16, codec=_C6)
    _, ty = _pair(2, PAPER_Y, ["B", "C"], n_shares=16, codec=_C6)
    res = api.QueryClient(tx, seed=3, device="cpu").join(ty, on=("B", "B"))
    rows, led = pkfk_join(tx, ty, 1, 0)              # key-less form
    assert res.rows == rows and res.strategy == "pkfk"
    # a keyed join re-randomizes its outputs: the same traffic and rounds,
    # plus the metered cloud work of the zero-sharing additions
    assert res.ledger.communication_bits == led.communication_bits
    assert res.ledger.rounds == led.rounds == 1
    assert res.ledger.cloud_ops_bits > led.cloud_ops_bits

    res = api.QueryClient(tx, seed=4, device="cpu").join(
        ty, on=("B", "B"), kind="equi", padding=api.Padding.fake_values(2))
    assert sorted(res.rows) == sorted(rows)
    # 2 common values + 2 fake ones, 2 rounds each (k hidden), 1 open
    assert res.ledger.rounds == 1 + 2 * 4


def test_pkfk_join_key_rerandomizes_but_preserves_result():
    _, tx = _pair(3, [["a1", "b1"], ["a2", "b2"]], ["A", "B"], n_shares=16,
                  codec=_C6)
    _, ty = _pair(4, [["b1", "c1"], ["b2", "c2"], ["b9", "c3"]], ["B", "C"],
                  n_shares=16, codec=_C6)
    legacy, _ = pkfk_join(tx, ty, 1, 0)
    keyed, _ = pkfk_join((5,), tx, ty, 1, 0)
    assert keyed == legacy == [["a1", "b1", "c1"], ["a2", "b2", "c2"]]


def test_rerandomize_bit_identical_with_reference_coefficients(rels):
    """The zero-sharing's coefficients injected from the reference's draw
    give the reference's shares exactly; drawn from a key, the shares
    differ but open to the same secret."""
    jx, tx = rels["X"]
    key = jax.random.PRNGKey(9)
    jsh = JShares(jx.relation.values[:, :5], 1)
    want = np.asarray(jrounds.rerandomize(key, jsh).values)
    coeffs = np.asarray(jfield.uniform(key, (1,) + jsh.shape))
    tsh = Shares(tx.relation.values[:, :5], 1)
    got = rounds.rerandomize(None, tsh, coeffs=torch.from_numpy(
        coeffs.astype(np.int64)))
    assert np.array_equal(got.values.numpy().astype(np.uint32), want)
    drawn = rounds.rerandomize((9,), tsh)
    assert not torch.equal(drawn.values, tsh.values)
    assert torch.equal(shamir.interpolate(drawn), shamir.interpolate(tsh))


def test_equijoin_no_common_values_returns_empty(rels):
    jx, tx = rels["X"]
    jn, tn = rels["N"]
    rows, led = equijoin((3,), tx, tn, 1, 0)
    jrows, jled = jequijoin(jax.random.PRNGKey(3), jx, jn, 1, 0)
    assert rows == jrows == [] and led.rounds == 1
    assert led.as_dict() == jled.as_dict()
    res = api.QueryClient(tx, seed=4, device="cpu").run_batch(
        [api.Join(right=tn, on=("Name", "Name"), kind="equi")])[0]
    assert res.rows == [] and res.count == 0


# ---------------------------------------------------------------------------
# match matrices and fetch rows, share for share
# ---------------------------------------------------------------------------

def _col(db, i):
    return db.relation.values[:, :, i]


def test_match_matrix_bit_identical(rels):
    """ops.match_matrix (W ss_matmul calls chained) equals the reference's
    Pallas composite (interpret mode) and both methods of the plain
    automata function; the stacked group and the aggregate matcher equal
    the reference's; the Shares helper carries the degree."""
    jx, tx = rels["X"]
    jy, ty = rels["Y1"]
    jcx, jcy = jx.relation.values[:, :, 0], jy.relation.values[:, :, 0]
    tcx, tcy = _col(tx, 0), _col(ty, 0)
    want = np.asarray(jkops.match_matrix(jcx, jcy))
    got = ops.match_matrix(tcx, tcy)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    for method in ("chain", "aggregate"):
        jm = jautomata.match_matrix(JShares(jcx, 1), JShares(jcy, 1),
                                    method=method)
        tm = automata.match_matrix(Shares(tcx, 1), Shares(tcy, 1),
                                   method=method)
        assert tm.degree == jm.degree == 2 * W
        assert np.array_equal(tm.values.numpy().astype(np.uint32),
                              np.asarray(jm.values)), method
    # a group of three pairs, two of them on one column (a B-stride-0 view)
    _, tz = rels["Y2"]
    jz = rels["Y2"][0]
    tbx = torch.stack([tcx, _col(tx, 0), _col(tx, 1)], dim=1)
    tby = torch.stack([tcy, _col(tz, 0), _col(tz, 1)], dim=1)
    jbx = np.stack([np.asarray(jcx), np.asarray(jx.relation.values[:, :, 0]),
                    np.asarray(jx.relation.values[:, :, 1])], axis=1)
    jby = np.stack([np.asarray(jcy), np.asarray(jz.relation.values[:, :, 0]),
                    np.asarray(jz.relation.values[:, :, 1])], axis=1)
    jbe = japi.get_backend("jnp")
    want_b = np.asarray(jbe.match_matrix_batch(jbx, jby))
    got_b = ops.match_matrix_batch(tbx, tby)
    assert np.array_equal(got_b.numpy().astype(np.uint32), want_b)
    expand = _col(tx, 0)[:, None].expand(C, 2, *tcx.shape[1:])
    assert torch.equal(ops.match_matrix_batch(expand, tby[:, :2]),
                       got_b[:, :2])
    want_a = np.asarray(japi.backends.aggregate_match_matrix(jbe)(jbx, jby))
    got_a = api.aggregate_match_matrix(api.get_backend("cuda"))(tbx, tby)
    assert np.array_equal(got_a.numpy().astype(np.uint32), want_a)
    # the two methods share the same secrets under different polynomials
    assert torch.equal(shamir.interpolate(Shares(got_a, 2 * W)),
                       shamir.interpolate(Shares(got_b, 2 * W)))
    sh = match_matrix_shares(api.get_backend("cuda"), Shares(tcx, 1),
                             Shares(tcy, 1))
    assert sh.degree == 2 * W and torch.equal(sh.values, got)


def test_match_chain_is_w_launches_per_group(rels, monkeypatch):
    """A group of B joins flattens (c, B) into the matmul's batch axis: W
    calls of ``ops.ss_matmul``, each over c·B, never W·B."""
    _, tx = rels["X"]
    _, ty = rels["Y1"]
    calls = []
    real = ops.ss_matmul

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(ops, "ss_matmul", spy)
    bx = _col(tx, 0)[:, None].expand(C, 3, *_col(tx, 0).shape[1:])
    by = torch.stack([_col(ty, 0)] * 3, dim=1)
    ops.match_matrix_batch(bx, by)
    nx, ny, a = tx.n_tuples, ty.n_tuples, len(ALPHABET)
    assert calls == [((C * 3, ny, a), (C * 3, a, nx))] * W


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("method", ["chain", "aggregate"])
def test_join_match_round_rows_bit_identical(rels, shards, method):
    """The PK/FK fetch rows (c, ny, nx) of a group of two equal-size joins
    and one other size, sharded over S tuple-axis shards, equal the
    reference's share for share."""
    jx, tx = rels["X"]
    rights = ["Y1", "Y2", "Y3"]
    jjobs = [jrounds.JoinJob(rels[r][0], 0, 0, None, JCostLedger(),
                             match_method=method) for r in rights]
    tjobs = [rounds.JoinJob(rels[r][1], 0, 0, None, CostLedger(),
                            match_method=method) for r in rights]
    jent = jrounds.join_match_round(japi.get_backend("jnp"),
                                    JSharded(jx, shards=shards), jjobs)
    tent = rounds.join_match_round(api.get_backend("cuda"),
                                   ShardedRelation(tx, shards=shards), tjobs)
    for je, te, jj, tj in zip(jent, tent, jjobs, tjobs):
        assert te.degree == je.degree == 2 * W
        assert np.array_equal(te.values.numpy().astype(np.uint32),
                              np.asarray(je.values))
        assert tj.ledger.as_dict() == jj.ledger.as_dict()


# ---------------------------------------------------------------------------
# whole plans through QueryClient
# ---------------------------------------------------------------------------

def _plans(mod, rels, side):
    """One mixed batch in either package's API (side 0 = reference)."""
    r = {k: v[side] for k, v in rels.items()}
    return [
        mod.Join(right=r["Y1"], on=("Id", "Id")),
        mod.Select(mod.Eq("Name", "cab"), strategy="one_round"),
        mod.Count(mod.Eq("Name", "dd")),
        mod.Join(right=r["Y2"], on=("Id", "Id"), match_method="aggregate"),
        mod.Join(right=r["Y3"], on=(0, "Id"), match_method="auto"),
        mod.Join(right=r["Z"], on=("Name", "Name"), kind="equi",
                 padding=mod.Padding.fake_values(1)),
        mod.Select(mod.Eq("Name", "hag"), strategy="tree"),
        mod.Join(right=r["Y1"], on=("Id", "Id"), match_method="aggregate"),
        mod.Join(right=r["Z"], on=(1, 0), kind="equi"),
    ]


@pytest.fixture(scope="module")
def reference_batch(rels):
    return japi.QueryClient(rels["X"][0], key=21).run_batch(
        _plans(japi, rels, 0))


def _check_truth(outs):
    assert outs[0].rows == _pkfk_truth(KIDS1)
    assert outs[3].rows == _pkfk_truth(KIDS2)
    assert outs[4].rows == _pkfk_truth(KIDS3)
    assert outs[7].rows == outs[0].rows
    assert sorted(map(tuple, outs[5].rows)) == _equi_truth(TAGS)
    assert outs[5].rows == outs[8].rows
    assert outs[5].ledger.rounds == 1 + 2 * (2 + 1)
    assert outs[2].count == sum(r[1] == "dd" for r in PARENT)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_run_batch_mixed_matches_reference(rels, reference_batch, shards):
    """Joins of every method and kind inside one batch with selects and a
    count: the same rows, strategies and ledgers as the reference, at every
    shard count."""
    _, tx = rels["X"]
    rel = tx if shards == 1 else ShardedRelation(tx, shards=shards)
    outs = api.QueryClient(rel, seed=21, device="cpu").run_batch(
        _plans(api, rels, 1))
    for jr, tr in zip(reference_batch, outs):
        _same_result(jr, tr)
    _check_truth(outs)


def test_sequential_runs_match_the_batch(rels, reference_batch):
    """Each plan alone gives the rows and ledger it gets inside the batch."""
    client = api.QueryClient(rels["X"][1], seed=22, device="cpu")
    for plan, jr in zip(_plans(api, rels, 1), reference_batch):
        _same_result(jr, client.run(plan))


def test_match_methods_agree(rels):
    """chain == aggregate == auto, rows and ledgers (and the reference's)."""
    jx, tx = rels["X"]
    outs = {}
    for mm in ("chain", "aggregate", "auto"):
        res = api.QueryClient(tx, seed=13, device="cpu").run(
            api.Join(right=rels["Y2"][1], on=(0, 0), match_method=mm))
        outs[mm] = (res.rows, res.ledger.as_dict())
    assert outs["chain"] == outs["aggregate"] == outs["auto"]
    jres = japi.QueryClient(jx, key=13).run(
        japi.Join(right=rels["Y2"][0], on=(0, 0), match_method="auto"))
    assert outs["auto"] == (jres.rows, jres.ledger.as_dict())
    assert outs["auto"][0] == _pkfk_truth(KIDS2)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

STATS = [dict(n=24, m=3, c=C, w=W, a=9), dict(n=131072, m=5, c=20, w=8,
                                               a=69, shards=2),
         dict(n=7, m=2, c=16, w=1, a=69)]


def _est(e):
    return (e.strategy, e.bits, e.rounds, e.dispatches)


@pytest.mark.parametrize("i", range(len(STATS)))
def test_planner_join_estimates_match_reference(i):
    ts, js = api.DBStats(**STATS[i]), japi.DBStats(**STATS[i])
    tr, jr = api.DBStats(n=1024, m=3, c=20, w=8, a=69), japi.DBStats(
        n=1024, m=3, c=20, w=8, a=69)
    assert _est(api.estimate_pkfk_cost(ts, tr)) == _est(
        japi.estimate_pkfk_cost(js, jr))
    for values in (0, 1, 2):
        for fake in (0, 2):
            assert _est(api.estimate_equijoin_cost(
                ts, tr, values=values, fake_values=fake)) == _est(
                japi.estimate_equijoin_cost(js, jr, values=values,
                                            fake_values=fake))
    for method in ("chain", "aggregate"):
        assert api.estimate_match_method_launches(ts, method) == \
            japi.estimate_match_method_launches(js, method)
        assert api.choose_match_method(ts, method) == method
    assert api.choose_match_method(ts) == japi.choose_match_method(js)
    with pytest.raises(ValueError):
        api.choose_match_method(ts, "bogus")


def test_choose_match_method_pricing():
    stats = api.DBStats(n=8, m=3, c=20, w=8, a=69)
    assert api.estimate_match_method_launches(stats, "chain") == 8
    assert api.estimate_match_method_launches(stats, "aggregate") == 2
    assert api.choose_match_method(stats) == "aggregate"


def test_explain_join_batch_matches_reference_and_ledgers(rels,
                                                           reference_batch):
    plans_t, plans_j = _plans(api, rels, 1), _plans(japi, rels, 0)
    te = api.QueryClient(rels["X"][1], seed=1, device="cpu").explain(plans_t)
    je = japi.QueryClient(rels["X"][0], key=1).explain(plans_j)
    assert (te.bits, te.rounds, te.dispatches) == (je.bits, je.rounds,
                                                   je.dispatches)
    assert [(g.family, g.size, _est(g.estimate)) for g in te.groups] == [
        (g.family, g.size, _est(g.estimate)) for g in je.groups]
    pk = [g for g in te.groups if g.family == "pkfk"][0]
    assert pk.estimate.bits == sum(
        reference_batch[i].ledger.communication_bits for i in (0, 3, 4, 7))


# ---------------------------------------------------------------------------
# dispatches per join group
# ---------------------------------------------------------------------------

def _counting_backend():
    calls = {"match_matrix_batch": 0, "ss_matmul": 0}

    def count(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    be = api.Backend("counting", ss_matmul=count("ss_matmul", ops.ss_matmul),
                     aa_match_batch=ops.aa_match_batch,
                     aa_match_rows=ops.aa_match_rows,
                     match_matrix_batch=count("match_matrix_batch",
                                              ops.match_matrix_batch))
    return be, calls


def test_join_group_stacks_match_matrices_into_one_dispatch(rels):
    _, tx = rels["X"]
    plans = [api.Join(right=rels["Y1"][1], on=("Id", "Id"))
             for _ in range(3)]
    seq = [api.QueryClient(tx, seed=77, device="cpu").run(p) for p in plans]
    be, calls = _counting_backend()
    bat = api.QueryClient(tx, seed=77, backend=be, device="cpu").run_batch(
        plans)
    assert calls == {"match_matrix_batch": 1, "ss_matmul": 1}
    for a, b in zip(seq, bat):
        assert a.rows == b.rows == _pkfk_truth(KIDS1)
        assert a.ledger.as_dict() == b.ledger.as_dict()


def test_join_groups_split_by_right_relation_size(rels):
    _, tx = rels["X"]
    plans = [api.Join(right=rels[r][1], on=("Id", "Id"))
             for r in ("Y1", "Y3", "Y2")]
    seq = [api.QueryClient(tx, seed=13, device="cpu").run(p) for p in plans]
    be, calls = _counting_backend()
    bat = api.QueryClient(tx, seed=13, backend=be, device="cpu").run_batch(
        plans)
    assert calls["match_matrix_batch"] == 2     # one per ny class
    for a, b in zip(seq, bat):
        assert a.rows == b.rows and a.ledger.as_dict() == b.ledger.as_dict()


def test_backend_without_batched_matcher_steps_its_own(rels):
    """A backend with only ``match_matrix`` steps it over the group on the
    same device; one with neither cannot join and says so."""
    _, tx = rels["X"]
    plain = api.get_backend("torch")
    assert plain.match_matrix_batch is None
    res = api.QueryClient(tx, seed=5, backend=plain, device="cpu").run(
        api.Join(right=rels["Y1"][1], on=("Id", "Id")))
    assert res.rows == _pkfk_truth(KIDS1)
    bare = api.Backend("bare", ss_matmul=plain.ss_matmul,
                       aa_match_batch=plain.aa_match_batch,
                       aa_match_rows=plain.aa_match_rows)
    with pytest.raises(ValueError, match="match_matrix"):
        api.QueryClient(tx, seed=5, backend=bare, device="cpu").run(
            api.Join(right=rels["Y1"][1], on=("Id", "Id")))

"""The reference's public names that the port's ported modules carry too.

``Shares.add_public``, ``neg``, ``reshape``, ``__getitem__`` and
``sum(axis, keepdims)`` (an axis outside the secret shape raises, as the
reference's does), ``SecretSharedDB.column`` / ``col_index``,
``engine.fresh_ledger``, ``partition.split_sizes`` and the delegating
properties and ``max_shard_rows`` of ``ShardedRelation``, each held
against the reference on the CPU bit for bit (tolerance 0: the arithmetic
is exact mod p), with twins of ``tests/test_partition.py``'s
``split_sizes`` tests and ``tests/test_dataplane.py``'s ``max_shard_rows``
checks.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import Codec as JCodec
from repro.core import engine as jengine
from repro.core import outsource as joutsource
from repro.core import partition as jpartition
from repro.core.dataplane import ShardedRelation as JShardedRelation
from repro.core.shamir import Shares as JShares
from repro_torch.api import Count, Eq, QueryClient, Select
from repro_torch.core import Codec, engine, outsource, partition
from repro_torch.core.dataplane import ShardedRelation
from repro_torch.core.engine import from_arrays
from repro_torch.core.shamir import Shares

P = 2**31 - 1
CODEC_W = 6


def _elems(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)
    x.reshape(-1)[:3] = [0, 1, P - 1]
    return x


def _pair(seed=0, shape=(3, 2, 3, 4), degree=2):
    v = _elems(seed, shape)
    return (JShares(jax.numpy.asarray(v), degree),
            Shares(torch.from_numpy(v.astype(np.int32)), degree))


def _same(j, t):
    assert j.degree == t.degree
    np.testing.assert_array_equal(np.asarray(j.values).astype(np.uint32),
                                  t.values.numpy().astype(np.uint32))


@pytest.mark.parametrize("axis", [None, 0, 1, 2, -1, -3, (0, 2), (1, -1),
                                  ()])
@pytest.mark.parametrize("keepdims", [False, True])
def test_shares_sum_matches_reference(axis, keepdims):
    j, t = _pair(1)
    _same(j.sum(axis, keepdims=keepdims), t.sum(axis, keepdims=keepdims))


def test_shares_sum_keeps_the_dim_alias():
    j, t = _pair(2)
    _same(j.sum(axis=1), t.sum(dim=1))
    with pytest.raises(TypeError):
        t.sum(0, dim=1)


@pytest.mark.parametrize("axis", [3, -4, (0, 3), 7])
def test_shares_sum_out_of_range_axis_raises(axis):
    """On secret shape (2, 3, 4), axis 3 does not exist: the reference
    raises, and so does the port (it used to wrap 3 onto axis 0)."""
    j, t = _pair(3)
    assert t.shape == (2, 3, 4)
    if isinstance(axis, int) and axis >= 0:
        with pytest.raises(ValueError):
            j.sum(axis)
    with pytest.raises(ValueError):
        t.sum(axis)


@pytest.mark.parametrize("const", [0, 1, 5, P - 1, -3, 2**40 + 7])
def test_shares_public_ops_match_reference(const):
    j, t = _pair(4)
    _same(j.add_public(const), t.add_public(const))
    _same(j.mul_public(const), t.mul_public(const))
    _same(j.neg(), t.neg())


def test_shares_public_tensor_constant_matches_reference():
    j, t = _pair(5)
    c = _elems(6, (2, 3, 4))
    _same(j.add_public(c), t.add_public(torch.from_numpy(c.astype(np.int64))))


@pytest.mark.parametrize("shape", [((6, 4),), (6, 4), ((24,),), (2, 12)])
def test_shares_reshape_matches_reference(shape):
    j, t = _pair(7)
    _same(j.reshape(*shape), t.reshape(*shape))


@pytest.mark.parametrize("idx", [0, -1, slice(1, 2), (1, slice(None), 2),
                                 (slice(None), 0), (Ellipsis, 1)])
def test_shares_getitem_matches_reference(idx):
    j, t = _pair(8)
    _same(j[idx], t[idx])


# ---------------------------------------------------------------------------
# engine, partition, dataplane
# ---------------------------------------------------------------------------

ROWS = [[f"id{i}", f"nm{i % 5}", str(500 + 137 * i)] for i in range(32)]
NAMES = ["Id", "Name", "Val"]


@pytest.fixture(scope="module")
def dbs():
    jdb = joutsource(jax.random.PRNGKey(19), ROWS, column_names=NAMES,
                     codec=JCodec(word_length=CODEC_W), n_shares=20,
                     degree=1, numeric_columns={2: 14})
    tdb = from_arrays(np.asarray(jdb.relation.values),
                      degree=jdb.relation.degree,
                      alphabet=jdb.codec.alphabet,
                      word_length=jdb.codec.word_length, column_names=NAMES,
                      numeric={c: np.asarray(s.values)
                               for c, s in jdb.numeric.items()},
                      numeric_bits=dict(jdb.numeric_bits),
                      base_degree=jdb.base_degree, device="cpu")
    return jdb, tdb


@pytest.mark.parametrize("col", [0, 1, 2])
def test_db_column_and_col_index_match_reference(dbs, col):
    jdb, tdb = dbs
    _same(jdb.column(col), tdb.column(col))
    assert tdb.col_index(NAMES[col]) == jdb.col_index(NAMES[col]) == col
    with pytest.raises(ValueError):
        tdb.col_index("Nope")


def test_fresh_ledger_matches_reference():
    jl, tl = jengine.fresh_ledger(), engine.fresh_ledger()
    assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
    assert tl is not engine.fresh_ledger()


@pytest.mark.parametrize("total, k", [(10, 3), (64, 8), (7, 7), (1, 5),
                                      (100, 7), (0, 3), (5, 1)])
def test_split_sizes_matches_reference(total, k):
    assert partition.split_sizes(total, k) == jpartition.split_sizes(total,
                                                                     k)


def test_split_sizes_sum_to_total():
    for total, k in [(10, 3), (64, 8), (7, 7), (1, 5)]:
        sizes = partition.split_sizes(total, k)
        assert sum(sizes) == total
        assert all(s > 0 for s in sizes)


def test_balanced_within_one():
    sizes = partition.split_sizes(100, 7)
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("shards", [1, 3, 4, 100])
def test_sharded_relation_delegates_like_reference(dbs, shards):
    jdb, tdb = dbs
    jp, tp = JShardedRelation(jdb, shards=shards), ShardedRelation(
        tdb, shards=shards)
    assert tp.max_shard_rows == jp.max_shard_rows
    assert tp.n_shards == jp.n_shards
    for name in ("n_shares", "n_tuples", "n_attrs", "base_degree"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert list(tp.column_names) == list(jp.column_names)
    assert tp.numeric_bits == jp.numeric_bits
    assert tp.codec is tdb.codec and tp.relation is tdb.relation
    assert tp.numeric is tdb.numeric
    _same(jp.relation, tp.relation)
    for col in range(3):
        _same(jp.column(col), tp.column(col))
        assert tp.col_index(NAMES[col]) == jp.col_index(NAMES[col])
    for c, s in jp.numeric.items():
        _same(s, tp.numeric[c])


def test_sharded_relation_partitions_cover_and_clamp(dbs):
    _, db = dbs
    plane = ShardedRelation(db, shards=4)
    assert plane.n_shards == 4
    assert plane.shards[0].lo == 0 and plane.shards[-1].hi == db.n_tuples
    assert plane.max_shard_rows == 8           # ceil(32/4)
    assert plane.view(1).n_tuples == 8
    tiny = ShardedRelation(db, shards=100)
    assert tiny.n_shards == db.n_tuples and tiny.max_shard_rows == 1
    assert plane.n_tuples == db.n_tuples and plane.codec is db.codec


def test_oversharded_tiny_relation_regression():
    """n = 1, S = 4: the plane clamps to one shard of one row and still
    answers."""
    one = [["E1", "Ada", "Byron", "900", "Math"]]
    db1 = outsource(one, column_names=["Id", "First", "Last", "Sal", "Dept"],
                    codec=Codec(word_length=CODEC_W), n_shares=20, degree=1,
                    seed=3, device="cpu")
    plane = ShardedRelation(db1, shards=4)
    assert plane.n_shards == 1 and plane.max_shard_rows == 1
    client = QueryClient(db1, seed=9, device="cpu")
    assert client.attach(shards=4).max_shard_rows == 1
    assert client.run(Count(Eq("First", "Ada"))).count == 1
    assert client.run(Select(Eq("First", "Ada"),
                             strategy="one_round")).rows == [one[0]]

"""The port's multi-relation QueryClient against the JAX reference.

The attach registry (default-relation routing, re-sharding, loud errors),
per-relation key streams that do not depend on attach order (a derived
collision raises), the explanation cache and its invalidation on re-attach,
and ``run_batch_multi``: equal to solo serial batches and to the reference's
``run_batch_multi``, fused into one wave on a shared pool at S = 1, 2 and
4, with ``explain_multi`` equal to the measured ledgers (as
``tests/test_fused_fetch.py``, without its mesh case). Opened values, rows
and ledgers are exact, so the tolerance is 0.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_serving as data  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.core import Codec as JCodec  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import client as client_mod  # noqa: E402
from repro_torch.core import ShardedRelation  # noqa: E402
from repro_torch.core.dataplane import ThreadedDispatcher  # noqa: E402

ALPHABET = JCodec(word_length=6).alphabet


def _pair(seed, rows, names, numeric=None):
    return data.pair(jax, seed, rows, names, numeric=numeric,
                     alphabet=ALPHABET, word_length=6)


@pytest.fixture(scope="module")
def alpha():
    rows = [[f"id{i}", f"nm{i % 5}", str(500 + 137 * i)] for i in range(16)]
    return _pair(31, rows, ["Id", "Name", "Val"], numeric={2: 14})


@pytest.fixture(scope="module")
def beta():
    rows = [[f"o{i}", f"c{i % 3}", "open" if i % 2 else "done"]
            for i in range(12)]
    return _pair(32, rows, ["OrderId", "Customer", "Status"])


def alpha_plans(m):
    return [m.Select(m.Eq("Name", "nm2"), strategy="one_round",
                     expected_matches=3),
            m.Count(m.Eq("Name", "nm1")),
            m.Select(m.Eq("Name", "nm3"), strategy="tree",
                     expected_matches=3),
            m.RangeCount(m.Between("Val", 600, 1500), reduce_every=2)]


def beta_plans(m):
    return [m.Select(m.Eq("Status", "open"), strategy="one_round",
                     expected_matches=6),
            m.Select(m.Eq("Customer", "c1"), strategy="tree",
                     expected_matches=4),
            m.Count(m.Eq("Status", "done"))]


@pytest.fixture(scope="module")
def reference(alpha, beta):
    """The reference's fused multi-batch over both relations."""
    jc = japi.QueryClient()
    jc.attach(alpha[0], name="alpha", key=51)
    jc.attach(beta[0], name="beta", key=52)
    return jc.run_batch_multi([("alpha", alpha_plans(japi)),
                               ("beta", beta_plans(japi))])


def _solo(db, seed, plans, shards, dispatcher=None):
    client = api.QueryClient(db, seed, device="cpu")
    client.attach(shards=shards, dispatcher=dispatcher)
    return client.run_batch(plans)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_run_batch_multi_matches_solo_and_reference(alpha, beta, reference,
                                                    shards):
    ref_a = _solo(alpha[1], 51, alpha_plans(api), shards)
    ref_b = _solo(beta[1], 52, beta_plans(api), shards)
    client = api.QueryClient(device="cpu")
    client.attach(alpha[1], name="alpha", shards=shards, key=51)
    client.attach(beta[1], name="beta", shards=shards, key=52)
    got_a, got_b = client.run_batch_multi(
        [("alpha", alpha_plans(api)), ("beta", beta_plans(api))])
    for solo, got, ref in zip(ref_a + ref_b, got_a + got_b,
                              reference[0] + reference[1]):
        data.same(solo, got)
        data.same(ref, got)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_run_batch_multi_fuses_on_shared_pool(alpha, beta, reference,
                                              shards):
    pool = ThreadedDispatcher(max_workers=4)
    client = api.QueryClient(device="cpu")
    pa = client.attach(alpha[1], name="alpha", shards=shards, key=51,
                       dispatcher=pool.handle(weight=2.0))
    pb = client.attach(beta[1], name="beta", shards=shards, key=52,
                       dispatcher=pool.handle(weight=1.0))
    got_a, got_b = client.run_batch_multi(
        [("alpha", alpha_plans(api)), ("beta", beta_plans(api))])
    pool.close()
    for ref, got in zip(reference[0] + reference[1], got_a + got_b):
        data.same(ref, got)
    # both batches carry fetch traffic: exactly one fused wave
    assert pa.stats.fused_steps == 1 and pb.stats.fused_steps == 1
    assert pa.stats.dispatches == pa.stats.steps * shards
    assert pb.stats.dispatches == pb.stats.steps * shards


def test_run_batch_multi_single_and_empty_parts(alpha):
    ref = _solo(alpha[1], 51, alpha_plans(api), 2)
    client = api.QueryClient(device="cpu")
    client.attach(alpha[1], name="alpha", shards=2, key=51)
    (got,) = client.run_batch_multi([("alpha", alpha_plans(api))])
    for r, g in zip(ref, got):
        data.same(r, g)
    got_a, got_empty = client.run_batch_multi(
        [("alpha", alpha_plans(api)), ("alpha", [])])
    assert got_empty == []
    # the relation's key stream went on: the second batch used new keys,
    # so its transcript equals the solo client's second batch
    solo = api.QueryClient(alpha[1], 51, device="cpu")
    solo.attach(shards=2)
    solo.run_batch(alpha_plans(api))
    for r, g in zip(solo.run_batch(alpha_plans(api)), got_a):
        data.same(r, g)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_tree_shard_aligned_bit_identity(alpha, shards):
    plan = [api.Select(api.Eq("Name", "nm3"), strategy="tree",
                       expected_matches=3)]
    base = _solo(alpha[1], 9, plan, 1)[0]
    data.same(base, _solo(alpha[1], 9, plan, shards)[0])
    pool = ThreadedDispatcher(max_workers=shards)
    data.same(base, _solo(alpha[1], 9, plan, shards, dispatcher=pool)[0])
    pool.close()


def test_explain_multi_exact_on_fused_path(alpha, beta):
    plans_a = [api.Select(api.Eq("Name", "nm2"), strategy="one_round",
                          expected_matches=3),
               api.Count(api.Eq("Name", "nm1"))]
    plans_b = [api.Select(api.Eq("Status", "open"), strategy="one_round",
                          expected_matches=6),
               api.Count(api.Eq("Status", "done"))]
    pool = ThreadedDispatcher(max_workers=4)
    client = api.QueryClient(device="cpu")
    pa = client.attach(alpha[1], name="alpha", shards=2, key=51,
                       dispatcher=pool.handle())
    pb = client.attach(beta[1], name="beta", shards=2, key=52,
                       dispatcher=pool.handle())
    exp = client.explain_multi([("alpha", plans_a), ("beta", plans_b)])
    got_a, got_b = client.run_batch_multi(
        [("alpha", plans_a), ("beta", plans_b)])
    pool.close()
    assert exp.bits == sum(r.ledger.communication_bits
                           for r in got_a + got_b)
    assert exp.rounds == max(p.rounds for p in exp.parts)
    assert exp.bits == sum(p.bits for p in exp.parts)
    assert (exp.fetch_parts, exp.fetch_waves) == (2, 1)
    assert exp.dispatches == pa.stats.dispatches + pb.stats.dispatches
    assert [p.relation for p in exp.parts] == ["alpha", "beta"]
    # the reference prices the same batches identically
    jc = japi.QueryClient()
    jc.attach(alpha[0], name="alpha", shards=2, key=51)
    jc.attach(beta[0], name="beta", shards=2, key=52)
    jexp = jc.explain_multi([
        ("alpha", [japi.Select(japi.Eq("Name", "nm2"), strategy="one_round",
                               expected_matches=3),
                   japi.Count(japi.Eq("Name", "nm1"))]),
        ("beta", [japi.Select(japi.Eq("Status", "open"),
                              strategy="one_round", expected_matches=6),
                  japi.Count(japi.Eq("Status", "done"))])])
    assert (exp.bits, exp.rounds, exp.dispatches, exp.fetch_parts,
            exp.fetch_waves) == (jexp.bits, jexp.rounds, jexp.dispatches,
                                 jexp.fetch_parts, jexp.fetch_waves)


# ---------------------------------------------------------------------------
# the registry, key streams and the explanation cache
# ---------------------------------------------------------------------------

def test_attach_registry_and_routing(alpha, beta):
    client = api.QueryClient(alpha[1], 3, device="cpu")
    assert client.relations == (api.DEFAULT_RELATION,)
    assert client.dataplane is None and client.db is alpha[1]
    plane = client.attach(beta[1], name="beta", shards=3)
    assert client.relations == ("default", "beta")
    assert client.dataplane_of("beta") is plane and plane.n_shards == 3
    assert client.stats("beta").relation == "beta"
    assert client.stats().n == 16 and client.stats("beta").shards == 3
    # no relation= routes to the default relation
    assert client.count("Name", "nm1").count == 3
    assert client.count("Status", "open", relation="beta").count == 6
    with pytest.raises(KeyError, match="unknown relation"):
        client.count("Status", "open", relation="nope")
    # re-shard an attached name without passing its db again
    again = client.attach(name="beta", shards=2)
    assert again.n_shards == 2 and client.dataplane_of("beta") is again
    # a new dispatcher alone keeps the partitioning
    pool = ThreadedDispatcher(2)
    kept = client.attach(name="beta", dispatcher=pool)
    assert kept.n_shards == 2 and kept.dispatcher is pool
    pool.close()
    with pytest.raises(ValueError, match="no relation registered"):
        client.attach(name="orders")
    empty = api.QueryClient(device="cpu")
    assert empty.db is None and empty.dataplane is None
    with pytest.raises(ValueError, match="no relation attached"):
        empty.count("Name", "nm1")
    two = api.QueryClient(device="cpu")
    two.attach(alpha[1], name="a")
    assert two.count("Name", "nm1").count == 3       # the sole relation
    two.attach(beta[1], name="b")
    with pytest.raises(ValueError, match="pass relation="):
        two.count("Name", "nm1")
    # a ShardedRelation handed over keeps its partitioning
    pre = api.QueryClient(ShardedRelation(alpha[1], shards=4), 3,
                          device="cpu")
    assert pre.dataplane.n_shards == 4
    assert pre.attach().n_shards == 4


def test_key_streams_order_independent_and_collision_raises(alpha, beta,
                                                            monkeypatch):
    fwd = api.QueryClient(device="cpu", seed=7)
    fwd.attach(alpha[1], name="a")
    fwd.attach(beta[1], name="b")
    rev = api.QueryClient(device="cpu", seed=7)
    rev.attach(beta[1], name="b")
    rev.attach(alpha[1], name="a")
    for name in ("a", "b"):
        assert fwd._relations[name].root_key == rev._relations[name].root_key
    assert fwd._relations["a"].root_key != fwd._relations["b"].root_key
    # the same name replays the same transcript, whatever else is attached
    lone = api.QueryClient(device="cpu", seed=7)
    lone.attach(alpha[1], name="a")
    data.same(lone.run(api.Select(api.Eq("Name", "nm2"), strategy="one_round"),
                   relation="a"),
          rev.run(api.Select(api.Eq("Name", "nm2"), strategy="one_round"),
                  relation="a"))
    # force both CRC folds to collide for every name
    monkeypatch.setattr(client_mod.zlib, "crc32", lambda data: 123)
    clash = api.QueryClient(device="cpu", seed=7)
    clash.attach(alpha[1], name="a")
    with pytest.raises(ValueError, match="collides"):
        clash.attach(beta[1], name="b")
    clash.attach(beta[1], name="b", key=99)         # explicit key: fine
    assert clash._relations["b"].root_key == (99,)


def test_explain_cache_and_invalidation_on_reattach(alpha, beta):
    client = api.QueryClient(alpha[1], 3, device="cpu")
    plans = alpha_plans(api)
    first = client.explain(plans)
    assert client.explain(list(plans)) is first          # a cache hit
    assert first.relation == "default" and first.shards == 1
    client.attach(shards=2)                              # re-shard
    second = client.explain(plans)
    assert second is not first and second.shards == 2
    assert second.bits == first.bits
    assert second.dispatches > first.dispatches
    # a new tenant's attach invalidates too
    client.attach(beta[1], name="beta")
    assert client.explain(plans) is not second
    # a Join's right relation keys by identity and is pinned by the entry
    join = [api.Join(right=beta[1], on=("Name", "Customer"), kind="equi")]
    j1 = client.explain(join)
    assert client.explain(join) is j1
    assert any(beta[1] is r for _, pinned in client._explanations.values()
               for r in pinned)
    # FIFO eviction bounds the cache
    for i in range(api.EXPLAIN_CACHE_MAX + 5):
        client.explain([api.Count(api.Eq("Name", f"n{i}"))])
    assert len(client._explanations) == api.EXPLAIN_CACHE_MAX
    assert client.explain(join) is not j1                # evicted


def test_reattach_with_key_restarts_stream(alpha):
    client = api.QueryClient(device="cpu")
    client.attach(alpha[1], name="a", key=5)
    first = client.run(api.Select(api.Eq("Name", "nm2"),
                                  strategy="one_round"), relation="a")
    client.attach(name="a", shards=2, key=5)
    again = client.run(api.Select(api.Eq("Name", "nm2"),
                                  strategy="one_round"), relation="a")
    data.same(first, again)
